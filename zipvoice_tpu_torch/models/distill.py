"""ZipVoice-Distill inference: the student's configuration.

The distilled student's fm_decoder takes the guidance scale as an embedding
input (``use_guidance_scale_embed``), so its sampler makes one fm_decoder
call a step at batch B with no CFG doubling (``sampling/euler.py``,
``distill=True``).  The weights load into a ``ZipVoiceModel`` built from
``distill_config``.  Distillation training is not ported.
"""

from __future__ import annotations

import dataclasses

from zipvoice_tpu_torch.config import ZipVoiceConfig


def distill_config(cfg: ZipVoiceConfig) -> ZipVoiceConfig:
    """The base configuration with the guidance-scale embedding on."""
    return dataclasses.replace(cfg, use_guidance_scale_embed=True)
