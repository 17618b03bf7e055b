"""Model-directory contract: {model.pt | model.safetensors, model.json, tokens.txt}.

Loads from a local directory only; the port never downloads.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Optional

import torch

from zipvoice_tpu_torch.config import FeatureConfig, ZipVoiceConfig, load_model_json
from zipvoice_tpu_torch.io.checkpoint import load_into, load_torch_state_dict
from zipvoice_tpu_torch.models.dialog import ZipVoiceDialogModel
from zipvoice_tpu_torch.models.distill import distill_config
from zipvoice_tpu_torch.models.zipvoice import ZipVoiceModel
from zipvoice_tpu_torch.text.tokenizer import get_tokenizer

# model-name -> (tokenizer, sampling defaults, pipeline variant)
MODEL_REGISTRY = {
    "zipvoice": dict(tokenizer="emilia", num_step=16, guidance_scale=1.0,
                     t_shift=0.5, distill=False, variant="zipvoice"),
    "zipvoice_distill": dict(tokenizer="emilia", num_step=8, guidance_scale=3.0,
                             t_shift=0.5, distill=True, variant="zipvoice"),
    "zipvoice_dialog": dict(tokenizer="dialog", num_step=16, guidance_scale=1.5,
                            t_shift=0.5, distill=False, variant="dialog"),
    "zipvoice_dialog_stereo": dict(tokenizer="dialog", num_step=16, guidance_scale=1.5,
                                   t_shift=0.5, distill=False, variant="dialog_stereo"),
}


@dataclasses.dataclass
class ModelAssets:
    model: ZipVoiceModel  # f32 weights on the CPU
    model_cfg: ZipVoiceConfig
    feat_cfg: FeatureConfig
    tokenizer: object
    defaults: Dict


def _find_checkpoint(model_dir: Path, checkpoint_name: Optional[str]) -> Path:
    # the CLI defaults checkpoint_name to "model.pt": fall through to the
    # safetensors lookup when that default does not exist
    if checkpoint_name and (model_dir / checkpoint_name).exists():
        return model_dir / checkpoint_name
    if checkpoint_name and checkpoint_name != "model.pt":
        raise FileNotFoundError(f"{model_dir / checkpoint_name} not found")
    for name in ("model.pt", "model.safetensors"):
        if (model_dir / name).exists():
            return model_dir / name
    raise FileNotFoundError(f"no model.pt/model.safetensors in {model_dir}")


def load_model_dir(
    model_dir: Optional[str],
    model_name: str = "zipvoice",
    checkpoint_name: Optional[str] = None,
    tokenizer_name: Optional[str] = None,
    lang: str = "en-us",
) -> ModelAssets:
    if model_dir is None:
        raise NotImplementedError(
            "downloading a model is not yet ported to zipvoice_tpu_torch; "
            "pass a local model dir (model.pt, model.json, tokens.txt)"
        )
    if model_name not in MODEL_REGISTRY:
        raise ValueError(f"unknown model {model_name!r}; one of {sorted(MODEL_REGISTRY)}")
    reg = MODEL_REGISTRY[model_name]
    model_dir = Path(model_dir)
    tokenizer = get_tokenizer(tokenizer_name or reg["tokenizer"],
                              str(model_dir / "tokens.txt"), lang=lang)
    model_cfg, feat_cfg = load_model_json(
        model_dir / "model.json",
        vocab_size=tokenizer.vocab_size,
        pad_id=tokenizer.pad_id,
    )
    if reg["distill"]:
        model_cfg = distill_config(model_cfg)
    with torch.device("meta"):
        if reg["variant"] == "zipvoice":
            model = ZipVoiceModel(model_cfg)
        else:
            model = ZipVoiceDialogModel(model_cfg,
                                        stereo=reg["variant"] == "dialog_stereo")
    load_into(model, load_torch_state_dict(_find_checkpoint(model_dir, checkpoint_name)))
    return ModelAssets(model=model.float(), model_cfg=model_cfg, feat_cfg=feat_cfg,
                       tokenizer=tokenizer, defaults=dict(reg))
