"""``ZipVoice`` with the reference's constructor, state_dict names and the
methods the parity harnesses call, on the port's modules."""

from typing import List

import torch

from zipvoice_tpu_torch.config import ZipVoiceConfig
from zipvoice_tpu_torch.models import zipvoice as zv
from zipvoice_tpu_torch.sampling.euler import euler_sample


def model_config(raw: dict, vocab_size: int, pad_id: int) -> ZipVoiceConfig:
    """The configuration of a model.json's ``model`` entries (an unknown
    key raises, as the reference's keyword arguments do)."""
    return ZipVoiceConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in raw.items()},
                          vocab_size=vocab_size, pad_id=pad_id)


class EulerSolver:
    """The reference's sampler semantics: Euler steps on the shifted grid,
    CFG as one doubled batch (the speech condition dropped for t > 0.5,
    else the scale doubled), or, for the distilled model, the scale
    embedded and no doubling."""

    def __init__(self, model: torch.nn.Module, distill: bool = False):
        self.model = model
        self.distill = distill

    def sample(self, x, text_condition, speech_condition, padding_mask, num_step: int = 10,
               guidance_scale: float = 0.5, t_start: float = 0.0, t_end: float = 1.0,
               t_shift: float = 1.0):
        return euler_sample(self.model, x, text_condition, speech_condition, padding_mask,
                            num_step=num_step, guidance_scale=guidance_scale, t_start=t_start,
                            t_end=t_end, t_shift=t_shift, distill=self.distill)


class ReferenceAPI:
    """The text front of the reference's models: token lists in, the text
    encoder's output and the frame-rate condition out."""

    pad_id: int

    def forward_text_embed(self, tokens: List[List[int]]):
        device = next(self.parameters()).device
        tokens_padded = torch.from_numpy(zv.pad_labels(tokens, self.pad_id)).to(device)
        tokens_lens = torch.tensor([len(t) for t in tokens], dtype=torch.int64, device=device)
        return self.text_embed(tokens_padded, tokens_lens), tokens_lens

    def text_embed(self, tokens_padded, tokens_lens):
        return zv.forward_text_embed(self, tokens_padded, tokens_lens)

    def forward_text_condition(self, embed, tokens_lens, features_lens):
        return zv.forward_text_condition(embed, tokens_lens, features_lens,
                                         int(features_lens.max()))


class ZipVoice(ReferenceAPI, zv.ZipVoiceModel):
    def __init__(self, vocab_size: int = 26, pad_id: int = 0, **raw):
        super().__init__(model_config(raw, vocab_size, pad_id))
        self.pad_id = pad_id
        self.solver = EulerSolver(self)
