"""ZipVoice-Dialog and ZipVoice-Dialog-Stereo inference.

Two-party dialogue TTS with speaker-turn tokens [S1]/[S2].  Against the
base model:

* a 2-row speaker embedding (``spk_embed``, (2, F)) is added to the text
  encoder's output at the positions each speaker owns, found from the
  cumulative parity of the turn tokens;
* the stereo variant swaps the fm_decoder for the two-stream backbone
  (stream 0: 5F in, 2F out, the stereo sample space; stream 1: 3F in, F
  out), chosen by the input's width inside ``tts_zipformer_forward``.

Sampling is the base sampler on the speaker-aware text embedding.  The
dialog losses and the checkpoint surgery for training are not ported.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from zipvoice_tpu_torch.config import ZipVoiceConfig
from zipvoice_tpu_torch.models import zipvoice as zv
from zipvoice_tpu_torch.nn.zipformer import TTSZipformer

# the turn-token ids the released dialog vocabulary puts [S1]/[S2] at; the
# sampler takes these, not the tokenizer's ids (as the reference package)
SPK_A_ID_DEFAULT = 360
SPK_B_ID_DEFAULT = 361


class ZipVoiceDialogModel(zv.ZipVoiceModel):
    """The base model plus the speaker embedding; ``stereo`` swaps in the
    two-stream fm_decoder."""

    def __init__(self, cfg: ZipVoiceConfig, stereo: bool = False):
        super().__init__(cfg)
        self.spk_embed = nn.Embedding(2, cfg.feat_dim)
        if stereo:
            f = cfg.feat_dim
            self.fm_decoder = TTSZipformer(cfg.fm_decoder_config(),
                                           in_dims=(5 * f, 3 * f), out_dims=(2 * f, f))


@torch.no_grad()
def init_zipvoice_dialog(cfg: ZipVoiceConfig, stereo: bool = False,
                         generator: Optional[torch.Generator] = None,
                         device="cpu") -> ZipVoiceDialogModel:
    """Random weights with init_zipvoice's statistics; spk_embed N(0, 0.1^2)."""
    with torch.device("meta"):
        model = ZipVoiceDialogModel(cfg, stereo)
    model = zv.init_weights(model.to_empty(device=device), generator)
    model.spk_embed.weight.mul_(0.1)
    return model


def speaker_parity(tokens_padded: torch.Tensor, pad_id: int,
                   spk_a_id: int = SPK_A_ID_DEFAULT,
                   spk_b_id: int = SPK_B_ID_DEFAULT) -> torch.Tensor:
    """(B, S) ids -> (B, S) int64 in {-1, 0, 1}: the owner of each token by
    the parity of the turn tokens counted up to and including it (speaker
    A = 0); -1 at padding."""
    turn = (tokens_padded == spk_a_id) | (tokens_padded == spk_b_id)
    parity = torch.cumsum(turn.long(), dim=1) % 2
    return parity.masked_fill(tokens_padded == pad_id, -1)


def forward_text_embed(model: ZipVoiceDialogModel, tokens_padded: torch.Tensor,
                       tokens_lens: torch.Tensor, dtype=torch.float32,
                       spk_a_id: int = SPK_A_ID_DEFAULT,
                       spk_b_id: int = SPK_B_ID_DEFAULT) -> torch.Tensor:
    """The text encoder's output plus each position's speaker embedding."""
    embed = zv.forward_text_embed(model, tokens_padded, tokens_lens, dtype)
    spk = speaker_parity(tokens_padded, model.cfg.pad_id, spk_a_id, spk_b_id)
    w = model.spk_embed.weight.to(embed.dtype)
    embed = embed + torch.where((spk == 0)[:, :, None], w[0], 0.0)
    return embed + torch.where((spk == 1)[:, :, None], w[1], 0.0)


def sample_dialog(model: ZipVoiceDialogModel, tokens_padded, tokens_lens,
                  prompt_features, prompt_features_lens, features_lens, noise,
                  num_step: int = 16, guidance_scale: float = 1.5,
                  t_shift: float = 0.5, spk_a_id: int = SPK_A_ID_DEFAULT,
                  spk_b_id: int = SPK_B_ID_DEFAULT, timesteps=None) -> torch.Tensor:
    """``zipvoice.sample`` with the speaker-aware text embedding.  A stereo
    model samples in 2F: a (B, T, 2F) prompt and noise take stream 0."""
    embed = forward_text_embed(model, tokens_padded, tokens_lens,
                               dtype=prompt_features.dtype, spk_a_id=spk_a_id,
                               spk_b_id=spk_b_id)
    return zv.sample_from_embed(model, embed, tokens_lens, prompt_features,
                                prompt_features_lens, features_lens, noise,
                                num_step=num_step, guidance_scale=guidance_scale,
                                t_shift=t_shift, timesteps=timesteps)
