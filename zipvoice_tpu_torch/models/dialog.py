"""ZipVoice-Dialog and ZipVoice-Dialog-Stereo.

Two-party dialogue TTS with speaker-turn tokens [S1]/[S2].  Against the
base model:

* a 2-row speaker embedding (``spk_embed``, (2, F)) is added to the text
  encoder's output at the positions each speaker owns, found from the
  cumulative parity of the turn tokens;
* the stereo variant swaps the fm_decoder for the two-stream backbone
  (stream 0: 5F in, 2F out, the stereo sample space; stream 1: 3F in, F
  out), chosen by the input's width inside ``tts_zipformer_forward``.

Sampling is the base sampler on the speaker-aware text embedding.
Training masks the *suffix* of the features (``condition_time_mask_suffix``)
rather than an interior span; the stereo objective adds a penalty on both
channels speaking at once (``energy_based_loss``).  The checkpoint surgery
(``extend_vocab_params``, ``duplicate_projections_stereo``) works on
torch-layout state_dicts: nn.Linear weights are (out, in).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from zipvoice_tpu_torch.config import ZipVoiceConfig
from zipvoice_tpu_torch.models import zipvoice as zv
from zipvoice_tpu_torch.nn.zipformer import TrainCtx, TTSZipformer, sequence_parallel
from zipvoice_tpu_torch.parallel.mesh import fold_rank, global_sum, scatter_frames

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
                       spk_b_id: int = SPK_B_ID_DEFAULT,
                       ctx: Optional[TrainCtx] = None) -> torch.Tensor:
    """The text encoder's output plus each position's speaker embedding."""
    embed = zv.forward_text_embed(model, tokens_padded, tokens_lens, dtype, ctx=ctx)
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


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def condition_time_mask_suffix(features_lens: torch.Tensor, max_len: int,
                               generator: torch.Generator,
                               mask_percent: Tuple[float, float] = (0.5, 1.0)) -> torch.Tensor:
    """A span of U(mask_percent) of each utterance's frames ending at its
    last frame, (B, max_len) bool, True = masked."""
    b = features_lens.shape[0]
    dev = features_lens.device
    lo, hi = mask_percent
    u = torch.rand((b,), generator=generator, device=dev)
    size = ((lo + u * (hi - lo)) * features_lens.float()).to(torch.int32)
    start = features_lens.to(torch.int32) - size
    seq = torch.arange(max_len, dtype=torch.int32, device=dev)[None, :]
    return (seq >= start[:, None]) & (seq < (start + size)[:, None])


def energy_based_loss(fbank1: torch.Tensor, fbank2: torch.Tensor, gt_fbank: torch.Tensor,
                      feat_dim: int) -> torch.Tensor:
    """The both-speaking penalty (B, T): where both channels' frame energies
    (mean over the mels) exceed the median frame energy of the ground
    truth's two channels, the product of their excesses; else 0.  The
    median is the 0.5 quantile with linear interpolation, over gt_fbank's
    frames, which may be the whole sequence of a rank's frames fbank1 and
    fbank2 (sequence parallelism)."""
    e1 = fbank1.float().mean(dim=-1)
    e2 = fbank2.float().mean(dim=-1)
    gt_both = torch.cat([gt_fbank[:, :, :feat_dim], gt_fbank[:, :, feat_dim:]], dim=1)
    frame_energy = gt_both.float().mean(dim=-1)  # (B, 2T)
    thresh = torch.quantile(frame_energy, 0.5, dim=1, keepdim=True)
    both = ((e1 > thresh) & (e2 > thresh)).float()
    return both * (e1 - thresh) * (e2 - thresh)


def compute_fm_loss_dialog(
    model: ZipVoiceDialogModel,
    tokens_padded: torch.Tensor,
    tokens_lens: torch.Tensor,
    features: torch.Tensor,
    features_lens: torch.Tensor,
    noise: torch.Tensor,
    t: torch.Tensor,
    seed: int,
    condition_drop_ratio: float = 0.0,
    se_weight: float = 0.0,
    stereo: bool = False,
    schedules: Optional[dict] = None,
) -> torch.Tensor:
    """The dialog flow-matching loss: ``zipvoice.compute_fm_loss`` with the
    speaker-aware text embedding and the suffix condition mask.  With
    ``stereo`` and se_weight > 0 (features (B, T, 2F) through stream 0) it
    adds se_weight times the energy penalty of the one-step denoised
    estimate x_t + v (1 - t), averaged over the loss frames.  ``seed``
    seeds the mask, the text-condition drop and the training contexts, in
    compute_fm_loss's order; both means are over the global batch as in
    compute_fm_loss, and under a data x seq mesh a rank runs the fm_decoder
    on its frames as compute_fm_loss does (the penalty's median taken over
    the whole sequence)."""
    num_frames = features.shape[1]
    seq = zv.loss_seq_mesh(model, num_frames)
    dev = features.device
    seeds = np.random.default_rng(seed).integers(0, 2**62, size=4)
    text_ctx = fm_ctx = None
    if schedules is not None:
        text_ctx = TrainCtx(int(seeds[2]), schedules["text_encoder"], dev)
        fm_ctx = TrainCtx(int(seeds[3]), schedules["fm_decoder"], dev)
    embed = forward_text_embed(model, tokens_padded, tokens_lens, dtype=features.dtype,
                               ctx=text_ctx)
    text_condition, padding_mask = zv.forward_text_condition(embed, tokens_lens,
                                                             features_lens, num_frames)
    gen = torch.Generator(device=dev)
    speech_condition_mask = condition_time_mask_suffix(features_lens, num_frames,
                                                       gen.manual_seed(fold_rank(seeds[0])))
    speech_condition = features.masked_fill(speech_condition_mask[:, :, None], 0.0)
    if condition_drop_ratio > 0.0:
        drop = torch.rand((features.shape[0], 1, 1),
                          generator=gen.manual_seed(fold_rank(seeds[1])), device=dev)
        text_condition = text_condition * (drop > condition_drop_ratio).to(text_condition.dtype)
    loss_mask = speech_condition_mask & ~padding_mask
    whole = features
    if seq is not None:  # this rank's frames
        text_condition = scatter_frames(text_condition, seq)
        speech_condition, padding_mask, loss_mask, features, noise = (
            scatter_frames(x, seq) for x in (speech_condition, padding_mask, loss_mask,
                                             features, noise))
    tm = t.to(features.dtype)
    xt = features * tm + noise * (1.0 - tm)
    ut = features - noise
    with contextlib.nullcontext() if seq is None else sequence_parallel(seq):
        vt = zv.forward_fm_decoder(model, t, xt, text_condition, speech_condition, padding_mask,
                                   ctx=fm_ctx)
    w = loss_mask[:, :, None].float()
    se = torch.square((vt - ut).float()) * w
    fm_loss = torch.sum(se) / torch.clamp(global_sum(torch.sum(w)) * features.shape[-1],
                                          min=1.0)
    if not (stereo and se_weight > 0):
        return fm_loss
    f = model.cfg.feat_dim
    target = xt + vt * (1.0 - t)
    pen = energy_based_loss(target[:, :, :f], target[:, :, f:], whole, f)
    wm = loss_mask.float()
    return fm_loss + se_weight * torch.sum(pen * wm) / torch.clamp(global_sum(torch.sum(wm)),
                                                                   min=1.0)


# ---------------------------------------------------------------------------
# Checkpoint surgery (host side, torch-layout state_dicts)
# ---------------------------------------------------------------------------


def extend_vocab_params(fresh: Dict[str, torch.Tensor],
                        loaded: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A dialog model's state_dict from a base checkpoint: every loaded
    tensor the fresh model has, except that the token embedding keeps the
    fresh rows past the loaded vocabulary (the +28 dialog tokens); the fresh
    ``spk_embed`` stays."""
    out = dict(fresh)
    for k, v in loaded.items():
        if k == "embed.weight":
            emb = fresh[k].clone()
            emb[: v.shape[0]] = v
            out[k] = emb
        elif k in fresh:
            out[k] = v
    return out


def duplicate_projections_stereo(sd: Dict[str, torch.Tensor],
                                 feat_dim: int) -> Dict[str, torch.Tensor]:
    """A mono dialog state_dict -> the stereo model's: the fm_decoder's
    in/out projections become two-stream lists.  Stream 0 takes 5F in,
    [x/2, x/2, text, speech/2, speech/2] of the mono (3F) in-projection's
    input columns (nn.Linear (out, in): split along dim 1), and 2F out, the
    mono out-projection stacked twice along dim 0 (its bias too); stream 1
    is the mono pair."""
    f = feat_dim
    out = {k: v for k, v in sd.items()
           if not k.startswith(("fm_decoder.in_proj.", "fm_decoder.out_proj."))}
    w, b = sd["fm_decoder.in_proj.weight"], sd["fm_decoder.in_proj.bias"]
    x, tc, sc = w[:, :f], w[:, f:2 * f], w[:, 2 * f:]
    out["fm_decoder.in_proj.0.weight"] = torch.cat([x / 2, x / 2, tc, sc / 2, sc / 2], dim=1)
    out["fm_decoder.in_proj.0.bias"] = b.clone()
    out["fm_decoder.in_proj.1.weight"] = w.clone()
    out["fm_decoder.in_proj.1.bias"] = b.clone()
    ow, ob = sd["fm_decoder.out_proj.weight"], sd["fm_decoder.out_proj.bias"]
    out["fm_decoder.out_proj.0.weight"] = torch.cat([ow, ow], dim=0)
    out["fm_decoder.out_proj.0.bias"] = torch.cat([ob, ob], dim=0)
    out["fm_decoder.out_proj.1.weight"] = ow.clone()
    out["fm_decoder.out_proj.1.bias"] = ob.clone()
    return out
