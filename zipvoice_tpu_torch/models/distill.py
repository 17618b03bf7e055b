"""ZipVoice-Distill: the guidance-scale-embedded student and its
distillation losses.

The distilled student's fm_decoder takes the guidance scale as an embedding
input (``use_guidance_scale_embed``), so its sampler makes one fm_decoder
call a step at batch B with no CFG doubling (``sampling/euler.py``,
``distill=True``).  The weights load into a ``ZipVoiceModel`` built from
``distill_config``.

Training has two stages.  In stage ``first`` the teacher is the trained
base model on its CFG path; in stage ``second`` it is the EMA of the
student (``ema_update``, decay 0.9999) on the distill path.  Each step the
teacher makes two chained one-step hops t -> t + d_fix -> t_dest and the
student one hop t -> t_dest; the loss is the MSE between the velocities the
two end points imply.  Only the student's fm_decoder trains
(``train/distill_step.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from zipvoice_tpu_torch.config import ZipVoiceConfig
from zipvoice_tpu_torch.models import zipvoice as zv
from zipvoice_tpu_torch.nn.functional import make_pad_mask
from zipvoice_tpu_torch.parallel.mesh import global_sum
from zipvoice_tpu_torch.sampling.euler import cfg_velocity, get_time_steps


def distill_config(cfg: ZipVoiceConfig) -> ZipVoiceConfig:
    """The base configuration with the guidance-scale embedding on."""
    return dataclasses.replace(cfg, use_guidance_scale_embed=True)


def init_zipvoice_distill(cfg: ZipVoiceConfig, generator: Optional[torch.Generator] = None,
                          device="cpu") -> zv.ZipVoiceModel:
    """A student with init_zipvoice's statistics on the base configuration
    ``cfg`` with the guidance-scale embedding added."""
    return zv.init_zipvoice(distill_config(cfg), generator, device=device)


def sample_intermediate(model: zv.ZipVoiceModel, tokens_padded, tokens_lens, features,
                        features_lens, noise, speech_condition_mask, t_start: float,
                        t_end: float, num_step: int = 1, guidance_scale=None,
                        distill: bool = True) -> torch.Tensor:
    """Integrate from t_start to t_end with the conditioning built from the
    ground truth.  guidance_scale: (B,) tensor or float on the distill path
    (None embeds 0.0, as the reference always embeds a scale), a float on
    the CFG path."""
    if distill and guidance_scale is None:
        guidance_scale = 0.0
    num_frames = features.shape[1]
    text_condition, padding_mask = zv.forward_text_train(
        model, tokens_padded, tokens_lens, features_lens, num_frames, dtype=features.dtype)
    speech_condition = features.masked_fill(speech_condition_mask[:, :, None], 0.0)
    ts = get_time_steps(t_start, t_end, num_step, 1.0)
    x = noise
    for i in range(num_step):
        v = cfg_velocity(model, float(ts[i]), x, text_condition, speech_condition,
                         padding_mask, guidance_scale, distill=distill)
        x = x + v * float(ts[i + 1] - ts[i])
    return x


def _cfg_velocity_traced_t(model: zv.ZipVoiceModel, t, x, text_condition,
                           speech_condition, padding_mask,
                           guidance_scale: torch.Tensor) -> torch.Tensor:
    """The CFG velocity with a tensor guidance scale (per row, (B, 1, 1), or
    one scalar): the unconditioned and conditioned passes as one 2B batch;
    for t > 0.5 the unconditioned half drops the speech condition too, for
    t <= 0.5 it keeps it and the scale doubles.  The rule is
    ``sampling/euler.cfg_velocity``'s with a tensor scale.  A host t makes
    the select a branch; a tensor t (a runtime input of an exported
    program) makes it a select on the device."""
    tc2 = torch.cat([torch.zeros_like(text_condition), text_condition])
    if isinstance(t, torch.Tensor):
        hi = t > 0.5
        sc_uncond = torch.where(hi, torch.zeros_like(speech_condition), speech_condition)
        gs = torch.where(hi, guidance_scale, 2.0 * guidance_scale)
    elif t > 0.5:
        sc_uncond, gs = torch.zeros_like(speech_condition), guidance_scale
    else:
        sc_uncond, gs = speech_condition, 2.0 * guidance_scale
    sc2 = torch.cat([sc_uncond, speech_condition])
    gs = gs.to(x.dtype)
    v2 = zv.forward_fm_decoder(model, t, torch.cat([x, x]), tc2, sc2,
                               torch.cat([padding_mask, padding_mask]))
    v_uncond, v_cond = v2.chunk(2)
    return (1.0 + gs) * v_cond - gs * v_uncond


def draw_noise_and_scale(seed: int, features: torch.Tensor,
                         stage: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The step's standard-normal noise (drawn in f32, in the features'
    dtype) and per-row guidance scale (B, 1, 1) in the features' dtype:
    U(0, 2) in stage ``first``, U(1, 3) in ``second``."""
    dev = features.device
    k_noise, k_gs = np.random.default_rng(seed).integers(0, 2**62, size=2)
    gen = torch.Generator(device=dev)
    noise = torch.randn(features.shape, generator=gen.manual_seed(int(k_noise)),
                        device=dev).to(features.dtype)
    u = torch.rand((features.shape[0], 1, 1), generator=gen.manual_seed(int(k_gs)),
                   device=dev)
    scale = u * 2.0 if stage == "first" else u * 2.0 + 1.0
    return noise, scale.to(features.dtype)


def _hop(model, x, t0, t1, text_condition, speech_condition, padding_mask,
         guidance_scale, distill_path: bool) -> torch.Tensor:
    """One Euler step t0 -> t1 (f32 host values)."""
    if distill_path:
        v = zv.forward_fm_decoder(model, float(t0), x, text_condition, speech_condition,
                                  padding_mask, guidance_scale=guidance_scale[:, 0, 0])
    else:
        v = _cfg_velocity_traced_t(model, float(t0), x, text_condition, speech_condition,
                                   padding_mask, guidance_scale)
    # the span is an f32 difference rounded to the velocity's dtype
    return x + v * torch.tensor(float(np.float32(t1) - np.float32(t0)), dtype=v.dtype,
                                device=v.device)


def compute_distill_loss(
    student: zv.ZipVoiceModel,
    teacher: zv.ZipVoiceModel,
    tokens_padded: torch.Tensor,
    tokens_lens: torch.Tensor,
    features: torch.Tensor,
    features_lens: torch.Tensor,
    seed: int,
    t_value: float,
    t_delta_fix: float,
    t_delta_ema: float,
    stage: str = "first",
    teacher_distill: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One distillation loss: (loss, ref_loss), f32 scalars.

    features: (B, T, F) in the compute dtype.  t_value / t_delta_*: the
    step's host-drawn f32 triple (``train/distill_step.draw_t_schedule``).
    ``seed`` seeds the noise, the guidance scales and the condition mask.
    The teacher's hops run without autograd; so does the student's text
    encoder (only its fm_decoder trains), so the graph holds the student's
    fm_decoder alone.  ref_loss is the student's error against the
    flow-matching target features - noise.  Both are normalized by the
    valid count over every rank, as ``zipvoice.compute_fm_loss`` is."""
    if teacher_distill is None:
        teacher_distill = stage != "first"
    if stage not in ("first", "second"):
        raise ValueError(f"unknown distillation stage {stage!r}")
    num_frames = features.shape[1]
    s_noise, s_mask = np.random.default_rng(seed).integers(0, 2**62, size=2)
    noise, guidance_scale = draw_noise_and_scale(int(s_noise), features, stage)

    t_value, t_delta_fix, t_delta_ema = (np.float32(v) for v in
                                         (t_value, t_delta_fix, t_delta_ema))
    t_mid = t_value + t_delta_fix
    t_dest = t_mid + t_delta_ema

    t = torch.tensor(float(t_value), dtype=features.dtype, device=features.device)
    xt = features * t + noise * (1.0 - t)
    gen = torch.Generator(device=features.device).manual_seed(int(s_mask))
    speech_condition_mask = zv.condition_time_mask(features_lens, num_frames, gen, (0.7, 1.0))
    speech_condition = features.masked_fill(speech_condition_mask[:, :, None], 0.0)

    def text(model):
        return zv.forward_text_train(model, tokens_padded, tokens_lens, features_lens,
                                     num_frames, dtype=features.dtype)

    with torch.no_grad():
        tc, pm = text(teacher)
        x_mid = _hop(teacher, xt, t_value, t_mid, tc, speech_condition, pm,
                     guidance_scale, teacher_distill)
        target_x1 = _hop(teacher, x_mid, t_mid, t_dest, tc, speech_condition, pm,
                         guidance_scale, teacher_distill)
        tc, pm = text(student)
    pred_x1 = _hop(student, xt, t_value, t_dest, tc, speech_condition, pm,
                   guidance_scale, True)

    denom = float(t_dest - t_value)
    pred_v = (pred_x1 - xt).float() / denom
    target_v = (target_x1 - xt).float() / denom
    padding_mask = make_pad_mask(features_lens, num_frames)
    w = (speech_condition_mask & ~padding_mask)[:, :, None].float()
    n = torch.clamp(global_sum(torch.sum(w)) * features.shape[-1], min=1.0)
    loss = torch.sum(torch.square(pred_v - target_v) * w) / n
    ut = (features - noise).float()
    ref_loss = torch.sum(torch.square(pred_v.detach() - ut) * w) / n
    return loss, ref_loss


@torch.no_grad()
def ema_update(teacher: torch.nn.Module, student: torch.nn.Module,
               decay: float = 0.9999) -> None:
    """teacher <- decay * teacher + (1 - decay) * student, in the teacher's
    dtype (f32), in place."""
    for t, s in zip(teacher.parameters(), student.parameters()):
        t.copy_(t * decay + s.to(t.dtype) * (1.0 - decay))
