"""Euler ODE sampling with classifier-free guidance.

The timestep grid is host-side numpy (f32), so the dual-condition CFG rule
(drop the speech condition for t > 0.5, else double the guidance scale) is
a plain Python branch per step.  ``cfg_velocity`` is the one place that
rule lives.  The distill variant embeds the guidance scale instead: one
fm_decoder call a step at batch B, no CFG batch and no dual-condition
switch.
"""

from __future__ import annotations

import numpy as np
import torch

from zipvoice_tpu_torch.models.zipvoice import ZipVoiceModel, forward_fm_decoder


def get_time_steps(t_start: float = 0.0, t_end: float = 1.0, num_step: int = 10,
                   t_shift: float = 1.0) -> np.ndarray:
    """Shifted linear schedule t' = s*t / (1 + (s-1)*t), in f32."""
    ts = np.linspace(t_start, t_end, num_step + 1, dtype=np.float64)
    ts = t_shift * ts / (1.0 + (t_shift - 1.0) * ts)
    return ts.astype(np.float32)


def validate_time_steps(timesteps, t_start: float = 0.0,
                        t_end: float = 1.0) -> np.ndarray:
    """Normalize an explicit timestep grid: strictly increasing, >= 2
    knots, spanning [t_start, t_end] exactly."""
    ts = np.asarray(timesteps, np.float32).reshape(-1)
    if ts.size < 2:
        raise ValueError(f"timesteps needs >= 2 knots, got {ts.size}")
    if not np.all(np.diff(ts) > 0):
        raise ValueError(f"timesteps must strictly increase: {ts}")
    if not (abs(ts[0] - t_start) < 1e-6 and abs(ts[-1] - t_end) < 1e-6):
        raise ValueError(
            f"timesteps must span [{t_start}, {t_end}] exactly, got "
            f"[{ts[0]}, {ts[-1]}]"
        )
    return ts


def cfg_velocity(model: ZipVoiceModel, t: float, x: torch.Tensor,
                 text_condition: torch.Tensor, speech_condition: torch.Tensor,
                 padding_mask: torch.Tensor, guidance_scale: float,
                 distill: bool = False) -> torch.Tensor:
    """One velocity evaluation with classifier-free guidance.

    ``distill``: one conditioned pass with the scale embedded (any scale,
    0 included).  guidance_scale == 0 runs the conditioned pass alone.
    Otherwise the unconditioned and conditioned passes run as one 2B
    batch: for t > 0.5 the unconditioned half drops the speech condition
    too; for t <= 0.5 it keeps it and the scale doubles.  The result is
    (1 + gs) * v_cond - gs * v_uncond."""
    if distill:
        return forward_fm_decoder(model, t, x, text_condition, speech_condition,
                                  padding_mask, guidance_scale=guidance_scale)
    if guidance_scale == 0.0:
        return forward_fm_decoder(model, t, x, text_condition, speech_condition,
                                  padding_mask)
    tc2 = torch.cat([torch.zeros_like(text_condition), text_condition])
    if t > 0.5:
        sc2 = torch.cat([torch.zeros_like(speech_condition), speech_condition])
        gs = guidance_scale
    else:
        sc2 = torch.cat([speech_condition, speech_condition])
        gs = 2.0 * guidance_scale
    v2 = forward_fm_decoder(model, t, torch.cat([x, x]), tc2, sc2,
                            torch.cat([padding_mask, padding_mask]))
    v_uncond, v_cond = v2.chunk(2)
    # the scale and 1 + scale are rounded to the state's dtype on the host
    # (no device copy); the products then run in that dtype
    gs = _round_to(gs, x.dtype)
    return _round_to(1.0 + gs, x.dtype) * v_cond - gs * v_uncond


def _round_to(value: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(value, dtype=dtype))


def euler_sample(
    model: ZipVoiceModel,
    x: torch.Tensor,
    text_condition: torch.Tensor,
    speech_condition: torch.Tensor,
    padding_mask: torch.Tensor,
    num_step: int = 16,
    guidance_scale: float = 1.0,
    t_start: float = 0.0,
    t_end: float = 1.0,
    t_shift: float = 1.0,
    distill: bool = False,
    timesteps=None,
) -> torch.Tensor:
    """Euler integration from noise x at t_start to t_end.  ``timesteps``
    (an explicit grid) overrides num_step / t_shift; ``distill`` embeds
    the guidance scale (``cfg_velocity``)."""
    if timesteps is not None:
        ts = validate_time_steps(timesteps, t_start, t_end)
    else:
        ts = get_time_steps(t_start, t_end, num_step, t_shift)
    out_dtype = x.dtype
    if model.cfg.f32_closers:
        # f32 Euler state and CFG combination; the fm_decoder's out_proj
        # emits f32 under the same flag
        x = x.float()
    for i in range(len(ts) - 1):
        v = cfg_velocity(model, float(ts[i]), x, text_condition, speech_condition,
                         padding_mask, guidance_scale, distill)
        x = x + v * _round_to(float(ts[i + 1] - ts[i]), v.dtype)
    return x.to(out_dtype)
