"""Core numerics for the Zipformer backbone, as plain functions on tensors.

All functions are batch-first (B, T, C) and dtype-polymorphic: the
precision-sensitive reductions (BiasNorm statistics, softmax) run in
float32 and cast back.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from zipvoice_tpu_torch.utils.graphs import hold


def swoosh_l(x: torch.Tensor) -> torch.Tensor:
    """SwooshL(x) = log(1 + exp(x-4)) - 0.08 x - 0.035, computed in f32."""
    x32 = x.float()
    return (F.softplus(x32 - 4.0) - 0.08 * x32
            - 0.035).to(x.dtype)


def swoosh_r(x: torch.Tensor) -> torch.Tensor:
    """SwooshR(x) = log(1 + exp(x-1)) - 0.08 x - 0.313261687, computed in f32."""
    x32 = x.float()
    return (F.softplus(x32 - 1.0) - 0.08 * x32
            - 0.313261687).to(x.dtype)


def bias_norm(x: torch.Tensor, bias: torch.Tensor,
              log_scale: torch.Tensor) -> torch.Tensor:
    """BiasNorm: x * rsqrt(mean((x - bias)^2, ch)) * exp(log_scale), with
    f32 statistics; channel dim is last."""
    x32 = x.float()
    d = x32 - bias.float()
    scales = torch.rsqrt(torch.mean(d * d, dim=-1, keepdim=True)) * torch.exp(
        log_scale.float()
    )
    return (x32 * scales).to(x.dtype)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense layer with torch's (out, in) weight; parameters are cast to
    x.dtype and the result stays in x.dtype."""
    return F.linear(x, weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype))


def masked_softmax(scores: torch.Tensor,
                   key_padding_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """f32 softmax over the last axis with the -1000 mask fill (not -inf,
    so a fully-masked row gives uniform rather than NaN weights).
    key_padding_mask: (B, S) True = masked; scores: (B, H, T, S)."""
    scores = scores.float()
    if key_padding_mask is not None:
        scores = scores.masked_fill(key_padding_mask[:, None, None, :], -1000.0)
    return torch.softmax(scores, dim=-1)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding: concat([cos(t*f), sin(t*f)]) with
    f = exp(-log(max_period) * i / half); (B,) -> (B, dim) in f32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t[..., None].float() * freqs
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[..., :1])], dim=-1)
    return emb


@functools.lru_cache(maxsize=64)
def _compact_rel_pe_np(seq_len: int, pos_dim: int, length_factor: float) -> np.ndarray:
    """The PE table in float64, rounded to f32: float64 keeps the
    high-frequency columns (error amplified by the frequency index, up to
    pos_dim/2) at f32 accuracy."""
    x = np.arange(-(seq_len - 1), seq_len, dtype=np.float64)[:, None]
    freqs = 1.0 + np.arange(pos_dim // 2, dtype=np.float64)
    compression_length = pos_dim**0.5
    x_compressed = (
        compression_length
        * np.sign(x)
        * (np.log(np.abs(x) + compression_length) - math.log(compression_length))
    )
    length_scale = length_factor * pos_dim / (2.0 * math.pi)
    x_atan = np.arctan(x_compressed / length_scale)
    pe = np.zeros((2 * seq_len - 1, pos_dim), dtype=np.float64)
    pe[:, 0::2] = np.cos(x_atan * freqs)
    pe[:, 1::2] = np.sin(x_atan * freqs)
    pe[:, -1] = 1.0  # bias column
    return pe.astype(np.float32)


def compact_rel_positional_encoding(
    seq_len: int, pos_dim: int, length_factor: float = 1.0,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """Relative positional encoding table for offsets -(T-1)..(T-1):
    atan-compressed Fourier features, (2T-1, pos_dim) f32; row n encodes
    relative offset n - (T-1).  Cached per (T, pos_dim, device) so the
    sampler uploads each table once, and held by a graph captured over it;
    callers must not write to it."""
    return hold(_rel_pe_table(seq_len, pos_dim, length_factor, device))


@functools.lru_cache(maxsize=64)
def _rel_pe_table(seq_len: int, pos_dim: int, length_factor: float,
                  device: Optional[torch.device]) -> torch.Tensor:
    return torch.from_numpy(_compact_rel_pe_np(seq_len, pos_dim, length_factor)).to(
        device
    )


def make_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths -> (B, max_len) bool mask, True at padding positions."""
    seq = torch.arange(max_len, dtype=lengths.dtype, device=lengths.device)
    return seq[None, :] >= lengths[:, None]
