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


def quantize_rows(x: torch.Tensor):
    """(int8 rows, (M, 1) f32 scales) of an (M, K) activation: symmetric per
    row, s_x = max(max|x_row| / 127, 1e-12), round half to even, clip to
    +-127, computed in f32.  The 127 is a tensor: CUDA divides by a Python
    scalar as a product with its reciprocal, which can round s_x one ulp
    away from the quotient the CPU (and the reference package) computes."""
    x32 = x.float()
    amax = x32.abs().amax(dim=1, keepdim=True)
    s_x = torch.clamp(amax / amax.new_full((), 127.0), min=1e-12)
    return torch.clamp(torch.round(x32 / s_x), -127, 127).to(torch.int8), s_x


def linear_int8(x: torch.Tensor, weight_int8: torch.Tensor, weight_scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None, dynamic: bool = False) -> torch.Tensor:
    """Dense layer over an int8 (out, in) weight with its f32 per-output-
    channel scale (``ops/quant.py``); the result is in x.dtype.

    Weight-only: x times the weight cast to x.dtype, accumulated in f32,
    times the f32 scale, then rounded to x.dtype once.  Dynamic: x is
    quantized per row (s_x = max(max|x_row| / 127, 1e-12), round half to
    even, clip to +-127), the product runs int8 x int8 -> int32, and the
    f32 result is (y * s_x) * scale.  On the card the int32 product is
    ``torch._int_mm``, which takes more than 16 rows and an input and output
    width that are multiples of 8; another shape raises."""
    k, n = weight_int8.shape[1], weight_int8.shape[0]
    x2 = x.reshape(-1, k)
    scale = weight_scale.float()
    if dynamic:
        qx, s_x = quantize_rows(x2)
        if qx.is_cuda and (qx.shape[0] <= 16 or k % 8 or n % 8):
            raise ValueError(f"linear_int8: torch._int_mm takes M > 16 and K, N "
                             f"multiples of 8, not M={qx.shape[0]} K={k} N={n}")
        y = torch._int_mm(qx, weight_int8.t()).float() * s_x * scale
    elif x.is_cuda and x.dtype != torch.float32:
        # half-precision inputs with an f32 accumulator and f32 output
        y = torch.mm(x2, weight_int8.to(x.dtype).t(), out_dtype=torch.float32) * scale
    else:
        # the CPU has no mm.dtype kernel: the upcast operands are exact, so
        # the f32 product is the same arithmetic
        y = (x2.float() @ weight_int8.to(x.dtype).float().t()) * scale
    y = y.to(x.dtype).reshape(*x.shape[:-1], n)
    return y if bias is None else y + bias.to(x.dtype)


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
    callers must not write to it.

    While ``torch.export`` traces, a table that an eager call cached
    becomes a constant of the program on its device.  A table the tracer
    has to make itself works too, but it holds a host-to-device copy,
    which a captured graph cannot run, and it must not stay in the cache
    that eager calls read: the cache is cleared after such a miss."""
    if torch.compiler.is_compiling():
        hits = _rel_pe_table.cache_info().hits
        table = _rel_pe_table(seq_len, pos_dim, length_factor, device)
        if _rel_pe_table.cache_info().hits == hits:
            _rel_pe_table.cache_clear()
        return table
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
