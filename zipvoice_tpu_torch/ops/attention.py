"""Relative-position attention kernels (CUDA, Hopper) and their plain versions.

Two kernels carry the Zipformer attention on the inference path:

* ``rel_attention_probs`` (B1, ``csrc/rel_probs.cu``): softmax over keys of
  q.k + pq.pe[j - i + T - 1] + key-padding bias, (B, H, T, T);
* ``rel_attention_probs_apply`` (B2, ``csrc/probs_apply.cu``): the
  SelfAttention contraction einsum('bhts,bshd->bthd', probs, v).

Each wrapper launches its kernel for CUDA tensors (or raises) and uses the
plain PyTorch version beside it only for CPU tensors.  ``launches`` on each
wrapper counts kernel launches and nothing else.

Mask semantics: a padded key gets an additive -1000 before the softmax.
This equals the reference's replace-with--1000 on every row that has at
least one real key; on a row whose keys are all padded the additive form
attends over the real scores instead of uniformly over constants (such rows
do not occur for key-padding masks of non-empty sequences).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from zipvoice_tpu_torch.ops import build

MASK_BIAS = -1000.0

_DTYPES = (torch.float32, torch.bfloat16)


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the oracle the kernels are held against)
# ---------------------------------------------------------------------------


def rel_shift(pos_scores: torch.Tensor, seq_len: int) -> torch.Tensor:
    """(B, H, T, 2T-1) relative-axis scores -> (B, H, T, T) absolute:
    out[..., i, j] = pos_scores[..., i, (T-1) + j - i]."""
    t = seq_len
    if t == 1:
        return pos_scores
    b, h = pos_scores.shape[0], pos_scores.shape[1]
    flat = pos_scores.reshape(b, h, t * (2 * t - 1))
    flat = flat[:, :, t - 1 : t - 1 + t * (2 * t - 2)]
    return flat.reshape(b, h, t, 2 * t - 2)[..., :t]


def rel_attention_probs_plain(q, k, pq, pe, key_padding_mask=None,
                              out_dtype=None) -> torch.Tensor:
    """Plain B1: f32 scores as einsums, the rel shift, the additive mask
    bias and torch.softmax."""
    out_dtype = q.dtype if out_dtype is None else out_dtype
    t = q.shape[1]
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    pos = torch.einsum("bthd,nhd->bhtn", pq.float(), pe.float())
    scores = scores + rel_shift(pos, t)
    if key_padding_mask is not None:
        bias = torch.zeros(key_padding_mask.shape, dtype=torch.float32,
                           device=scores.device)
        bias = bias.masked_fill(key_padding_mask, MASK_BIAS)
        scores = scores + bias[:, None, None, :]
    return torch.softmax(scores, dim=-1).to(out_dtype)


def rel_attention_probs_apply_plain(probs, v) -> torch.Tensor:
    """Plain B2: einsum('bhts,bshd->bthd') accumulated in f32, in v.dtype."""
    return torch.einsum("bhts,bshd->bthd", probs.float(), v.float()).to(v.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_cuda(name: str, *tensors):
    for x in tensors:
        if x.device != tensors[0].device or x.device.type != "cuda":
            raise ValueError(f"{name}: every input must be on the same CUDA "
                             f"device, got {x.device}")
        if x.dtype not in _DTYPES:
            raise ValueError(f"{name}: dtype {x.dtype} not supported "
                             "(float32 or bfloat16)")


def _stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # zv_rel_probs(q, kt, pq, pe, mask, out, B, T, H, QD, PD, in_bf16, out_bf16, stream)
    "rel_probs": ("zv_rel_probs", [_P] * 6 + [_I] * 7 + [_P]),
    # zv_probs_apply(probs, v, out, B, T, H, VD, bf16, stream)
    "probs_apply": ("zv_probs_apply", [_P] * 3 + [_I] * 5 + [_P]),
}
_entry_points = {}


def _entry(name: str):
    """The C entry point of one kernel library, typed once."""
    fn = _entry_points.get(name)
    if fn is None:
        symbol, argtypes = _SIGNATURES[name]
        fn = getattr(build.load(name), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _entry_points[name] = fn
    return fn


def _raise_on(code: int, name: str, shape_note: str):
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed (cudaError {code}) "
                           f"for {shape_note}")


def rel_attention_probs(
    q: torch.Tensor,  # (B, T, H, qd)
    k: torch.Tensor,  # (B, T, H, qd)
    pq: torch.Tensor,  # (B, T, H, pd)
    pe: torch.Tensor,  # (2T-1, H, pd) projected positional encodings
    key_padding_mask: Optional[torch.Tensor] = None,  # (B, T) bool, True = pad
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Attention probabilities (B, H, T, T) in ``out_dtype`` (default
    q.dtype); scores and softmax in f32.  Any T."""
    out_dtype = q.dtype if out_dtype is None else out_dtype
    if q.device.type == "cpu":
        return rel_attention_probs_plain(q, k, pq, pe, key_padding_mask, out_dtype)
    _check_cuda("rel_attention_probs", q, k, pq, pe)
    b, t, h, qd = q.shape
    pd = pq.shape[-1]
    if (k.shape != q.shape or pq.shape[:3] != (b, t, h)
            or pe.shape != (2 * t - 1, h, pd)):
        raise ValueError(f"rel_attention_probs: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} pq{tuple(pq.shape)} pe{tuple(pe.shape)}")
    if len({q.dtype, k.dtype, pq.dtype, pe.dtype}) != 1:
        raise ValueError("rel_attention_probs: q, k, pq, pe must share a dtype")
    if out_dtype not in _DTYPES:
        raise ValueError(f"rel_attention_probs: out_dtype {out_dtype}")
    q, pq, pe = q.contiguous(), pq.contiguous(), pe.contiguous()
    kt = k.permute(0, 2, 3, 1).contiguous()  # (B, H, qd, T): coalesced key reads
    mask_ptr = None
    if key_padding_mask is not None:
        if (key_padding_mask.shape != (b, t) or key_padding_mask.device != q.device
                or key_padding_mask.dtype != torch.bool):
            raise ValueError("rel_attention_probs: key_padding_mask must be a "
                             f"(B, T) bool tensor on {q.device}")
        key_padding_mask = key_padding_mask.contiguous().view(torch.uint8)
        mask_ptr = key_padding_mask.data_ptr()
    out = torch.empty((b, h, t, t), dtype=out_dtype, device=q.device)
    code = _entry("rel_probs")(
        q.data_ptr(), kt.data_ptr(), pq.data_ptr(), pe.data_ptr(), mask_ptr,
        out.data_ptr(), b, t, h, qd, pd, int(q.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16), _stream_ptr(q.device))
    _raise_on(code, "rel_probs", f"B={b} T={t} H={h} qd={qd} pd={pd}")
    rel_attention_probs.launches += 1
    return out


rel_attention_probs.launches = 0


def rel_attention_probs_apply(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """einsum('bhts,bshd->bthd', probs, v) accumulated in f32, returned in
    v.dtype; probs (B, H, T, T), v (B, T, H, vd).  Any T."""
    if probs.device.type == "cpu":
        return rel_attention_probs_apply_plain(probs, v)
    _check_cuda("rel_attention_probs_apply", probs, v)
    b, h, t, _ = probs.shape
    vd = v.shape[-1]
    if probs.shape != (b, h, t, t) or v.shape != (b, t, h, vd):
        raise ValueError(f"rel_attention_probs_apply: shapes probs"
                         f"{tuple(probs.shape)} v{tuple(v.shape)}")
    if probs.dtype != v.dtype:
        raise ValueError("rel_attention_probs_apply: probs and v must share a dtype")
    probs, v = probs.contiguous(), v.contiguous()
    out = torch.empty((b, t, h, vd), dtype=v.dtype, device=v.device)
    code = _entry("probs_apply")(probs.data_ptr(), v.data_ptr(), out.data_ptr(),
                                 b, t, h, vd, int(v.dtype == torch.bfloat16),
                                 _stream_ptr(v.device))
    _raise_on(code, "probs_apply", f"B={b} T={t} H={h} vd={vd}")
    rel_attention_probs_apply.launches += 1
    return out


rel_attention_probs_apply.launches = 0
