"""Relative-position attention kernels (CUDA, Hopper) and their plain versions.

Seven kernels carry the Zipformer attention:

* ``rel_attention_probs`` (B1, ``csrc/rel_probs.cu``, its kernel in
  ``csrc/rel_probs.cuh``): softmax over keys of q.k + pq.pe[j - i + T - 1]
  + key-padding bias, (B, H, T, T).  It is differentiable: its backward is
  B4 plus four matmul adjoints.  It also takes a rectangular tile, Tq query
  rows against Tk keys with pe (Tq + Tk - 1, H, pd): a block of rows
  [r0, r0 + Tq) of a square problem is that tile with the window
  pe[Tk - r0 - Tq : 2 Tk - 1 - r0] of the square pe (a rank's rows under
  sequence parallelism, in the sampler and in training).
* ``rel_attention_ds`` (B4, ``csrc/rel_ds.cu``): the score cotangent
  ds = p * (g - sum(g * p)) + pen * sign(s) * (|s| > limit), with the
  probabilities recomputed from q, k, pq, pe: B1's kernel with an epilogue
  that reads g behind the scores, its probabilities B1's bit for bit, on
  B1's tiles, square or rectangular.
* ``rel_attention_probs_apply`` (B2, ``csrc/probs_apply.cu``): the
  SelfAttention contraction einsum('bhts,bshd->bthd', probs, v), with its
  einsum adjoints as the backward; probs (B, H, Tq, Tk) may be
  rectangular.
* ``rel_attention_consume_bwd`` (B3, ``csrc/rel_apply_bwd.cu``): the flash
  backward of ``rel_attention_consume``, which contracts a layer's shared
  stop-gradient probabilities with one consumer's values in the forward
  and recomputes them in the backward to emit dq, dk, dpq, dpe, dv; square
  or on a rectangular tile (dq, dpq over the Tq rows, dk, dv over the Tk
  keys, dpe over the Tq + Tk - 1 band rows).
* ``rel_attention_probs_consume`` (B6, ``csrc/rel_probs_consume.cu``):
  B1's kernel with a fused epilogue on the tensor cores, (probs, rounded
  probs @ v), its probabilities B1's bit for bit; the fused eval path's
  SelfAttention-1, which hands the probabilities to SelfAttention-2.
* ``rel_attention_head0_consume`` (B7, ``csrc/rel_consume_fwd.cu``, its
  kernel in ``csrc/rel_wide_consume.cuh``): head 0's probabilities,
  recomputed and never written, @ the wide NonlinAttention value stream
  (B, T, C); the fused eval path's NonlinAttention.
* ``rel_attention_apply`` (B5, ``csrc/rel_apply.cu``): softmax(scores) @ v
  with the const-attention gate, differentiable through B3; B6's kernel
  without the probabilities' store for vd <= 64, B7's kernel on every head
  for a wider v.  No model path calls it; it is the op the JAX package
  exposes as ``rel_attention_apply``.

Each wrapper launches its kernel for CUDA tensors (or raises) and uses the
plain PyTorch version beside it only for CPU tensors.  ``launches`` on each
wrapper counts kernel launches and nothing else.

Mask semantics: a padded key gets an additive -1000 before the softmax.
This equals the reference's replace-with--1000 on every row that has at
least one real key; on a row whose keys are all padded the additive form
attends over the real scores instead of uniformly over constants (such rows
do not occur for key-padding masks of non-empty sequences).  The failsafe
penalty applies to every key column, padded ones included (it acts on the
pre-mask score).
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


def rel_shift(pos_scores: torch.Tensor, seq_len: int,
              keys: Optional[int] = None) -> torch.Tensor:
    """(B, H, Tq, Tq+Tk-1) relative-axis scores -> (B, H, Tq, Tk) absolute:
    out[..., i, j] = pos_scores[..., i, (Tq-1) + j - i], with Tq = seq_len
    and Tk = keys (seq_len when None: the square (B, H, T, 2T-1) case)."""
    tq = seq_len
    tk = tq if keys is None else keys
    if tq == 1:
        return pos_scores
    b, h = pos_scores.shape[0], pos_scores.shape[1]
    w = tq + tk - 1
    flat = pos_scores.reshape(b, h, tq * w)
    flat = flat[:, :, tq - 1 : tq - 1 + tq * (w - 1)]
    return flat.reshape(b, h, tq, w - 1)[..., :tk]


def unshear(ds: torch.Tensor) -> torch.Tensor:
    """Adjoint of ``rel_shift``: (B, H, Tq, Tk) -> (B, H, Tq, Tq+Tk-1) with
    out[..., i, (Tq-1) + j - i] = ds[..., i, j] and zeros elsewhere (the
    square case Tq = Tk = T: (B, H, T, 2T-1))."""
    b, h, tq, tk = ds.shape
    if tq == 1:
        return ds
    w = tq + tk - 1
    rows = torch.nn.functional.pad(ds, (0, w - 1 - tk))  # (B, H, Tq, w-1)
    flat = torch.nn.functional.pad(rows.reshape(b, h, tq * (w - 1)), (tq - 1, 1))
    return flat.reshape(b, h, tq, w)


def rel_scores_plain(q, k, pq, pe) -> torch.Tensor:
    """Pre-mask scores q.k + pq.pe[j - i + Tq - 1], (B, H, Tq, Tk) f32
    (square: Tq = Tk = T)."""
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    pos = torch.einsum("bthd,nhd->bhtn", pq.float(), pe.float())
    return scores + rel_shift(pos, q.shape[1], k.shape[1])


def _softmax_masked(scores: torch.Tensor, key_padding_mask) -> torch.Tensor:
    if key_padding_mask is not None:
        bias = torch.zeros(key_padding_mask.shape, dtype=torch.float32,
                           device=scores.device).masked_fill(key_padding_mask, MASK_BIAS)
        scores = scores + bias[:, None, None, :]
    return torch.softmax(scores, dim=-1)


def rel_attention_probs_plain(q, k, pq, pe, key_padding_mask=None,
                              out_dtype=None) -> torch.Tensor:
    """Plain B1: f32 scores as einsums, the rel shift, the additive mask
    bias and torch.softmax."""
    out_dtype = q.dtype if out_dtype is None else out_dtype
    return _softmax_masked(rel_scores_plain(q, k, pq, pe), key_padding_mask).to(out_dtype)


def rel_attention_probs_apply_plain(probs, v) -> torch.Tensor:
    """Plain B2: einsum('bhts,bshd->bthd') accumulated in f32, in v.dtype."""
    return torch.einsum("bhts,bshd->bthd", probs.float(), v.float()).to(v.dtype)


def _penalty_term(s_pre: torch.Tensor, score_penalty: float, penalty_limit: float,
                  valid_cols: Optional[int] = None):
    term = score_penalty * torch.sign(s_pre) * ((torch.abs(s_pre) - penalty_limit) > 0)
    if valid_cols is not None:
        term = term * (torch.arange(s_pre.shape[-1], device=s_pre.device) < valid_cols)
    return term


def _const_probs(probs: torch.Tensor) -> torch.Tensor:
    """The const-attention replacement: the row-normalised support (p > 0)."""
    binary = (probs > 0.0).float()
    return binary / torch.clamp(binary.sum(-1, keepdim=True), min=1e-20)


def rel_attention_ds_plain(q, k, pq, pe, key_padding_mask, g, score_penalty=0.0,
                           penalty_limit=25.0) -> torch.Tensor:
    """Plain B4: ds = p * (g - sum(g * p)) + pen * sign(s) * (|s| > limit)
    with p recomputed in f32 and s the pre-mask score; (B, H, Tq, Tk) in
    q.dtype (square: Tq = Tk = T)."""
    s_pre = rel_scores_plain(q, k, pq, pe)
    probs = _softmax_masked(s_pre, key_padding_mask)
    g = g.float()
    ds = probs * (g - torch.sum(g * probs, dim=-1, keepdim=True))
    if score_penalty:
        ds = ds + _penalty_term(s_pre, score_penalty, penalty_limit)
    return ds.to(q.dtype)


def score_adjoints(ds, q, k, pq, pe):
    """The four matmul adjoints of the scores, in f32: (dq, dk, dpq, dpe)
    from the score cotangent ds (B, H, Tq, Tk); dpe (Tq + Tk - 1, H, pd) is
    summed over batch."""
    ds = ds.float()
    dq = torch.einsum("bhts,bshd->bthd", ds, k.float())
    dk = torch.einsum("bhts,bthd->bshd", ds, q.float())
    dpos = unshear(ds)
    dpq = torch.einsum("bhtn,nhd->bthd", dpos, pe.float())
    dpe = torch.einsum("bhtn,bthd->nhd", dpos, pq.float())
    return dq, dk, dpq, dpe


def rel_attention_consume_bwd_plain(q, k, pq, pe, key_padding_mask, v, g,
                                    score_penalty=0.0, penalty_limit=25.0,
                                    const_gate=False, penalty_valid_cols=None):
    """Plain B3: recompute the probabilities (the const-attention ones when
    the gate is open), dv = used^T g, the softmax VJP of dP = g v^T (zero
    through the detached const branch), the penalty on pre-mask scores
    (key columns < penalty_valid_cols, all when None), then the score
    adjoints.  Square or rectangular (Tq rows, Tk keys).  Returns (dq, dk,
    dpq, dpe, dv) in f32."""
    s_pre = rel_scores_plain(q, k, pq, pe)
    probs = _softmax_masked(s_pre, key_padding_mask)
    g32, v32 = g.float(), v.float()
    if const_gate:
        used = _const_probs(probs)
        ds = torch.zeros_like(probs)
    else:
        used = probs
        dp = torch.einsum("bthd,bshd->bhts", g32, v32)
        ds = probs * (dp - torch.sum(dp * probs, dim=-1, keepdim=True))
    dv = torch.einsum("bhts,bthd->bshd", used, g32)
    if score_penalty:
        ds = ds + _penalty_term(s_pre, score_penalty, penalty_limit, penalty_valid_cols)
    return (*score_adjoints(ds, q, k, pq, pe), dv)


def rel_attention_probs_consume_plain(q, k, pq, pe, key_padding_mask, v, out_dtype=None):
    """Plain B6: (B1's probabilities in out_dtype, those rounded
    probabilities @ v accumulated in f32, in v.dtype)."""
    probs = rel_attention_probs_plain(q, k, pq, pe, key_padding_mask, out_dtype)
    return probs, rel_attention_probs_apply_plain(probs, v)


def rel_attention_head0_consume_plain(q, k, pq, pe, key_padding_mask, v):
    """Plain B7: head 0's f32 probabilities rounded to v.dtype, @ v (B, T, C)
    accumulated in f32, in v.dtype."""
    s0 = rel_scores_plain(q[:, :, :1], k[:, :, :1], pq[:, :, :1], pe[:, :1])
    p0 = _softmax_masked(s0, key_padding_mask)[:, 0].to(v.dtype)
    return torch.einsum("bts,bsc->btc", p0.float(), v.float()).to(v.dtype)


def rel_attention_apply_plain(q, k, pq, pe, key_padding_mask, v, out_dtype=None,
                              const_gate=False):
    """Plain B5: the f32 probabilities (their const-attention replacement
    when the gate is open) rounded to v.dtype, @ v accumulated in f32, in
    out_dtype (default v.dtype)."""
    probs = _softmax_masked(rel_scores_plain(q, k, pq, pe), key_padding_mask)
    used = (_const_probs(probs) if const_gate else probs).to(v.dtype)
    out = torch.einsum("bhts,bshd->bthd", used.float(), v.float())
    return out.to(v.dtype if out_dtype is None else out_dtype)


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
    if len({x.dtype for x in tensors}) != 1:
        raise ValueError(f"{name}: inputs must share a dtype")


def _check_rel_shapes(name, q, k, pq, pe, square: bool = True):
    """q, pq (B, Tq, H, .), k (B, Tk, H, qd), pe (Tq + Tk - 1, H, pd);
    Tq = Tk unless the kernel takes rectangular tiles (B1)."""
    b, tq, h, qd = q.shape
    tk, pd = k.shape[1], pq.shape[-1]
    if (k.shape != (b, tk, h, qd) or (square and tk != tq) or pq.shape[:3] != (b, tq, h)
            or pe.shape != (tq + tk - 1, h, pd)):
        raise ValueError(f"{name}: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"pq{tuple(pq.shape)} pe{tuple(pe.shape)}")


def _mask_ptr(name, key_padding_mask, k):
    """(pointer, keep-alive tensor) of a (B, Tk) bool key mask as uint8;
    k: the keys (B, Tk, ...)."""
    if key_padding_mask is None:
        return None, None
    b, t = k.shape[:2]
    if (key_padding_mask.shape != (b, t) or key_padding_mask.device != k.device
            or key_padding_mask.dtype != torch.bool):
        raise ValueError(f"{name}: key_padding_mask must be a (B, T) bool "
                         f"tensor on {k.device}")
    m = key_padding_mask.contiguous().view(torch.uint8)
    return m.data_ptr(), m


def _stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> (kernel library, argtypes)
_SIGNATURES = {
    # zv_rel_probs(q, kt, pq, pe, mask, out, B, Tq, Tk, H, QD, PD, in_bf16, out_bf16, stream)
    "zv_rel_probs": ("rel_probs", [_P] * 6 + [_I] * 8 + [_P]),
    # zv_probs_apply(probs, v, out, B, Tq, Tk, H, VD, bf16, stream)
    "zv_probs_apply": ("probs_apply", [_P] * 3 + [_I] * 6 + [_P]),
    # zv_rel_ds(q, kt, pq, pe, mask, g, ds, B, Tq, Tk, H, QD, PD, bf16, pen, limit, stream)
    "zv_rel_ds": ("rel_ds", [_P] * 7 + [_I] * 7 + [_F, _F, _P]),
    # zv_rel_apply_bwd(q, kt, pq, pe, mask, v, g, stats, dq, dk, dpq, dpe, dv, B, Tq, Tk,
    #                  H, QD, PD, VD, bf16, const_gate, valid_cols, pen, limit, stream)
    "zv_rel_apply_bwd": ("rel_apply_bwd", [_P] * 13 + [_I] * 10 + [_F, _F, _P]),
    # zv_rel_probs_consume(q, kt, pq, pe, mask, v, probs, out,
    #                      B, T, H, QD, PD, VD, bf16, probs_bf16, stream)
    "zv_rel_probs_consume": ("rel_probs_consume", [_P] * 8 + [_I] * 8 + [_P]),
    # zv_rel_head0_consume(q, kt0, pq, pe, mask, v, out, B, T, H, QD, PD, C, bf16, stream)
    "zv_rel_head0_consume": ("rel_consume_fwd", [_P] * 7 + [_I] * 7 + [_P]),
    # zv_rel_apply(q, kt, pq, pe, mask, v, out, B, T, H, QD, PD, VD, bf16, out_bf16,
    #              const_gate, stream)
    "zv_rel_apply": ("rel_apply", [_P] * 7 + [_I] * 9 + [_P]),
}


def _entry(symbol: str):
    lib, argtypes = _SIGNATURES[symbol]
    return build.entry(lib, symbol, argtypes)


def _raise_on(code: int, name: str, shape_note: str):
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed (cudaError {code}) "
                           f"for {shape_note}")


# B1's and B2's forward entry points are custom ops, so that the
# dispatcher, and a selective checkpoint policy with it (nn/zipformer.
# set_remat_policy), sees the allocation and the launch as one op: a saved
# output is then reused in the recompute and its kernel not launched again.
@torch.library.custom_op("zipvoice::rel_probs", mutates_args=())
def _rel_probs_forward(q: torch.Tensor, k: torch.Tensor, pq: torch.Tensor, pe: torch.Tensor,
                       key_padding_mask: Optional[torch.Tensor],
                       out_dtype: torch.dtype) -> torch.Tensor:
    if q.device.type == "cpu":
        return rel_attention_probs_plain(q, k, pq, pe, key_padding_mask, out_dtype)
    _check_cuda("rel_attention_probs", q, k, pq, pe)
    _check_rel_shapes("rel_attention_probs", q, k, pq, pe, square=False)
    if out_dtype not in _DTYPES:
        raise ValueError(f"rel_attention_probs: out_dtype {out_dtype}")
    b, tq, h, qd = q.shape
    tk, pd = k.shape[1], pq.shape[-1]
    q, pq, pe = q.contiguous(), pq.contiguous(), pe.contiguous()
    kt = k.permute(0, 2, 3, 1).contiguous()  # (B, H, qd, Tk): coalesced key reads
    mask_ptr, _keep = _mask_ptr("rel_attention_probs", key_padding_mask, k)
    out = torch.empty((b, h, tq, tk), dtype=out_dtype, device=q.device)
    code = _entry("zv_rel_probs")(
        q.data_ptr(), kt.data_ptr(), pq.data_ptr(), pe.data_ptr(), mask_ptr,
        out.data_ptr(), b, tq, tk, h, qd, pd, int(q.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16), _stream_ptr(q.device))
    _raise_on(code, "rel_probs", f"B={b} Tq={tq} Tk={tk} H={h} qd={qd} pd={pd}")
    rel_attention_probs.launches += 1
    return out


def rel_attention_ds(q, k, pq, pe, key_padding_mask, g, score_penalty=0.0,
                     penalty_limit=25.0) -> torch.Tensor:
    """B4: the score cotangent (B, H, Tq, Tk) in q.dtype from the
    probabilities' cotangent g (same dtype as q), probabilities recomputed
    in f32; the penalty acts on the pre-mask scores.  Any Tq, Tk: B1's
    tiles, square or rectangular."""
    if q.device.type == "cpu":
        return rel_attention_ds_plain(q, k, pq, pe, key_padding_mask, g,
                                      score_penalty, penalty_limit)
    _check_cuda("rel_attention_ds", q, k, pq, pe, g)
    _check_rel_shapes("rel_attention_ds", q, k, pq, pe, square=False)
    b, tq, h, qd = q.shape
    tk, pd = k.shape[1], pq.shape[-1]
    if g.shape != (b, h, tq, tk):
        raise ValueError(f"rel_attention_ds: g{tuple(g.shape)} for B={b} H={h} Tq={tq} "
                         f"Tk={tk}")
    q, pq, pe = q.contiguous(), pq.contiguous(), pe.contiguous()
    g = build.aligned(g.contiguous())  # its rows are staged in 16-byte copies
    kt = k.permute(0, 2, 3, 1).contiguous()
    mask_ptr, _keep = _mask_ptr("rel_attention_ds", key_padding_mask, k)
    ds = torch.empty((b, h, tq, tk), dtype=q.dtype, device=q.device)
    code = _entry("zv_rel_ds")(
        q.data_ptr(), kt.data_ptr(), pq.data_ptr(), pe.data_ptr(), mask_ptr,
        g.data_ptr(), ds.data_ptr(), b, tq, tk, h, qd, pd, int(q.dtype == torch.bfloat16),
        float(score_penalty), float(penalty_limit), _stream_ptr(q.device))
    _raise_on(code, "rel_ds", f"B={b} Tq={tq} Tk={tk} H={h} qd={qd} pd={pd}")
    rel_attention_ds.launches += 1
    return ds


rel_attention_ds.launches = 0


class _RelProbs(torch.autograd.Function):
    """B1 forward; backward = B4 (ds) then the four score adjoints as plain
    PyTorch matmuls (as the JAX package leaves them to XLA)."""

    @staticmethod
    def forward(ctx, q, k, pq, pe, key_padding_mask, out_dtype, score_penalty,
                penalty_limit):
        ctx.save_for_backward(q, k, pq, pe, key_padding_mask)
        ctx.penalty = (score_penalty, penalty_limit)
        return _rel_probs_forward(q, k, pq, pe, key_padding_mask, out_dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, pq, pe, mask = ctx.saved_tensors
        ds = rel_attention_ds(q, k, pq, pe, mask, g.to(q.dtype), *ctx.penalty)
        grads = score_adjoints(ds, q, k, pq, pe)
        return (*(d.to(x.dtype) for d, x in zip(grads, (q, k, pq, pe))),
                None, None, None, None)


def rel_attention_probs(
    q: torch.Tensor,  # (B, Tq, H, qd)
    k: torch.Tensor,  # (B, Tk, H, qd)
    pq: torch.Tensor,  # (B, Tq, H, pd)
    pe: torch.Tensor,  # (Tq+Tk-1, H, pd) projected positional encodings
    key_padding_mask: Optional[torch.Tensor] = None,  # (B, Tk) bool, True = pad
    out_dtype: Optional[torch.dtype] = None,
    score_penalty: float = 0.0,
    penalty_limit: float = 25.0,
) -> torch.Tensor:
    """Attention probabilities (B, H, Tq, Tk) in ``out_dtype`` (default
    q.dtype); scores and softmax in f32.  Any T; square (Tq = Tk = T) on
    the model's paths, rectangular for a block of query rows (module
    docstring).  Differentiable on either tile: the backward (B4, then the
    score adjoints) adds score_penalty * sign(s) * (|s| > penalty_limit) to
    the pre-mask score cotangent (the attention-score failsafe)."""
    out_dtype = q.dtype if out_dtype is None else out_dtype
    return _RelProbs.apply(q, k, pq, pe, key_padding_mask, out_dtype,
                           float(score_penalty), float(penalty_limit))


rel_attention_probs.launches = 0
# the op whose output is the attention probabilities (remat policies)
REL_PROBS_OP = torch.ops.zipvoice.rel_probs.default


# The fake implementations give the output's shape and dtype without
# computing it, so torch.export traces each op as one opaque node: an
# exported program calls the op, which launches B1 / B2 on the card and
# runs the plain version on the CPU.
@_rel_probs_forward.register_fake
def _(q, k, pq, pe, key_padding_mask, out_dtype):
    b, tq, h, _ = q.shape
    return q.new_empty((b, h, tq, k.shape[1]), dtype=out_dtype)


@torch.library.custom_op("zipvoice::probs_apply", mutates_args=())
def _probs_apply_forward(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if probs.device.type == "cpu":
        return rel_attention_probs_apply_plain(probs, v)
    _check_cuda("rel_attention_probs_apply", probs, v)
    b, h, tq, tk = probs.shape
    vd = v.shape[-1]
    if v.shape != (b, tk, h, vd):
        raise ValueError(f"rel_attention_probs_apply: shapes probs"
                         f"{tuple(probs.shape)} v{tuple(v.shape)}")
    probs, v = build.aligned(probs.contiguous()), build.aligned(v.contiguous())
    out = torch.empty((b, tq, h, vd), dtype=v.dtype, device=v.device)
    code = _entry("zv_probs_apply")(probs.data_ptr(), v.data_ptr(), out.data_ptr(),
                                    b, tq, tk, h, vd, int(v.dtype == torch.bfloat16),
                                    _stream_ptr(v.device))
    _raise_on(code, "probs_apply", f"B={b} Tq={tq} Tk={tk} H={h} vd={vd}")
    rel_attention_probs_apply.launches += 1
    return out


class _ProbsApply(torch.autograd.Function):
    """B2 forward; backward = the two einsum adjoints, f32 accumulation."""

    @staticmethod
    def forward(ctx, probs, v):
        ctx.save_for_backward(probs, v)
        return _probs_apply_forward(probs, v)

    @staticmethod
    def backward(ctx, g):
        probs, v = ctx.saved_tensors
        g32 = g.float()
        dprobs = torch.einsum("bthd,bshd->bhts", g32, v.float()).to(probs.dtype)
        dv = torch.einsum("bhts,bthd->bshd", probs.float(), g32).to(v.dtype)
        return dprobs, dv


def rel_attention_probs_apply(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """einsum('bhts,bshd->bthd', probs, v) accumulated in f32, returned in
    v.dtype; probs (B, H, Tq, Tk), v (B, Tk, H, vd) of the same dtype.  Any
    Tq, Tk; vd in {4, 8, 12, 16}.  Differentiable."""
    return _ProbsApply.apply(probs, v)


rel_attention_probs_apply.launches = 0


@_probs_apply_forward.register_fake
def _(probs, v):
    return v.new_empty((v.shape[0], probs.shape[2], *v.shape[2:]))

# value widths the B2 kernel takes; wider consumers contract with torch.matmul
PROBS_APPLY_VD = (4, 8, 12, 16)


def rel_attention_consume_bwd(q, k, pq, pe, key_padding_mask, v, g,
                              score_penalty=0.0, penalty_limit=25.0,
                              const_gate=False, penalty_valid_cols=None):
    """B3: the flash backward of ``rel_attention_consume`` and
    ``rel_attention_apply``.  Returns (dq, dk, dpq, dpe, dv) in f32, dpe
    summed over the batch; the penalty acts on key columns <
    penalty_valid_cols (every column when None).  Any Tq, Tk: q, pq, g (B,
    Tq, H, .) against k, v (B, Tk, H, .) and pe (Tq + Tk - 1, H, pd), the
    square case Tq = Tk; vd <= 384 on the card (the kernel refuses a wider
    one)."""
    if q.device.type == "cpu":
        return rel_attention_consume_bwd_plain(q, k, pq, pe, key_padding_mask, v, g,
                                               score_penalty, penalty_limit, const_gate,
                                               penalty_valid_cols)
    _check_cuda("rel_attention_consume_bwd", q, k, pq, pe, v, g)
    _check_rel_shapes("rel_attention_consume_bwd", q, k, pq, pe, square=False)
    b, tq, h, qd = q.shape
    tk, pd, vd = k.shape[1], pq.shape[-1], v.shape[-1]
    valid_cols = tk if penalty_valid_cols is None else int(penalty_valid_cols)
    if v.shape != (b, tk, h, vd) or g.shape != (b, tq, h, vd):
        raise ValueError(f"rel_attention_consume_bwd: v{tuple(v.shape)} "
                         f"g{tuple(g.shape)} for Tq={tq} Tk={tk}")
    q, pq, pe = q.contiguous(), pq.contiguous(), pe.contiguous()
    v, g = v.contiguous(), g.contiguous()
    kt = k.permute(0, 2, 3, 1).contiguous()
    mask_ptr, _keep = _mask_ptr("rel_attention_consume_bwd", key_padding_mask, k)
    f32 = dict(dtype=torch.float32, device=q.device)
    stats = torch.empty((4, b, h, tq), **f32)  # per row: max, 1/sum, sum(p dP), count(p > 0)
    dq = torch.empty((b, tq, h, qd), **f32)
    dk = torch.empty((b, tk, h, qd), **f32)
    dpq = torch.empty((b, tq, h, pd), **f32)
    dpe = torch.zeros((tq + tk - 1, h, pd), **f32)  # batch sum by atomics
    dv = torch.empty((b, tk, h, vd), **f32)
    code = _entry("zv_rel_apply_bwd")(
        q.data_ptr(), kt.data_ptr(), pq.data_ptr(), pe.data_ptr(), mask_ptr,
        v.data_ptr(), g.data_ptr(), stats.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dpq.data_ptr(), dpe.data_ptr(), dv.data_ptr(), b, tq, tk, h, qd, pd, vd,
        int(q.dtype == torch.bfloat16), int(bool(const_gate)), valid_cols,
        float(score_penalty), float(penalty_limit), _stream_ptr(q.device))
    _raise_on(code, "rel_apply_bwd", f"B={b} Tq={tq} Tk={tk} H={h} qd={qd} pd={pd} vd={vd}")
    rel_attention_consume_bwd.launches += 1
    return dq, dk, dpq, dpe, dv


rel_attention_consume_bwd.launches = 0


def consume_forward(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs (B, H, Tq, Tk) @ v (B, Tk, H, vd) -> (B, Tq, H, vd) in v.dtype:
    the B2 kernel where it takes vd, torch.matmul otherwise (the head-0
    NonlinAttention consumer, vd = 3D/4)."""
    probs = probs.to(v.dtype)
    if v.shape[-1] in PROBS_APPLY_VD:
        return _probs_apply_forward(probs, v)
    return torch.matmul(probs, v.transpose(1, 2)).transpose(1, 2)


class _RelConsume(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, pq, pe, key_padding_mask, probs, v, score_penalty,
                penalty_limit, const_gate):
        ctx.save_for_backward(q, k, pq, pe, key_padding_mask, v)
        ctx.args = (score_penalty, penalty_limit, const_gate)
        return consume_forward(probs, v)

    @staticmethod
    def backward(ctx, g):
        q, k, pq, pe, mask, v = ctx.saved_tensors
        grads = rel_attention_consume_bwd(q, k, pq, pe, mask, v, g.to(v.dtype), *ctx.args)
        dq, dk, dpq, dpe, dv = (d.to(x.dtype) for d, x in zip(grads, (q, k, pq, pe, v)))
        return dq, dk, dpq, dpe, None, None, dv, None, None, None


def rel_attention_consume(
    q: torch.Tensor,  # (B, Tq, H, qd)
    k: torch.Tensor,  # (B, Tk, H, qd)
    pq: torch.Tensor,  # (B, Tq, H, pd)
    pe: torch.Tensor,  # (Tq+Tk-1, H, pd)
    key_padding_mask: Optional[torch.Tensor],  # (B, Tk)
    probs: torch.Tensor,  # (B, H, Tq, Tk), shared, no gradient
    v: torch.Tensor,  # (B, Tk, H, vd)
    score_penalty: float = 0.0,
    penalty_limit: float = 25.0,
    const_gate: bool = False,
) -> torch.Tensor:
    """probs @ v with the flash backward (B3); any Tq, Tk (square on one
    process, a rank's rows against every key under sequence parallelism).

    probs must be the probabilities computed from exactly (q, k, pq, pe,
    mask), or the const-attention replacement of them when const_gate is
    set: the backward recomputes them, and no gradient reaches probs.
    score_penalty attaches the failsafe gradient (one consumer per layer).
    With const_gate the score cotangent is zero and dv flows through the
    recomputed const probabilities."""
    return _RelConsume.apply(q, k, pq, pe, key_padding_mask, probs, v,
                             float(score_penalty), float(penalty_limit), bool(const_gate))


# ---------------------------------------------------------------------------
# Forwards with a fused probs @ V epilogue (B6, B7, B5)
# ---------------------------------------------------------------------------


def _consume_inputs(name, q, k, pq, pe, key_padding_mask, v, v_shape):
    """Checks and device layouts shared by B5-B7: (q, pq, pe, v, mask
    pointer, mask keep-alive)."""
    _check_cuda(name, q, k, pq, pe, v)
    _check_rel_shapes(name, q, k, pq, pe)
    if v.shape != v_shape or v.shape[-1] % 4 != 0:
        raise ValueError(f"{name}: v{tuple(v.shape)}, want {v_shape} with a width "
                         "that is a multiple of 4")
    mask_ptr, keep = _mask_ptr(name, key_padding_mask, k)
    return (q.contiguous(), pq.contiguous(), pe.contiguous(), build.aligned(v.contiguous()),
            mask_ptr, keep)


def rel_attention_probs_consume(q, k, pq, pe, key_padding_mask, v, out_dtype=None):
    """B6: (probs (B, H, T, T) in out_dtype (default q.dtype), probs @ v
    (B, T, H, vd) in v.dtype); the contraction takes the probabilities as
    rounded to out_dtype, with f32 sums.  q, k, pq, pe, v share a dtype;
    vd a multiple of 4; any T.  Eval only (no backward)."""
    out_dtype = q.dtype if out_dtype is None else out_dtype
    if q.device.type == "cpu":
        return rel_attention_probs_consume_plain(q, k, pq, pe, key_padding_mask, v,
                                                 out_dtype)
    name = "rel_attention_probs_consume"
    b, t, h, qd = q.shape
    pd, vd = pq.shape[-1], v.shape[-1]
    if out_dtype not in _DTYPES:
        raise ValueError(f"{name}: out_dtype {out_dtype}")
    q, pq, pe, v, mask_ptr, _keep = _consume_inputs(name, q, k, pq, pe, key_padding_mask,
                                                    v, (b, t, h, vd))
    kt = k.permute(0, 2, 3, 1).contiguous()
    probs = torch.empty((b, h, t, t), dtype=out_dtype, device=q.device)
    out = torch.empty((b, t, h, vd), dtype=v.dtype, device=q.device)
    code = _entry("zv_rel_probs_consume")(
        q.data_ptr(), kt.data_ptr(), pq.data_ptr(), pe.data_ptr(), mask_ptr, v.data_ptr(),
        probs.data_ptr(), out.data_ptr(), b, t, h, qd, pd, vd,
        int(q.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        _stream_ptr(q.device))
    _raise_on(code, "rel_probs_consume", f"B={b} T={t} H={h} qd={qd} pd={pd} vd={vd}")
    rel_attention_probs_consume.launches += 1
    return probs, out


rel_attention_probs_consume.launches = 0


def rel_attention_head0_consume(q, k, pq, pe, key_padding_mask, v):
    """B7: head 0's probabilities (recomputed, never written), rounded to
    v.dtype, @ v (B, T, C) with f32 sums, in v.dtype.  q, k, pq (B, T, H,
    .) and pe (2T-1, H, pd) carry every head; only head 0 is read.  C a
    multiple of 4; any T.  Eval only (no backward)."""
    if q.device.type == "cpu":
        return rel_attention_head0_consume_plain(q, k, pq, pe, key_padding_mask, v)
    name = "rel_attention_head0_consume"
    b, t, h, qd = q.shape
    pd, c = pq.shape[-1], v.shape[-1]
    q, pq, pe, v, mask_ptr, _keep = _consume_inputs(name, q, k, pq, pe, key_padding_mask,
                                                    v, (b, t, c))
    kt0 = k[:, :, 0].permute(0, 2, 1).contiguous()  # (B, qd, T): head 0's keys
    out = torch.empty((b, t, c), dtype=v.dtype, device=q.device)
    code = _entry("zv_rel_head0_consume")(
        q.data_ptr(), kt0.data_ptr(), pq.data_ptr(), pe.data_ptr(), mask_ptr, v.data_ptr(),
        out.data_ptr(), b, t, h, qd, pd, c, int(q.dtype == torch.bfloat16),
        _stream_ptr(q.device))
    _raise_on(code, "rel_head0_consume", f"B={b} T={t} H={h} qd={qd} pd={pd} C={c}")
    rel_attention_head0_consume.launches += 1
    return out


rel_attention_head0_consume.launches = 0


def _rel_apply_forward(q, k, pq, pe, key_padding_mask, v, out_dtype, const_gate):
    if q.device.type == "cpu":
        return rel_attention_apply_plain(q, k, pq, pe, key_padding_mask, v, out_dtype,
                                         const_gate)
    name = "rel_attention_apply"
    b, t, h, qd = q.shape
    pd, vd = pq.shape[-1], v.shape[-1]
    if out_dtype not in _DTYPES:
        raise ValueError(f"{name}: out_dtype {out_dtype}")
    q, pq, pe, v, mask_ptr, _keep = _consume_inputs(name, q, k, pq, pe, key_padding_mask,
                                                    v, (b, t, h, vd))
    kt = k.permute(0, 2, 3, 1).contiguous()
    out = torch.empty((b, t, h, vd), dtype=out_dtype, device=q.device)
    code = _entry("zv_rel_apply")(
        q.data_ptr(), kt.data_ptr(), pq.data_ptr(), pe.data_ptr(), mask_ptr, v.data_ptr(),
        out.data_ptr(), b, t, h, qd, pd, vd, int(q.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16), int(bool(const_gate)), _stream_ptr(q.device))
    _raise_on(code, "rel_apply", f"B={b} T={t} H={h} qd={qd} pd={pd} vd={vd}")
    rel_attention_apply.launches += 1
    return out


class _RelApply(torch.autograd.Function):
    """B5 forward; backward = B3, which recomputes the probabilities (and
    the const branch's support) from q, k, pq, pe."""

    @staticmethod
    def forward(ctx, q, k, pq, pe, key_padding_mask, v, out_dtype, score_penalty,
                penalty_limit, penalty_valid_cols, const_gate):
        ctx.save_for_backward(q, k, pq, pe, key_padding_mask, v)
        ctx.args = (score_penalty, penalty_limit, const_gate, penalty_valid_cols)
        return _rel_apply_forward(q, k, pq, pe, key_padding_mask, v, out_dtype, const_gate)

    @staticmethod
    def backward(ctx, g):
        q, k, pq, pe, mask, v = ctx.saved_tensors
        grads = rel_attention_consume_bwd(q, k, pq, pe, mask, v, g.to(v.dtype), *ctx.args)
        dq, dk, dpq, dpe, dv = (d.to(x.dtype) for d, x in zip(grads, (q, k, pq, pe, v)))
        return dq, dk, dpq, dpe, None, dv, None, None, None, None, None


def rel_attention_apply(
    q: torch.Tensor,  # (B, T, H, qd)
    k: torch.Tensor,  # (B, T, H, qd)
    pq: torch.Tensor,  # (B, T, H, pd)
    pe: torch.Tensor,  # (2T-1, H, pd)
    key_padding_mask: Optional[torch.Tensor],  # (B, T) bool, True = pad
    v: torch.Tensor,  # (B, T, H, vd)
    out_dtype: Optional[torch.dtype] = None,
    score_penalty: float = 0.0,
    penalty_limit: float = 25.0,
    penalty_valid_cols: Optional[int] = None,
    const_gate: bool = False,
) -> torch.Tensor:
    """softmax(rel-pos scores + mask bias) @ v -> (B, T, H, vd) in
    out_dtype (default v.dtype), differentiable: B5 forward, B3 backward.

    The probabilities are f32, rounded to v.dtype for an f32-accumulated
    contraction.  With const_gate they are replaced by the row-normalised
    support (p > 0) and the score gradient is zero (dv still flows).
    score_penalty adds the failsafe gradient pen * sign(s) * (|s| > limit)
    on the pre-mask scores of key columns < penalty_valid_cols (every
    column when None).  Any T (no pad-to-128 twin is needed); vd a
    multiple of 4 on the card."""
    return _RelApply.apply(q, k, pq, pe, key_padding_mask, v,
                           v.dtype if out_dtype is None else out_dtype,
                           float(score_penalty), float(penalty_limit), penalty_valid_cols,
                           bool(const_gate))


rel_attention_apply.launches = 0
