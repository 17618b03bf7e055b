"""Gradient-shaping regularizers for training (identity in the forward).

The Zipformer "scaling kit" as ``torch.autograd.Function``s:

* ``balancer``: per-channel mean / RMS constraint gradients;
* ``whiten``: covariance-whitening metric penalty;
* ``penalize_abs_values_gt``: the attention-score failsafe;
* ``limit_param_value``: sign-flipping gradient clamp for parameters;
* ``dropout_shared`` / ``sequence_dropout``: dropout with a shared mask
  axis and whole-sequence dropout, drawn from an explicit torch.Generator.

Each regularizer takes an explicit boolean ``gate`` (drawn on the host by
the caller) in place of a ``random.random() < prob`` test.  A closed gate
returns ``x`` itself, so the backward is the plain identity.  Constraint
values are Python floats (schedule outputs).

Under sequence parallelism (``seq``: the mesh whose seq group splits the
frames) the balancer's and the whitening's statistics are summed over the
seq group, so that its ranks see the statistics of the whole sequence, as
one process does (``parallel/mesh.seq_sum``); the frames split evenly.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from zipvoice_tpu_torch.parallel.mesh import Mesh, seq_sum


def _channel_dims(x: torch.Tensor):
    return tuple(range(x.ndim - 1))


# ---------------------------------------------------------------------------
# Balancer
# ---------------------------------------------------------------------------


def _abs_grad(v):
    """d|v|/dv with the JAX package's rule at 0: +1."""
    return torch.where(v >= 0, 1.0, -1.0)


def _inside(v, lo, hi):
    """d clip(v, lo, hi) / dv."""
    return ((v > lo) & (v < hi)).to(v.dtype)


def balancer_stats(x32: torch.Tensor, seq: Optional[Mesh] = None):
    """The balancer's statistics of x32: per channel (the last axis), the
    mean square and the mean over every other axis, and over the seq
    group's frames too under ``seq``; with the count n they are taken
    over."""
    dims = _channel_dims(x32)
    n = math.prod(x32.shape[d] for d in dims) * (1 if seq is None else seq.size("seq"))
    sq, s = torch.sum(x32 * x32, dim=dims, keepdim=True), torch.sum(x32, dim=dims, keepdim=True)
    if seq is not None:  # one all-reduce for both
        sq, s = seq_sum(torch.cat([sq, s]), seq).chunk(2)
    return sq / n, s / n, n


def _balancer_loss_grad(x32, min_mean, max_mean, min_rms, max_rms, seq=None):
    """d/dx of sum_c(|m - clip(m)| + |log(clip(rms) / rms)|), with
    m = mean / stddev over every axis but the last (over the seq group's
    frames too under ``seq``), written out by the rules the JAX package
    differentiates its balancer penalty with.

    Where a channel meets both constraints its penalty is exactly 0, but
    |.|'(0) = +1 lets the rms term's two f32 halves (1/rms and
    -rms/rms^2) through, and they need not cancel: the rounding remainder,
    some multiple of x, is then that channel's gradient, and the caller's
    per-channel normalization makes it grad_scale-sized.  This is the JAX
    package's behaviour (ROADMAP C); the reference torch Balancer has
    |.|'(0) = 0 and leaves such channels alone."""
    uv, mean, n = balancer_stats(x32, seq)
    var = uv - mean * mean
    stddev = torch.sqrt(torch.clamp(var, min=1.0e-20))
    rms = torch.sqrt(torch.clamp(uv, min=1.0e-20))
    # r_loss = |log(rc / rms)|
    rc = torch.clamp(rms, min_rms, max_rms)
    ratio = rc / rms
    g_ratio = _abs_grad(torch.log(ratio)) / ratio
    g_rms = (g_ratio / rms) * _inside(rms, min_rms, max_rms) \
        + (-g_ratio * rc) * (1.0 / (rms * rms))
    # m_loss = |m - clip(m)|, m = mean / stddev
    m = mean / stddev
    g_diff = _abs_grad(m - torch.clamp(m, min_mean, max_mean))
    g_m = g_diff - g_diff * _inside(m, min_mean, max_mean)
    g_std = (-g_m * mean) * (1.0 / (stddev * stddev))
    g_var = g_std * (0.5 / stddev) * (var > 1.0e-20)
    g_uv = g_rms * (0.5 / rms) * (uv > 1.0e-20) + g_var
    g_mean = g_m / stddev + 2 * (-g_var * mean)
    return 2 * ((g_uv / n) * x32) + g_mean / n


class _Balancer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, min_mean, max_mean, min_rms, max_rms, grad_scale, seq):
        ctx.save_for_backward(x)
        ctx.args = (min_mean, max_mean, min_rms, max_rms, grad_scale)
        ctx.seq = seq
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        min_mean, max_mean, min_rms, max_rms, grad_scale = ctx.args
        seq = ctx.seq
        loss_grad = _balancer_loss_grad(x.float(), min_mean, max_mean, min_rms, max_rms, seq)
        dims = _channel_dims(x)
        if seq is None:
            ms = torch.mean(loss_grad * loss_grad, dim=dims, keepdim=True)
        else:
            n = math.prod(x.shape[d] for d in dims) * seq.size("seq")
            ms = seq_sum(torch.sum(loss_grad * loss_grad, dim=dims, keepdim=True), seq) / n
        rms = torch.clamp(torch.sqrt(ms), min=1.0e-20)
        loss_grad = loss_grad * (grad_scale / rms)
        g32 = g.float()
        return ((g32 + torch.abs(g32) * loss_grad).to(g.dtype),
                None, None, None, None, None, None)


def _prop_to_mean(p: float) -> float:
    """Proportion-positive -> mean/stddev through an approximate inverse
    erf (computed in f32 like the reference)."""
    eps = 1.0e-10
    p2 = torch.tensor(-1.0 + 2.0 * p, dtype=torch.float32)
    atanh = (torch.log(1.0 + p2 + eps) - torch.log(1.0 - p2 + eps)) / 2.0
    return float(0.8139535143 * atanh)


def balancer(x: torch.Tensor, gate: bool, min_positive: float = 0.05,
             max_positive: float = 0.95, min_abs: float = 0.2,
             max_abs: float = 100.0, grad_scale: float = 0.04,
             seq: Optional[Mesh] = None) -> torch.Tensor:
    """Balancer with the reference's unit conversions: abs -> rms via
    sqrt(pi/2), proportion-positive -> mean/stddev; its statistics over the
    seq group of ``seq`` too (module docstring)."""
    if not gate:
        return x
    c = 1.25331413732
    return _Balancer.apply(x, _prop_to_mean(min_positive), _prop_to_mean(max_positive),
                           c * float(min_abs), c * float(max_abs), float(grad_scale), _seq(seq))


# ---------------------------------------------------------------------------
# Whiten
# ---------------------------------------------------------------------------


def _seq(seq: Optional[Mesh]) -> Optional[Mesh]:
    """The mesh if it splits frames, else None."""
    return seq if seq is not None and seq.size("seq") > 1 else None


def whitening_metric(x: torch.Tensor, num_groups: int,
                     seq: Optional[Mesh] = None) -> torch.Tensor:
    """1.0 iff each group's centered covariance is lambda*I with the same
    lambda across groups.  Under ``seq`` the frames' mean and covariance
    are summed over the seq group; the mean enters without gradient (its
    gradient through the centering sums to zero over all the frames)."""
    x = x.reshape(-1, x.shape[-1])
    num_frames, num_channels = x.shape
    cpg = num_channels // num_groups
    xg = x.reshape(num_frames, num_groups, cpg).transpose(0, 1)
    if seq is None:
        xg = xg - torch.mean(xg, dim=1, keepdim=True)
        covar = torch.einsum("gtc,gtd->gcd", xg, xg)
    else:
        n = num_frames * seq.size("seq")
        mean = seq_sum(torch.sum(xg.detach(), dim=1, keepdim=True), seq) / n
        xg = xg - mean
        covar = seq_sum(torch.einsum("gtc,gtd->gcd", xg, xg), seq)
    mean_diag = torch.mean(torch.diagonal(covar, dim1=1, dim2=2))
    covarsq_mean_diag = torch.sum(covar * covar) / (num_groups * cpg)
    return covarsq_mean_diag / (mean_diag**2 + 1.0e-20)


class _Whiten(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, num_groups, limit, grad_scale, seq):
        ctx.save_for_backward(x)
        ctx.args = (num_groups, limit, grad_scale)
        ctx.seq = seq
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        num_groups, limit, grad_scale = ctx.args
        seq = ctx.seq
        with torch.enable_grad():
            xv = x.detach().float().requires_grad_(True)
            metric = whitening_metric(xv, num_groups, seq)
            (pgrad,) = torch.autograd.grad(metric, xv)
        g32 = g.float()
        if seq is None:
            norms = torch.linalg.vector_norm(g32), torch.linalg.vector_norm(pgrad)
        else:  # the whole sequence's norms
            sq = seq_sum(torch.stack([torch.sum(g32 * g32), torch.sum(pgrad * pgrad)]), seq)
            norms = torch.sqrt(sq[0]), torch.sqrt(sq[1])
        scale = grad_scale * (norms[0] / (norms[1] + 1.0e-20))
        # where() rather than a host test of the metric: no device sync
        out = torch.where(metric >= limit, g32 + pgrad * scale, g32)
        return out.to(g.dtype), None, None, None, None


def whiten(x: torch.Tensor, gate: bool, num_groups: int, whitening_limit: float,
           grad_scale: float, seq: Optional[Mesh] = None) -> torch.Tensor:
    """Adds the whitening-metric gradient (rescaled to ``grad_scale`` of
    the incoming gradient's norm) when the gate is open and the metric is
    at or above ``whitening_limit``; the metric and the norms over the seq
    group of ``seq`` too (module docstring)."""
    if not gate:
        return x
    return _Whiten.apply(x, num_groups, float(whitening_limit), float(grad_scale), _seq(seq))


# ---------------------------------------------------------------------------
# penalize_abs_values_gt / limit_param_value
# ---------------------------------------------------------------------------


class _PenalizeAbsGt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, limit, penalty):
        ctx.save_for_backward(x)
        ctx.args = (limit, penalty)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        limit, penalty = ctx.args
        extra = penalty * torch.sign(x) * ((torch.abs(x) - limit) > 0).to(g.dtype)
        return g + extra.to(g.dtype), None, None


def penalize_abs_values_gt(x: torch.Tensor, gate: bool, limit: float = 25.0,
                           penalty: float = 1.0e-04) -> torch.Tensor:
    """Failsafe penalty: adds penalty * sign(x) where |x| > limit."""
    if not gate:
        return x
    return _PenalizeAbsGt.apply(x, float(limit), float(penalty))


class _LimitParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.args = (lo, hi)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lo, hi = ctx.args
        g1 = torch.where((g > 0) & (x < lo), -g, g)
        return torch.where((g1 < 0) & (x > hi), -g1, g1), None, None


def limit_param_value(x: torch.Tensor, gate: bool, lo: float, hi: float) -> torch.Tensor:
    """Keep a parameter's elements in [lo, hi] by flipping the gradients
    that push them further out."""
    if not gate:
        return x
    return _LimitParam.apply(x, float(lo), float(hi))


# ---------------------------------------------------------------------------
# Dropout
# ---------------------------------------------------------------------------


def dropout_shared(x: torch.Tensor, generator: torch.Generator, rate: float,
                   shared_dim: Optional[int] = None,
                   columns: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Dropout whose mask is shared along ``shared_dim``; the mask is drawn
    from ``generator`` (on x's device).  ``columns`` (offset, full width):
    x holds the last-dim columns [offset, offset + width) of a wider tensor
    (a tensor-parallel shard); the mask is drawn at the full width and
    sliced, so it is the full tensor's mask and the generator advances as
    for the full tensor."""
    shape = list(x.shape)
    if shared_dim is not None:
        shape[shared_dim] = 1
    if columns is not None:
        shape[-1] = columns[1]
    keep = torch.rand(shape, generator=generator, device=x.device) >= rate
    if columns is not None:
        keep = keep[..., columns[0]:columns[0] + x.shape[-1]]
    scale = 1.0 / max(1.0 - rate, 1e-6)
    return x * keep.to(x.dtype) * torch.tensor(scale, dtype=x.dtype, device=x.device)


def sequence_dropout(x: torch.Tensor, generator: torch.Generator, rate: float) -> torch.Tensor:
    """Drop whole sequences of a (B, T, C) tensor: mask shape (B, 1, 1)."""
    keep = torch.rand((x.shape[0], 1, 1), generator=generator, device=x.device) > rate
    return x * keep.to(x.dtype)
