"""Model diagnostics: per-module, per-dim activation and parameter
statistics, as the JAX package's ``utils/diagnostics.py`` computes them
(same function names, percentiles and keys):

* per-dim summaries: for every tensor dimension, the 11-point percentile
  profile (sorted values at i*n//10) of the per-index mean / abs / rms /
  positive-fraction reductions over all other dims;
* eigenvalue summary: percentiles of the eigenvalues of the x^T x
  covariance over the channel dim, for dims up to ``MAX_EIG_DIM``;
* attention entropy: the mean softmax entropy of each attention-weights
  tap.

The statistics are computed on the host in numpy.  Per-module activations
come from the tap registry of ``nn/zipformer`` (``set_diagnostics_tap``):
the backbone's layer functions call their submodules as functions, so a
module hook would see none of them.  One eager forward without autograd
reports every submodule output by name.  Used by the train CLI's
--print-diagnostics.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Union

import numpy as np
import torch

MAX_EIG_DIM = 512


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _percentiles(v: np.ndarray) -> List[float]:
    """The 11-point profile: sorted values at i*n//10."""
    v = np.sort(v.ravel())
    n = v.size
    idx = np.minimum((np.arange(11) * n) // 10, n - 1)
    return [float(x) for x in v[idx]]


def dim_stats(x, dim: int) -> Dict[str, List[float]]:
    """Per-index reductions over all other dims, as percentiles
    ('mean'/'abs'/'rms'/'pos')."""
    x = _np(x)
    other = tuple(d for d in range(x.ndim) if d != dim)
    return {
        "mean": _percentiles(np.mean(x, axis=other)),
        "abs": _percentiles(np.mean(np.abs(x), axis=other)),
        "rms": _percentiles(np.sqrt(np.mean(x * x, axis=other))),
        "pos": _percentiles(np.mean(x > 0, axis=other)),
    }


def eig_stats(x, dim: int = -1, max_eig_dim: int = MAX_EIG_DIM) -> Optional[List[float]]:
    """Eigenvalue percentiles of the covariance over ``dim`` (x reshaped to
    (-1, size)); None for a dim wider than max_eig_dim or narrower than 2."""
    x = _np(x)
    size = x.shape[dim]
    if size > max_eig_dim or size < 2:
        return None
    x2 = np.moveaxis(x, dim, -1).reshape(-1, size)
    cov = x2.T @ x2 / max(x2.shape[0], 1)
    return _percentiles(np.linalg.eigvalsh(cov))


def attention_entropy(weights) -> float:
    """Mean softmax entropy over (batch, heads, queries) of attention
    weights (B, H, Tq, Tk)."""
    w = _np(weights).astype(np.float64)
    ent = -(w * np.log(np.clip(w, 1e-20, None))).sum(axis=-1)
    return float(ent.mean())


def tensor_stats(x, with_dims: bool = False, with_eigs: bool = False) -> Dict:
    """Scalar summary (+ optional per-dim profiles and channel-dim eigs)."""
    x = _np(x)
    if x.size == 0:
        return {}
    out: Dict = {
        "shape": list(x.shape),
        "abs_mean": float(np.mean(np.abs(x))),
        "rms": float(np.sqrt(np.mean(x * x))),
        "pos_frac": float(np.mean(x > 0)),
        "min": float(x.min()),
        "max": float(x.max()),
    }
    if with_dims and x.ndim > 1:
        out["dims"] = {d: dim_stats(x, d) for d in range(x.ndim) if x.shape[d] > 1}
    if with_eigs and x.ndim > 1:
        eigs = eig_stats(x, -1)
        if eigs is not None:
            out["eigs"] = eigs
    return out


def param_diagnostics(params: Union[torch.nn.Module, Mapping[str, torch.Tensor]],
                      with_dims: bool = False) -> Dict[str, Dict]:
    """Statistics of every named tensor of a module (its parameters) or of
    a {name: tensor} dict."""
    named = params.named_parameters() if isinstance(params, torch.nn.Module) \
        else params.items()
    return {name: tensor_stats(t, with_dims=with_dims) for name, t in named}


def grad_diagnostics(grads: Union[torch.nn.Module, Mapping[str, torch.Tensor]],
                     with_dims: bool = False) -> Dict[str, Dict]:
    """Statistics of a {name: gradient} dict, or of a module's parameters'
    .grad (those without one left out)."""
    if isinstance(grads, torch.nn.Module):
        grads = {n: p.grad for n, p in grads.named_parameters() if p.grad is not None}
    return param_diagnostics(grads, with_dims=with_dims)


@torch.no_grad()
def activation_diagnostics(m, x: torch.Tensor, t: Optional[torch.Tensor] = None,
                           padding_mask: Optional[torch.Tensor] = None,
                           per_module: bool = True, with_dims: bool = True,
                           with_eigs: bool = True) -> Dict[str, Dict]:
    """Per-module activation statistics of one eval forward of the
    TTSZipformer ``m`` (single-stream) on x (B, T, in_dim) at t (B,):
    every submodule output through the tap registry (with an ``entropy``
    for the attention weights) when ``per_module``, plus "in_proj", each
    stack's output "encoders.i" and "out_proj"."""
    from zipvoice_tpu_torch.nn import zipformer as zf

    stats: Dict[str, Dict] = {}

    def tap(name: str, value):
        s = tensor_stats(value, with_dims=with_dims, with_eigs=with_eigs)
        if name.endswith("self_attn_weights"):
            s["entropy"] = attention_entropy(value)
        stats[name] = s

    if per_module:
        zf.set_diagnostics_tap(tap)
    try:
        h = zf._lin(m.in_proj, x)
        stats["in_proj"] = tensor_stats(h, with_dims=with_dims, with_eigs=with_eigs)
        time_emb = None if t is None else zf._time_embedding(m, t, x.dtype)
        for i in range(len(m.encoders)):
            with zf._diag_scope(f"encoders.{i}"):
                h = zf._stack_forward(m, i, h, time_emb, padding_mask)
            stats[f"encoders.{i}"] = tensor_stats(h, with_dims=with_dims,
                                                  with_eigs=with_eigs)
        out = zf._lin(m.out_proj, h)
        stats["out_proj"] = tensor_stats(out, with_dims=with_dims, with_eigs=with_eigs)
    finally:
        if per_module:
            zf.set_diagnostics_tap(None)
    return stats


def format_diagnostics(stats: Dict[str, Dict], top: Optional[int] = None,
                       verbose_dims: bool = False) -> str:
    """One scalar line per tensor; the channel dim's percentile profile and
    the eigenvalues where present."""
    lines = []
    for name, s in stats.items():
        if not s:
            continue
        line = (f"{name:60s} shape={s['shape']} abs={s['abs_mean']:.3e} "
                f"rms={s['rms']:.3e} pos={s['pos_frac']:.2f} "
                f"range=[{s['min']:.3e}, {s['max']:.3e}]")
        if "entropy" in s:
            line += f" attn_entropy={s['entropy']:.3f}"
        lines.append(line)
        dims = s.get("dims")
        if dims:
            chan = max(dims)  # channel = trailing dim
            prof = dims[chan]
            lines.append(f"  dim={chan} rms percentiles {_fmt(prof['rms'])} "
                         f"pos {_fmt(prof['pos'])}")
            if verbose_dims:
                for d, p in dims.items():
                    if d != chan:
                        lines.append(f"  dim={d} rms percentiles {_fmt(p['rms'])}")
        if "eigs" in s:
            lines.append(f"  eigs percentiles {_fmt(s['eigs'])}")
    if top:
        lines = lines[:top]
    return "\n".join(lines)


def _fmt(vals: List[float]) -> str:
    return "[" + " ".join(f"{v:.2e}" for v in vals) + "]"
