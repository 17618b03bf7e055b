"""The fused ConvolutionModule tail of the eval path (B9, ``csrc/conv_glu.cu``)
and its plain version.

    out = linear(w_out, SwooshR(depthwise_conv_K(v * sigmoid(s) * keep) + b)) + b_out

with (v, s) the two halves of the in_proj output ``proj`` (B, T, 2C) and
keep = 0 on padded rows.  Gate, conv and SwooshR are f32; SwooshR's output
is rounded to proj's dtype before an f32-accumulated out-projection; the
result is in proj's dtype.  The unfused ``nn.zipformer._conv_module``
convolves in the compute dtype instead, so in bf16 the two differ by where
they round.

The weights keep the port's module layouts: the nn.Conv1d weight (C, 1, K)
and the nn.Linear weight (D, C), as ``io.checkpoint.from_jax_params`` maps
the JAX package's (K, C) taps and (C, D) projection.  The wrapper launches
the kernel for CUDA tensors (or raises) and takes the plain version only
for CPU tensors; ``conv_glu_swoosh_out.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from zipvoice_tpu_torch.ops import build

_P, _I = ctypes.c_void_p, ctypes.c_int
# zv_conv_glu(proj, mask, w, b, w_out, b_out, out, B, T, C, K, D, bf16, stream)
_ARGTYPES = [_P] * 7 + [_I] * 6 + [_P]


def conv_glu_swoosh_out_plain(proj, w, b, key_padding_mask, w_out, b_out=None):
    """Plain B9 in f32 (f64 when proj is f64, the reference the kernel is
    judged against); the conv is torch's grouped conv1d."""
    acc = torch.float64 if proj.dtype == torch.float64 else torch.float32
    t, c = proj.shape[1], proj.shape[2] // 2
    v, s = proj.to(acc).chunk(2, dim=-1)
    g = v * torch.sigmoid(s)
    if key_padding_mask is not None:
        g = g * (~key_padding_mask)[:, :, None].to(acc)
    k = w.shape[-1]
    y = F.conv1d(g.transpose(1, 2), w.to(acc), b.to(acc), padding=k // 2,
                 groups=c)[..., :t].transpose(1, 2)
    y = F.softplus(y - 1.0) - 0.08 * y - 0.313261687
    out = y.to(proj.dtype).to(acc) @ w_out.to(proj.dtype).to(acc).T
    if b_out is not None:
        out = out + b_out.to(acc)
    return out.to(proj.dtype)


def conv_glu_swoosh_out(
    proj: torch.Tensor,  # (B, T, 2C) in_proj output
    w: torch.Tensor,  # (C, 1, K) depthwise conv weight
    b: torch.Tensor,  # (C,) depthwise conv bias
    key_padding_mask: Optional[torch.Tensor],  # (B, T) bool, True = padded
    w_out: torch.Tensor,  # (D, C) out-projection weight
    b_out: Optional[torch.Tensor] = None,  # (D,)
) -> torch.Tensor:
    """B9: (B, T, D) in proj.dtype; any T; eval only (no backward)."""
    if proj.device.type == "cpu":
        return conv_glu_swoosh_out_plain(proj, w, b, key_padding_mask, w_out, b_out)
    name = "conv_glu_swoosh_out"
    if proj.device.type != "cuda" or proj.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: proj must be a float32 or bfloat16 CUDA tensor, got "
                         f"{proj.dtype} on {proj.device}")
    bsz, t, c2 = proj.shape
    c, k, d = c2 // 2, w.shape[-1], w_out.shape[0]
    if (w.shape != (c, 1, k) or b.shape != (c,) or w_out.shape != (d, c)
            or (b_out is not None and b_out.shape != (d,))):
        raise ValueError(f"{name}: shapes proj{tuple(proj.shape)} w{tuple(w.shape)} "
                         f"b{tuple(b.shape)} w_out{tuple(w_out.shape)}")
    params = [w, b, w_out] + ([] if b_out is None else [b_out])
    if any(p.device != proj.device for p in params):
        raise ValueError(f"{name}: every input must be on {proj.device}")
    mask = None
    if key_padding_mask is not None:
        if (key_padding_mask.shape != (bsz, t) or key_padding_mask.dtype != torch.bool
                or key_padding_mask.device != proj.device):
            raise ValueError(f"{name}: key_padding_mask must be a (B, T) bool tensor "
                             f"on {proj.device}")
        mask = key_padding_mask.contiguous().view(torch.uint8)
    proj = build.aligned(proj.contiguous())
    w32 = w.float().reshape(c, k).contiguous()
    b32 = b.float().contiguous()
    wo = build.aligned(w_out.to(proj.dtype).contiguous())
    bo = None if b_out is None else b_out.float().contiguous()
    out = torch.empty((bsz, t, d), dtype=proj.dtype, device=proj.device)
    code = build.entry("conv_glu", "zv_conv_glu", _ARGTYPES)(
        proj.data_ptr(), None if mask is None else mask.data_ptr(), w32.data_ptr(),
        b32.data_ptr(), wo.data_ptr(), None if bo is None else bo.data_ptr(), out.data_ptr(),
        bsz, t, c, k, d, int(proj.dtype == torch.bfloat16),
        ctypes.c_void_p(torch.cuda.current_stream(proj.device).cuda_stream))
    if code != 0:
        raise RuntimeError(f"conv_glu kernel launch failed (cudaError {code}) for "
                           f"B={bsz} T={t} C={c} K={k} D={d}")
    conv_glu_swoosh_out.launches += 1
    return out


conv_glu_swoosh_out.launches = 0
