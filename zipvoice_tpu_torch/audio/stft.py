"""STFT magnitude and ISTFT as framing + real-DFT products.

Conventions match torch.stft / torch.istft: onesided, un-normalized,
periodic Hann window.  The transforms are written as products against
cos/sin bases built in float64 (rather than torch.fft) so that they
compute the same sums as the reference package, to f32 rounding.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from zipvoice_tpu_torch.utils.graphs import hold


def hann_window(win_length: int, periodic: bool = True) -> np.ndarray:
    """torch.hann_window semantics (periodic=True by default), f32."""
    n = win_length if periodic else win_length - 1
    t = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * math.pi * t / n)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def dft_basis(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """Real-DFT basis X[k] = sum_n x[n] (cos - i sin)(2 pi k n / N):
    (cos, sin), each (n_fft, n_fft//2+1) f32, computed in f64."""
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
    ang = 2.0 * math.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=8)
def idft_basis(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse real-DFT basis mapping onesided (re, im) -> time frame:
    x[n] = (1/N) sum_k w_k (re[k] cos + im[k] sin)(2 pi k n / N), with
    w_k = 1 at k = 0 and N/2, else 2.  (cos_i, sin_i), each
    (n_fft//2+1, n_fft) f32."""
    half = n_fft // 2 + 1
    k = np.arange(half, dtype=np.float64)[:, None]
    n = np.arange(n_fft, dtype=np.float64)[None, :]
    ang = 2.0 * math.pi * k * n / n_fft
    w = np.full((half, 1), 2.0)
    w[0, 0] = 1.0
    if n_fft % 2 == 0:
        w[-1, 0] = 1.0
    return ((w * np.cos(ang) / n_fft).astype(np.float32),
            (w * np.sin(ang) / n_fft).astype(np.float32))


def _device_consts(n_fft: int, device: torch.device):
    """Hann window and the forward/inverse bases as f32 tensors on
    ``device``, uploaded once per (n_fft, device) and held by a graph
    captured over them."""
    return tuple(hold(t) for t in _device_consts_cached(n_fft, device))


@functools.lru_cache(maxsize=16)
def _device_consts_cached(n_fft: int, device: torch.device):
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    cos, sin = dft_basis(n_fft)
    cos_i, sin_i = idft_basis(n_fft)
    return to(hann_window(n_fft)), to(cos), to(sin), to(cos_i), to(sin_i)


def frame_signal(y: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """(..., L) -> (..., F, n_fft) frames at stride hop, F = 1 + (L - n_fft) // hop."""
    return y.unfold(-1, n_fft, hop_length)


def stft_magnitude(y: torch.Tensor, n_fft: int, hop_length: int,
                   center: bool = True, eps: float = 0.0) -> torch.Tensor:
    """|STFT(y)| with a periodic Hann window: (..., L) -> (..., F, n_fft//2+1);
    center=True reflect-pads n_fft//2 like torch.stft; eps > 0 takes
    sqrt(power + eps) (the BigVGAN features).  The products run in f32; the
    result is in y.dtype."""
    if center:
        pad = n_fft // 2
        lead = y.shape[:-1]
        y = torch.nn.functional.pad(y.reshape(-1, 1, y.shape[-1]), (pad, pad),
                                    mode="reflect").reshape(lead + (-1,))
    window, cos, sin, _, _ = _device_consts(n_fft, y.device)
    frames = (frame_signal(y, n_fft, hop_length) * window.to(y.dtype)).float()
    re = frames @ cos
    im = -(frames @ sin)
    power = re * re + im * im
    if eps:
        power = power + eps
    return torch.sqrt(power).to(y.dtype)


def istft(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop_length: int,
          center: bool = True, length_eps: float = 1e-11) -> torch.Tensor:
    """torch.istft-compatible inverse with a periodic Hann window:
    (..., F, n_fft//2+1) re/im -> (..., (F-1)*hop) f32 with center=True.
    Overlap-add is n_fft/hop shifted adds; the window-square envelope is a
    host-side constant."""
    if n_fft % hop_length:
        raise ValueError(f"n_fft {n_fft} must be a multiple of hop {hop_length}")
    k_overlap = n_fft // hop_length
    num_frames = re.shape[-2]
    window, _, _, cos_i, sin_i = _device_consts(n_fft, re.device)
    frames = (re.float() @ cos_i - im.float() @ sin_i) * window

    total = (num_frames - 1) * hop_length + n_fft
    batch_shape = frames.shape[:-2]
    out = frames.new_zeros(batch_shape + (total,))
    # chunk c of frame f lands at (f + c) * hop
    fr = frames.reshape(batch_shape + (num_frames, k_overlap, hop_length))
    span = num_frames * hop_length
    for c in range(k_overlap):
        seg = fr[..., :, c, :].reshape(batch_shape + (span,))
        out[..., c * hop_length : c * hop_length + span] += seg

    out = out / hold(_envelope(n_fft, hop_length, num_frames, length_eps, out.device))
    if center:
        out = out[..., n_fft // 2 : total - n_fft // 2]
    return out


@functools.lru_cache(maxsize=32)
def _envelope(n_fft: int, hop_length: int, num_frames: int, length_eps: float,
              device: torch.device) -> torch.Tensor:
    """Overlap-added squared window, floored at length_eps, f32 on device."""
    wsq = hann_window(n_fft).astype(np.float64) ** 2
    total = (num_frames - 1) * hop_length + n_fft
    env = np.zeros(total, np.float64)
    for f in range(num_frames):
        env[f * hop_length : f * hop_length + n_fft] += wsq
    return torch.from_numpy(np.maximum(env, length_eps).astype(np.float32)).to(device)
