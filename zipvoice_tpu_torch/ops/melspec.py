"""Fused log-mel kernel (B8, ``csrc/log_mel.cu``) and its plain version.

``fused_log_mel`` takes center-padded audio (reflect-padded by n_fft/2 on
both sides) and returns the Vocos log-mel of every frame: framing, periodic
Hann window, real DFT, magnitude, HTK mel (no filter normalization) and
log(max(., 1e-7)) in one kernel, the DFT as a real FFT and the mel product
over the filterbank's nonzeros only.  Any frame count.  The wrapper
launches the kernel for a CUDA tensor (or raises) and takes the plain
version, the port's ``audio/mel.py`` composition, only for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from zipvoice_tpu_torch.audio.mel import mel_filterbank, vocos_log_mel
from zipvoice_tpu_torch.audio.stft import hann_window
from zipvoice_tpu_torch.config import FeatureConfig
from zipvoice_tpu_torch.ops import build

# zv_log_mel(wav, win, cos, sin, fb_w, fb_r, out, B, L, n_fft, hop, n_mels, n_w, stream)
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def fused_log_mel_plain(wav: torch.Tensor, sample_rate: int = 24000, n_fft: int = 1024,
                        hop: int = 256, n_mels: int = 100) -> torch.Tensor:
    """Plain B8: the STFT magnitude as real-DFT products, the mel product
    and the log, (B, L) pre-padded -> (B, F, n_mels) f32."""
    cfg = FeatureConfig(sampling_rate=sample_rate, n_mels=n_mels, n_fft=n_fft,
                        hop_length=hop)
    return vocos_log_mel(wav.float(), cfg, pre_padded=True)


def sparse_filterbank(sample_rate: int, n_fft: int, n_mels: int):
    """The mel filterbank as each mel's nonzero bins: (weights, ranges).
    ranges is (n_mels, 3) int32, mel m's rows (lo, hi, offset): its bins
    [lo, hi) from its first to its last nonzero, their f32 weights at
    weights[offset : offset + hi - lo] (a mel without one: lo = hi = 0)."""
    fb = mel_filterbank(sample_rate, n_fft, n_mels)
    ranges = np.zeros((n_mels, 3), np.int32)
    parts, offset = [], 0
    for m in range(n_mels):
        nz = np.flatnonzero(fb[:, m])
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        ranges[m] = lo, hi, offset
        parts.append(fb[lo:hi, m])
        offset += hi - lo
    return np.concatenate(parts + [np.zeros(0, np.float32)]), ranges


def twiddle_table(n_fft: int):
    """One period of (cos, sin)(2 pi m / n_fft), m < n_fft, built in f64 and
    rounded to f32: every twiddle of the kernel's FFT and of its split."""
    ang = 2.0 * math.pi * np.arange(n_fft, dtype=np.float64) / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _consts(sample_rate: int, n_fft: int, n_mels: int, device: torch.device):
    """Hann window, the twiddle table and the mel filterbank's packed
    weights and ranges, as tensors on ``device``."""
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    weights, ranges = sparse_filterbank(sample_rate, n_fft, n_mels)
    return (to(hann_window(n_fft)), *map(to, twiddle_table(n_fft)), to(weights), to(ranges))


def fused_log_mel(wav: torch.Tensor, sample_rate: int = 24000, n_fft: int = 1024,
                  hop: int = 256, n_mels: int = 100) -> torch.Tensor:
    """(B, L) f32 audio, reflect-padded by n_fft//2 on both sides ->
    (B, F, n_mels) f32 log-mel with F = (L - n_fft) // hop + 1."""
    if wav.device.type == "cpu":
        return fused_log_mel_plain(wav, sample_rate, n_fft, hop, n_mels)
    if wav.device.type != "cuda" or wav.dtype != torch.float32 or wav.ndim != 2:
        raise ValueError(f"fused_log_mel: needs a (B, L) float32 CUDA tensor, got "
                         f"{tuple(wav.shape)} {wav.dtype} on {wav.device}")
    b, length = wav.shape
    if length < n_fft:
        raise ValueError(f"fused_log_mel: {length} samples < n_fft {n_fft}")
    wav = wav.contiguous()
    win, cos_t, sin_t, fb_w, fb_r = _consts(sample_rate, n_fft, n_mels, wav.device)
    frames = (length - n_fft) // hop + 1
    out = torch.empty((b, frames, n_mels), dtype=torch.float32, device=wav.device)
    code = build.entry("log_mel", "zv_log_mel", _ARGTYPES)(
        wav.data_ptr(), win.data_ptr(), cos_t.data_ptr(), sin_t.data_ptr(), fb_w.data_ptr(),
        fb_r.data_ptr(), out.data_ptr(), b, length, n_fft, hop, n_mels, fb_w.numel(),
        ctypes.c_void_p(torch.cuda.current_stream(wav.device).cuda_stream))
    if code != 0:
        raise RuntimeError(f"log_mel kernel launch failed (cudaError {code}) for "
                           f"B={b} L={length} n_fft={n_fft} hop={hop} n_mels={n_mels}")
    fused_log_mel.launches += 1
    return out


fused_log_mel.launches = 0
