"""Vocos log-mel feature extraction in PyTorch.

VocosFbank semantics (torchaudio MelSpectrogram): center=True reflect pad,
periodic Hann window, magnitude (power 1), HTK mel scale without filter
normalization, log(clamp 1e-7).  The filterbank is built in float64 on the
host.  The BigVGAN features are not ported yet.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from zipvoice_tpu_torch.audio.stft import stft_magnitude
from zipvoice_tpu_torch.config import FeatureConfig


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=16)
def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, f_min: float = 0.0,
                   f_max: Optional[float] = None) -> np.ndarray:
    """Triangular HTK mel filterbank without normalization,
    (n_fft//2+1, n_mels) f32 (torchaudio melscale_fbanks defaults)."""
    if f_max is None:
        f_max = sample_rate / 2.0
    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    m_pts = np.linspace(_hz_to_mel_htk(f_min), _hz_to_mel_htk(f_max), n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)
    # triangle filters: rising edge f_pts[i]..f_pts[i+1], falling to f_pts[i+2]
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _filterbank_on(sample_rate: int, n_fft: int, n_mels: int,
                   device: torch.device) -> torch.Tensor:
    return torch.from_numpy(mel_filterbank(sample_rate, n_fft, n_mels)).to(device)


def stft_pad_amount(cfg: FeatureConfig) -> int:
    """Per-side reflect padding the vocos extractor applies (n_fft//2).  A
    caller that reflect-pads by this amount and extracts with
    pre_padded=True gets sample-identical frames."""
    if cfg.type != "vocos":
        raise NotImplementedError(f"{cfg.type!r} features are not yet ported")
    return cfg.n_fft // 2


def vocos_log_mel(wav: torch.Tensor, cfg: FeatureConfig = FeatureConfig(),
                  pre_padded: bool = False) -> torch.Tensor:
    """(..., L) waveform -> (..., F, n_mels) log-mel."""
    mag = stft_magnitude(wav, cfg.n_fft, cfg.hop_length, center=not pre_padded)
    mel = mag.float() @ _filterbank_on(cfg.sampling_rate, cfg.n_fft, cfg.n_mels,
                                       wav.device)
    return torch.log(torch.clamp(mel, min=1e-7)).to(wav.dtype)


def compute_num_frames(num_samples: int, hop_length: int) -> int:
    """Frame-count contract: round-half-up of samples / hop."""
    return int((num_samples + hop_length // 2) // hop_length)


def fix_num_frames(mel: torch.Tensor, num_frames: int) -> torch.Tensor:
    """Crop or replicate-pad (..., F, n_mels) to exactly num_frames frames."""
    f = mel.shape[-2]
    if f > num_frames:
        return mel[..., :num_frames, :]
    if f < num_frames:
        pad = mel[..., -1:, :].expand(mel.shape[:-2] + (num_frames - f, mel.shape[-1]))
        return torch.cat([mel, pad], dim=-2)
    return mel


def extract_features(wav, cfg: FeatureConfig, num_channels: int = 1,
                     pre_padded: bool = False) -> torch.Tensor:
    """Vocos fbank: (C, L) or (L,) waveform -> (F, n_mels * C').  With
    num_channels=1 a stereo input is averaged to mono (C' = 1); otherwise
    each channel keeps its own mel, concatenated channel-major (C' = C).

    pre_padded=True: the caller already applied stft_pad_amount reflect
    padding (plus optional right zeros to a bucketed length); the STFT runs
    center=False and every frame is returned, so the caller owns the
    frame-count contract (slice to compute_num_frames of the true length).
    """
    if cfg.type != "vocos":
        raise NotImplementedError(f"{cfg.type!r} features are not yet ported")
    wav = torch.as_tensor(wav)
    if wav.ndim == 1:
        wav = wav[None, :]
    if num_channels == 1 and wav.shape[0] == 2:
        wav = wav.mean(dim=0, keepdim=True)
    mel = vocos_log_mel(wav, cfg, pre_padded=pre_padded)
    if not pre_padded:
        mel = fix_num_frames(mel, compute_num_frames(wav.shape[-1], cfg.hop_length))
    c, f, m = mel.shape
    return mel.transpose(0, 1).reshape(f, c * m)
