"""Log-mel feature extraction in PyTorch: the Vocos and BigVGAN flavours.

* Vocos (torchaudio MelSpectrogram semantics): center=True reflect pad,
  periodic Hann window, magnitude (power 1), HTK mel scale without filter
  normalization, log(clamp 1e-7).
* BigVGAN (HiFi-GAN semantics): reflect pad (n_fft - hop) / 2 on each side,
  center=False, sqrt(power + 1e-9), Slaney mel scale with Slaney
  normalization, log(clamp 1e-5).

The filterbanks are built in float64 on the host.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from zipvoice_tpu_torch.audio.stft import stft_magnitude
from zipvoice_tpu_torch.config import FeatureConfig

_TYPES = ("vocos", "bigvgan")


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_LOGSTEP = np.log(6.4) / 27.0


def _hz_to_mel_slaney(f):
    f = np.asarray(f, np.float64)
    log_part = _MIN_LOG_HZ / _F_SP + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP
    return np.where(f >= _MIN_LOG_HZ, log_part, f / _F_SP)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, np.float64)
    min_log_mel = _MIN_LOG_HZ / _F_SP
    return np.where(m >= min_log_mel, _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - min_log_mel)),
                    m * _F_SP)


@functools.lru_cache(maxsize=16)
def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, f_min: float = 0.0,
                   f_max: Optional[float] = None, scale: str = "htk",
                   norm: Optional[str] = None) -> np.ndarray:
    """Triangular mel filterbank, (n_fft//2+1, n_mels) f32.  scale="htk",
    norm=None: torchaudio melscale_fbanks' defaults; scale="slaney",
    norm="slaney": librosa.filters.mel's."""
    if f_max is None:
        f_max = sample_rate / 2.0
    if scale == "htk":
        to_mel, to_hz = _hz_to_mel_htk, _mel_to_hz_htk
    elif scale == "slaney":
        to_mel, to_hz = _hz_to_mel_slaney, _mel_to_hz_slaney
    else:
        raise ValueError(f"unknown mel scale {scale!r}")
    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    f_pts = to_hz(np.linspace(to_mel(f_min), to_mel(f_max), n_mels + 2))
    # triangle filters: rising edge f_pts[i]..f_pts[i+1], falling to f_pts[i+2]
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if norm == "slaney":
        fb = fb * (2.0 / (f_pts[2:n_mels + 2] - f_pts[:n_mels]))[None, :]
    elif norm is not None:
        raise ValueError(f"unknown mel norm {norm!r}")
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _filterbank_on(sample_rate: int, n_fft: int, n_mels: int, device: torch.device,
                   slaney: bool = False) -> torch.Tensor:
    kw = dict(scale="slaney", norm="slaney") if slaney else {}
    return torch.from_numpy(mel_filterbank(sample_rate, n_fft, n_mels, **kw)).to(device)


def _check_type(cfg: FeatureConfig):
    if cfg.type not in _TYPES:
        raise ValueError(f"unknown feature type {cfg.type!r}; one of {_TYPES}")


def stft_pad_amount(cfg: FeatureConfig) -> int:
    """Per-side reflect padding the extractor applies: n_fft//2 for vocos
    (center=True), (n_fft - hop)//2 for bigvgan.  A caller that
    reflect-pads by this amount and extracts with pre_padded=True gets
    sample-identical frames."""
    _check_type(cfg)
    if cfg.type == "vocos":
        return cfg.n_fft // 2
    return (cfg.n_fft - cfg.hop_length) // 2


def vocos_log_mel(wav: torch.Tensor, cfg: FeatureConfig = FeatureConfig(),
                  pre_padded: bool = False) -> torch.Tensor:
    """(..., L) waveform -> (..., F, n_mels) log-mel, Vocos semantics."""
    mag = stft_magnitude(wav, cfg.n_fft, cfg.hop_length, center=not pre_padded)
    mel = mag.float() @ _filterbank_on(cfg.sampling_rate, cfg.n_fft, cfg.n_mels,
                                       wav.device)
    return torch.log(torch.clamp(mel, min=1e-7)).to(wav.dtype)


def bigvgan_log_mel(wav: torch.Tensor, cfg: FeatureConfig = FeatureConfig(),
                    pre_padded: bool = False) -> torch.Tensor:
    """(..., L) waveform -> (..., F, n_mels) log-mel, BigVGAN semantics."""
    if not pre_padded:
        pad = (cfg.n_fft - cfg.hop_length) // 2
        lead = wav.shape[:-1]
        wav = torch.nn.functional.pad(wav.reshape(-1, 1, wav.shape[-1]), (pad, pad),
                                      mode="reflect").reshape(lead + (-1,))
    mag = stft_magnitude(wav, cfg.n_fft, cfg.hop_length, center=False, eps=1e-9)
    mel = mag.float() @ _filterbank_on(cfg.sampling_rate, cfg.n_fft, cfg.n_mels,
                                       wav.device, slaney=True)
    return torch.log(torch.clamp(mel, min=1e-5)).to(wav.dtype)


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
    """The fbank of cfg.type: (C, L) or (L,) waveform -> (F, n_mels * C').
    With num_channels=1 a stereo input is averaged to mono (C' = 1);
    otherwise each channel keeps its own mel, concatenated channel-major
    (C' = C).  Without pre_padded the frame count is fixed to
    round-half-up(L / hop): cropped, or the last frame replicated.

    pre_padded=True: the caller already applied stft_pad_amount reflect
    padding (plus optional right zeros to a bucketed length); the STFT runs
    center=False and every frame is returned, so the caller owns the
    frame-count contract (slice to compute_num_frames of the true length).
    """
    _check_type(cfg)
    wav = torch.as_tensor(wav)
    if wav.ndim == 1:
        wav = wav[None, :]
    if num_channels == 1 and wav.shape[0] == 2:
        wav = wav.mean(dim=0, keepdim=True)
    log_mel = vocos_log_mel if cfg.type == "vocos" else bigvgan_log_mel
    mel = log_mel(wav, cfg, pre_padded=pre_padded)
    if not pre_padded:
        mel = fix_num_frames(mel, compute_num_frames(wav.shape[-1], cfg.hop_length))
    c, f, m = mel.shape
    return mel.transpose(0, 1).reshape(f, c * m)
