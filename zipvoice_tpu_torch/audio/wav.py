"""WAV read/write + resampling in numpy (no torchaudio/soundfile).

Reads PCM 8/16/24/32 and IEEE-float RIFF files, writes PCM16.  Resampling
is windowed-sinc polyphase via scipy.signal.resample_poly.
"""

from __future__ import annotations

import os
import struct
from fractions import Fraction
from pathlib import Path
from typing import Tuple, Union

import numpy as np


def read_wav(path: Union[str, Path]) -> Tuple[np.ndarray, int]:
    """Read a RIFF WAV file -> (samples (C, L) float32 in [-1, 1], sample_rate)."""
    return read_wav_bytes(Path(path).read_bytes(), name=str(path))


def read_wav_bytes(data: bytes, name: str = "<bytes>") -> Tuple[np.ndarray, int]:
    """read_wav of an in-memory RIFF blob (a serving request's prompt)."""
    path = name
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    raw = None
    subformat = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
            if len(body) >= 26:
                # WAVE_FORMAT_EXTENSIBLE: the real format code is the first
                # word of the SubFormat GUID (fmt-chunk offset 24)
                subformat = struct.unpack("<H", body[24:26])[0]
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = subformat if subformat in (1, 3) else 1

    if audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
            x = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            x = (x - ((x >> 23) & 1) * (1 << 24)).astype(np.float32) / 8388608.0
        elif bits == 8:
            x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        x = np.frombuffer(raw, "<f4" if bits == 32 else "<f8").astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV format code {audio_format}")

    x = x.reshape(-1, channels).T  # (C, L)
    return np.ascontiguousarray(x), sample_rate


def _fmt_chunk(sample_rate: int, channels: int) -> bytes:
    return b"fmt " + struct.pack(
        "<IHHIIHH", 16, 1, channels, sample_rate, sample_rate * channels * 2,
        channels * 2, 16,
    )


def pcm16_bytes(samples: np.ndarray) -> bytes:
    """(L,) or (C, L) float32 -> interleaved little-endian PCM16 bytes."""
    x = np.asarray(samples, np.float32)
    if x.ndim == 1:
        x = x[None, :]
    return np.clip(np.round(x.T * 32768.0), -32768, 32767).astype("<i2").tobytes()


def wav_bytes(samples: np.ndarray, sample_rate: int) -> bytes:
    """Encode (C, L) or (L,) float32 samples as a PCM16 RIFF blob."""
    x = np.asarray(samples, np.float32)
    if x.ndim == 1:
        x = x[None, :]
    body = pcm16_bytes(x)
    hdr = b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVE"
    hdr += _fmt_chunk(sample_rate, x.shape[0])
    hdr += b"data" + struct.pack("<I", len(body))
    return hdr + body


def write_wav(path: Union[str, Path], samples: np.ndarray, sample_rate: int):
    """Write (C, L) or (L,) float32 samples as PCM16 WAV."""
    Path(path).write_bytes(wav_bytes(samples, sample_rate))


def wav_stream_header(sample_rate: int, channels: int = 1) -> bytes:
    """RIFF/WAVE header of a stream of unknown length: the RIFF and data
    sizes are 0xFFFFFFFF (players read to the end).  PCM16 frames
    (pcm16_bytes) follow."""
    hdr = b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE"
    hdr += _fmt_chunk(sample_rate, channels)
    hdr += b"data" + struct.pack("<I", 0xFFFFFFFF)
    return hdr


def probe_wav(path: Union[str, Path]) -> Tuple[int, int, int]:
    """Read only the RIFF headers -> (sample_rate, num_frames, channels).

    Unlike the stdlib ``wave`` module this accepts every format read_wav
    does (PCM, IEEE float, WAVE_FORMAT_EXTENSIBLE) and never decodes the
    data chunk — duration probing over a large manifest stays I/O-light."""
    with open(path, "rb") as f:
        head = f.read(12)
        if head[:4] != b"RIFF" or head[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        total = os.fstat(f.fileno()).st_size
        fmt = None
        data_size = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid = hdr[:4]
            size = struct.unpack("<I", hdr[4:8])[0]
            if cid == b"fmt ":
                fmt = struct.unpack("<HHIIHH", f.read(16))
                f.seek(size - 16 + (size & 1), 1)
            elif cid == b"data":
                # streaming-style headers write size 0xFFFFFFFF and
                # truncated files lie: clamp to the bytes actually present
                data_size = min(size, max(total - f.tell(), 0))
                f.seek(size + (size & 1), 1)
            else:
                f.seek(size + (size & 1), 1)
            if fmt is not None and data_size is not None:
                break
    if fmt is None or data_size is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    _, channels, sample_rate, _, block_align, bits = fmt
    bytes_per_frame = block_align or channels * max(bits // 8, 1)
    return sample_rate, data_size // bytes_per_frame, channels


def resample(wav: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Polyphase resample along the last axis."""
    if orig_sr == new_sr:
        return wav
    from scipy.signal import resample_poly

    frac = Fraction(new_sr, orig_sr)
    return resample_poly(wav, frac.numerator, frac.denominator, axis=-1).astype(
        np.float32
    )
