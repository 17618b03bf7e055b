"""ctypes bridge to the native audio-IO library (``ops/cpp/zipvoice_io.cc``).

``batch_load_wav`` decodes, downmixes and resamples a whole batch of wav
files on a pool of native threads: the host side of the training path,
whose output feeds the fbank kernel (B8) in every batch.  The library is a
host library, not a device kernel.  g++ builds it at first use into
``libzipvoice_io-<hash>.so`` in the kernels' build directory
(``ops/build.build_dir``), the hash being of the source, so an edited
source is rebuilt and a stale library is never loaded.  The build
writes a temporary file and renames it into place, so processes that build
at the same time never load a half-written library.  Without a compiler
``available()`` is false and the callers take the numpy path of
``audio/wav.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from zipvoice_tpu_torch.ops.build import build_dir

_SRC = Path(__file__).resolve().parent / "cpp" / "zipvoice_io.cc"
# the package's build/, where build_dir takes it to be writable
_PREFERRED = Path(__file__).resolve().parent.parent / "build"
# no -march=native: the library's output stays the same on every host
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


class NativeUnavailable(RuntimeError):
    pass


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    return build_dir(_PREFERRED) / f"libzipvoice_io-{digest}.so"


def _build(lib: Path) -> bool:
    """g++ into a temporary name in the build directory, then an atomic
    rename onto ``lib``."""
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        lib.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(_SRC), "-lpthread"],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, lib)
        return True
    except (OSError, subprocess.SubprocessError) as ex:
        logging.info("native io build failed (%s); using numpy fallback", ex)
        return False
    finally:
        tmp.unlink(missing_ok=True)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Type the library's two C entry points; returns ``lib``."""
    lib.batch_load_wav.restype = ctypes.c_int
    lib.batch_load_wav.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int,
    ]
    lib.wav_info.restype = ctypes.c_int
    lib.wav_info.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int64),
    ]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        try:
            path = library_path()
        except OSError:
            _build_failed = True
            return None
        if not path.exists() and not _build(path):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as ex:
            logging.info("native io load failed (%s); numpy fallback", ex)
            _build_failed = True
            return None
        _lib = bind(lib)
        return _lib


def available() -> bool:
    return get_lib() is not None


def batch_load_wav(
    paths: List[str],
    target_sr: int,
    max_len: int,
    num_threads: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode, downmix and resample ``paths`` on native threads.

    Returns (audio (N, max_len) float32 zero-padded, lens (N,) int64).
    Raises NativeUnavailable if the library cannot be built.
    """
    lib = get_lib()
    if lib is None:
        raise NativeUnavailable("libzipvoice_io.so not available")
    encoded = [p.encode() for p in paths]
    blob = b"".join(p + b"\0" for p in encoded)
    offsets = np.zeros(len(paths), np.int64)
    offsets[1:] = np.cumsum([len(p) + 1 for p in encoded])[:-1]
    out = np.zeros((len(paths), max_len), np.float32)
    lens = np.zeros(len(paths), np.int64)
    rc = lib.batch_load_wav(
        blob,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(paths),
        target_sr,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_len,
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        num_threads,
    )
    if rc != 0:
        bad = [paths[i] for i in range(len(paths)) if lens[i] == 0]
        raise IOError(f"native wav decode failed for: {bad[:5]}")
    return out, lens


def wav_info(path: str) -> Tuple[int, int, int]:
    """(sample_rate, channels, num_frames) from the header alone."""
    lib = get_lib()
    if lib is None:
        raise NativeUnavailable("libzipvoice_io.so not available")
    sr = ctypes.c_int()
    ch = ctypes.c_int()
    n = ctypes.c_int64()
    rc = lib.wav_info(path.encode(), ctypes.byref(sr), ctypes.byref(ch),
                      ctypes.byref(n))
    if rc != 0:
        raise IOError(f"cannot parse {path}")
    return sr.value, ch.value, n.value
