"""The port's native audio-IO loader (``zipvoice_tpu_torch/ops/native.py``)
on the CPU.  g++ is required: a failed build fails these tests, none skips.

- The port's source is the JAX package's, byte for byte, and its library
  lands in the build directory under the source's hash.
- ``batch_load_wav`` is bit-equal to a library built from the JAX package's
  ``zipvoice_io.cc`` with the JAX package's g++ flags into this test's
  temporary directory (the JAX package's own build in its source tree is
  not touched), at 16, 24 and 48 kHz, mono and stereo.
- At the target rate it equals the numpy path (``audio/wav.read_wav``, a
  stereo file averaged) within 1e-6.
- Six processes that call ``available()`` at once on a fresh copy of the
  module and its source all load the library.
"""

import ctypes
import hashlib
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from zipvoice_tpu_torch.audio.wav import read_wav, write_wav
from zipvoice_tpu_torch.ops import native

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

REPO = Path(__file__).resolve().parent.parent
JAX_SRC = REPO / "zipvoice_tpu" / "ops" / "cpp" / "zipvoice_io.cc"
CASES = [(sr, ch) for sr in (16000, 24000, 48000) for ch in (1, 2)]


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """{(rate, channels): path}: 1.3 s of noise each, plus the JAX package's
    library built into the module's temporary directory."""
    d = tmp_path_factory.mktemp("native_io")
    rng = np.random.default_rng(0)
    paths = {}
    for sr, ch in CASES:
        p = d / f"{sr}_{ch}.wav"
        write_wav(p, (rng.standard_normal((ch, int(1.3 * sr))) * 0.1).astype(np.float32), sr)
        paths[(sr, ch)] = str(p)
    jax_lib = d / "libzipvoice_io_jax.so"
    # the JAX package's build command (zipvoice_tpu/ops/native.py), another output path
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", str(jax_lib),
                    str(JAX_SRC), "-lpthread"], check=True, capture_output=True, timeout=300)
    paths["jax_lib"] = str(jax_lib)
    return paths


def _load(lib, paths, sr, max_len, monkeypatch):
    """batch_load_wav through ``lib`` (a CDLL) in place of the port's own."""
    with monkeypatch.context() as m:
        m.setattr(native, "_lib", native.bind(ctypes.CDLL(lib)))
        return native.batch_load_wav(paths, sr, max_len, num_threads=2)


def test_library_builds_under_content_hash():
    assert (REPO / "zipvoice_tpu_torch/ops/cpp/zipvoice_io.cc").read_bytes() == \
        JAX_SRC.read_bytes()
    assert native.available()
    path = native.library_path()
    digest = hashlib.sha256(JAX_SRC.read_bytes()).hexdigest()[:12]
    assert path == REPO / "zipvoice_tpu_torch" / "build" / f"libzipvoice_io-{digest}.so"
    assert path.exists()
    assert native.GXX_FLAGS == ("-O3", "-shared", "-fPIC", "-std=c++17")


@pytest.mark.parametrize("sr,ch", CASES)
def test_batch_load_bit_equal_to_jax_library(wavs, sr, ch, monkeypatch):
    """One file alone and the same file in a batch of all six, to 24 kHz:
    the samples and lengths of both libraries bit-equal."""
    assert native.available()
    every = [wavs[c] for c in CASES]
    for paths in ([wavs[(sr, ch)]], every):
        ours, ours_lens = native.batch_load_wav(paths, 24000, 40000, num_threads=2)
        ref, ref_lens = _load(wavs["jax_lib"], paths, 24000, 40000, monkeypatch)
        np.testing.assert_array_equal(ours_lens, ref_lens)
        np.testing.assert_array_equal(ours, ref)
    assert ours_lens[CASES.index((sr, ch))] == int(1.3 * 24000)


@pytest.mark.parametrize("ch", [1, 2])
def test_same_rate_equals_read_wav(wavs, ch):
    """At the file's own rate: the samples of read_wav (the mean of the
    channels of a stereo file) within 1e-6."""
    audio, lens = native.batch_load_wav([wavs[(24000, ch)]], 24000, 32000)
    ref, sr = read_wav(wavs[(24000, ch)])
    ref = ref.mean(axis=0)
    assert sr == 24000 and lens[0] == ref.shape[-1]
    np.testing.assert_allclose(audio[0, : lens[0]], ref, rtol=0, atol=1e-6)
    assert not audio[0, lens[0]:].any()


def test_wav_info_and_missing_file(wavs, tmp_path):
    assert native.wav_info(wavs[(48000, 2)]) == (48000, 2, int(1.3 * 48000))
    with pytest.raises(IOError):
        native.batch_load_wav([str(tmp_path / "nope.wav")], 24000, 1000)
    with pytest.raises(IOError):
        native.wav_info(str(tmp_path / "nope.wav"))


_RACER = r"""
import importlib.util, sys, time
from pathlib import Path
root = Path(sys.argv[1])
spec = importlib.util.spec_from_file_location("native_copy", root / "ops" / "native.py")
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
while not (root / "go").exists():
    time.sleep(0.001)
print(mod.available(), mod.library_path().name)
"""


def test_concurrent_first_builds_all_load(tmp_path):
    """Six processes wait for one signal, then each builds the library
    into the same fresh build directory and loads it: every one loads a
    whole library, and no temporary file is left."""
    pkg = tmp_path / "pkg"
    (pkg / "ops" / "cpp").mkdir(parents=True)
    (pkg / "ops" / "native.py").write_bytes(
        (REPO / "zipvoice_tpu_torch/ops/native.py").read_bytes())
    (pkg / "ops" / "cpp" / "zipvoice_io.cc").write_bytes(JAX_SRC.read_bytes())
    procs = [subprocess.Popen([sys.executable, "-c", _RACER, str(pkg)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(6)]
    time.sleep(1.0)  # every racer imported and waiting
    (pkg / "go").touch()
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, [e for _, e in outs]
    lines = [o.split() for o, _ in outs]
    assert all(line[0] == "True" for line in lines), lines
    assert len({line[1] for line in lines}) == 1
    assert sorted(p.name for p in (pkg / "build").iterdir()) == [lines[0][1]]
