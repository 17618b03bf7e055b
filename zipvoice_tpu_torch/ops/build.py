"""Build and load the port's CUDA kernels.

Each library ``<name>`` is ``csrc/<name>.cu`` (and the sources that
``EXTRA_SOURCES`` adds to it), compiled by ``nvcc`` for ``sm_90a`` and
linked into a shared library with a plain C interface,
``lib<name>-<hash>.so`` in ``build_dir()``, loaded through ctypes.  The
hash is of the library's sources and of the shared headers
(``csrc/*.cuh``), so an edited kernel is rebuilt and a stale library is
never loaded.  Nothing is compiled when the module is imported: the first
kernel call (or ``build_all``) does it, and all sources compile in
parallel.  The sources ship in the wheel as package data, so an installed
package builds from its own copy.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
SOURCES = ("rel_probs", "rel_probs_consume", "probs_apply", "rel_ds", "rel_apply_bwd",
           "log_mel", "rel_consume_fwd", "conv_glu", "rel_apply")
# further sources of a library, each its own nvcc process: B6's, B3's and
# B5's instantiations for bf16 inputs build beside those for f32 inputs, and
# B5's wide route beside both
EXTRA_SOURCES = {"rel_probs_consume": ("rel_probs_consume_bf16",),
                 "rel_apply_bwd": ("rel_apply_bwd_bf16",),
                 "rel_apply": ("rel_apply_bf16", "rel_apply_wide")}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the seconds of each nvcc process of the last ``build_all``, by source
# (the links by library name, with a "link " prefix)
SECONDS: Dict[str, float] = {}
_loaded: Dict[str, ctypes.CDLL] = {}
_entry_points: Dict[Tuple[str, str], object] = {}


@functools.lru_cache(maxsize=None)
def build_dir(preferred: Path = PKG / "build") -> Path:
    """The directory the port's native libraries are built in and loaded
    from, created: ``preferred`` (the package's ``build/``, as in a
    checkout) when it can be created and written, else a per-user cache,
    ``$XDG_CACHE_HOME/zipvoice_tpu_torch/build`` (``~/.cache`` without
    ``XDG_CACHE_HOME``), for an installed package whose tree is read-only."""
    try:
        preferred.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryFile(dir=preferred):
            return preferred
    except OSError:
        cache = Path(os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache")
        out = cache / "zipvoice_tpu_torch" / "build"
        out.mkdir(parents=True, exist_ok=True)
        return out


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def sources(name: str) -> Tuple[str, ...]:
    """The source files (without ``.cu``) of library ``name``."""
    return (name,) + EXTRA_SOURCES.get(name, ())


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sources(name):
        h.update((CSRC / f"{src}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return build_dir() / f"lib{name}-{digest}.so"


def build_all() -> Dict[str, str]:
    """Compile every kernel source whose library is missing, all at once.
    Returns {name: compiler log} for what was built; raises on a failure."""
    todo = [n for n in SOURCES if not library_path(n).exists()]
    if not todo:
        return {}
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()

    def run(cmds, label):
        """Run the commands side by side: ({key: output}, [failed keys]);
        each one's seconds into SECONDS under ``label(key)``."""
        t0 = time.monotonic()
        procs = {key: subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True) for key, cmd in cmds.items()}
        # each output read on a thread of its own, so no pipe fills and blocks
        # its writer while another process is waited for
        outs = {}

        def collect(key, proc):
            outs[key] = proc.communicate()[0]
            SECONDS[label(key)] = time.monotonic() - t0

        threads = [threading.Thread(target=collect, args=item) for item in procs.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return outs, [key for key, proc in procs.items() if proc.returncode != 0]

    # every source to an object, all at once; then each library linked
    tag = f"{os.getpid()}.tmp"
    objs = {(name, src): out / f"{src}.{tag}.o" for name in todo for src in sources(name)}
    SECONDS.clear()
    outs, bad = run({key: [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / f"{key[1]}.cu")]
                     for key, obj in objs.items()}, lambda key: key[1])
    logs = {name: "".join(outs[(name, src)] for src in sources(name)) for name in todo}
    failed = sorted({name for name, _ in bad})
    if not failed:
        tmps = {name: library_path(name).with_suffix(f".{tag}") for name in todo}
        links, failed = run({name: [nvcc, "-shared", "-o", str(tmps[name]),
                                    *(str(objs[(name, src)]) for src in sources(name))]
                             for name in todo}, lambda name: f"link {name}")
        for name in todo:
            logs[name] += links[name]
            if name in failed:
                tmps[name].unlink(missing_ok=True)
            else:
                os.replace(tmps[name], library_path(name))
    for obj in objs.values():
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        if not library_path(name).exists():
            build_all()
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def aligned(x):
    """x itself if its data is 16-byte aligned (the kernels' vector loads),
    else an aligned copy."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def entry(name: str, symbol: str, argtypes):
    """The C entry point ``symbol`` of kernel library ``name``, typed once
    (argtypes; an int return code)."""
    fn = _entry_points.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _entry_points[(name, symbol)] = fn
    return fn
