"""The ctypes bindings and the build of the port's CUDA kernels, checked
without a compiler: each C entry point that ``ops/attention.py`` binds
lives in the library it is mapped to, and its argtypes follow the C
parameter list (a pointer for each pointer, a 32-bit int for each int, a
float for each float; a mismatch would pass pointers cut to 32 bits or
arguments shifted by one, which only a run on the card would show
otherwise); B6's and B7's wrappers pass a rectangular tile's Tq and Tk
where the C entry points take them, and B9's its halo count;
``ops/build.py`` compiles every source of a library and links them into
it, and names the library by all of them."""

import ctypes
import re
import sys

import numpy as np
import pytest
import torch

from zipvoice_tpu_torch.audio.mel import mel_filterbank
from zipvoice_tpu_torch.ops import attention as att
from zipvoice_tpu_torch.ops import build, convglu, melspec

_C_TYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}


def _c_signature(lib: str, symbol: str):
    """[(kind, name)] of the C entry point's parameters."""
    src = (build.CSRC / f"{lib}.cu").read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", src)
    assert m, f"{symbol} is not defined in csrc/{lib}.cu"
    params = []
    for p in m.group(1).split(","):
        p = re.sub(r"\bconst\b", "", p)
        params.append(("void*" if "*" in p else p.split()[0], re.findall(r"\w+", p)[-1]))
    return params


def _c_params(lib: str, symbol: str):
    return [kind for kind, _ in _c_signature(lib, symbol)]


@pytest.mark.parametrize("symbol", sorted(att._SIGNATURES))
def test_attention_entry_points_match_their_sources(symbol):
    lib, argtypes = att._SIGNATURES[symbol]
    assert lib in build.SOURCES
    assert [_C_TYPES[k] for k in _c_params(lib, symbol)] == argtypes


def test_conv_glu_entry_point_matches_its_source():
    """B9's entry takes the halo count h after D (proj and the mask hold
    h rows on each side of the T rows)."""
    assert "conv_glu" in build.SOURCES
    sig = _c_signature("conv_glu", "zv_conv_glu")
    assert [_C_TYPES[k] for k, _ in sig] == convglu._ARGTYPES
    assert [n for _, n in sig[7:]] == ["B", "T", "C", "K", "D", "h", "bf16", "stream"]


@pytest.mark.parametrize("symbol", ["zv_rel_probs_consume", "zv_rel_head0_consume"])
def test_consume_wrappers_pass_a_rectangular_tile(symbol, monkeypatch):
    """B6's and B7's wrappers on a rectangular tile (meta tensors, so no
    data), into a stand-in entry point that takes the C parameters by name:
    the argument count is the bound one, B, Tq, Tk, H, QD and PD land where
    the source declares them, and the outputs have Tq rows."""
    lib, argtypes = att._SIGNATURES[symbol]
    names = [n for _, n in _c_signature(lib, symbol)]
    got = {}

    def entry(*args):
        assert len(args) == len(argtypes) == len(names)
        got.update(zip(names, args))
        return 0

    wrapper = (att.rel_attention_probs_consume if symbol == "zv_rel_probs_consume"
               else att.rel_attention_head0_consume)
    monkeypatch.setattr(att, "_entry", lambda s: entry)
    monkeypatch.setattr(att, "_check_cuda", lambda *a: None)
    monkeypatch.setattr(att, "_stream_ptr", lambda device: None)
    monkeypatch.setattr(wrapper, "launches", wrapper.launches)  # restored after
    b, tq, tk, h, qd, pd = 2, 24, 96, 4, 32, 4

    def meta(*shape):
        return torch.empty(shape, device="meta")

    q, k, pq, pe = meta(b, tq, h, qd), meta(b, tk, h, qd), meta(b, tq, h, pd), \
        meta(tq + tk - 1, h, pd)
    if wrapper is att.rel_attention_probs_consume:
        probs, out = wrapper(q, k, pq, pe, None, meta(b, tk, h, 12))
        assert probs.shape == (b, h, tq, tk) and out.shape == (b, tq, h, 12)
        assert got["VD"] == 12
    else:
        out = wrapper(q, k, pq, pe, None, meta(b, tk, 384))
        assert out.shape == (b, tq, 384) and got["C"] == 384
    assert [got[n] for n in ("B", "Tq", "Tk", "H", "QD", "PD")] == [b, tq, tk, h, qd, pd]


def test_log_mel_entry_point_matches_its_source():
    assert "log_mel" in build.SOURCES
    assert [_C_TYPES[k] for k in _c_params("log_mel", "zv_log_mel")] == melspec._ARGTYPES


@pytest.mark.parametrize("n_fft,n_mels", [(1024, 100), (1024, 20), (16, 8)])
def test_sparse_filterbank_gives_back_the_dense_one(n_fft, n_mels):
    """B8's mel product runs over each mel's range of bins with the packed
    weights that the wrapper builds: put back, they are the dense
    filterbank bit for bit, and the ranges hold every nonzero."""
    fb = mel_filterbank(24000, n_fft, n_mels)
    weights, ranges = melspec.sparse_filterbank(24000, n_fft, n_mels)
    assert weights.dtype == np.float32 and ranges.dtype == np.int32
    assert ranges.shape == (n_mels, 3)
    dense = np.zeros_like(fb)
    offset = 0
    for m, (lo, hi, off) in enumerate(ranges):
        assert 0 <= lo <= hi <= n_fft // 2 + 1 and off == offset
        dense[lo:hi, m] = weights[off:off + hi - lo]
        offset += hi - lo
    assert offset == weights.size
    assert np.array_equal(dense, fb)
    assert weights.size < 2 * (n_fft // 2 + 1) + n_mels  # each bin in at most two mels


@pytest.mark.parametrize("n_fft", [2 ** p for p in range(11)])
def test_log_mel_twiddle_table_is_symmetric(n_fft):
    """B8's split reads the twiddle of bin M - k (M = n_fft/2) as the
    (-cos, sin) of bin k for 0 < k < M/2: the wrapper's f32 table holds
    exactly that, at every n_fft the kernel takes."""
    cos_t, sin_t = melspec.twiddle_table(n_fft)
    assert cos_t.dtype == sin_t.dtype == np.float32 and cos_t.shape == (n_fft,)
    m = n_fft // 2
    k = np.arange(1, (m + 1) // 2)
    k = k[k != m - k]
    assert np.array_equal(cos_t[m - k], -cos_t[k]) and np.array_equal(sin_t[m - k], sin_t[k])


def test_probs_consume_shares_b1s_kernel_body():
    """B6 is B1's kernel body with an epilogue: every source of both
    libraries includes the header that holds it, and the old B6 of
    rel_consume_fwd.cu is gone."""
    for symbol in ("zv_rel_probs", "zv_rel_probs_consume"):
        for src in build.sources(att._SIGNATURES[symbol][0]):
            assert '#include "rel_probs.cuh"' in (build.CSRC / f"{src}.cu").read_text()
    assert build.sources("rel_probs_consume") == ("rel_probs_consume", "rel_probs_consume_bf16")
    assert "zv_rel_probs_consume" not in (build.CSRC / "rel_consume_fwd.cu").read_text()


def test_rel_apply_routes_are_b6s_body_and_b7s_kernel():
    """B5 takes B1's kernel body with its own epilogue at a narrow vd and
    B7's kernel at a wide one: its library is its entry point and the narrow
    route's bf16 half (both include the header that holds B1's body) and the
    wide route, which includes B7's kernel header as B7's own source does;
    neither of those two defines a kernel.  zv_rel_apply is defined in
    rel_apply.cu and is gone from rel_consume_fwd.cu, with its old kernel."""
    lib = att._SIGNATURES["zv_rel_apply"][0]
    assert lib == "rel_apply" and lib in build.SOURCES
    assert build.sources(lib) == ("rel_apply", "rel_apply_bf16", "rel_apply_wide")
    for src in ("rel_apply", "rel_apply_bf16"):
        text = (build.CSRC / f"{src}.cu").read_text()
        assert '#include "rel_probs.cuh"' in text and "Epi::kApply" in text
    for src in ("rel_apply_wide", "rel_consume_fwd"):
        text = (build.CSRC / f"{src}.cu").read_text()
        assert '#include "rel_wide_consume.cuh"' in text and "__global__" not in text
    assert 'extern "C" int zv_rel_apply(' in (build.CSRC / "rel_apply.cu").read_text()
    fwd = (build.CSRC / "rel_consume_fwd.cu").read_text()
    assert "zv_rel_apply" not in fwd and "consume_tile" not in fwd


def test_rel_ds_shares_b1s_kernel_body():
    """B4 is B1's kernel body with a score-cotangent epilogue: its one
    source includes the header that holds the body and defines no kernel of
    its own."""
    src = (build.CSRC / "rel_ds.cu").read_text()
    assert build.sources(att._SIGNATURES["zv_rel_ds"][0]) == ("rel_ds",)
    assert '#include "rel_probs.cuh"' in src and "__global__" not in src


def test_rel_apply_bwd_builds_its_two_halves_from_one_header():
    """B3's kernels live in one header, built for f32 inputs with the entry
    point and for bf16 inputs in a second source of the same library, so
    that nvcc compiles the halves side by side; neither source defines a
    kernel of its own."""
    lib = att._SIGNATURES["zv_rel_apply_bwd"][0]
    assert build.sources(lib) == ("rel_apply_bwd", "rel_apply_bwd_bf16")
    for src in build.sources(lib):
        text = (build.CSRC / f"{src}.cu").read_text()
        assert '#include "rel_apply_bwd.cuh"' in text and "__global__" not in text
    assert "launch_in<__nv_bfloat16>" in (build.CSRC / "rel_apply_bwd_bf16.cu").read_text()
    assert "launch_in<float>" in (build.CSRC / "rel_apply_bwd.cu").read_text()


@pytest.fixture
def fake_tree(tmp_path, monkeypatch):
    """A csrc/ of two libraries, "a" of sources a.cu and b.cu and "c" of
    c.cu, a header, and a stand-in nvcc that writes its -o file."""
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    for name in ("a", "b", "c"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    (csrc / "h.cuh").write_text("// header\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\na = sys.argv[1:]\n"
                    "print(' '.join(a))\nopen(a[a.index('-o') + 1], 'w').write('x')\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "build_dir", lambda: out)
    monkeypatch.setattr(build, "SOURCES", ("a", "c"))
    monkeypatch.setattr(build, "EXTRA_SOURCES", {"a": ("b",)})
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    return csrc, out


def test_library_name_covers_every_source(fake_tree):
    """Editing any source of a library, its extra ones too, or a header
    renames it, so that a stale library is never loaded."""
    csrc, _ = fake_tree
    names = [build.library_path("a")]
    for edited in ("b.cu", "h.cuh", "a.cu"):
        (csrc / edited).write_text("// edited\n")
        names.append(build.library_path("a"))
    assert len(set(names)) == 4
    assert build.library_path("c") != build.library_path("a")


def test_build_all_links_every_source_into_its_library(fake_tree):
    _, out = fake_tree
    logs = build.build_all()
    assert sorted(logs) == ["a", "c"]
    assert "a.cu" in logs["a"] and "b.cu" in logs["a"] and "b.cu" not in logs["c"]
    # one link a library, of the objects of all its sources
    link_a = next(line for line in logs["a"].splitlines() if line.startswith("-shared"))
    assert ".o" in link_a and link_a.count(".o") == 2
    built = sorted(p.name for p in out.iterdir())
    assert built == sorted([build.library_path("a").name, build.library_path("c").name])
    assert build.build_all() == {}  # nothing stale, nothing built
