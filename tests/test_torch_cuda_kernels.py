"""The CUDA kernels of zipvoice_tpu_torch.ops (B1-B9) against their plain
versions on the card, square and on the rectangular tiles and halo rows of
sequence parallelism.  Marked ``cuda``: without a CUDA card every test
skips.  On a machine with one (and nvcc), run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from zipvoice_tpu_torch.ops import attention as att

pytestmark = pytest.mark.cuda

# f32: reordered sums over |scores| up to ~30; bf16: one unit in the last
# place of the output (probabilities <= 1, outputs scaled by their max)
TOL = {torch.float32: 2e-5, torch.bfloat16: 8e-3}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(gen, t, dtype, b=2, h=4, qd=32, pd=4):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    # the last batch row padded from t - t // 3 - 1 on
    mask = torch.arange(t, device="cuda")[None, :] >= torch.tensor(
        [t] * (b - 1) + [t - t // 3 - 1], device="cuda")[:, None]
    return rnd(b, t, h, qd), rnd(b, t, h, qd), rnd(b, t, h, pd), rnd(2 * t - 1, h, pd), mask


_DTYPE_PAIRS = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)]


def _check_rel_probs(gen, t, dtype, out_dtype, **shape):
    """B1 against its plain version (the output type's tolerance) and
    against B6's probabilities, which take the same operations: equal bit
    for bit."""
    q, k, pq, pe, mask = _inputs(gen, t, dtype, **shape)
    b, h = q.shape[0], q.shape[2]
    n = att.rel_attention_probs.launches
    out = att.rel_attention_probs(q, k, pq, pe, mask, out_dtype=out_dtype)
    ref = att.rel_attention_probs_plain(q, k, pq, pe, mask, out_dtype=out_dtype)
    v = torch.randn((b, t, h, 12), generator=gen, device="cuda").to(dtype)
    probs6 = att.rel_attention_probs_consume(q, k, pq, pe, mask, v, out_dtype=out_dtype)[0]
    torch.cuda.synchronize()
    assert att.rel_attention_probs.launches == n + 1
    assert out.dtype == out_dtype and out.shape == (b, h, t, t)
    assert float((out.float() - ref.float()).abs().max()) <= TOL[out_dtype]
    assert torch.equal(out, probs6)


@pytest.mark.parametrize("t", [1, 17, 40, 127, 288, 577, 1024, 1408])
@pytest.mark.parametrize("dtype,out_dtype", _DTYPE_PAIRS)
def test_rel_probs_kernel_matches_plain(gen, t, dtype, out_dtype):
    """Any T: rows that do not start 16-byte aligned (17, 127, 577), one
    key group a thread (<= 1024) and more (1408)."""
    _check_rel_probs(gen, t, dtype, out_dtype)


@pytest.mark.parametrize("t", [4000, 8000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rel_probs_kernel_long_t(gen, t, dtype):
    """Long T: the scores of 16 rows do not fit in shared memory, so the
    kernel takes tiles of fewer rows (8 at T=4000) or of one row with an
    unpadded band (T=8000)."""
    _check_rel_probs(gen, t, dtype, dtype, b=1, h=1)


@pytest.mark.parametrize("qd", [8, 16, 24, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rel_probs_kernel_other_head_dims(gen, qd, dtype):
    """QD 8, 16, 24 (4 keys a thread; QD / 4 = 6 at 24) and 64 (2 keys a
    thread)."""
    _check_rel_probs(gen, 577, dtype, dtype, qd=qd)


@pytest.mark.parametrize("t", [1, 63, 64, 65, 577, 1152])
@pytest.mark.parametrize("vd", [4, 8, 12, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_probs_apply_kernel_matches_plain(gen, t, vd, dtype):
    """Every row is written at any T: the edges of a 64-row block and of a
    16-row tile (63, 64, 65), rows not 16-byte aligned (577) and two staged
    key chunks (1152 = 9 x 128)."""
    q, k, pq, pe, mask = _inputs(gen, t, dtype)
    probs = att.rel_attention_probs_plain(q, k, pq, pe, mask)
    v = torch.randn((2, t, 4, vd), generator=gen, device="cuda").to(dtype)
    n = att.rel_attention_probs_apply.launches
    out = att.rel_attention_probs_apply(probs, v)
    ref = att.rel_attention_probs_apply_plain(probs, v)
    torch.cuda.synchronize()
    assert att.rel_attention_probs_apply.launches == n + 1
    scale = max(1.0, float(ref.float().abs().max()))
    assert float((out.float() - ref.float()).abs().max()) <= TOL[dtype] * scale


def test_kernels_refuse_what_they_do_not_take(gen):
    q, k, pq, pe, mask = _inputs(gen, 16, torch.float32)
    with pytest.raises(ValueError):
        att.rel_attention_probs(q, k, pq, pe[:-1], mask)
    with pytest.raises(RuntimeError, match="launch failed"):
        att.rel_attention_probs(q[..., :12], k[..., :12], pq, pe, mask)  # qd=12
    probs = att.rel_attention_probs(q, k, pq, pe, mask)
    with pytest.raises(ValueError):
        att.rel_attention_probs_apply(probs, torch.zeros((2, 16, 4, 12), device="cuda",
                                                         dtype=torch.bfloat16))


def _train_inputs(gen, t, dtype, h=4, vd=12):
    q, k, pq, pe, mask = _inputs(gen, t, dtype, h=h)
    v = torch.randn((2, t, h, vd), generator=gen, device="cuda").to(dtype)
    g = torch.randn((2, t, h, vd), generator=gen, device="cuda").to(dtype)
    return q, k, pq, pe, mask, v, g


def _rel(out, ref):
    return float((out.float() - ref.float()).abs().max()) / max(1.0, float(ref.abs().max()))


@pytest.mark.parametrize("t,h,vd", [(1, 4, 12), (40, 4, 12), (63, 4, 12), (65, 4, 12),
                                    (577, 4, 12), (300, 1, 384), (120, 1, 144)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pen,gate", [(0.0, False), (1e-2, False), (0.0, True)])
def test_rel_apply_bwd_kernel_matches_plain(gen, t, h, vd, dtype, pen, gate):
    """B3: every gradient within 1e-4 of its max (f32 sums over T keys in
    another order; dpe by atomics).  The penalty limit sits in a gap of the
    scores so that rounding cannot flip an element across it."""
    q, k, pq, pe, mask, v, g = _train_inputs(gen, t, dtype, h, vd)
    s = att.rel_scores_plain(q, k, pq, pe).abs().flatten().sort(descending=True).values
    limit = float(s[min(len(s) - 1, 5)]) - 1e-3 if pen else 25.0
    n = att.rel_attention_consume_bwd.launches
    outs = att.rel_attention_consume_bwd(q, k, pq, pe, mask, v, g, pen, limit, gate)
    refs = att.rel_attention_consume_bwd_plain(q, k, pq, pe, mask, v, g, pen, limit, gate)
    torch.cuda.synchronize()
    assert att.rel_attention_consume_bwd.launches == n + 1
    for o, r in zip(outs, refs):
        assert o.shape == r.shape and _rel(o, r) <= 1e-4


@pytest.mark.parametrize("t,h,vd", [(577, 4, 12), (300, 1, 384)])
def test_rel_apply_bwd_const_gate_support_is_b1s(gen, t, h, vd):
    """With the const gate, B3's dv is the normalised support (p > 0) of the
    B1 kernel's own f32 probabilities, transposed, times g: B3 recomputes
    the support with B1's operations (within f32 rounding of the sum)."""
    q, k, pq, pe, mask, v, g = _train_inputs(gen, t, torch.float32, h, vd)
    q, k = 1.5 * q, 1.5 * k  # a wide score range: some p underflow to 0
    probs = att.rel_attention_probs(q, k, pq, pe, mask)
    ref = torch.einsum("bhts,bthd->bshd", att._const_probs(probs), g)
    dv = att.rel_attention_consume_bwd(q, k, pq, pe, mask, v, g, const_gate=True)[4]
    torch.cuda.synchronize()
    assert _rel(dv, ref) <= 1e-6


# B4's shapes (B, H, T, QD): rows that do not start 16-byte aligned (1, 17,
# 40, 577), the training shape, a bucket with fewer rows a block (1152), the
# long T of 8-, 4- and 1-row tiles with g staged (2000, 4000, 8000) and of
# 1-row tiles with g read from device memory (10000), and the other head
# dims
_DS_CASES = ([(2, 4, t, 32) for t in (1, 17, 40, 577, 1024, 1152)] + [(8, 4, 1024, 32)]
             + [(1, 1, t, 32) for t in (2000, 4000, 8000, 10000)]
             + [(2, 4, 577, qd) for qd in (8, 16, 24, 64)])


@pytest.mark.parametrize("b,h,t,qd", _DS_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pen", [0.0, 1e-2])
def test_rel_ds_kernel_matches_plain(gen, b, h, t, qd, dtype, pen):
    """B4 with the failsafe off and on: f32 within 2e-5, bf16 one unit in
    the last place of ds (relative to its max)."""
    q, k, pq, pe, mask = _inputs(gen, t, dtype, b=b, h=h, qd=qd)
    gp = torch.randn((b, h, t, t), generator=gen, device="cuda").to(dtype)
    n = att.rel_attention_ds.launches
    ds = att.rel_attention_ds(q, k, pq, pe, mask, gp, pen, 25.0)
    ref = att.rel_attention_ds_plain(q, k, pq, pe, mask, gp, pen, 25.0)
    torch.cuda.synchronize()
    assert att.rel_attention_ds.launches == n + 1
    assert ds.dtype == dtype and _rel(ds, ref) <= TOL[dtype]


@pytest.mark.parametrize("b,h,t", [(2, 4, 577), (1, 1, 10000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rel_ds_kernel_twice_equal_bits(gen, b, h, t, dtype):
    """No atomics and no order that changes between launches: two launches
    give the same bits."""
    q, k, pq, pe, mask = _inputs(gen, t, dtype, b=b, h=h)
    gp = torch.randn((b, h, t, t), generator=gen, device="cuda").to(dtype)
    first = att.rel_attention_ds(q, k, pq, pe, mask, gp, 1e-2, 25.0)
    assert torch.equal(first, att.rel_attention_ds(q, k, pq, pe, mask, gp, 1e-2, 25.0))


def _gap_limit(q, k, pq, pe) -> float:
    """A penalty limit that a few hundred |scores| cross, in a gap of at
    least 1e-3 between two of them, so that the kernel's and the plain
    version's f32 rounding cannot put a score on different sides."""
    top = torch.topk(att.rel_scores_plain(q, k, pq, pe).abs().flatten(), 1000).values
    for i in range(200, 999):
        if float(top[i] - top[i + 1]) > 1e-3:
            return float(top[i] + top[i + 1]) / 2
    raise AssertionError("no gap in the top scores")


@pytest.mark.parametrize("b,h,t", [(2, 4, 40), (2, 4, 577), (2, 4, 1024), (1, 1, 10000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rel_ds_kernel_penalty_alone(gen, b, h, t, dtype):
    """With g = 0, ds is exactly the failsafe penalty pen * sign(s) * (|s| >
    limit) on the pre-mask scores, padded keys included."""
    q, k, pq, pe, mask = _inputs(gen, t, dtype, b=b, h=h)
    limit = _gap_limit(q, k, pq, pe)
    ds = att.rel_attention_ds(q, k, pq, pe, mask, torch.zeros((b, h, t, t), device="cuda",
                                                               dtype=dtype), 1e-2, limit)
    want = att._penalty_term(att.rel_scores_plain(q, k, pq, pe), 1e-2, limit).to(dtype)
    torch.cuda.synchronize()
    assert torch.equal(ds, want)
    assert bool((want != 0)[mask[:, None, None, :].expand_as(want)].any())  # padded keys


@pytest.mark.parametrize("b,h,t", [(2, 4, 17), (2, 4, 577), (2, 4, 1024), (1, 1, 10000)])
def test_rel_ds_kernel_one_hot_cotangent(gen, b, h, t):
    """With g one-hot at key j of each row and no penalty, ds = p_j (delta_j
    - p), p being B1's kernel's probabilities at the same inputs: B4 takes
    B1's scores and softmax, and dot = p_j exactly, so only the two f32
    roundings of the product remain."""
    q, k, pq, pe, mask = _inputs(gen, t, torch.float32, b=b, h=h)
    j = torch.randint(0, t, (b, h, t, 1), generator=gen, device="cuda")
    g = torch.zeros((b, h, t, t), device="cuda").scatter_(-1, j, 1.0)
    ds = att.rel_attention_ds(q, k, pq, pe, mask, g)
    p = att.rel_attention_probs(q, k, pq, pe, mask)
    want = p * (g - torch.gather(p, -1, j))
    torch.cuda.synchronize()
    assert float((ds - want).abs().max()) <= 2 ** -24 * float(want.abs().max())


# rectangular tiles of B3 and B4 (Tq, Tk, r0): query rows [r0, r0 + Tq) of a
# Tk-frame problem against every key, pe the window pe[Tk - r0 - Tq : 2 Tk
# - 1 - r0]; the sequence-parallel training step's stack-0 halves (B=8 at
# T=1024), a ragged tile, a text-encoder-sized one and a single row
_RECT_CASES = [(512, 1024, 0), (512, 1024, 512), (100, 577, 333), (20, 40, 20), (1, 17, 5)]


def _rect(gen, tq, tk, r0, dtype, b=2, h=4, vd=12):
    """A tile's inputs: q, pq, g of its rows; k, v, the key mask of every
    key; pe's window; and the probabilities' cotangent (B, H, Tq, Tk)."""
    q, k, pq, pe, mask = _inputs(gen, tk, dtype, b=b, h=h)
    v = torch.randn((b, tk, h, vd), generator=gen, device="cuda").to(dtype)
    g = torch.randn((b, tq, h, vd), generator=gen, device="cuda").to(dtype)
    gp = torch.randn((b, h, tq, tk), generator=gen, device="cuda").to(dtype)
    rows = slice(r0, r0 + tq)
    return (q[:, rows].contiguous(), k, pq[:, rows].contiguous(),
            pe[tk - r0 - tq: 2 * tk - 1 - r0].contiguous(), mask, v, g, gp)


@pytest.mark.parametrize("tq,tk,r0", _RECT_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pen", [0.0, 1e-2])
def test_rel_ds_kernel_rectangular_matches_plain(gen, tq, tk, r0, dtype, pen):
    """B4 on a rectangular tile against its plain version (the square
    tolerances), and with a one-hot cotangent against B1's rectangular
    probabilities (B4 takes B1's scores and softmax on the same tile)."""
    q, k, pq, pe, mask, _, _, gp = _rect(gen, tq, tk, r0, dtype)
    n = att.rel_attention_ds.launches
    ds = att.rel_attention_ds(q, k, pq, pe, mask, gp, pen, 25.0)
    ref = att.rel_attention_ds_plain(q, k, pq, pe, mask, gp, pen, 25.0)
    torch.cuda.synchronize()
    assert att.rel_attention_ds.launches == n + 1
    assert ds.shape == (2, 4, tq, tk) and _rel(ds, ref) <= TOL[dtype]
    if dtype == torch.float32 and not pen:
        j = torch.randint(0, tk, (2, 4, tq, 1), generator=gen, device="cuda")
        hot = torch.zeros((2, 4, tq, tk), device="cuda").scatter_(-1, j, 1.0)
        p = att.rel_attention_probs(q, k, pq, pe, mask)
        want = p * (hot - torch.gather(p, -1, j))
        got = att.rel_attention_ds(q, k, pq, pe, mask, hot)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= 2 ** -24 * float(want.abs().max())


@pytest.mark.parametrize("tq,tk,r0", _RECT_CASES)
@pytest.mark.parametrize("h,vd", [(4, 12), (1, 384)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pen,gate", [(0.0, False), (1e-2, False), (0.0, True)])
def test_rel_apply_bwd_kernel_rectangular_matches_plain(gen, tq, tk, r0, h, vd, dtype, pen,
                                                        gate):
    """B3 on a rectangular tile: dq, dpq over the Tq rows, dk, dv over the
    Tk keys and dpe over the Tq + Tk - 1 band rows, each within 1e-4 of its
    max of the plain version's (the square tolerance)."""
    q, k, pq, pe, mask, v, g, _ = _rect(gen, tq, tk, r0, dtype, h=h, vd=vd)
    s = att.rel_scores_plain(q, k, pq, pe).abs().flatten().sort(descending=True).values
    limit = float(s[min(len(s) - 1, 5)]) - 1e-3 if pen else 25.0
    n = att.rel_attention_consume_bwd.launches
    outs = att.rel_attention_consume_bwd(q, k, pq, pe, mask, v, g, pen, limit, gate)
    refs = att.rel_attention_consume_bwd_plain(q, k, pq, pe, mask, v, g, pen, limit, gate)
    torch.cuda.synchronize()
    assert att.rel_attention_consume_bwd.launches == n + 1
    assert outs[3].shape == (tq + tk - 1, h, 4) and outs[1].shape == (2, tk, h, 32)
    for o, r in zip(outs, refs):
        assert o.shape == r.shape and _rel(o, r) <= 1e-4


@pytest.mark.parametrize("tq,tk,r0", _RECT_CASES)
@pytest.mark.parametrize("dtype,out_dtype", _DTYPE_PAIRS)
def test_probs_consume_kernel_rectangular_matches_plain(gen, tq, tk, r0, dtype, out_dtype):
    """B6 on a rectangular tile: its probabilities are B1's on the same
    tile bit for bit and within the probs dtype's tolerance of plain; its
    output (B, Tq, H, vd) within the square test's tolerances."""
    q, k, pq, pe, mask, v, _, _ = _rect(gen, tq, tk, r0, dtype)
    n = att.rel_attention_probs_consume.launches
    probs, out = att.rel_attention_probs_consume(q, k, pq, pe, mask, v, out_dtype=out_dtype)
    ref_p, ref_o = att.rel_attention_probs_consume_plain(q, k, pq, pe, mask, v, out_dtype)
    torch.cuda.synchronize()
    assert att.rel_attention_probs_consume.launches == n + 1
    assert probs.shape == (2, 4, tq, tk) and out.shape == (2, tq, 4, 12)
    assert torch.equal(probs, att.rel_attention_probs(q, k, pq, pe, mask, out_dtype=out_dtype))
    assert float((probs.float() - ref_p.float()).abs().max()) <= TOL[out_dtype]
    assert _rel(out, att.rel_attention_probs_apply_plain(probs, v)) <= TOL[dtype]
    assert _rel(out, ref_o) <= max(TOL[dtype], TOL[out_dtype])


@pytest.mark.parametrize("tq,tk,r0", _RECT_CASES)
@pytest.mark.parametrize("c", [384, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head0_consume_kernel_rectangular_matches_plain(gen, tq, tk, r0, c, dtype):
    """B7 on a rectangular tile: (B, Tq, C) from v (B, Tk, C), within the
    square test's tolerance of its plain version."""
    q, k, pq, pe, mask, _, _, _ = _rect(gen, tq, tk, r0, dtype)
    v = torch.randn((2, tk, c), generator=gen, device="cuda").to(dtype)
    n = att.rel_attention_head0_consume.launches
    out = att.rel_attention_head0_consume(q, k, pq, pe, mask, v)
    ref = att.rel_attention_head0_consume_plain(q, k, pq, pe, mask, v)
    torch.cuda.synchronize()
    assert att.rel_attention_head0_consume.launches == n + 1
    assert out.shape == (2, tq, c) and _rel(out, ref) <= TOL[dtype]


# B9 on rows [r0, r0 + T) of a T_all-frame sequence with K // 2 halo rows a
# side (zeros past the sequence): a rank's halves at 1024 frames, a block
# in the middle, ragged blocks and a single row
_HALO_CASES = [(512, 1024, 0, 31), (512, 1024, 512, 31), (100, 300, 100, 15),
               (17, 51, 34, 7), (1, 3, 1, 3)]


@pytest.mark.parametrize("t,t_all,r0,kernel", _HALO_CASES)
def test_conv_glu_kernel_halo_matches_f64(gen, t, t_all, r0, kernel):
    """B9 with halo rows: f32 within 2e-5 of the f64 plain version on the
    same rows and of the f64 plain version's rows [r0, r0 + T) on the whole
    sequence; bf16 within one unit in the last place of the bf16 plain
    version."""
    from zipvoice_tpu_torch.ops.convglu import conv_glu_swoosh_out, conv_glu_swoosh_out_plain

    c, h = 512, kernel // 2
    proj_all = torch.randn((2, t_all, 2 * c), generator=gen, device="cuda")
    w = 0.2 * torch.randn((c, 1, kernel), generator=gen, device="cuda")
    b = 0.1 * torch.randn((c,), generator=gen, device="cuda")
    w_out = 0.05 * torch.randn((c, c), generator=gen, device="cuda")
    b_out = 0.1 * torch.randn((c,), generator=gen, device="cuda")
    mask_all = torch.arange(t_all, device="cuda")[None, :] >= torch.tensor(
        [t_all, t_all - t_all // 3 - 1], device="cuda")[:, None]
    window = slice(r0, r0 + t + 2 * h)
    proj = torch.nn.functional.pad(proj_all, (0, 0, h, h))[:, window].contiguous()
    mask = torch.nn.functional.pad(mask_all, (h, h), value=False)[:, window].contiguous()
    args = (w, b, mask, w_out, b_out, h)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref = conv_glu_swoosh_out_plain(proj.double(), *args)
        whole = conv_glu_swoosh_out_plain(proj_all.double(), w, b, mask_all, w_out, b_out)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    n = conv_glu_swoosh_out.launches
    out = conv_glu_swoosh_out(proj, *args)
    out16 = conv_glu_swoosh_out(proj.bfloat16(), *args)
    ref16 = conv_glu_swoosh_out_plain(proj.bfloat16(), *args)
    torch.cuda.synchronize()
    assert conv_glu_swoosh_out.launches == n + 2
    assert out.shape == (2, t, c)
    assert _rel(out, ref) <= 2e-5 and _rel(out, whole[:, r0:r0 + t]) <= 2e-5
    assert _rel(out16, ref16) <= TOL[torch.bfloat16]


def _log_mel_input(gen, b, samples, n_fft, zero_rows=0):
    """(b, samples) audio, its last zero_rows rows zero (a padded batch),
    reflect-padded by n_fft/2 on both sides as the fbank collator pads it."""
    wav = 0.1 * torch.randn((b, samples), generator=gen, device="cuda")
    if zero_rows:
        wav[-zero_rows:] = 0.0
    return torch.nn.functional.pad(wav[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]


# B8's (B, samples, n_fft, hop, n_mels, zero rows): 0.05, 1 and 10 s; the
# training shape, B=8 and 1153 frames (1152 * 256 samples) with the batch
# bucket's zero rows; an odd sample count (rows start off a 16-byte
# boundary); other FFT sizes and mel counts, down to n_fft 16
_LOG_MEL_CASES = [(3, 1200, 1024, 256, 100, 0), (3, 24000, 1024, 256, 100, 0),
                  (3, 240000, 1024, 256, 100, 0), (8, 1152 * 256, 1024, 256, 100, 3),
                  (3, 24001, 1024, 256, 100, 0), (3, 24000, 1024, 256, 20, 0),
                  (3, 24000, 512, 128, 80, 0), (3, 24000, 256, 64, 40, 0),
                  (3, 4001, 16, 4, 4, 0)]


@pytest.mark.parametrize("b,samples,n_fft,hop,n_mels,zero_rows", _LOG_MEL_CASES)
def test_log_mel_kernel_matches_plain(gen, b, samples, n_fft, hop, n_mels, zero_rows):
    """B8 at any frame count, FFT size and mel count: log-mel within 1e-3
    (f32 FFT sums in another order than the plain DFT products)."""
    from zipvoice_tpu_torch.ops.melspec import fused_log_mel, fused_log_mel_plain

    wp = _log_mel_input(gen, b, samples, n_fft, zero_rows)
    n = fused_log_mel.launches
    out = fused_log_mel(wp, 24000, n_fft, hop, n_mels)
    ref = fused_log_mel_plain(wp, 24000, n_fft, hop, n_mels)
    torch.cuda.synchronize()
    assert fused_log_mel.launches == n + 1
    assert out.shape == ref.shape == (b, (wp.shape[1] - n_fft) // hop + 1, n_mels)
    assert float((out - ref).abs().max()) <= 1e-3


@pytest.mark.parametrize("b,samples", [(3, 24001), (8, 1152 * 256)])
def test_log_mel_kernel_twice_equal_bits(gen, b, samples):
    from zipvoice_tpu_torch.ops.melspec import fused_log_mel

    wp = _log_mel_input(gen, b, samples, 1024)
    assert torch.equal(fused_log_mel(wp), fused_log_mel(wp))


def test_log_mel_kernel_zero_rows_are_clamped(gen):
    """Every frame of an all-zero row is log(1e-7) to one f32 unit in the
    last place, in the kernel and in the plain version."""
    from zipvoice_tpu_torch.ops.melspec import fused_log_mel, fused_log_mel_plain

    wp = _log_mel_input(gen, 8, 1152 * 256, 1024, zero_rows=3)
    want = torch.log(torch.tensor(1e-7, dtype=torch.float32)).item()
    ulp = float(torch.finfo(torch.float32).eps) * abs(want)
    for out in (fused_log_mel(wp), fused_log_mel_plain(wp)):
        zero = out[-3:]
        assert float((zero - want).abs().max()) <= ulp
        assert float(out[:-3].min()) > want + 1.0


def test_log_mel_kernel_refuses_what_it_does_not_take(gen):
    from zipvoice_tpu_torch.ops.melspec import fused_log_mel

    wp = _log_mel_input(gen, 2, 4000, 1024)
    with pytest.raises(RuntimeError, match="launch failed"):  # not a power of two
        fused_log_mel(wp, 24000, 1000, 256, 100)
    with pytest.raises(RuntimeError, match="launch failed"):  # above 1024
        fused_log_mel(wp, 24000, 2048, 256, 100)
    with pytest.raises(ValueError):
        fused_log_mel(wp[:, :1000])
    with pytest.raises(ValueError):
        fused_log_mel(wp.double())
    with pytest.raises(ValueError):
        fused_log_mel(wp[0])


# B6's (T, VD, B, H): the serving T at the fm_decoder's VD = 12; other value
# widths, with v staged once a block (T = 40, and VD 4 / 16 at T = 1024) or
# streamed through a chunk of keys (VD 64 / 96 at T = 1024); long T at
# B = H = 1 (v streamed, fewer rows a tile; the 1-row tile at T = 8000)
_CONSUME_CASES = ([(t, 12, 2, 4) for t in (1, 17, 40, 288, 577, 1024, 1408)]
                  + [(t, vd, 2, 4) for vd in (4, 16, 64, 96) for t in (40, 1024)]
                  + [(4000, 12, 1, 1), (8000, 12, 1, 1)])


@pytest.mark.parametrize("t,vd,b,h", _CONSUME_CASES)
@pytest.mark.parametrize("dtype,out_dtype", _DTYPE_PAIRS)
def test_probs_consume_kernel_matches_plain(gen, t, vd, b, h, dtype, out_dtype):
    """B6: its probabilities are B1's bit for bit (and within the probs
    dtype's tolerance of plain); its output within v's dtype's tolerance
    (of the output's scale) of the plain contraction of those rounded
    probabilities, and within the coarser of the two dtypes' tolerances of
    the plain version end to end (bf16 probabilities that round the other
    way than plain's move an f32 output by up to a bf16 unit); a second
    launch on the same inputs gives the same bits (no atomics)."""
    q, k, pq, pe, mask = _inputs(gen, t, dtype, b=b, h=h)
    v = torch.randn((b, t, h, vd), generator=gen, device="cuda").to(dtype)
    n = att.rel_attention_probs_consume.launches
    probs, out = att.rel_attention_probs_consume(q, k, pq, pe, mask, v, out_dtype=out_dtype)
    probs2, out2 = att.rel_attention_probs_consume(q, k, pq, pe, mask, v, out_dtype=out_dtype)
    ref_p, ref_o = att.rel_attention_probs_consume_plain(q, k, pq, pe, mask, v, out_dtype)
    torch.cuda.synchronize()
    assert att.rel_attention_probs_consume.launches == n + 2
    assert probs.dtype == out_dtype and probs.shape == (b, h, t, t)
    assert torch.equal(probs, att.rel_attention_probs(q, k, pq, pe, mask, out_dtype=out_dtype))
    assert float((probs.float() - ref_p.float()).abs().max()) <= TOL[out_dtype]
    assert out.dtype == dtype and out.shape == (b, t, h, vd)
    assert _rel(out, att.rel_attention_probs_apply_plain(probs, v)) <= TOL[dtype]
    assert _rel(out, ref_o) <= max(TOL[dtype], TOL[out_dtype])
    assert torch.equal(probs2, probs) and torch.equal(out2, out)


@pytest.mark.parametrize("t", [1, 17, 40, 288, 577, 1024, 1408])
@pytest.mark.parametrize("c", [384, 144, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head0_consume_kernel_matches_plain(gen, t, c, dtype):
    """B7 at the NonlinAttention widths (fm_decoder 384, text encoder 144)
    and a width that is a multiple of 4 but not of 8 (100: 8-byte copies in
    bf16, a ragged last column tile); short T splits C over the grid, and
    T = 1408 is the longest serving bucket.  The second batch row's last
    third is padded."""
    q, k, pq, pe, mask = _inputs(gen, t, dtype)
    v = torch.randn((2, t, c), generator=gen, device="cuda").to(dtype)
    n = att.rel_attention_head0_consume.launches
    out = att.rel_attention_head0_consume(q, k, pq, pe, mask, v)
    ref = att.rel_attention_head0_consume_plain(q, k, pq, pe, mask, v)
    torch.cuda.synchronize()
    assert att.rel_attention_head0_consume.launches == n + 1
    assert out.shape == (2, t, c) and _rel(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("t,h,vd", [(1, 4, 12), (40, 4, 12), (577, 4, 12), (300, 1, 384)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gate", [False, True])
def test_rel_apply_kernel_matches_plain(gen, t, h, vd, dtype, gate):
    """B5 forward against its plain version, and (f32) its gradients, B3's,
    against plain autograd: within 1e-4 of each gradient's scale."""
    q, k, pq, pe, mask, v, g = _train_inputs(gen, t, dtype, h, vd)
    n = att.rel_attention_apply.launches
    out = att.rel_attention_apply(q, k, pq, pe, mask, v, out_dtype=torch.float32,
                                  const_gate=gate)
    ref = att.rel_attention_apply_plain(q, k, pq, pe, mask, v, torch.float32, gate)
    torch.cuda.synchronize()
    assert att.rel_attention_apply.launches == n + 1
    assert out.dtype == torch.float32 and _rel(out, ref) <= TOL[dtype]
    if dtype != torch.float32:
        return
    xs = [x.clone().requires_grad_() for x in (q, k, pq, pe, v)]
    ys = [x.clone().requires_grad_() for x in (q, k, pq, pe, v)]
    (att.rel_attention_apply(*xs[:4], mask, xs[4], const_gate=gate) * g).sum().backward()
    (att.rel_attention_apply_plain(*ys[:4], mask, ys[4], const_gate=gate) * g).sum().backward()
    for x, y in zip(xs, ys):  # the plain const branch leaves q, k, pq, pe without a grad
        assert _rel(x.grad, torch.zeros_like(y) if y.grad is None else y.grad) <= 1e-4


# B5's narrow route (vd <= 64) is B6's kernel body and epilogue without the
# probabilities' store: B6's cases of vd <= 64, v staged once a block or
# streamed (vd 64 at T=1024), fewer rows a tile and the 1-row tile at long T
_APPLY_NARROW_CASES = ([(t, 12, 2, 4) for t in (1, 17, 40, 288, 577, 1024, 1408)]
                       + [(t, vd, 2, 4) for vd in (4, 16, 64) for t in (40, 1024)]
                       + [(4000, 12, 1, 1), (8000, 12, 1, 1)])


@pytest.mark.parametrize("t,vd,b,h", _APPLY_NARROW_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rel_apply_narrow_equals_probs_consume(gen, t, vd, b, h, dtype):
    """Gate closed, out in v's dtype: B5's output is B6's bit for bit."""
    q, k, pq, pe, mask = _inputs(gen, t, dtype, b=b, h=h)
    v = torch.randn((b, t, h, vd), generator=gen, device="cuda").to(dtype)
    n = att.rel_attention_apply.launches
    out = att.rel_attention_apply(q, k, pq, pe, mask, v)
    ref = att.rel_attention_probs_consume(q, k, pq, pe, mask, v)[1]
    torch.cuda.synchronize()
    assert att.rel_attention_apply.launches == n + 1
    assert out.dtype == dtype and torch.equal(out, ref)


@pytest.mark.parametrize("t", [1, 17, 40, 288, 577, 1024, 1408])
@pytest.mark.parametrize("c", [384, 144, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rel_apply_wide_equals_head0_consume(gen, t, c, dtype):
    """At H=1 and vd > 64, gate closed, out in v's dtype: B5's output is
    B7's on v[:, :, 0] bit for bit (B7's widths and its ragged 100)."""
    q, k, pq, pe, mask = _inputs(gen, t, dtype, h=1)
    v = torch.randn((2, t, 1, c), generator=gen, device="cuda").to(dtype)
    out = att.rel_attention_apply(q, k, pq, pe, mask, v)
    ref = att.rel_attention_head0_consume(q, k, pq, pe, mask, v[:, :, 0].contiguous())
    torch.cuda.synchronize()
    assert out.dtype == dtype and torch.equal(out[:, :, 0], ref)


@pytest.mark.parametrize("t,h,vd", [(577, 4, 96), (40, 2, 384), (1024, 4, 12), (1024, 1, 384)])
@pytest.mark.parametrize("dtype,out_dtype", _DTYPE_PAIRS)
@pytest.mark.parametrize("gate", [False, True])
def test_rel_apply_every_head_matches_plain(gen, t, h, vd, dtype, out_dtype, gate):
    """Both routes at H > 1 (the wide one walks every head) and in every
    input / output type pair, against the plain version; with the gate
    open, also against the contraction of the const probabilities of B1's
    kernel, whose support p > 0 the kernel must take (one key more or less
    in a row moves its outputs by a 1 / count share)."""
    q, k, pq, pe, mask = _inputs(gen, t, dtype, h=h)
    v = torch.randn((2, t, h, vd), generator=gen, device="cuda").to(dtype)
    out = att.rel_attention_apply(q, k, pq, pe, mask, v, out_dtype=out_dtype, const_gate=gate)
    ref = att.rel_attention_apply_plain(q, k, pq, pe, mask, v, out_dtype, gate)
    torch.cuda.synchronize()
    tol = max(TOL[dtype], TOL[out_dtype])
    assert out.dtype == out_dtype and out.shape == (2, t, h, vd) and _rel(out, ref) <= tol
    if gate:
        probs = att.rel_attention_probs(q, k, pq, pe, mask, out_dtype=torch.float32)
        used = att._const_probs(probs).to(dtype)
        assert _rel(out, att.rel_attention_probs_apply_plain(used, v)) <= tol


@pytest.mark.parametrize("h,vd", [(4, 12), (1, 384)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gate", [False, True])
def test_rel_apply_long_t_matches_plain(gen, h, vd, dtype, gate):
    """T = 3072, the JAX export default's frame count, at both routes: the
    narrow one on fewer rows a tile, the wide one on fewer rows and two
    stages of v."""
    t = 3072
    q, k, pq, pe, mask = _inputs(gen, t, dtype, h=h)
    v = torch.randn((2, t, h, vd), generator=gen, device="cuda").to(dtype)
    out = att.rel_attention_apply(q, k, pq, pe, mask, v, out_dtype=torch.float32,
                                  const_gate=gate)
    ref = att.rel_attention_apply_plain(q, k, pq, pe, mask, v, torch.float32, gate)
    torch.cuda.synchronize()
    assert out.shape == (2, t, h, vd) and _rel(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("c,d,kernel,t", [(512, 512, 31, 1024), (512, 512, 15, 512),
                                          (512, 512, 7, 288), (192, 192, 9, 40),
                                          (512, 512, 31, 1), (512, 512, 31, 1408),
                                          (512, 512, 7, 17), (512, 256, 31, 300),
                                          (196, 196, 9, 100)])
@pytest.mark.parametrize("out_bias", [True, False])
def test_conv_glu_kernel_matches_f64(gen, c, d, kernel, t, out_bias):
    """B9 and its f32 plain version both within 2e-5 of an f64 plain version
    (relative to its scale); bf16 within one unit in the last place of the
    bf16 plain version.  Short T splits D over the grid; D != C; C = 196 is
    a multiple of 4 but not of 8 (8-byte copies of w_out in bf16)."""
    from zipvoice_tpu_torch.ops.convglu import conv_glu_swoosh_out, conv_glu_swoosh_out_plain

    proj = torch.randn((2, t, 2 * c), generator=gen, device="cuda")
    w = 0.2 * torch.randn((c, 1, kernel), generator=gen, device="cuda")
    b = 0.1 * torch.randn((c,), generator=gen, device="cuda")
    w_out = 0.05 * torch.randn((d, c), generator=gen, device="cuda")
    b_out = 0.1 * torch.randn((d,), generator=gen, device="cuda") if out_bias else None
    mask = torch.arange(t, device="cuda")[None, :] >= torch.tensor(
        [t, t - t // 3 - 1], device="cuda")[:, None]
    args = (w, b, mask, w_out, b_out)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref = conv_glu_swoosh_out_plain(proj.double(), *args)
        plain = conv_glu_swoosh_out_plain(proj, *args)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    n = conv_glu_swoosh_out.launches
    out = conv_glu_swoosh_out(proj, *args)
    out16 = conv_glu_swoosh_out(proj.bfloat16(), *args)
    ref16 = conv_glu_swoosh_out_plain(proj.bfloat16(), *args)
    torch.cuda.synchronize()
    assert conv_glu_swoosh_out.launches == n + 2
    assert out.shape == (2, t, d) and out16.dtype == torch.bfloat16
    assert _rel(out, ref) <= 2e-5 and _rel(plain, ref) <= 2e-5
    assert _rel(out16, ref16) <= TOL[torch.bfloat16]


def test_fused_kernels_refuse_what_they_do_not_take(gen):
    from zipvoice_tpu_torch.ops.convglu import conv_glu_swoosh_out

    q, k, pq, pe, mask = _inputs(gen, 16, torch.float32)
    with pytest.raises(ValueError, match="multiple of 4"):
        att.rel_attention_probs_consume(q, k, pq, pe, mask, torch.zeros((2, 16, 4, 10),
                                                                        device="cuda"))
    with pytest.raises(ValueError, match="not supported"):
        h = lambda x: x.half()  # noqa: E731
        att.rel_attention_head0_consume(h(q), h(k), h(pq), h(pe), mask,
                                        torch.zeros((2, 16, 384), device="cuda").half())
    with pytest.raises(RuntimeError, match="launch failed"):  # qd = 12 is not built
        att.rel_attention_apply(q[..., :12], k[..., :12], pq, pe, mask,
                                torch.zeros((2, 16, 4, 12), device="cuda"))
    with pytest.raises(ValueError, match="CUDA"):
        att.rel_attention_apply(q, k.cpu(), pq, pe, mask,
                                torch.zeros((2, 16, 4, 12), device="cuda"))
    proj = torch.zeros((2, 16, 12), device="cuda")
    w, b = torch.zeros((6, 1, 3), device="cuda"), torch.zeros((6,), device="cuda")
    with pytest.raises(RuntimeError, match="launch failed"):  # C = 6 is not a multiple of 4
        conv_glu_swoosh_out(proj, w, b, mask, torch.zeros((6, 6), device="cuda"))
    with pytest.raises(ValueError):
        conv_glu_swoosh_out(proj.half(), w, b, mask, torch.zeros((6, 6), device="cuda"))
    with pytest.raises(ValueError):
        conv_glu_swoosh_out(proj, w.cpu(), b, mask, torch.zeros((6, 6), device="cuda"))
