"""B5's plain version (``rel_attention_apply_plain``) against B6's and B7's
on the CPU: the identities that B5's two kernel routes are held to bit for
bit on the card (a narrow vd on B6's kernel body without its probabilities'
store, a wide vd on B7's kernel walked over every head), pinned here on the
plain versions.  With the const gate open, B6 and B7 have no counterpart:
there B5 equals their contraction of the const-attention probabilities,
the support of B1's f32 probabilities normalised, rounded to v's dtype."""

import os

import numpy as np
import pytest
import torch

from zipvoice_tpu_torch.ops import attention as att

# torch's CPU ops share one OpenMP pool a process; pytest-xdist runs a
# process a worker, and pools sized to every core oversubscribe the machine
# by the worker count
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

DTYPES = [torch.float32, torch.bfloat16]
# a narrow vd (B6's route) and a wide one (> 64: B7's route)
VDS = [12, 96]


def _inputs(t, h, vd, dtype, seed):
    """q, k, pq, pe, mask (the second row's last third padded), v."""
    r = np.random.default_rng(seed)

    def rnd(*shape):
        return torch.from_numpy(r.standard_normal(shape).astype(np.float32)).to(dtype)

    mask = torch.from_numpy(np.arange(t)[None, :] >= np.array([t, t - t // 3 - 1])[:, None])
    return (rnd(2, t, h, 32), rnd(2, t, h, 32), rnd(2, t, h, 4), rnd(2 * t - 1, h, 4), mask,
            rnd(2, t, h, vd))


def _const_used(q, k, pq, pe, mask, dtype):
    """The const branch's probabilities: the support of B1's f32
    probabilities, row-normalised, rounded to v's dtype."""
    probs = att.rel_attention_probs_plain(q, k, pq, pe, mask, out_dtype=torch.float32)
    return att._const_probs(probs).to(dtype)


@pytest.mark.parametrize("vd", VDS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("t", [7, 24])
def test_plain_apply_equals_probs_consume(t, gate, dtype, vd):
    """Gate closed and out in v's dtype: B5's output is B6's
    (``rel_attention_probs_consume(...)[1]``) bit for bit; gate open: B6's
    contraction (B2's plain version) of the const probabilities.  CPU
    tensors launch nothing."""
    q, k, pq, pe, mask, v = _inputs(t, 4, vd, dtype, seed=t + vd)
    before = (att.rel_attention_apply.launches, att.rel_attention_probs_consume.launches)
    out = att.rel_attention_apply(q, k, pq, pe, mask, v, const_gate=gate)
    if gate:
        ref = att.rel_attention_probs_apply_plain(_const_used(q, k, pq, pe, mask, dtype), v)
    else:
        ref = att.rel_attention_probs_consume(q, k, pq, pe, mask, v, out_dtype=dtype)[1]
    assert (att.rel_attention_apply.launches,
            att.rel_attention_probs_consume.launches) == before
    assert out.dtype == dtype and out.shape == (2, t, 4, vd)
    assert torch.isfinite(out.float()).all()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("vd", VDS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("t", [7, 24])
def test_plain_apply_equals_head0_consume(t, gate, dtype, vd):
    """At H=1: B5's output is B7's on v[:, :, 0] bit for bit (gate closed),
    or B7's contraction of the const probabilities (gate open)."""
    q, k, pq, pe, mask, v = _inputs(t, 1, vd, dtype, seed=2 * t + vd)
    before = att.rel_attention_head0_consume.launches
    out = att.rel_attention_apply(q, k, pq, pe, mask, v, const_gate=gate)
    v0 = v[:, :, 0]
    if gate:
        used = _const_used(q, k, pq, pe, mask, dtype)[:, 0]
        ref = torch.einsum("bts,bsc->btc", used.float(), v0.float()).to(dtype)
    else:
        ref = att.rel_attention_head0_consume(q, k, pq, pe, mask, v0)
    assert att.rel_attention_head0_consume.launches == before
    assert out.shape == (2, t, 1, vd)
    assert torch.equal(out[:, :, 0], ref)


@pytest.mark.parametrize("vd", VDS)
@pytest.mark.parametrize("gate", [False, True])
def test_plain_apply_out_dtype_rounds_once(gate, vd):
    """bf16 inputs with an f32 output: the probabilities are rounded to v's
    dtype and the f32 sums are not rounded again, so the bf16 output is the
    f32 one rounded."""
    q, k, pq, pe, mask, v = _inputs(24, 2, vd, torch.bfloat16, seed=vd)
    out32 = att.rel_attention_apply(q, k, pq, pe, mask, v, out_dtype=torch.float32,
                                    const_gate=gate)
    out16 = att.rel_attention_apply(q, k, pq, pe, mask, v, const_gate=gate)
    assert out32.dtype == torch.float32 and out16.dtype == torch.bfloat16
    assert torch.equal(out32.to(torch.bfloat16), out16)
