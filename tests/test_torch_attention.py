"""Plain B1/B2 of zipvoice_tpu_torch.ops.attention against the JAX kernels
run in interpret mode (as tests/test_attention_kernel.py runs them) and
against the JAX XLA path, at T in {40, 128, 200}, f32, within 1e-5.

The kernel wrappers take the plain version only for CPU tensors; these
tests also pin that a CPU call never counts as a kernel launch."""

import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zipvoice_tpu.nn.functional import masked_softmax
from zipvoice_tpu.nn.zipformer import _rel_shift
from zipvoice_tpu.ops.attention import (
    rel_attention_probs_any,
    rel_attention_probs_apply as jax_probs_apply,
)
from zipvoice_tpu_torch.ops import attention as ta

# torch's CPU ops share one OpenMP pool a process; pytest-xdist runs a
# process a worker, and pools sized to every core oversubscribe the machine
# by the worker count, which slows torch's ops by orders of magnitude
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

TOL = 1e-5
H, QD, PD, VD = 4, 32, 4, 12


def _inputs(t, with_mask, seed=0, b=2):
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, t, H, QD)).astype(np.float32)
    k = r.standard_normal((b, t, H, QD)).astype(np.float32)
    pq = r.standard_normal((b, t, H, PD)).astype(np.float32)
    pe = r.standard_normal((2 * t - 1, H, PD)).astype(np.float32)
    # one batch row padded (ragged tail), one full
    mask = (np.arange(t)[None, :] >= np.array([t, max(1, t - t // 3 - 1)])[:, None]
            if with_mask else None)
    return q, k, pq, pe, mask


def _xla_path(q, k, pq, pe, mask):
    t = q.shape[1]
    attn = jnp.einsum("bthd,bshd->bhts", q, k, preferred_element_type=jnp.float32)
    pos = jnp.einsum("bthd,nhd->bhtn", pq, pe, preferred_element_type=jnp.float32)
    return masked_softmax(attn + _rel_shift(pos, t), mask)


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("t", [40, 128, 200])
@pytest.mark.parametrize("with_mask", [False, True])
def test_rel_probs_plain_matches_jax(t, with_mask):
    q, k, pq, pe, mask = _inputs(t, with_mask, seed=t)
    jargs = [jnp.asarray(a) for a in (q, k, pq, pe)]
    jmask = None if mask is None else jnp.asarray(mask)
    before = ta.rel_attention_probs.launches
    out = ta.rel_attention_probs(*_torch(q, k, pq, pe, mask),
                                 out_dtype=torch.float32).numpy()
    assert ta.rel_attention_probs.launches == before  # CPU: plain, no launch
    kern = np.asarray(rel_attention_probs_any(*jargs, jmask, out_dtype=jnp.float32,
                                              interpret=True))
    xla = np.asarray(_xla_path(*jargs, jmask))
    # every row has a real key, so additive and replacing masks agree
    assert np.abs(out - kern).max() < TOL
    assert np.abs(out - xla).max() < TOL
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=TOL)


def test_rel_probs_plain_odd_t_asymmetric_offsets():
    """Odd T, no mask, pe rows distinct per offset: pins the rel shift
    (pe row n encodes offset n - (T-1)) against a direct loop."""
    t = 7
    q, k, pq, pe, _ = _inputs(t, False, seed=3, b=1)
    out = ta.rel_attention_probs_plain(*_torch(q, k, pq, pe)).numpy()
    scores = np.einsum("bthd,bshd->bhts", q, k).astype(np.float64)
    for i in range(t):
        for j in range(t):
            scores[:, :, i, j] += np.einsum("bhd,hd->bh", pq[:, i], pe[j - i + t - 1])
    ref = np.exp(scores - scores.max(-1, keepdims=True))
    ref /= ref.sum(-1, keepdims=True)
    assert np.abs(out - ref).max() < TOL


@pytest.mark.parametrize("t", [40, 128, 200])
def test_probs_apply_plain_matches_jax(t):
    r = np.random.default_rng(t + 1)
    logits = r.standard_normal((2, H, t, t)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    v = r.standard_normal((2, t, H, VD)).astype(np.float32)
    before = ta.rel_attention_probs_apply.launches
    out = ta.rel_attention_probs_apply(*_torch(probs, v)).numpy()
    assert ta.rel_attention_probs_apply.launches == before
    ref = np.asarray(jnp.einsum("bhts,bshd->bthd", jnp.asarray(probs), jnp.asarray(v)))
    assert np.abs(out - ref).max() < TOL
    if t % 128 == 0:  # the Pallas kernel takes only T % 128 == 0
        kern = np.asarray(jax_probs_apply(jnp.asarray(probs), jnp.asarray(v),
                                          interpret=True))
        assert np.abs(out - kern).max() < TOL


def test_cpu_tensors_never_reach_a_kernel():
    """The CPU path is decided by the tensor's device: no build, no launch."""
    q, k, pq, pe, mask = _inputs(16, True, seed=9)
    n1, n2 = ta.rel_attention_probs.launches, ta.rel_attention_probs_apply.launches
    probs = ta.rel_attention_probs(*_torch(q, k, pq, pe, mask))
    v = torch.zeros((2, 16, H, VD))
    ta.rel_attention_probs_apply(probs, v)
    assert (ta.rel_attention_probs.launches, ta.rel_attention_probs_apply.launches) \
        == (n1, n2)


@pytest.mark.parametrize("tq", [1, 7, 64])
@pytest.mark.parametrize("where", ["start", "middle", "end"])
def test_rectangular_plain_equals_the_square_rows(tq, where):
    """Query rows [r0, r0 + Tq) against every key, with the window
    pe[T - r0 - Tq : 2T - 1 - r0] of the square pe (the sequence-parallel
    sampler's tile): plain B1 gives the square plain B1's rows (B, H, Tq,
    T), and plain B2 on them the square B2's rows, with one batch row's
    keys padded; the square calls keep their (B, H, T, T) and (B, T, H,
    vd) outputs."""
    t = 128
    q, k, pq, pe, mask = _torch(*_inputs(t, True, seed=tq))
    v = torch.from_numpy(np.random.default_rng(tq).standard_normal((2, t, H, VD))
                         .astype(np.float32))
    r0 = {"start": 0, "middle": (t - tq) // 2, "end": t - tq}[where]
    rows = slice(r0, r0 + tq)
    full = ta.rel_attention_probs(q, k, pq, pe, mask)
    full_out = ta.rel_attention_probs_apply(full, v)
    assert full.shape == (2, H, t, t) and full_out.shape == (2, t, H, VD)
    part = ta.rel_attention_probs(q[:, rows], k, pq[:, rows], pe[t - r0 - tq: 2 * t - 1 - r0],
                                  mask)
    assert part.shape == (2, H, tq, t)
    assert float((part - full[:, :, rows]).abs().max()) < TOL
    out = ta.rel_attention_probs_apply(part, v)
    assert out.shape == (2, tq, H, VD)
    assert float((out - full_out[:, rows]).abs().max()) < TOL
