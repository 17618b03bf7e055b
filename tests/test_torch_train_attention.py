"""The training backward of the port's attention against jax.grad on the
CPU, f32: the consume backward (B3's plain version) and the probs backward
(B4's plain version), with the score failsafe and the const-attention
branch, at T=128 and T=130, against autodiff of the JAX package's XLA
formulation (penalize_abs_values_gt on the scores, masked softmax, the
const branch under stop_gradient), within 5e-5; and the log-mel plain
version against fused_log_mel in interpret mode within 1e-4."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zipvoice_tpu.nn.functional import masked_softmax
from zipvoice_tpu.nn.regularizers import penalize_abs_values_gt
from zipvoice_tpu.nn.zipformer import _rel_shift
from zipvoice_tpu.ops.melspec import fused_log_mel as jax_fused_log_mel
from zipvoice_tpu_torch.ops import attention as ta
from zipvoice_tpu_torch.ops.melspec import fused_log_mel

# torch's CPU ops share one OpenMP pool a process; pytest-xdist runs a
# process a worker, and pools sized to every core oversubscribe the machine
# by the worker count, which slows torch's ops by orders of magnitude
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

TOL = 5e-5
PEN, LIMIT = 1e-2, 4.0  # a low limit so that many scores cross it


def _inputs(t, seed, b=2, h=2, qd=8, pd=4, vd=12):
    r = np.random.default_rng(seed)
    arrs = [r.standard_normal(s).astype(np.float32) for s in
            ((b, t, h, qd), (b, t, h, qd), (b, t, h, pd), (2 * t - 1, h, pd), (b, t, h, vd))]
    mask = np.arange(t)[None, :] >= np.array([t, t - 17])[:, None]
    return arrs, mask


def _jax_probs(q, k, pq, pe, mask, pen):
    t = q.shape[1]
    s = jnp.einsum("bthd,bshd->bhts", q, k) + _rel_shift(
        jnp.einsum("bthd,nhd->bhtn", pq, pe), t)
    if pen:
        s = penalize_abs_values_gt(s, jnp.asarray(True), limit=LIMIT, penalty=pen)
    return masked_softmax(s, mask)


def _grads_torch(fn, arrays):
    xs = [torch.tensor(a, requires_grad=True) for a in arrays]
    loss = fn(*xs)
    loss.backward()
    return float(loss.detach()), [x.grad.numpy() for x in xs]


def _check(ours, ref):
    (lo, go), (lr, gr) = ours, ref
    assert abs(lo - lr) <= 1e-5 * max(1.0, abs(lr))
    for name, a, b in zip("q k pq pe v".split(), go, gr):
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL, err_msg=name)


@pytest.mark.parametrize("t", [128, 130])
@pytest.mark.parametrize("pen,const_gate", [(0.0, False), (PEN, False), (0.0, True)])
def test_consume_backward_matches_jax_grad(t, pen, const_gate):
    (q, k, pq, pe, v), mask = _inputs(t, seed=t)
    mask_t = torch.from_numpy(mask)

    def loss_torch(q, k, pq, pe, v):
        with torch.no_grad():
            probs = ta.rel_attention_probs(q, k, pq, pe, mask_t)
            if const_gate:
                binary = (probs > 0).float()
                probs = binary / binary.sum(-1, keepdim=True).clamp(min=1e-20)
        o = ta.rel_attention_consume(q, k, pq, pe, mask_t, probs, v, score_penalty=pen,
                                     penalty_limit=LIMIT, const_gate=const_gate)
        return torch.sin(o).sum()

    def loss_jax(q, k, pq, pe, v):
        p = _jax_probs(q, k, pq, pe, jnp.asarray(mask), pen)
        if const_gate:
            binary = jax.lax.stop_gradient((p > 0.0).astype(p.dtype))
            p = binary / jnp.maximum(binary.sum(-1, keepdims=True), 1e-20)
        return jnp.sum(jnp.sin(jnp.einsum("bhts,bshd->bthd", p, v)))

    jargs = [jnp.asarray(a) for a in (q, k, pq, pe, v)]
    ref = jax.value_and_grad(loss_jax, argnums=(0, 1, 2, 3, 4))(*jargs)
    n = ta.rel_attention_consume_bwd.launches
    _check(_grads_torch(loss_torch, (q, k, pq, pe, v)), (float(ref[0]), ref[1]))
    assert ta.rel_attention_consume_bwd.launches == n  # CPU: plain version


@pytest.mark.parametrize("t", [128, 130])
@pytest.mark.parametrize("pen", [0.0, PEN])
def test_probs_backward_matches_jax_grad(t, pen):
    """B1's backward (B4 + the score adjoints), through B2 and its einsum
    adjoints, as the no-regularizers training path uses them."""
    (q, k, pq, pe, v), mask = _inputs(t, seed=t + 1)
    mask_t = torch.from_numpy(mask)

    def loss_torch(q, k, pq, pe, v):
        p = ta.rel_attention_probs(q, k, pq, pe, mask_t, score_penalty=pen,
                                   penalty_limit=LIMIT)
        return torch.sin(ta.rel_attention_probs_apply(p, v)).sum() + torch.cos(p[:, 0]).sum()

    def loss_jax(q, k, pq, pe, v):
        p = _jax_probs(q, k, pq, pe, jnp.asarray(mask), pen)
        o = jnp.einsum("bhts,bshd->bthd", p, v)
        return jnp.sum(jnp.sin(o)) + jnp.sum(jnp.cos(p[:, 0]))

    jargs = [jnp.asarray(a) for a in (q, k, pq, pe, v)]
    ref = jax.value_and_grad(loss_jax, argnums=(0, 1, 2, 3, 4))(*jargs)
    n = ta.rel_attention_ds.launches
    _check(_grads_torch(loss_torch, (q, k, pq, pe, v)), (float(ref[0]), ref[1]))
    assert ta.rel_attention_ds.launches == n


def test_log_mel_plain_matches_jax_kernel():
    """128 frames (the TPU kernel's tile) of center-padded noise, one row
    silent after 1/3: log-mel within 1e-4."""
    r = np.random.default_rng(3)
    n = 127 * 256
    wav = (0.1 * r.standard_normal((2, n))).astype(np.float32)
    wav[1, n // 3:] = 0.0
    padded = np.pad(wav, ((0, 0), (512, 512)), mode="reflect")
    ref = np.asarray(jax_fused_log_mel(jnp.asarray(padded), interpret=True))
    n_launch = fused_log_mel.launches
    ours = fused_log_mel(torch.from_numpy(padded)).numpy()
    assert fused_log_mel.launches == n_launch
    assert ours.shape == ref.shape == (2, 128, 100)
    np.testing.assert_allclose(ours, ref, atol=1e-4)
