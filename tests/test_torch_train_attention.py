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


def _square_and_tiles(t, tq, seed, vd=12):
    """Square inputs (B=2, H=2, T=t, one row's keys padded) in torch, and
    the (r0, rows, pe window) of each Tq-row tile of them: rows [r0, r0 +
    Tq) against every key with pe[t - r0 - Tq : 2t - 1 - r0]."""
    (q, k, pq, pe, v), mask = _inputs(t, seed, vd=vd)
    g = np.random.default_rng(seed + 1).standard_normal(v.shape).astype(np.float32)
    gp = np.random.default_rng(seed + 2).standard_normal((2, 2, t, t)).astype(np.float32)
    xs = {n: torch.from_numpy(a) for n, a in zip(("q", "k", "pq", "pe", "v", "g", "gp"),
                                                  (q, k, pq, pe, v, g, gp))}
    xs["mask"] = torch.from_numpy(mask)
    tiles = [(r0, slice(r0, r0 + tq), slice(t - r0 - tq, 2 * t - 1 - r0))
             for r0 in range(0, t, tq)]
    return xs, tiles


def _close(a, ref, what):
    """Within 1e-6 of ref, relative to max(1, max |ref|): the tile's f32
    sums are the square's in another blocking."""
    scale = max(1.0, float(ref.abs().max()))
    err = float((a - ref).abs().max())
    assert err <= 1e-6 * scale, (what, err, scale)


@pytest.mark.parametrize("tq", [8, 12])
@pytest.mark.parametrize("pen", [0.0, PEN])
def test_rel_ds_plain_tile_is_the_square_rows(tq, pen):
    """B4's plain version on a (Tq, Tk = T, r0) tile: the square score
    cotangent's rows [r0, r0 + Tq)."""
    x, tiles = _square_and_tiles(24, tq, seed=5)
    square = ta.rel_attention_ds_plain(x["q"], x["k"], x["pq"], x["pe"], x["mask"], x["gp"],
                                       pen, LIMIT)
    for r0, rows, win in tiles:
        tile = ta.rel_attention_ds_plain(x["q"][:, rows], x["k"], x["pq"][:, rows],
                                         x["pe"][win], x["mask"], x["gp"][:, :, rows], pen,
                                         LIMIT)
        assert tile.shape == (2, 2, tq, 24)
        _close(tile, square[:, :, rows], f"ds r0={r0}")


@pytest.mark.parametrize("tq", [8, 12])
@pytest.mark.parametrize("pen,const_gate", [(0.0, False), (PEN, False), (0.0, True)])
def test_consume_bwd_plain_tiles_sum_to_the_square(tq, pen, const_gate):
    """B3's plain version on the (Tq, Tk = T, r0) tiles of a square
    problem: dq and dpq are the square's rows [r0, r0 + Tq); dk, dv and dpe
    (over Tq + Tk - 1 band rows, placed at the tile's pe window) summed over
    the tiles are the square's."""
    t = 24
    x, tiles = _square_and_tiles(t, tq, seed=7)
    names = ("dq", "dk", "dpq", "dpe", "dv")
    square = dict(zip(names, ta.rel_attention_consume_bwd_plain(
        x["q"], x["k"], x["pq"], x["pe"], x["mask"], x["v"], x["g"], pen, LIMIT, const_gate)))
    summed = {n: torch.zeros_like(square[n]) for n in ("dk", "dpe", "dv")}
    for r0, rows, win in tiles:
        out = dict(zip(names, ta.rel_attention_consume_bwd_plain(
            x["q"][:, rows], x["k"], x["pq"][:, rows], x["pe"][win], x["mask"], x["v"],
            x["g"][:, rows], pen, LIMIT, const_gate)))
        assert out["dpe"].shape == (tq + t - 1, 2, 4) and out["dk"].shape == (2, t, 2, 8)
        _close(out["dq"], square["dq"][:, rows], f"dq r0={r0}")
        _close(out["dpq"], square["dpq"][:, rows], f"dpq r0={r0}")
        summed["dk"] += out["dk"]
        summed["dv"] += out["dv"]
        summed["dpe"][win] += out["dpe"]
    for n, v in summed.items():
        _close(v, square[n], n)


@pytest.mark.parametrize("tq,tk", [(1, 5), (3, 7), (6, 6), (4, 2), (5, 16)])
def test_unshear_is_the_adjoint_of_the_rectangular_rel_shift(tq, tk):
    """<rel_shift(x), y> = <x, unshear(y)> for x (B, H, Tq, Tq + Tk - 1)
    and y (B, H, Tq, Tk), in f64; unshear's band rows outside the shift's
    reach are zero."""
    r = np.random.default_rng(tq * 31 + tk)
    x = torch.from_numpy(r.standard_normal((2, 3, tq, tq + tk - 1)))
    y = torch.from_numpy(r.standard_normal((2, 3, tq, tk)))
    lhs = float((ta.rel_shift(x, tq, tk) * y).sum())
    assert ta.unshear(y).shape == x.shape
    assert lhs == pytest.approx(float((x * ta.unshear(y)).sum()), rel=1e-12, abs=1e-12)
    band = ta.unshear(torch.ones(1, 1, tq, tk))[0, 0]
    for i in range(tq):
        assert band[i].tolist() == [1.0 if 0 <= n - (tq - 1) + i < tk else 0.0
                                    for n in range(tq + tk - 1)]
