"""zipvoice_tpu_torch's training pieces without a model, against the JAX
package on the CPU in f32: each regularizer's forward and gradient with its
gate open and closed (within 1e-5 relative), the schedules (exact), one
run of ScaledAdam updates (within 1e-5) and the Eden LR (within 1e-6)."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zipvoice_tpu.config import ZipformerConfig as JZipformerConfig
from zipvoice_tpu.nn import regularizers as jreg
from zipvoice_tpu.train import lr_schedule as jlr
from zipvoice_tpu.train import schedules as jsched
from zipvoice_tpu.train.scaled_adam import apply_updates, scaled_adam
from zipvoice_tpu_torch.config import ZipformerConfig
from zipvoice_tpu_torch.nn import regularizers as reg
from zipvoice_tpu_torch.train import lr_schedule, schedules
from zipvoice_tpu_torch.train.scaled_adam import ScaledAdam, ScaledAdamConfig

# torch's CPU ops share one OpenMP pool a process; pytest-xdist runs a
# process a worker, and pools sized to every core oversubscribe the machine
# by the worker count, which slows torch's ops by orders of magnitude
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

TOL = 1e-5


def _jax_grad(fn, x, ct):
    y, vjp = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(ct))[0])


def _torch_grad(fn, x, ct):
    xt = torch.tensor(x, requires_grad=True)
    y = fn(xt)
    y.backward(torch.tensor(ct))
    return y.detach().numpy(), xt.grad.numpy()


def _close(a, b, tol=TOL):
    scale = max(1.0, float(np.abs(b).max()))
    assert float(np.abs(a - b).max()) <= tol * scale, float(np.abs(a - b).max())


CASES = {
    "balancer": (
        lambda x, gate: jreg.balancer(x, jnp.asarray(gate), min_positive=0.45,
                                      max_positive=0.55, min_abs=0.2, max_abs=4.0),
        lambda x, gate: reg.balancer(x, gate, min_positive=0.45, max_positive=0.55,
                                     min_abs=0.2, max_abs=4.0),
    ),
    # whitening limit 1.0 lies below the metric of random data (applies),
    # 1e6 above it (the metric branch leaves the gradient alone)
    "whiten_active": (
        lambda x, gate: jreg.whiten(x, jnp.asarray(gate), 2, 1.0, 0.02),
        lambda x, gate: reg.whiten(x, gate, 2, 1.0, 0.02),
    ),
    "whiten_below_limit": (
        lambda x, gate: jreg.whiten(x, jnp.asarray(gate), 2, 1e6, 0.02),
        lambda x, gate: reg.whiten(x, gate, 2, 1e6, 0.02),
    ),
    "penalize_abs_values_gt": (
        lambda x, gate: jreg.penalize_abs_values_gt(x, jnp.asarray(gate), 1.0, 0.1),
        lambda x, gate: reg.penalize_abs_values_gt(x, gate, 1.0, 0.1),
    ),
    "limit_param_value": (
        lambda x, gate: jreg.limit_param_value(x, jnp.asarray(gate), -0.5, 0.5),
        lambda x, gate: reg.limit_param_value(x, gate, -0.5, 0.5),
    ),
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("gate", [False, True])
def test_regularizer_matches_jax(name, gate):
    rng = np.random.default_rng(len(name))
    x = (rng.standard_normal((3, 7, 8)) * 1.5 + 0.3).astype(np.float32)
    ct = rng.standard_normal((3, 7, 8)).astype(np.float32)
    jfn, tfn = CASES[name]
    jy, jg = _jax_grad(lambda v: jfn(v, gate), x, ct)
    ty, tg = _torch_grad(lambda v: tfn(v, gate), x, ct)
    np.testing.assert_array_equal(ty, x)  # identity forward
    _close(ty, jy)
    _close(tg, jg)
    if not gate:
        np.testing.assert_array_equal(tg, ct)


def test_dropout_draws():
    """Masks come from the generator: the same seed gives the same mask, a
    shared axis shares it, rate 0 keeps everything."""
    x = torch.ones((4, 50, 6))
    a = reg.dropout_shared(x, torch.Generator().manual_seed(1), 0.5, shared_dim=1)
    b = reg.dropout_shared(x, torch.Generator().manual_seed(1), 0.5, shared_dim=1)
    assert torch.equal(a, b)
    assert torch.equal(a, a[:, :1].expand_as(a))
    assert set(a.unique().tolist()) <= {0.0, 2.0}
    assert torch.equal(reg.dropout_shared(x, torch.Generator(), 0.0), x)
    s = reg.sequence_dropout(x, torch.Generator().manual_seed(2), 0.5)
    assert torch.equal(s, s[:, :1, :1].expand_as(s))


SMALL = dict(in_dim=8, out_dim=8, downsampling_factor=(1, 2, 4, 2, 1),
             num_encoder_layers=(2, 2, 3, 2, 2))


@pytest.mark.parametrize("count", [0.0, 150.0, 3999.0, 12345.5, 1e6])
def test_zipformer_schedules_match_jax(count):
    ours = schedules.zipformer_schedules(count, ZipformerConfig(**SMALL))
    ref = jsched.zipformer_schedules(count, JZipformerConfig(**SMALL))
    assert ours == ref
    assert schedules.adjusted_batch_count(7, 100.0, 1) == jsched.adjusted_batch_count(7, 100.0, 1)


@pytest.mark.parametrize("batch,epoch", [(0, 0.0), (250, 0.4), (500, 1.0), (20000, 7.5)])
def test_eden_lr_matches_jax(batch, epoch):
    ours = lr_schedule.eden_lr(0.02, batch, epoch, 7500.0, 10.0, 500.0)
    ref = float(jlr.eden_lr(0.02, batch, epoch, 7500.0, 10.0, 500.0))
    assert abs(ours - ref) <= 1e-6 * ref


@pytest.mark.parametrize("clipping", [None, 2.0])
def test_scaled_adam_matches_jax(clipping):
    """12 updates of a matrix, a vector and a scalar with per-tensor LR
    scales: crosses size updates (every 4 steps) and the step-10 clipping
    threshold."""
    rng = np.random.default_rng(0)
    init = {"w": rng.standard_normal((16, 8)).astype(np.float32) * 0.5,
            "b": rng.standard_normal((8,)).astype(np.float32) * 0.1,
            "s": np.float32(rng.standard_normal())}
    grads = [{k: rng.standard_normal(np.shape(v)).astype(np.float32) * (1 + 3 * (i == 11))
              for k, v in init.items()} for i in range(12)]
    scales = {"w": 1.0, "b": 0.5, "s": 1.0}
    lr = 0.03

    jopt = scaled_adam(clipping_scale=clipping)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    state = jopt.init(params)
    jscales = {k: jnp.float32(v) for k, v in scales.items()}
    for g in grads:
        upd, state = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, state, params,
                                 lr, lr_scales=jscales)
        params = apply_updates(params, upd)

    tp = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in init.items()}
    opt = ScaledAdam(tp.items(), ScaledAdamConfig(clipping_scale=clipping), lr_scales=scales)
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.tensor(g[k])
        diag = opt.step(lr)
    assert float(diag["grad_clip"]) <= 1.0
    for k in init:
        _close(tp[k].detach().numpy(), np.asarray(params[k]))


def test_scalar_updates_can_cancel_to_the_bit_like_jax():
    """A 0-d parameter (BiasNorm's log_scale) can end bit-equal to its start
    after steps that each moved it: ScaledAdam's scalar path at LR 1e-4
    moves it by ~1e-6 a step (8 ulps at 1.0), and alternating gradient signs
    (the stereo fine-tune alternates its two objectives a batch) make the
    rounded updates sum to zero.  The gradients are those of the first
    fm_decoder layer of stack 1 in the stereo recipe's 4 steps (a CPU run
    at full depth, narrow width).  JAX's optimizer and the port's take the
    same rounded updates, +8, -1, +2 and -9 ulps."""
    p0 = np.uint32(1065353227).view(np.float32)
    grads = [np.uint32(b).view(np.float32)
             for b in (3144066501, 998287104, 3130216181, 1000061048)]
    jopt = scaled_adam()
    params = {"log_scale": jnp.asarray(p0)}
    state = jopt.init(params)
    jtrace = []
    for g in grads:
        upd, state = jopt.update({"log_scale": jnp.asarray(g)}, state, params, 1e-4)
        params = apply_updates(params, upd)
        jtrace.append(np.float32(params["log_scale"]))
    p = torch.nn.Parameter(torch.tensor(p0))
    opt = ScaledAdam([("log_scale", p)])
    trace = []
    for g in grads:
        p.grad = torch.tensor(g)
        opt.step(1e-4)
        trace.append(np.float32(p.detach().numpy()))
    assert [t.view(np.uint32) for t in trace] == [t.view(np.uint32) for t in jtrace]
    ulps = np.diff(np.array([p0] + trace).view(np.uint32).astype(np.int64))
    assert list(ulps) == [8, -1, 2, -9]
    assert trace[-1] == p0


def _signs_of_hold_form(g_out, ct, x, grad_scale):
    """Asserts g_out - ct == s_c * grad_scale * |ct| * x / rms_c(x) in each
    channel c, with s_c in {-1, 0, +1}; returns the s_c."""
    unit = grad_scale * np.abs(ct) * x / np.sqrt(np.mean(x * x, axis=(0, 1)))
    extra = g_out - ct
    signs = np.sign(np.sum(extra * unit, axis=(0, 1)))
    np.testing.assert_allclose(extra, signs * unit, rtol=TOL, atol=TOL * np.abs(unit).max())
    return signs


@pytest.mark.parametrize("seed", [4, 5])
def test_balancer_where_constraints_hold_matches_jax(seed):
    """Where every channel meets its constraints the penalty is exactly 0,
    and the JAX balancer's backward adds to each channel either nothing or
    +-grad_scale * |g| * x / rms(x): |.|'(0) = +1 passes the f32 rounding of
    that zero penalty's rms term, and the per-channel normalization scales
    it up.  The port differentiates by the same rules, so both sides take
    that form in every channel (within 1e-5) and both add the term in some
    channels; which ones, and the signs, follow the last bit of each side's
    own sums, so they are not compared."""
    rng = np.random.default_rng(seed)
    # mean ~0 (proportion positive ~0.5), rms ~0.3: inside every bound
    x = (rng.standard_normal((2, 37, 16)) * 0.3).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    kw = dict(min_positive=0.05, max_positive=0.95, min_abs=0.01, max_abs=100.0)
    _, tg = _torch_grad(lambda v: reg.balancer(v, True, **kw), x, ct)
    _, jg = _jax_grad(lambda v: jreg.balancer(v, jnp.asarray(True), **kw), x, ct)
    assert np.any(_signs_of_hold_form(tg, ct, x, 0.04))
    assert np.any(_signs_of_hold_form(jg, ct, x, 0.04))
