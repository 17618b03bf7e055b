"""zipvoice_tpu_torch.nn.functional against zipvoice_tpu.nn.functional on the
CPU: same numpy inputs, f32, within 1e-6."""

import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zipvoice_tpu.nn import functional as jf
from zipvoice_tpu_torch.nn import functional as tf

# torch's CPU ops share one OpenMP pool a process; pytest-xdist runs a
# process a worker, and pools sized to every core oversubscribe the machine
# by the worker count, which slows torch's ops by orders of magnitude
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

TOL = 1e-6


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(a, b, tol=TOL):
    a = np.asarray(a, np.float64)
    b = np.asarray(b.detach().numpy() if isinstance(b, torch.Tensor) else b,
                   np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max() if a.size else 0.0
    assert err <= tol, err


@pytest.mark.parametrize("name", ["swoosh_l", "swoosh_r"])
def test_swoosh(name):
    x = (_rng(1).standard_normal((4, 33, 17)) * 8).astype(np.float32)
    _close(getattr(jf, name)(jnp.asarray(x)), getattr(tf, name)(torch.from_numpy(x)))


def test_bias_norm():
    r = _rng(2)
    x = r.standard_normal((2, 19, 24)).astype(np.float32)
    bias = r.standard_normal(24).astype(np.float32) * 0.1
    log_scale = np.float32(0.7)
    ref = jf.bias_norm(jnp.asarray(x), jnp.asarray(bias), jnp.asarray(log_scale))
    out = tf.bias_norm(torch.from_numpy(x), torch.from_numpy(bias),
                       torch.tensor(log_scale))
    _close(ref, out)


@pytest.mark.parametrize("bias", [True, False])
def test_linear(bias):
    r = _rng(3)
    x = r.standard_normal((2, 7, 16)).astype(np.float32)
    w = (r.standard_normal((16, 24)) * 0.25).astype(np.float32)  # JAX (in, out)
    b = r.standard_normal(24).astype(np.float32) if bias else None
    p = {"weight": jnp.asarray(w)}
    if bias:
        p["bias"] = jnp.asarray(b)
    ref = jf.linear(p, jnp.asarray(x))
    out = tf.linear(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                    None if b is None else torch.from_numpy(b))
    _close(ref, out)


@pytest.mark.parametrize("with_mask", [False, True])
def test_masked_softmax(with_mask):
    r = _rng(4)
    s = (r.standard_normal((2, 3, 9, 11)) * 4).astype(np.float32)
    mask = (np.arange(11)[None, :] >= np.array([11, 6])[:, None]) if with_mask else None
    ref = jf.masked_softmax(jnp.asarray(s), None if mask is None else jnp.asarray(mask))
    out = tf.masked_softmax(torch.from_numpy(s),
                            None if mask is None else torch.from_numpy(mask))
    _close(ref, out)


@pytest.mark.parametrize("dim", [32, 33, 192])
def test_timestep_embedding(dim):
    t = _rng(5).uniform(0, 1, 5).astype(np.float32)
    _close(jf.timestep_embedding(jnp.asarray(t), dim),
           tf.timestep_embedding(torch.from_numpy(t), dim))


@pytest.mark.parametrize("seq_len,pos_dim", [(1, 48), (40, 48), (577, 48), (9, 16)])
def test_compact_rel_positional_encoding(seq_len, pos_dim):
    _close(jf.compact_rel_positional_encoding(seq_len, pos_dim),
           tf.compact_rel_positional_encoding(seq_len, pos_dim))


def test_make_pad_mask():
    lens = np.array([3, 7, 0], np.int32)
    ref = np.asarray(jf.make_pad_mask(jnp.asarray(lens), 7))
    out = tf.make_pad_mask(torch.from_numpy(lens), 7).numpy()
    np.testing.assert_array_equal(ref, out)
