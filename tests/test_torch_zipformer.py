"""zipvoice_tpu_torch.nn.zipformer (eval forward) against zipvoice_tpu's on
the CPU, f32, within 1e-5: one encoder layer, one downsampled stack and
the whole TTSZipformer for the text-encoder and fm-decoder shapes.  JAX
parameters reach the port through ``from_jax_params``."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zipvoice_tpu.config import ZipformerConfig as JZipformerConfig
from zipvoice_tpu.nn import zipformer as jzf
from zipvoice_tpu.nn.functional import compact_rel_positional_encoding
from zipvoice_tpu_torch.config import ZipformerConfig
from zipvoice_tpu_torch.io.checkpoint import from_jax_params, load_into
from zipvoice_tpu_torch.nn import zipformer as tzf

# torch's CPU ops share one OpenMP pool a process; pytest-xdist runs a
# process a worker, and pools sized to every core oversubscribe the machine
# by the worker count, which slows torch's ops by orders of magnitude
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

TOL = 1e-5

SMALL = dict(
    in_dim=24, out_dim=20, downsampling_factor=(1, 2, 1),
    num_encoder_layers=(1, 2, 1), cnn_module_kernel=(9, 5, 9), encoder_dim=48,
    query_head_dim=8, pos_head_dim=4, value_head_dim=8, num_heads=2,
    feedforward_dim=64, pos_dim=16, use_time_embed=True, time_embed_dim=32,
)
TEXT = dict(SMALL, downsampling_factor=(1,), num_encoder_layers=2,
            cnn_module_kernel=5, use_time_embed=False)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _port(module_cls, tree, *args):
    with torch.device("meta"):
        m = module_cls(*args)
    return load_into(m, from_jax_params(_np_tree(tree)))


def _inputs(t, d, seed):
    r = np.random.default_rng(seed)
    x = r.standard_normal((2, t, d)).astype(np.float32)
    mask = np.arange(t)[None, :] >= np.array([t, t - 6])[:, None]
    temb = r.standard_normal((2, d)).astype(np.float32) * 0.5
    return x, mask, temb


def _err(ref, out):
    return float(np.abs(np.asarray(ref) - out.detach().numpy()).max())


def test_encoder_layer_matches_jax():
    jcfg, cfg = JZipformerConfig(**SMALL), ZipformerConfig(**SMALL)
    p = jzf._init_layer(jax.random.PRNGKey(1), jcfg, 9)
    m = _port(tzf.EncoderLayer, p, cfg, 9)
    x, mask, temb = _inputs(37, cfg.encoder_dim, 0)
    pe = compact_rel_positional_encoding(37, cfg.pos_dim)
    ref = jzf._encoder_layer(p, jcfg, jnp.asarray(x), pe, jnp.asarray(temb),
                             jnp.asarray(mask), None)
    with torch.no_grad():
        out = tzf._encoder_layer(m, cfg, torch.from_numpy(x),
                                 torch.from_numpy(np.array(pe)),
                                 torch.from_numpy(temb), torch.from_numpy(mask))
    assert _err(ref, out) < TOL


def test_downsampled_stack_matches_jax():
    """T=37 downsampled by 2 gives a ragged 19 with last-frame padding and
    the mask taken as mask[:, ::2]."""
    jcfg, cfg = JZipformerConfig(**SMALL), ZipformerConfig(**SMALL)
    p = jzf._init_encoder_stack(jax.random.PRNGKey(2), jcfg, 1)
    m = _port(tzf.DownsampledEncoder, p, cfg, 1)
    x, mask, temb = _inputs(37, cfg.time_embed_dim, 1)
    x = np.random.default_rng(5).standard_normal((2, 37, cfg.encoder_dim)).astype(
        np.float32)
    ref = jzf._downsampled_encoder_stack(p, jcfg, 1, jnp.asarray(x), jnp.asarray(temb),
                                         jnp.asarray(mask), None)
    with torch.no_grad():
        out = tzf._downsampled_encoder_stack(m, cfg, 1, torch.from_numpy(x),
                                             torch.from_numpy(temb),
                                             torch.from_numpy(mask))
    assert _err(ref, out) < TOL


@pytest.mark.parametrize("kind,t", [("text", 23), ("fm", 45)])
def test_tts_zipformer_forward_matches_jax(kind, t):
    kw = TEXT if kind == "text" else SMALL
    jcfg, cfg = JZipformerConfig(**kw), ZipformerConfig(**kw)
    p = jzf.init_tts_zipformer(jax.random.PRNGKey(3), jcfg)
    m = _port(tzf.TTSZipformer, p, cfg)
    x, mask, _ = _inputs(t, cfg.in_dim, 2)
    tt = np.array([0.3, 0.8], np.float32) if cfg.use_time_embed else None
    ref = jzf.tts_zipformer_forward(
        p, jcfg, jnp.asarray(x), None if tt is None else jnp.asarray(tt),
        jnp.asarray(mask),
    )
    with torch.no_grad():
        out = tzf.tts_zipformer_forward(
            m, torch.from_numpy(x), None if tt is None else torch.from_numpy(tt),
            torch.from_numpy(mask),
        )
    assert out.shape == (2, t, cfg.out_dim)
    assert _err(ref, out) < TOL
