"""The fused eval path of zipvoice_tpu_torch against zipvoice_tpu on the CPU,
f32: the plain versions of B5, B6, B7 and B9 against the JAX Pallas kernels
run in interpret mode, one encoder layer with both fused flags on against
the JAX layer with its flags on, and the port's fused forward against its
unfused one.

The JAX kernels take their pad-and-slice path below a multiple of 128, so
T = 200 exercises it.  Tolerances are the JAX package's own: 1e-5 on
probabilities, 2e-5 on outputs, 1e-4 on gradients (f32 sums over T keys in
another order), 5e-5 through a whole layer."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import zipvoice_tpu.ops.attention as jatt
import zipvoice_tpu.ops.convglu as jcg
from zipvoice_tpu.config import ZipformerConfig as JZipformerConfig
from zipvoice_tpu.nn import zipformer as jzf
from zipvoice_tpu.nn.functional import compact_rel_positional_encoding
from zipvoice_tpu_torch.config import ZipformerConfig
from zipvoice_tpu_torch.io.checkpoint import from_jax_params, load_into
from zipvoice_tpu_torch.nn import zipformer as tzf
from zipvoice_tpu_torch.ops import attention as ta
from zipvoice_tpu_torch.ops.convglu import conv_glu_swoosh_out

# torch's CPU ops share one OpenMP pool a process; pytest-xdist runs a
# process a worker, and pools sized to every core oversubscribe the machine
# by the worker count, which slows torch's ops by orders of magnitude
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

H, QD, PD, VD = 4, 32, 4, 12


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _rel_inputs(t, with_mask, seed, b=2, h=H, vd=VD):
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, t, h, QD)).astype(np.float32)
    k = r.standard_normal((b, t, h, QD)).astype(np.float32)
    pq = r.standard_normal((b, t, h, PD)).astype(np.float32)
    pe = r.standard_normal((2 * t - 1, h, PD)).astype(np.float32)
    v = r.standard_normal((b, t, h, vd)).astype(np.float32)
    pad_to = t - 60 if t > 60 else t - t // 3 - 1  # a short T keeps two thirds
    mask = (np.arange(t)[None, :] >= np.array([t, pad_to][:b])[:, None]
            if with_mask else None)
    return q, k, pq, pe, v, mask


def _launches():
    return (ta.rel_attention_probs_consume.launches, ta.rel_attention_head0_consume.launches,
            ta.rel_attention_apply.launches, conv_glu_swoosh_out.launches)


# ---------------------------------------------------------------------------
# Op level
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t", [128, 200])
@pytest.mark.parametrize("with_mask", [False, True])
def test_probs_consume_matches_jax(t, with_mask):
    """B6: the probabilities and the contraction of the rounded ones."""
    q, k, pq, pe, v, mask = _rel_inputs(t, with_mask, seed=t + 1)
    before = _launches()
    probs, out = ta.rel_attention_probs_consume(*map(_t, (q, k, pq, pe, mask, v)),
                                                out_dtype=torch.float32)
    assert _launches() == before  # CPU tensors: the plain version, no launch
    jprobs, jout = jatt.rel_attention_probs_consume(*map(_j, (q, k, pq, pe, mask, v)),
                                                    out_dtype=jnp.float32, interpret=True)
    assert probs.shape == (2, H, t, t) and out.shape == (2, t, H, VD)
    assert np.abs(probs.numpy() - np.asarray(jprobs)).max() < 1e-5
    assert np.abs(out.numpy() - np.asarray(jout)).max() < 2e-5


@pytest.mark.parametrize("t,c", [(128, 96), (200, 96), (40, 144)])
@pytest.mark.parametrize("with_mask", [False, True])
def test_head0_consume_matches_jax(t, c, with_mask):
    """B7: head 0 against the wide value stream (C = 96; the text
    encoder's C = 144 at T = 40)."""
    q, k, pq, pe, _, mask = _rel_inputs(t, with_mask, seed=t + 2)
    v = np.random.default_rng(t).standard_normal((2, t, c)).astype(np.float32)
    out = ta.rel_attention_head0_consume(*map(_t, (q, k, pq, pe, mask, v)))
    ref = jatt.rel_attention_head0_consume(*map(_j, (q, k, pq, pe, mask, v)), interpret=True)
    assert out.shape == (2, t, c)
    assert np.abs(out.numpy() - np.asarray(ref)).max() < 2e-5


def _conv_params(c, d, kernel, seed, out_bias):
    """A JAX-layout ConvolutionModule tail (taps (K, C), out-projection
    (C, D)) and the same weights through the port's weight bridge."""
    r = np.random.default_rng(seed)
    tree = {
        "depthwise_conv": {"weight": r.standard_normal((kernel, c)).astype(np.float32) * 0.2,
                           "bias": r.standard_normal((c,)).astype(np.float32) * 0.1},
        "out_proj": {"weight": r.standard_normal((c, d)).astype(np.float32) * 0.2},
    }
    if out_bias:
        tree["out_proj"]["bias"] = r.standard_normal((d,)).astype(np.float32) * 0.1
    return tree, from_jax_params(tree)


@pytest.mark.parametrize("kernel", [3, 7, 31])
@pytest.mark.parametrize("t", [40, 200])
@pytest.mark.parametrize("with_mask,out_bias", [(False, True), (True, True), (True, False),
                                                (False, False)])
def test_conv_glu_matches_jax(kernel, t, with_mask, out_bias):
    """B9 with the weights in the port's module layouts: from_jax_params
    gives the (C, 1, K) conv weight and the (D, C) linear weight the
    kernel takes, so the bridge needs no case of its own."""
    c, d = 16, 24
    tree, sd = _conv_params(c, d, kernel, seed=kernel * t, out_bias=out_bias)
    assert sd["depthwise_conv.weight"].shape == (c, 1, kernel)
    assert sd["out_proj.weight"].shape == (d, c)
    r = np.random.default_rng(kernel + t)
    proj = r.standard_normal((2, t, 2 * c)).astype(np.float32)
    mask = np.arange(t)[None, :] >= np.array([t, t - 13])[:, None] if with_mask else None
    before = _launches()
    out = conv_glu_swoosh_out(_t(proj), sd["depthwise_conv.weight"], sd["depthwise_conv.bias"],
                              _t(mask), sd["out_proj.weight"], sd.get("out_proj.bias"))
    assert _launches() == before
    dw, op = tree["depthwise_conv"], tree["out_proj"]
    ref = jcg.conv_glu_swoosh_out(_j(proj), _j(dw["weight"]), _j(dw["bias"]), _j(mask),
                                  _j(op["weight"]), _j(op.get("bias")), interpret=True)
    assert out.shape == (2, t, d)
    assert np.abs(out.numpy() - np.asarray(ref)).max() < 2e-5


def _apply_jax(q, k, pq, pe, mask, v, gate, pen=None, t=None):
    kw = dict(out_dtype=jnp.float32, interpret=True, const_gate=jnp.asarray(gate, jnp.float32))
    if pen is not None:
        kw.update(score_penalty=jnp.asarray(pen, jnp.float32), penalty_limit=25.0)
    if t is not None:  # the penalty-column limit is an argument of the aligned op only
        return jatt.rel_attention_apply(q, k, pq, pe, mask, v, penalty_valid_cols=t, **kw)
    return jatt.rel_attention_apply_any(q, k, pq, pe, mask, v, **kw)


def _apply_case(t, gate, pen=None, valid_cols=None, scale=1.0, seed=0, h=2, vd=VD):
    """The port's rel_attention_apply against the JAX op: forward and the
    gradients of sum(sin(out)) in q, k, pq, pe, v."""
    q, k, pq, pe, v, mask = _rel_inputs(t, True, seed=seed, b=2, h=h, vd=vd)
    q, k = q * scale, k * scale
    tq = [_t(a).requires_grad_() for a in (q, k, pq, pe, v)]
    before = _launches()
    out = ta.rel_attention_apply(*tq[:4], _t(mask), tq[4], out_dtype=torch.float32,
                                 score_penalty=pen or 0.0, penalty_valid_cols=valid_cols,
                                 const_gate=gate)
    torch.sin(out).sum().backward()
    assert _launches() == before

    def loss(q, k, pq, pe, v):
        return jnp.sum(jnp.sin(_apply_jax(q, k, pq, pe, _j(mask), v, gate, pen, valid_cols)))

    jargs = [_j(a) for a in (q, k, pq, pe, v)]
    ref = _apply_jax(*jargs[:4], _j(mask), jargs[4], gate, pen, valid_cols)
    grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*jargs)
    assert np.abs(out.detach().numpy() - np.asarray(ref)).max() < 2e-5
    for name, x, g in zip(("q", "k", "pq", "pe", "v"), tq, grads):
        assert np.abs(x.grad.numpy() - np.asarray(g)).max() < 1e-4, name
    return [x.grad for x in tq]


@pytest.mark.parametrize("t,h,vd", [pytest.param(128, 2, VD, id="128"),
                                    pytest.param(200, 2, VD, id="200"),
                                    pytest.param(128, 1, 48, id="128-h1-vd48")])
@pytest.mark.parametrize("gate", [False, True])
def test_rel_apply_matches_jax(t, h, vd, gate):
    """B5 forward and its B3 backward against rel_attention_apply_any (at
    H=2, vd=12, and at H=1 with a wider vd, the head-0 consumer's shape);
    with the const gate the score gradients are exactly zero."""
    grads = _apply_case(t, gate, seed=t, h=h, vd=vd)
    if gate:
        assert all(float(g.abs().max()) == 0.0 for g in grads[:4])


def test_rel_apply_penalty_columns_match_jax():
    """The failsafe penalty on the key columns below penalty_valid_cols."""
    _apply_case(128, False, pen=1e-2, valid_cols=100, scale=2.5, seed=7)


# ---------------------------------------------------------------------------
# A layer, and the port's fused forward against its unfused one
# ---------------------------------------------------------------------------


LAYER = dict(
    in_dim=16, out_dim=16, downsampling_factor=(1,), num_encoder_layers=1,
    cnn_module_kernel=3, encoder_dim=16, query_head_dim=8, pos_head_dim=4,
    value_head_dim=8, num_heads=2, feedforward_dim=32, pos_dim=8,
    use_time_embed=True, time_embed_dim=8,
)


def _small_layer(seed=0):
    """The layer of tests/test_attention_kernel.py's `_small_layer`: T = 128,
    the smallest T at which the JAX fused branches run their kernels."""
    cfg = JZipformerConfig(**LAYER)
    t = 128
    p = jzf._init_layer(jax.random.PRNGKey(seed), cfg, kernel=3)
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((2, t, 16)), jnp.float32)
    time_emb = jnp.asarray(rng.standard_normal((2, 16)), jnp.float32)
    pos_emb = compact_rel_positional_encoding(t, cfg.pos_dim)
    mask = jnp.asarray(np.arange(t)[None, :] >= np.array([t, 100])[:, None])
    return cfg, p, x, time_emb, pos_emb, mask


def _interp_patch(monkeypatch):
    """The JAX package's kernels in interpret mode (a copy of the helper of
    tests/test_attention_kernel.py)."""
    for mod, name in ((jcg, "conv_glu_swoosh_out"), (jatt, "rel_attention_probs_any"),
                      (jatt, "rel_attention_apply_any"), (jatt, "rel_attention_consume"),
                      (jatt, "rel_attention_probs_consume"),
                      (jatt, "rel_attention_head0_consume"),
                      (jatt, "rel_attention_probs_apply")):
        real = getattr(mod, name)

        def interp(*a, _real=real, **kw):
            kw["interpret"] = True
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, interp)


def test_encoder_layer_fused_matches_jax_fused(monkeypatch):
    """Both fused flags on, on both sides: every B5-B9 consumer of a layer."""
    jcfg, p, x, temb, pe, mask = _small_layer()
    _interp_patch(monkeypatch)
    jzf.set_fused_attention(True)
    jzf.set_fused_eval(True)
    jzf.set_fused_conv(True)
    try:
        ref = np.asarray(jzf._encoder_layer(p, jcfg, x, pe, temb, mask, None))
    finally:
        jzf.set_fused_attention(None)
        jzf.set_fused_eval(False)
        jzf.set_fused_conv(False)
    cfg = ZipformerConfig(**LAYER)
    with torch.device("meta"):
        m = tzf.EncoderLayer(cfg, 3)
    m = load_into(m, from_jax_params(jax.tree.map(lambda a: np.asarray(a, np.float32), p)))
    spy = _Spy(monkeypatch)
    tzf.set_fused_eval(True)
    tzf.set_fused_conv(True)
    try:
        with torch.no_grad():
            out = tzf._encoder_layer(m, cfg, _t(x), _t(np.asarray(pe)), _t(temb), _t(mask))
    finally:
        tzf.set_fused_eval(False)
        tzf.set_fused_conv(False)
    assert spy.calls == {"rel_attention_head0_consume": 1, "rel_attention_probs_consume": 1,
                         "conv_glu_swoosh_out": 2, "rel_attention_probs_apply": 1}
    assert np.abs(out.numpy() - ref).max() < 5e-5


class _Spy:
    """Counts the calls the port's Zipformer makes to its attention and conv
    ops."""

    NAMES = ("rel_attention_probs", "rel_attention_probs_apply",
             "rel_attention_head0_consume", "rel_attention_probs_consume",
             "conv_glu_swoosh_out")

    def __init__(self, monkeypatch):
        self.calls = {}
        for name in self.NAMES:
            real = getattr(tzf, name)

            def spy(*a, _real=real, _name=name, **kw):
                self.calls[_name] = self.calls.get(_name, 0) + 1
                return _real(*a, **kw)

            monkeypatch.setattr(tzf, name, spy)


SMALL = dict(
    in_dim=24, out_dim=20, downsampling_factor=(1, 2, 1),
    num_encoder_layers=(1, 2, 1), cnn_module_kernel=(9, 5, 9), encoder_dim=48,
    query_head_dim=8, pos_head_dim=4, value_head_dim=8, num_heads=2,
    feedforward_dim=64, pos_dim=16, use_time_embed=True, time_embed_dim=32,
)


def _tiny_forward(fused_eval, fused_conv, grad=False):
    cfg = ZipformerConfig(**SMALL)
    torch.manual_seed(0)
    m = tzf.TTSZipformer(cfg)
    r = np.random.default_rng(4)
    x = torch.from_numpy(r.standard_normal((2, 45, cfg.in_dim)).astype(np.float32))
    mask = torch.arange(45)[None, :] >= torch.tensor([45, 38])[:, None]
    tzf.set_fused_eval(fused_eval)
    tzf.set_fused_conv(fused_conv)
    try:
        with torch.set_grad_enabled(grad):
            return tzf.tts_zipformer_forward(m, x, torch.tensor([0.3, 0.8]), mask)
    finally:
        tzf.set_fused_eval(False)
        tzf.set_fused_conv(False)


@pytest.mark.parametrize("fused_eval,fused_conv", [(True, True), (True, False), (False, True)])
def test_tts_zipformer_fused_matches_unfused(monkeypatch, fused_eval, fused_conv):
    """A three-stack TTSZipformer (a downsampled stack of two layers in the
    middle), T = 45 with a padded row: fused within 1e-5 of unfused, and
    the fused ops called once (B6, B7) or twice (B9) a layer."""
    ref = _tiny_forward(False, False)
    spy = _Spy(monkeypatch)
    out = _tiny_forward(fused_eval, fused_conv)
    layers = sum(SMALL["num_encoder_layers"])
    want = {"rel_attention_probs_apply": 2 * layers}
    if fused_eval:
        want.update(rel_attention_head0_consume=layers, rel_attention_probs_consume=layers)
        want["rel_attention_probs_apply"] = layers
    else:
        want["rel_attention_probs"] = layers
    if fused_conv:
        want["conv_glu_swoosh_out"] = 2 * layers
    assert spy.calls == want
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_fused_flags_default_off_and_restore(monkeypatch):
    """Off by default; set, they switch the eval path; reset, the unfused
    path serves again; under autograd they have no effect (no backward)."""
    assert (tzf._FUSED_EVAL, tzf._FUSED_CONV) == (False, False)
    spy = _Spy(monkeypatch)
    _tiny_forward(True, True, grad=True)
    assert "rel_attention_probs_consume" not in spy.calls
    assert "conv_glu_swoosh_out" not in spy.calls
    _tiny_forward(True, True)
    assert spy.calls["rel_attention_probs_consume"] == 4
    assert (tzf._FUSED_EVAL, tzf._FUSED_CONV) == (False, False)
    spy.calls.clear()
    _tiny_forward(tzf._FUSED_EVAL, tzf._FUSED_CONV)
    assert spy.calls == {"rel_attention_probs": 4, "rel_attention_probs_apply": 8}
