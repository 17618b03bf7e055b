"""The port's training path against the JAX package on the CPU, f32, at
tiny sizes: one encoder layer's training forward and gradients with every
gate forced (as tests/test_attention_kernel.py's
test_layer_fused_apply_matches_xla_training does), compute_fm_loss value
and gradients with the random draws neutralised on both sides, remat
gradients equal to no-remat gradients, and a Trainer run that saves,
resumes and keeps model_avg in float64.  JAX weights reach the port
through ``from_jax_params``."""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zipvoice_tpu.config import ZipVoiceConfig as JZipVoiceConfig
from zipvoice_tpu.config import ZipformerConfig as JZipformerConfig
from zipvoice_tpu.models import zipvoice as jzv
from zipvoice_tpu.nn import regularizers as jreg
from zipvoice_tpu.nn import zipformer as jzf
from zipvoice_tpu.nn.functional import compact_rel_positional_encoding
from zipvoice_tpu.train.schedules import zipformer_schedules as jax_schedules
from zipvoice_tpu_torch.config import ZipVoiceConfig, ZipformerConfig
from zipvoice_tpu_torch.io.checkpoint import from_jax_params, load_into
from zipvoice_tpu_torch.models import zipvoice as tzv
from zipvoice_tpu_torch.nn import regularizers as treg
from zipvoice_tpu_torch.nn import zipformer as tzf
from zipvoice_tpu_torch.train.schedules import zipformer_schedules, zipvoice_schedules

# torch's CPU ops share one OpenMP pool a process; pytest-xdist runs a
# process a worker, and pools sized to every core oversubscribe the machine
# by the worker count, which slows torch's ops by orders of magnitude
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

LAYER = dict(in_dim=16, out_dim=16, downsampling_factor=(1,), num_encoder_layers=1,
             cnn_module_kernel=3, encoder_dim=16, query_head_dim=8, pos_head_dim=4,
             value_head_dim=8, num_heads=2, feedforward_dim=32, pos_dim=8,
             use_time_embed=True, time_embed_dim=8)
TINY = dict(fm_decoder_downsampling_factor=(1, 2, 1), fm_decoder_num_layers=(1, 2, 1),
            fm_decoder_cnn_module_kernel=(9, 7, 9), fm_decoder_feedforward_dim=96,
            fm_decoder_num_heads=2, fm_decoder_dim=64, text_encoder_num_layers=2,
            text_encoder_feedforward_dim=48, text_encoder_cnn_module_kernel=5,
            text_encoder_num_heads=2, text_encoder_dim=48, time_embed_dim=32,
            text_embed_dim=48, query_head_dim=8, value_head_dim=8, pos_head_dim=4,
            pos_dim=48, feat_dim=20, vocab_size=28, pad_id=0)
# the random rates at 0 (skips, dropout, layerdrop): only the gates remain
NO_DRAWS = dict(dropout=0.0, attention_skip_rate=0.0, conv_skip_rate=0.0,
                ff2_skip_rate=0.0, ff3_skip_rate=0.0)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _port(module, tree):
    return load_into(module, from_jax_params(_np_tree(tree)))


def _grads_by_name(jgrads):
    return {k: v.numpy() for k, v in from_jax_params(_np_tree(jgrads)).items()}


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b)) / max(float(np.linalg.norm(a)),
                                              float(np.linalg.norm(b)), 1e-6)


def _fixed_gate_classes(gates_on):
    class JaxGates(jzf.TrainCtx):
        def gate(self, prob):
            self.next_key()
            return jnp.asarray(gates_on)

    class TorchGates(tzf.TrainCtx):
        def gate(self, prob):
            return gates_on

    return JaxGates, TorchGates


@pytest.mark.parametrize("gates_on", [False, True])
def test_encoder_layer_training_matches_jax(monkeypatch, gates_on):
    """Every gate forced (whitening, const attention, pos-score skip, score
    failsafe, bypass limits) and the random rates at 0: the port's
    shared-probs layer (B1 + flash consumers) against the JAX XLA training
    path, elementwise (rtol 5e-4, atol 5e-5).  The balancers are identities
    on both sides here: where a channel meets its constraints both sides'
    balancers add a grad_scale-sized term whose channels and signs follow
    f32 rounding (test_torch_regularizers); the next test holds them where
    their constraints bind."""
    monkeypatch.setattr(jreg, "balancer", lambda x, gate, **kw: x)
    monkeypatch.setattr(treg, "balancer", lambda x, gate, **kw: x)
    _layer_matches_jax(gates_on)


def test_encoder_layer_training_balancers_bind_matches_jax(monkeypatch):
    """As above with every gate open and the layer's balancers live,
    each with its own placement, gate, grad_scale and proportion-positive
    bounds, but an RMS floor of 1e3 that every channel falls below: so
    each balancer adds its constraint gradient in every channel, and the
    layer's gradients equal JAX's within the same tolerances."""
    jbal, tbal = jreg.balancer, treg.balancer
    bind = dict(min_abs=1e3, max_abs=1e4)
    monkeypatch.setattr(jreg, "balancer", lambda x, gate, **kw: jbal(x, gate, **dict(kw, **bind)))
    monkeypatch.setattr(treg, "balancer", lambda x, gate, **kw: tbal(x, gate, **dict(kw, **bind)))
    _layer_matches_jax(True)


def _layer_matches_jax(gates_on):
    jcfg, cfg = JZipformerConfig(**LAYER), ZipformerConfig(**LAYER)
    p = jzf._init_layer(jax.random.PRNGKey(1), jcfg, kernel=3)
    with torch.device("meta"):
        m = tzf.EncoderLayer(cfg, 3)
    m = _port(m, p)
    t = 37
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, t, 16)).astype(np.float32)
    temb = rng.standard_normal((2, 16)).astype(np.float32)
    mask = np.arange(t)[None, :] >= np.array([t, 29])[:, None]
    pe = np.array(compact_rel_positional_encoding(t, cfg.pos_dim))
    s = dict(zipformer_schedules(100.0, cfg), **NO_DRAWS, layerdrop=((0.0,),))
    js = dict(jax_schedules(100.0, jcfg), **NO_DRAWS, layerdrop=((0.0,),))
    JaxGates, TorchGates = _fixed_gate_classes(gates_on)

    def jloss(p, x):
        out = jzf._encoder_layer(p, jcfg, x, jnp.asarray(pe), jnp.asarray(temb),
                                 jnp.asarray(mask), JaxGates(jax.random.PRNGKey(3), js))
        return jnp.sum(jnp.sin(out))

    jl, (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(p, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = tzf._encoder_layer(m, cfg, xt, torch.from_numpy(pe), torch.from_numpy(temb),
                             torch.from_numpy(mask), TorchGates(3, s, "cpu"))
    loss = torch.sin(out).sum()
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    ref = _grads_by_name(jgp)
    ref["x"], ours = np.asarray(jgx), {"x": xt.grad.numpy()}
    ours.update({n: q.grad.numpy() for n, q in m.named_parameters()})
    assert sorted(ours) == sorted(ref)
    for name, g in ours.items():
        np.testing.assert_allclose(g, ref[name], rtol=5e-4, atol=5e-5, err_msg=name)


def _tiny_model():
    # one layer a stack keeps the JAX reference's compile short
    kw = dict(TINY, fm_decoder_num_layers=(1, 1, 1), text_encoder_num_layers=1)
    jcfg, cfg = JZipVoiceConfig(**kw), ZipVoiceConfig(**kw)
    params = jzv.init_zipvoice(jax.random.PRNGKey(0), jcfg)
    with torch.device("meta"):
        model = tzv.ZipVoiceModel(cfg)
    return jcfg, cfg, params, _port(model, params)


def _batch(seed=0, b=2, t=40, s=9):
    r = np.random.default_rng(seed)
    tokens = r.integers(1, 28, size=(b, s + 1)).astype(np.int64)
    tokens_lens = np.array([s, s - 3])
    tokens[1, s - 3:] = 0
    tokens[:, -1] = 0
    features = (r.standard_normal((b, t, 20)) * 0.5).astype(np.float32)
    features_lens = np.array([t, t - 7])
    noise = r.standard_normal((b, t, 20)).astype(np.float32)
    tt = r.uniform(0.1, 0.9, size=(b, 1, 1)).astype(np.float32)
    cond = np.zeros((b, t), bool)
    cond[0, 5:30] = True
    cond[1, 3:25] = True
    return tokens, tokens_lens, features, features_lens, noise, tt, cond


@pytest.mark.parametrize("regularizers", [False, True])
def test_compute_fm_loss_matches_jax(monkeypatch, regularizers):
    """The loss and every parameter's gradient with the condition mask
    fixed, the text-condition drop off and (with regularizers) every gate
    closed, the random rates at 0 and the pos-emb dropout an identity on
    both sides.  With regularizers the port takes the shared-probs path
    (B1 + B3's plain version); without, B1 with B4's plain version.
    Relative L2 error of each gradient under 1e-4 (f32 sums of ~10^3 terms
    in another order)."""
    jcfg, cfg, params, model = _tiny_model()
    tokens, tl, feats, fl, noise, tt, cond = _batch()
    monkeypatch.setattr(jzv, "condition_time_mask", lambda *a, **k: jnp.asarray(cond))
    monkeypatch.setattr(tzv, "condition_time_mask", lambda *a, **k: torch.from_numpy(cond))
    monkeypatch.setattr(jreg, "dropout_shared", lambda x, *a, **k: x)
    monkeypatch.setattr(treg, "dropout_shared", lambda x, *a, **k: x)
    JaxGates, TorchGates = _fixed_gate_classes(False)
    monkeypatch.setattr(jzf.TrainCtx, "gate", JaxGates.gate)
    monkeypatch.setattr(tzf.TrainCtx, "gate", TorchGates.gate)

    def sched(mk, c):
        base = mk(200.0, c)
        return dict(base, **NO_DRAWS,
                    layerdrop=tuple(tuple(0.0 for _ in st) for st in base["layerdrop"]))

    jsched = tsched = None
    if regularizers:
        jsched = {"fm_decoder": sched(jax_schedules, jcfg.fm_decoder_config()),
                  "text_encoder": sched(jax_schedules, jcfg.text_encoder_config())}
        tsched = {"fm_decoder": sched(zipformer_schedules, cfg.fm_decoder_config()),
                  "text_encoder": sched(zipformer_schedules, cfg.text_encoder_config())}

    def jloss(p):
        return jzv.compute_fm_loss(p, jcfg, jnp.asarray(tokens), jnp.asarray(tl),
                                   jnp.asarray(feats), jnp.asarray(fl), jnp.asarray(noise),
                                   jnp.asarray(tt), jax.random.PRNGKey(0),
                                   schedules=jsched)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    loss = tzv.compute_fm_loss(model, torch.from_numpy(tokens), torch.from_numpy(tl),
                               torch.from_numpy(feats), torch.from_numpy(fl),
                               torch.from_numpy(noise), torch.from_numpy(tt), 0,
                               schedules=tsched)
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * float(jl)
    ref = _grads_by_name(jg)
    for name, q in model.named_parameters():
        assert _rel_l2(q.grad.numpy(), ref[name]) < 1e-4, name


@pytest.mark.parametrize("policy", ["all", "dots", "xprobs", "xprobs_ff", "names"])
def test_remat_gradients_equal_no_remat(policy):
    """Regularizers live with their real random draws: under each remat
    policy the loss and gradients equal full remat's.  A rematerialized
    layer rebuilds its generator from the seed drawn before the
    checkpointed call, so its recompute draws what the forward drew; the
    selective policies save the draws and whatever else they keep."""
    cfg = ZipVoiceConfig(**TINY)
    model = tzv.init_zipvoice(cfg, torch.Generator().manual_seed(0))
    tokens, tl, feats, fl, noise, tt, _ = _batch(seed=1)
    args = [torch.from_numpy(a) for a in (tokens, tl, feats, fl, noise, tt)]
    scheds = zipvoice_schedules(50.0, cfg)

    def grads(name):
        tzf.set_remat_policy(name)
        try:
            model.zero_grad()
            loss = tzv.compute_fm_loss(model, *args, 7, condition_drop_ratio=0.2,
                                       schedules=scheds)
            loss.backward()
        finally:
            tzf.set_remat_policy("full")
        return float(loss.detach()), {n: q.grad.clone() for n, q in model.named_parameters()}

    l1, g1 = grads("full")
    l0, g0 = grads(policy)
    assert l1 == l0
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], rtol=1e-6, atol=1e-7, msg=name)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from zipvoice_tpu_torch.audio.wav import write_wav
    from zipvoice_tpu_torch.text.tokenizer import write_token_file

    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    lines = []
    for i, text in enumerate(["hello world", "abc def", "the quick brown fox", "jumps"]):
        n = int(rng.uniform(1.2, 2.0) * 24000)
        write_wav(d / f"u{i}.wav", (rng.standard_normal((1, n)) * 0.1).astype(np.float32),
                  24000)
        lines.append(f"u{i}\t{text}\t{d / f'u{i}.wav'}")
    (d / "train.tsv").write_text("\n".join(lines) + "\n")
    write_token_file({"_": 0, " ": 1, **{c: i + 2 for i, c in
                                         enumerate("abcdefghijklmnopqrstuvwxyz")}},
                     str(d / "tokens.txt"))
    model = {k: list(v) if isinstance(v, tuple) else v for k, v in TINY.items()
             if k not in ("vocab_size", "pad_id")}
    (d / "model.json").write_text(json.dumps(
        {"model": model, "feature": {"sampling_rate": 24000, "type": "vocos", "n_mels": 20}}))
    return d


def _cli(corpus, exp, *extra):
    from zipvoice_tpu_torch.bin.train_zipvoice import main

    return main(["--device", "cpu", "--train-manifest", str(corpus / "train.tsv"),
                 "--token-file", str(corpus / "tokens.txt"), "--tokenizer", "simple",
                 "--model-config", str(corpus / "model.json"), "--exp-dir", str(exp),
                 "--max-duration", "4", "--num-steps-per-epoch", "2", "--log-interval", "1",
                 "--average-period", "1", "--dtype", "float32", *extra])


def test_train_cli_saves_resumes_and_serves(corpus, tmp_path):
    """Two steps through the CLI, then a resume for two more: finite
    losses, changed weights, the float64 average saved and reloaded, the
    optimizer state restored, and the checkpoint loads into the JAX
    package's load_checkpoint and, as model.pt, into the port's model-dir
    loader."""
    from zipvoice_tpu.train.checkpoint import load_checkpoint as jax_load
    from zipvoice_tpu_torch.io.model_dir import load_model_dir
    from zipvoice_tpu_torch.train.checkpoint import load_checkpoint

    exp = tmp_path / "exp"
    first = _cli(corpus, exp, "--num-epochs", "1")
    losses = [loss for _, loss in first["steps"]]
    assert len(losses) == 2 and all(np.isfinite(losses))
    ck = load_checkpoint(str(exp / "epoch-1.pt"))
    assert ck["info"]["batch_idx_train"] == 2 and ck["opt_state"]["step"] == 2
    assert all(v.dtype == torch.float64 for v in ck["model_avg"].values())
    init = tzv.init_zipvoice(ZipVoiceConfig(**TINY), torch.Generator().manual_seed(42))
    assert not torch.equal(ck["model"]["embed.weight"], init.embed.weight)

    second = _cli(corpus, exp, "--num-epochs", "2", "--start-epoch", "2")
    trainer = second["trainer"]
    assert trainer.batch_idx_train == 4 and trainer.opt.step_count == 4
    assert all(np.isfinite([loss for _, loss in second["steps"]]))
    avg = load_checkpoint(str(exp / "epoch-2.pt"))["model_avg"]
    # average_period 1: avg_4 = (avg_2 * 2 + w_3 + w_4) / 4, accumulated in f64
    assert not torch.equal(avg["embed.weight"], ck["model_avg"]["embed.weight"])

    jck = jax_load(str(exp / "epoch-2.pt"))
    np.testing.assert_array_equal(np.asarray(jck["params"]["embed"]["weight"]),
                                  trainer.model.embed.weight.detach().numpy())
    assert jck["model_avg"]["embed"]["weight"].dtype == np.float64
    assets = load_model_dir(str(exp), checkpoint_name="epoch-2.pt", tokenizer_name="simple")
    assert torch.equal(assets.model.embed.weight, trainer.model.embed.weight.detach())


@pytest.mark.parametrize("flags", [["--unroll-layers"], ["--remat-policy", "all"],
                                   ["--remat-policy", "dots"], ["--remat-policy", "xprobs"],
                                   ["--remat-policy", "xprobs_ff"]])
def test_train_cli_runs_remat_policies_and_unrolled_layers(corpus, tmp_path, flags):
    """Two steps under each --remat-policy the CLI offers, and with
    --unroll-layers (which changes nothing in the port): finite losses,
    the same as under the default policy, and the policy in force while
    the CLI ran."""
    seen = []
    step = tzf._encoder_stack

    def spy(*a, **k):
        seen.append(tzf._REMAT_POLICY)
        return step(*a, **k)

    try:
        tzf._encoder_stack = spy
        got = _cli(corpus, tmp_path / "exp", "--num-epochs", "1", *flags)
        want = _cli(corpus, tmp_path / "ref", "--num-epochs", "1")
    finally:
        tzf._encoder_stack = step
        tzf.set_remat_policy("full")
    losses = [loss for _, loss in got["steps"]]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert losses == [loss for _, loss in want["steps"]]
    policy = flags[1] if flags[0] == "--remat-policy" else "full"
    assert seen and set(seen[: len(seen) // 2]) == {policy}


def test_train_cli_print_diagnostics(corpus, tmp_path, capsys):
    """--print-diagnostics prints the parameters' statistics and the
    fm_decoder's per-module activation statistics on the first batch, then
    exits without training."""
    assert _cli(corpus, tmp_path / "exp", "--print-diagnostics") is None
    out = capsys.readouterr().out
    names = [line.split()[0] for line in out.splitlines() if not line.startswith(" ")]
    assert "embed.weight" in names and "fm_decoder.out_proj.weight" in names
    for name in ("in_proj", "encoders.0", "encoders.1.layer1.feed_forward1",
                 "encoders.2.layer0.conv_module2", "encoders.0.layer0.output", "out_proj"):
        assert name in names, name
    attn = [line for line in out.splitlines() if line.split()[0].endswith("self_attn_weights")]
    assert attn and all("attn_entropy=" in line for line in attn)
    assert not (tmp_path / "exp" / "epoch-1.pt").exists()


def test_train_cli_scan_oom_restores_state(corpus, tmp_path, caplog):
    """--scan-oom trains one step on the epoch's largest batch, then puts
    the state before it back: the run that follows ends bit for bit where
    the same run without --scan-oom ends (weights, optimizer state, the
    float64 average, steps, hours)."""
    import logging

    from zipvoice_tpu_torch.train.checkpoint import load_checkpoint

    with caplog.at_level(logging.INFO):
        got = _cli(corpus, tmp_path / "scan", "--num-epochs", "1", "--scan-oom")
    assert "scan-oom: ok" in caplog.text
    want = _cli(corpus, tmp_path / "ref", "--num-epochs", "1")
    a, b = got["trainer"], want["trainer"]
    assert [x for _, x in got["steps"]] == [x for _, x in want["steps"]]
    assert (a.batch_idx_train, a.seen_seconds) == (b.batch_idx_train, b.seen_seconds)
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name
    sa, sb = (load_checkpoint(str(d / "epoch-1.pt")) for d in (tmp_path / "scan",
                                                               tmp_path / "ref"))
    assert sa["opt_state"]["step"] == sb["opt_state"]["step"] == 2
    for name, st in sa["opt_state"]["params"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["opt_state"]["params"][name][k]), (name, k)
    for k, v in sa["model_avg"].items():
        assert torch.equal(v, sb["model_avg"][k]), k


def test_train_cli_defaults_to_cuda(corpus, tmp_path):
    from zipvoice_tpu_torch.bin.train_zipvoice import get_parser

    assert get_parser().parse_args(["--train-manifest", "a", "--token-file", "b",
                                    "--model-config", "c"]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _cli(corpus, tmp_path / "exp", "--device", "cuda")
