"""The port's sequence-parallel training (``parallel/mesh.make_dp_sp_mesh``
and ``train/step.make_train_step(mesh=...)``: the fm_decoder's frames over
a seq group of gloo processes, ``tests/torch_sp_train_worker.py`` a rank)
against the JAX package's ``compute_fm_loss`` and against the port's own
data-parallel and one-process steps, at the TINY widths of
tests/test_sequence_parallel.py (T = 64, downsampling (1, 2, 1)):

* sp = 2 and sp = 4 (dp = 1), f32, no regularizers, with the condition
  mask, noise and t pinned: the loss within 1e-5 relative of JAX's
  compute_fm_loss, and every synced gradient within 1e-4 relative L2 of
  JAX's value_and_grad;
* dp = 2 x sp = 2 in four processes, one f32 step through
  ``make_train_step`` without the regularizers, against a dp = 2 run on
  the same rows: the loss within 1e-5 and the parameters within atol 1e-4
  (JAX's test_sp_train_step_matches_dp tolerances), the two data ranks'
  parameters (and their seq ranks') bit-identical;
* sp = 2 with the regularizers: 3 f32 steps, each loss within 1e-5
  relative of one process's step from the same parameters with the same
  seed (the whole-sequence draws and the seq-summed statistics give one
  process's forward).  The regularized parameters are not held
  elementwise: the regularizers switch their gradient terms on
  thresholds (a balancer channel's limits, the whitening metric's), so a
  sum taken in another order can flip one, as in
  tests/test_torch_tensor_parallel.py;
* the text encoder's and the token embedding's gradients under sp = 2,
  with the text encoder's regularizers on and the fm_decoder's left out,
  within 1e-5 relative L2 of one process's: the text encoder runs whole
  and bit-identical on both ranks, so only the order of the cotangent's
  sums differs; a text encoder whose ranks' gradients were summed rather
  than averaged over the seq group would be off by a factor of 2;
* the stereo dialog loss (the suffix mask, the speaker embedding, the
  energy penalty whose median spans the whole sequence) under sp = 2,
  pinned: the loss within 1e-5 relative and every gradient within 1e-4
  relative L2 of one process's (the bound of the JAX comparisons: a
  downsampling bias's two gradient entries are equal and opposite sums of
  terms a hundred times larger, so their f32 sum order shows at 1e-5).
"""

import json
import os
import threading
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zipvoice_tpu.config import ZipVoiceConfig as JZipVoiceConfig
from zipvoice_tpu.io.checkpoint import state_dict_to_params
from zipvoice_tpu.models import zipvoice as jzv
from zipvoice_tpu_torch.config import ZipVoiceConfig
from zipvoice_tpu_torch.io.checkpoint import from_jax_params, load_into
from zipvoice_tpu_torch.models import zipvoice as tzv
from zipvoice_tpu_torch.train import dryrun
from zipvoice_tpu_torch.train.scaled_adam import ScaledAdam
from zipvoice_tpu_torch.train.schedules import zipvoice_schedules
from zipvoice_tpu_torch.train.step import TrainConfig, make_train_step

# see tests/test_torch_distributed.py: one OpenMP pool a pytest-xdist worker
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

TESTS = Path(__file__).resolve().parent
# tests/test_sequence_parallel.py's TINY
TINY = dict(fm_decoder_downsampling_factor=(1, 2, 1), fm_decoder_num_layers=(1, 1, 1),
            fm_decoder_cnn_module_kernel=(9, 7, 9), fm_decoder_feedforward_dim=96,
            fm_decoder_num_heads=2, fm_decoder_dim=64, text_encoder_num_layers=1,
            text_encoder_feedforward_dim=48, text_encoder_cnn_module_kernel=5,
            text_encoder_num_heads=2, text_encoder_dim=48, time_embed_dim=32,
            text_embed_dim=48, query_head_dim=8, value_head_dim=8, pos_head_dim=4,
            pos_dim=48, feat_dim=16, vocab_size=40, pad_id=0)
T = 64


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _weights(seed):
    """(JAX parameter tree, the port's model on the same weights)."""
    init = tzv.init_zipvoice(ZipVoiceConfig(**TINY), torch.Generator().manual_seed(seed))
    tree = jax.tree.map(jnp.asarray, state_dict_to_params(
        {k: v.numpy() for k, v in init.state_dict().items()}))
    with torch.device("meta"):
        model = tzv.ZipVoiceModel(ZipVoiceConfig(**TINY))
    return tree, load_into(model, from_jax_params(_np_tree(tree)))


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b)) / max(float(np.linalg.norm(a)),
                                              float(np.linalg.norm(b)), 1e-6)


def _batch(rows=4, s=12):
    """Rows with unequal valid frames and condition masks; the mask spans
    the ranks' frame boundaries."""
    rng = np.random.default_rng(19)
    tokens = rng.integers(1, TINY["vocab_size"], size=(rows, s)).astype(np.int64)
    tokens_lens = np.array([s - 2 - (i % 3) for i in range(rows)])
    for i, n in enumerate(tokens_lens):
        tokens[i, n:] = 0
    features_lens = np.array([T - 5 * i for i in range(rows)])
    cond = np.zeros((rows, T), bool)
    for i, n in enumerate(features_lens):
        cond[i, 3 + 2 * i: 3 + 2 * i + int(n) * 2 // 3] = True
    return {"tokens": tokens, "tokens_lens": tokens_lens,
            "features": (rng.standard_normal((rows, T, 16)) * 0.5).astype(np.float32),
            "features_lens": features_lens,
            "noise": rng.standard_normal((rows, T, 16)).astype(np.float32),
            "features2": (rng.standard_normal((rows, T, 32)) * 0.5).astype(np.float32),
            "noise2": rng.standard_normal((rows, T, 32)).astype(np.float32),
            "t": rng.uniform(0.1, 0.9, size=(rows, 1, 1)).astype(np.float32),
            "cond": cond}


def _spawn_in_thread(target, n, kwargs, failure):
    def run():
        try:
            dryrun.spawn(target, n, kwargs, timeout=240, path=[str(TESTS)])
        except Exception as ex:  # noqa: BLE001 - re-raised in the test's thread
            failure.append(ex)

    th = threading.Thread(target=run)
    th.start()
    return th


def _torch_batch(g):
    return {k: torch.from_numpy(v) for k, v in g.items()}


def _one_process_pinned(model, g, schedules=None):
    """One process's compute_fm_loss gradient with the mask, noise and t
    pinned."""
    x = _torch_batch(g)
    drawn = tzv.condition_time_mask
    tzv.condition_time_mask = lambda *a, **k: x["cond"]
    try:
        loss = tzv.compute_fm_loss(model, x["tokens"], x["tokens_lens"], x["features"],
                                   x["features_lens"], x["noise"], x["t"], 0,
                                   schedules=schedules)
    finally:
        tzv.condition_time_mask = drawn
    loss.backward()
    return float(loss.detach()), {n: p.grad.numpy() for n, p in model.named_parameters()}


def _one_process_loss(params, batch, i):
    """The loss of one process's regularized f32 step i (seed 5 + i) from
    ``params``."""
    cfg = ZipVoiceConfig(**TINY)
    model = load_into(tzv.ZipVoiceModel(cfg), params)
    step = make_train_step(model, ScaledAdam(model.named_parameters()),
                           TrainConfig(compute_dtype="float32"))
    return float(step(batch, 5 + i, i + 1, 0.0, zipvoice_schedules(1000.0, cfg))["loss"])


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' results (``tests/torch_sp_train_worker.py``), JAX's
    pinned loss and gradient, and the batch."""
    tmp = tmp_path_factory.mktemp("sp_training")
    params, model = _weights(0)
    torch.save(model.state_dict(), tmp / "model.pt")
    g = _batch()
    np.savez(tmp / "batch.npz", **g)
    kw = {"cfg": json.dumps({k: list(v) if isinstance(v, tuple) else v
                             for k, v in TINY.items()}),
          "model_path": str(tmp / "model.pt"), "batch_path": str(tmp / "batch.npz"),
          "out": str(tmp)}
    failure = []
    threads = [_spawn_in_thread("torch_sp_train_worker:two", 2, kw, failure),
               _spawn_in_thread("torch_sp_train_worker:four", 4, kw, failure)]

    # JAX's pinned loss and gradient meanwhile
    jcfg = JZipVoiceConfig(**TINY)
    pinned_mask = jzv.condition_time_mask
    jzv.condition_time_mask = lambda *a, **k: jnp.asarray(g["cond"])
    try:
        def jloss(p):
            return jzv.compute_fm_loss(p, jcfg, *(jnp.asarray(g[k]) for k in (
                "tokens", "tokens_lens", "features", "features_lens", "noise", "t")),
                jax.random.PRNGKey(0))

        jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    finally:
        jzv.condition_time_mask = pinned_mask
    ref = {"loss": float(jl),
           "grads": {k: v.numpy() for k, v in from_jax_params(_np_tree(jg)).items()}}
    for th in threads:
        th.join(timeout=260)
        assert not th.is_alive()
    if failure:
        raise failure[0]
    return {"two": [torch.load(tmp / f"two-{r}.pt") for r in range(2)],
            "four": [torch.load(tmp / f"four-{r}.pt") for r in range(4)],
            "jax": ref, "batch": g}


@pytest.mark.parametrize("n_seq", [2, 4])
def test_sp_loss_and_gradient_match_jax(worlds, n_seq):
    ref = worlds["jax"]
    ranks = worlds["two" if n_seq == 2 else "four"]
    layers, stacks = sum(TINY["fm_decoder_num_layers"]), len(TINY["fm_decoder_num_layers"])
    for res in ranks:
        r = res["pinned"]
        assert abs(r["loss"] - ref["loss"]) <= 1e-5 * ref["loss"]
        for name, grad in r["grads"].items():
            assert _rel_l2(grad.numpy(), ref["grads"][name]) < 1e-4, name
        # a layer: the forward's four all-gathers (k, two SelfAttention
        # values, NonlinAttention values) each with its backward all-reduce,
        # two halos each with its backward halo; a stack: the key mask's
        # gather; the text condition's slice gathered in the backward; the
        # loss normalizer and the gradient sum
        assert r["counts"] == {"all_gather": 4 * layers + stacks + 1,
                               "all_reduce": 4 * layers + 2, "halo": 4 * layers}
    for name, grad in ranks[0]["pinned"]["grads"].items():
        for res in ranks[1:]:
            assert torch.equal(res["pinned"]["grads"][name], grad), name


def test_dp_sp_step_matches_dp(worlds):
    """dp = 2 x sp = 2 (rank r at (r // 2, r % 2)) against dp = 2, one f32
    step without the regularizers: JAX's test_sp_train_step_matches_dp."""
    four, dp = worlds["four"], worlds["two"][0]
    assert [r["index"] for r in four] == [{"data": d, "seq": s} for d in (0, 1) for s in (0, 1)]
    assert len({r["dp_sp_loss"] for r in four}) == 1
    assert abs(four[0]["dp_sp_loss"] - dp["dp_loss"]) < 1e-5
    for name, v in dp["dp_params"].items():
        np.testing.assert_allclose(four[0]["dp_sp_params"][name].numpy(), v.numpy(), rtol=0,
                                   atol=1e-4, err_msg=name)
        for r in four[1:]:
            assert torch.equal(r["dp_sp_params"][name], four[0]["dp_sp_params"][name]), name


def test_sp_regularized_steps_match_one_process(worlds):
    ranks = worlds["two"]
    g = worlds["batch"]
    batch = {k: g[k] for k in ("tokens", "tokens_lens", "features", "features_lens")}
    for i, st in enumerate(ranks[0]["steps"]):
        loss = _one_process_loss(st["params"], batch, i)
        for res in ranks:
            assert res["steps"][i]["loss"] == pytest.approx(loss, rel=1e-5), i
    for name, v in ranks[0]["trained"].items():
        assert torch.equal(v, ranks[1]["trained"][name]), name


def test_sp_text_encoder_gradient_is_averaged_over_the_seq_group(worlds):
    _, model = _weights(0)
    cfg = ZipVoiceConfig(**TINY)
    scheds = {"text_encoder": zipvoice_schedules(1000.0, cfg)["text_encoder"],
              "fm_decoder": None}
    loss, grads = _one_process_pinned(model, worlds["batch"], scheds)
    text = [n for n in grads if not n.startswith("fm_decoder.")]
    assert len(text) > 20
    for res in worlds["two"]:
        r = res["text_regularized"]
        assert r["loss"] == pytest.approx(loss, rel=1e-5)
        for name in text:
            assert _rel_l2(r["grads"][name].numpy(), grads[name]) < 1e-5, name


def test_sp_dialog_stereo_matches_one_process(worlds):
    import torch_sp_train_worker as w

    model = w.dialog_model(ZipVoiceConfig(**TINY))
    loss = w.dialog_loss(model, _torch_batch(worlds["batch"]))
    loss.backward()
    for res in worlds["two"]:
        r = res["dialog"]
        assert r["loss"] == pytest.approx(float(loss.detach()), rel=1e-5)
        for name, p in model.named_parameters():
            want = torch.zeros_like(p) if p.grad is None else p.grad  # stream 1: unused
            assert _rel_l2(r["grads"][name].numpy(), want.numpy()) < 1e-4, name
