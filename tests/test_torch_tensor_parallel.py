"""The port's tensor parallelism (``parallel/mesh``: the feedforwards'
hidden dimension over a model group) against the JAX package's
``tp_param_shardings`` and its DP x TP step, on the CPU over gloo
processes (``train/dryrun.spawn``; ``tests/torch_tp_worker.py`` is a rank),
at the TINY widths of tests/test_tensor_parallel.py:

* tp = 2 (dp = 1) with the condition mask, noise and t pinned: the loss
  within 1e-5 relative of JAX's compute_fm_loss, the gathered gradients
  within 1e-4 relative L2 a tensor of JAX's, and four ScaledAdam updates on
  them (a size update among them: the whole-tensor RMS and scale
  gradients) within atol 1e-5 of JAX's scaled_adam, the dominant-gradient
  share (the clipping norm's whole-tensor sums) within 1e-5 relative;
* 3 regularized f32 steps through ``make_train_step(mesh=...)``: each
  step's loss within 1e-5 relative of one process's step from the same
  parameters with the same seed (the sliced dropout and the fold by the
  data index give the one-process draws), the gathered parameters
  bit-identical on both ranks.  Neither the regularized gradient nor the
  parameters after regularized steps are held elementwise: the
  regularizers switch their gradient terms on thresholds (a balancer
  channel's limits, the whitening metric's) and ScaledAdam's first
  updates are sign-like, so a one-ulp change of the weights alone moves
  one process's own regularized gradient and parameters beyond these
  tolerances at these shapes;
* dp = 2 x tp = 2 in four processes, one f32 step: the data ranks' shards
  bit-identical and the loss within 1e-5 relative of a dp = 2 run's; without
  the regularizers the gathered gradient within 1e-4 relative L2 a tensor
  and the gathered parameters within atol 1e-4 (JAX's own TP tolerance) of
  dp = 2's;
* the split map equal to JAX's through ``from_jax_params`` (>= 9 tensors),
  the shards at local shape, a step's collectives all-reduces only.
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
from zipvoice_tpu.parallel.mesh import make_mesh as jmake_mesh
from zipvoice_tpu.parallel.mesh import tp_param_shardings as jtp_param_shardings
from zipvoice_tpu.train.scaled_adam import apply_updates, leaf_names, scaled_adam
from zipvoice_tpu_torch.config import ZipVoiceConfig
from zipvoice_tpu_torch.io.checkpoint import from_jax_params, load_into
from zipvoice_tpu_torch.models import zipvoice as tzv
from zipvoice_tpu_torch.nn import regularizers as treg
from zipvoice_tpu_torch.parallel import mesh
from zipvoice_tpu_torch.train import dryrun
from zipvoice_tpu_torch.train.scaled_adam import ScaledAdam
from zipvoice_tpu_torch.train.schedules import zipvoice_schedules
from zipvoice_tpu_torch.train.step import TrainConfig, make_train_step

# see tests/test_torch_distributed.py: one OpenMP pool a pytest-xdist worker
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

TESTS = Path(__file__).resolve().parent
# tests/test_tensor_parallel.py's TINY
TINY = dict(fm_decoder_downsampling_factor=(1, 2, 1), fm_decoder_num_layers=(1, 1, 1),
            fm_decoder_cnn_module_kernel=(9, 7, 9), fm_decoder_feedforward_dim=96,
            fm_decoder_num_heads=2, fm_decoder_dim=64, text_encoder_num_layers=1,
            text_encoder_feedforward_dim=48, text_encoder_cnn_module_kernel=5,
            text_encoder_num_heads=2, text_encoder_dim=48, time_embed_dim=32,
            text_embed_dim=48, query_head_dim=8, value_head_dim=8, pos_head_dim=4,
            pos_dim=48, feat_dim=16, vocab_size=40, pad_id=0)
LR = 0.02
UPDATES = 4  # ScaledAdam updates on the pinned gradients: step 3 is a size update


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


def _batch(rows=4, t=32, s=12):
    """Rows with unequal valid frames and condition masks."""
    rng = np.random.default_rng(4)
    tokens = rng.integers(1, TINY["vocab_size"], size=(rows, s)).astype(np.int64)
    tokens_lens = np.array([s - 2 - (i % 3) for i in range(rows)])
    for i, n in enumerate(tokens_lens):
        tokens[i, n:] = 0
    features_lens = np.array([t - 3 * i for i in range(rows)])
    cond = np.zeros((rows, t), bool)
    for i, n in enumerate(features_lens):
        cond[i, 2 + i: 2 + i + int(n) // (2 + i % 2)] = True
    return {"tokens": tokens, "tokens_lens": tokens_lens,
            "features": (rng.standard_normal((rows, t, 16)) * 0.5).astype(np.float32),
            "features_lens": features_lens,
            "noise": rng.standard_normal((rows, t, 16)).astype(np.float32),
            "t": rng.uniform(0.1, 0.9, size=(rows, 1, 1)).astype(np.float32),
            "cond": cond}


def _cfg_json():
    return json.dumps({k: list(v) if isinstance(v, tuple) else v for k, v in TINY.items()})


def _spawn_in_thread(target, n, kwargs, failure):
    def run():
        try:
            dryrun.spawn(target, n, kwargs, timeout=240, path=[str(TESTS)])
        except Exception as ex:  # noqa: BLE001 - re-raised in the test's thread
            failure.append(ex)

    th = threading.Thread(target=run)
    th.start()
    return th


def _one_process_loss(params, batch, i):
    """The loss of one process's regularized step i (seed 5 + i) from
    ``params``."""
    model = load_into(tzv.ZipVoiceModel(ZipVoiceConfig(**TINY)), params)
    step = make_train_step(model, ScaledAdam(model.named_parameters()),
                           TrainConfig(compute_dtype="float32"))
    return float(step(batch, 5 + i, i + 1, 0.0,
                      zipvoice_schedules(1000.0, ZipVoiceConfig(**TINY)))["loss"])


def test_tp_two_ranks_match_jax_and_one_process(tmp_path, monkeypatch):
    jcfg = JZipVoiceConfig(**TINY)
    params, model = _weights(0)
    torch.save(model.state_dict(), tmp_path / "model.pt")
    g = _batch()
    np.savez(tmp_path / "batch.npz", **g)
    failure = []
    worker = _spawn_in_thread("torch_tp_worker:pinned", 2,
                              {"cfg": _cfg_json(), "model_path": str(tmp_path / "model.pt"),
                               "batch_path": str(tmp_path / "batch.npz"), "out": str(tmp_path),
                               "lr": LR, "updates": UPDATES}, failure)

    # the JAX reference meanwhile: the loss, its gradient, ScaledAdam on it
    monkeypatch.setattr(jzv, "condition_time_mask", lambda *a, **k: jnp.asarray(g["cond"]))

    def jloss(p):
        return jzv.compute_fm_loss(p, jcfg, *(jnp.asarray(g[k]) for k in (
            "tokens", "tokens_lens", "features", "features_lens", "noise", "t")),
            jax.random.PRNGKey(0))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    jopt = scaled_adam(clipping_scale=2.0)
    state, p = jopt.init(params), params
    update = jax.jit(lambda grads, st, pp: jopt.update(grads, st, pp, LR,
                                                       with_diagnostics=True))
    names, jdiags = leaf_names(params), []
    for _ in range(UPDATES):
        upd, state, diag = update(jg, state, p)
        p = apply_updates(p, upd)
        jdiags.append((names[int(diag["grad_dominant_idx"])],
                       float(diag["grad_dominant_frac"])))
    ref_grads = {k: v.numpy() for k, v in from_jax_params(_np_tree(jg)).items()}
    ref_updated = {k: v.numpy() for k, v in from_jax_params(_np_tree(p)).items()}
    worker.join(timeout=260)
    assert not worker.is_alive()
    if failure:
        raise failure[0]

    ranks = [torch.load(tmp_path / f"pinned-{r}.pt") for r in range(2)]
    for res in ranks:
        assert abs(res["loss"] - float(jl)) <= 1e-5 * float(jl)
        for name, grad in res["grads"].items():
            assert _rel_l2(grad.numpy(), ref_grads[name]) < 1e-4, name
        for name, v in res["updated"].items():
            np.testing.assert_allclose(v.numpy(), ref_updated[name], rtol=0, atol=1e-5,
                                       err_msg=name)
        for (jname, jfrac), d in zip(jdiags, res["diags"]):
            assert d["name"] == jname and d["frac"] == pytest.approx(jfrac, rel=1e-5)
    # (b): each regularized step's loss against one process's from the
    # same parameters with the same seed
    batch = {k: g[k] for k in ("tokens", "tokens_lens", "features", "features_lens")}
    for i, st in enumerate(ranks[0]["steps"]):
        loss = _one_process_loss(st["params"], batch, i)
        for res in ranks:
            assert res["steps"][i]["loss"] == pytest.approx(loss, rel=1e-5), i
    for name, v in ranks[0]["trained"].items():
        assert torch.equal(v, ranks[1]["trained"][name]), name

    # (d): a step's collectives are all-reduces only: the feedforwards'
    # pair (forward and backward), the replicated gradients' average over
    # the model group and ScaledAdam's two whole-tensor sums
    res = ranks[0]
    assert res["n_ff"] == 3 * 4  # 3 feedforwards in each of 3 fm_decoder and 1 text layer
    assert res["loss_counts"] == {"all_reduce": 2 * res["n_ff"] + 1, "all_gather": 0,
                                  "halo": 0}
    for counts in res["step_counts"]:
        assert counts == {"all_reduce": 2 * res["n_ff"] + 3, "all_gather": 0, "halo": 0}
    assert res["shapes"]["fm_decoder.encoders.0.layers.0.feed_forward2.in_proj.weight"] == \
        (48, 64)
    assert res["shapes"]["fm_decoder.encoders.0.layers.0.feed_forward2.out_proj.weight"] == \
        (64, 48)


@pytest.mark.parametrize("regularizers", [False, True])
def test_dp_tp_four_ranks_match_dp_two(tmp_path, regularizers):
    """dp = 2 x tp = 2 (four processes, rank r at (r // 2, r % 2)) against
    dp = 2 (two processes), one f32 step on the same rows: the shards of the
    two data ranks of each model index bit-identical and the loss within
    1e-5 relative of dp = 2's (the loss normalizer summed over the data
    group only, the draws folded by the data index); without the
    regularizers the gathered gradient within 1e-4 relative L2 a tensor and
    the gathered parameters within atol 1e-4 of dp = 2's (the gradient
    summed over the data group only; module docstring for why not with
    them)."""
    _, model = _weights(1)
    torch.save(model.state_dict(), tmp_path / "model.pt")
    np.savez(tmp_path / "batch.npz", **_batch())
    kw = {"cfg": _cfg_json(), "model_path": str(tmp_path / "model.pt"),
          "batch_path": str(tmp_path / "batch.npz"), "out": str(tmp_path),
          "regularizers": regularizers}
    failure = []
    threads = [_spawn_in_thread("torch_tp_worker:step", 4, dict(kw, n_model=2, tag="tp"),
                                failure),
               _spawn_in_thread("torch_tp_worker:step", 2, dict(kw, n_model=1, tag="dp"),
                                failure)]
    for th in threads:
        th.join(timeout=260)
        assert not th.is_alive()
    if failure:
        raise failure[0]
    tp = [torch.load(tmp_path / f"tp-{r}.pt") for r in range(4)]
    dp = [torch.load(tmp_path / f"dp-{r}.pt") for r in range(2)]
    assert [r["index"] for r in tp] == [{"data": d, "model": m} for d in (0, 1) for m in (0, 1)]
    for m in (0, 1):
        for name, v in tp[m]["shards"].items():
            assert torch.equal(v, tp[2 + m]["shards"][name]), (m, name)
    assert len({r["loss"] for r in tp}) == 1
    assert tp[0]["loss"] == pytest.approx(dp[0]["loss"], rel=1e-5)
    for r in tp:
        if not regularizers:
            for name, grad in dp[0]["grads"].items():
                assert _rel_l2(r["grads"][name].numpy(), grad.numpy()) < 1e-4, name
            for name, v in dp[0]["full"].items():
                np.testing.assert_allclose(r["full"][name].numpy(), v.numpy(), rtol=0,
                                           atol=1e-4, err_msg=name)


def test_tp_sharding_map_matches_jax():
    """The port's split map equals JAX's tp_param_shardings through the
    weight bridge (the same tensors, the split dimension moved by the
    (in, out) -> (out, in) transpose); >= 9 split tensors at TINY; sharded
    over a model axis of 2, the feedforwards hold their local shapes
    (fm_decoder 96 -> 48) and the rest stays whole."""
    params, model = _weights(2)
    shardings = jtp_param_shardings(jmake_mesh(n_data=4, n_model=2), params)
    # a marker a leaf: 0 replicated, 1 + the JAX axis split over "model"
    markers = jax.tree.map(
        lambda leaf, s: np.full(np.shape(leaf), 0.0 if "model" not in s.spec
                                else 1.0 + list(s.spec).index("model"), np.float32),
        params, shardings)
    jax_split = {}
    for name, v in from_jax_params(markers).items():
        axis = int(v.reshape(-1)[0]) - 1
        if axis >= 0:
            jax_split[name] = 0 if v.ndim == 1 else 1 - axis
    spec = mesh.tp_param_shardings(model)
    ours = {k: d for k, d in spec.items() if d is not None}
    assert ours == jax_split
    assert len(ours) >= 9
    full = {k: tuple(v.shape) for k, v in model.named_parameters()}
    fake = mesh.Mesh({"data": 1, "model": 2}, {"data": 0, "model": 1}, {"data": None,
                                                                         "model": None})
    mesh.shard_module(model, spec, fake)
    for name, p in model.named_parameters():
        want = list(full[name])
        if name in ours:
            want[ours[name]] //= 2
            assert p.tp_shard.index == 1 and p.tp_dim == ours[name]
        assert tuple(p.shape) == tuple(want), name
    ff = model.fm_decoder.encoders[0].layers[0].feed_forward2
    assert tuple(ff.in_proj.weight.shape) == (48, 64) and ff.tp_shard.size == 2
    assert tuple(ff.out_proj.bias.shape) == (64,)


def test_tp_dropout_mask_is_the_full_width_draws_slice():
    """A shard's shared dropout mask is the full-width draw's columns, and
    the generator ends where the full-width draw leaves it."""
    x = torch.ones(3, 5, 8)
    full = treg.dropout_shared(torch.ones(3, 5, 16), torch.Generator().manual_seed(7), 0.4,
                               shared_dim=1)
    for i in (0, 1):
        gen = torch.Generator().manual_seed(7)
        part = treg.dropout_shared(x, gen, 0.4, shared_dim=1, columns=(8 * i, 16))
        assert torch.equal(part, full[..., 8 * i:8 * (i + 1)])
        after = torch.Generator().manual_seed(7)
        torch.rand((3, 1, 16), generator=after)
        assert torch.equal(torch.rand(4, generator=gen), torch.rand(4, generator=after))


def test_draws_fold_by_the_data_index(monkeypatch):
    """Under a mesh the draws fold by the data index: the ranks of one
    model group (rank 0 and 1 at data index 0) draw as one process; data
    index 1 draws its own; without a mesh a rank folds by its rank, as
    before."""
    monkeypatch.setattr(mesh, "rank", lambda: 1)
    seed = 123
    by_rank = mesh.fold_rank(seed)
    assert by_rank != seed and mesh.data_index() == 1
    rows = [mesh.Mesh({"data": 2, "model": 2}, {"data": d, "model": 1},
                      {"data": None, "model": None}) for d in (0, 1)]
    with mesh.use_mesh(rows[0]):
        assert mesh.fold_rank(seed) == seed and mesh.data_index() == 0
    with mesh.use_mesh(rows[1]):
        assert mesh.fold_rank(seed) == by_rank
