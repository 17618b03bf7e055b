"""The port's data-parallel training and the training CLIs' tools against
the JAX package on the CPU, at tiny sizes:

* the sampler's per-rank shards and the precomputed-feature collator equal
  JAX's;
* two gloo ranks (processes) with unequal valid frames and the
  regularizers off: each rank's summed gradient equals JAX's gradient of
  compute_fm_loss on the global batch, as does the global loss; after 3
  Trainer steps with the regularizers on, the ranks' parameters are
  bit-identical and only rank 0 wrote (properties (a) and (b) of
  tests/test_distributed.py);
* two ranks given the same rows draw different t, noise and per-row masks,
  and the same per-layer gates and batch-shared draws;
* the CPU dry run (``train/dryrun.run_dryrun(2)``): the train, distill and
  dialog CLIs with --distributed over gloo in two processes, then the
  sequence-parallel sampler over them;
* param_diagnostics, activation_diagnostics and find_nonfinite equal
  JAX's.

Tolerances: the gradients within 1e-4 relative L2 a tensor and the loss
within 1e-5 relative (test_compute_fm_loss_matches_jax's); the statistics
within 1e-4 relative and the covariance eigenvalues within 1e-3 (f32
reductions in another order, then an eigensolver)."""

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
from zipvoice_tpu.data import dataset as jds
from zipvoice_tpu.io.checkpoint import state_dict_to_params
from zipvoice_tpu.models import zipvoice as jzv
from zipvoice_tpu.text.tokenizer import SimpleTokenizer as JSimpleTokenizer
from zipvoice_tpu.utils import diagnostics as jdiag
from zipvoice_tpu.utils import hooks as jhooks
from zipvoice_tpu_torch.config import ZipVoiceConfig
from zipvoice_tpu_torch.data import dataset as tds
from zipvoice_tpu_torch.io.checkpoint import from_jax_params, load_into
from zipvoice_tpu_torch.models import zipvoice as tzv
from zipvoice_tpu_torch.nn import zipformer as tzf
from zipvoice_tpu_torch.parallel import mesh
from zipvoice_tpu_torch.text.tokenizer import SimpleTokenizer, write_token_file
from zipvoice_tpu_torch.train import dryrun
from zipvoice_tpu_torch.train import step as tstep
from zipvoice_tpu_torch.utils import diagnostics as tdiag
from zipvoice_tpu_torch.utils import hooks as thooks

# torch's CPU ops share one OpenMP pool a process; pytest-xdist runs a
# process a worker, and pools sized to every core oversubscribe the machine
# by the worker count, which slows torch's ops by orders of magnitude
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

TESTS = Path(__file__).resolve().parent
# one fm_decoder stack of one layer keeps the JAX reference's compile (and
# its eager, op-by-op diagnostics forward) short
TINY = dict(fm_decoder_downsampling_factor=(1,), fm_decoder_num_layers=(1,),
            fm_decoder_cnn_module_kernel=(9,), fm_decoder_feedforward_dim=96,
            fm_decoder_num_heads=2, fm_decoder_dim=64, text_encoder_num_layers=1,
            text_encoder_feedforward_dim=48, text_encoder_cnn_module_kernel=5,
            text_encoder_num_heads=2, text_encoder_dim=48, time_embed_dim=32,
            text_embed_dim=48, query_head_dim=8, value_head_dim=8, pos_head_dim=4,
            pos_dim=48, feat_dim=20, vocab_size=28, pad_id=0)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _weights(seed):
    """(JAX parameter tree, the port's model on the same weights carried by
    from_jax_params); drawn by the port's init, which is quicker than
    JAX's op-by-op one."""
    init = tzv.init_zipvoice(ZipVoiceConfig(**TINY), torch.Generator().manual_seed(seed))
    tree = jax.tree.map(jnp.asarray, state_dict_to_params(
        {k: v.numpy() for k, v in init.state_dict().items()}))
    with torch.device("meta"):
        model = tzv.ZipVoiceModel(ZipVoiceConfig(**TINY))
    return tree, load_into(model, from_jax_params(_np_tree(tree)))


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b)) / max(float(np.linalg.norm(a)),
                                              float(np.linalg.norm(b)), 1e-6)


def _durations(n, seed=0):
    return np.random.default_rng(seed).uniform(1.0, 9.0, n)


@pytest.mark.parametrize("count", [1, 2, 3])
def test_sampler_shards_match_jax(count):
    """Every rank's shard of two epochs, uid by uid, equal to JAX's
    DurationBucketSampler(process_index=r, process_count=count), with
    equal counts on every rank."""
    durs = _durations(37)
    kw = dict(max_duration=20.0, seed=5, num_buckets=4)
    lens = {1: set(), 2: set()}
    for r in range(count):
        ours = tds.DurationBucketSampler(
            [tds.Utterance(f"u{i}", "x", "-", duration=float(d)) for i, d in enumerate(durs)],
            process_index=r, process_count=count, **kw)
        ref = jds.DurationBucketSampler(
            [jds.Utterance(f"u{i}", "x", "-", duration=float(d)) for i, d in enumerate(durs)],
            process_index=r, process_count=count, **kw)
        for epoch in (1, 2):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            got = [[u.uid for u in b] for b in ours]
            assert got == [[u.uid for u in b] for b in ref]
            assert [[u.uid for u in b] for b in ours.pessimistic_batches(2)] == \
                [[u.uid for u in b] for b in ref.pessimistic_batches(2)]
            lens[epoch].add(len(got))
    assert all(len(v) == 1 for v in lens.values())


def test_precomputed_collator_matches_jax(tmp_path):
    """Features from two npz shards, scaled, padded to the frame and batch
    buckets, with the tokens: the same arrays as JAX's collator."""
    rng = np.random.default_rng(2)
    write_token_file({"_": 0, " ": 1, **{c: i + 2 for i, c in
                                         enumerate("abcdefghijklmnopqrstuvwxyz")}},
                     str(tmp_path / "tokens.txt"))
    texts = ["hello world", "abc", "the quick fox"]
    index = []
    shards = {"s0.npz": {}, "s1.npz": {}}
    for i, text in enumerate(texts):
        name = f"s{i % 2}.npz"
        shards[name][f"u{i}"] = rng.standard_normal((70 + 13 * i, 20)).astype(np.float32)
        index.append(f"u{i}\t{text}\tu{i}.wav\t{name}")
    for name, arrs in shards.items():
        np.savez(tmp_path / name, **arrs)
    (tmp_path / "index.tsv").write_text("\n".join(index) + "\n")
    kw = dict(index_tsv=str(tmp_path / "index.tsv"), feats_dir=str(tmp_path),
              feat_scale=0.1, feat_bias=2.0)
    ours = tds.PrecomputedFeatureCollator(SimpleTokenizer(str(tmp_path / "tokens.txt")), **kw)
    ref = jds.PrecomputedFeatureCollator(JSimpleTokenizer(str(tmp_path / "tokens.txt")), **kw)
    got = ours([tds.Utterance(f"u{i}", t, "-") for i, t in enumerate(texts)])
    want = ref([jds.Utterance(f"u{i}", t, "-") for i, t in enumerate(texts)])
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k], got[k].dtype), err_msg=k)


def _global_batch(n_ranks, b=2, t=40, s=9):
    """A global batch of n_ranks * b rows with unequal valid frames and
    condition masks, so each rank's valid count differs."""
    rng = np.random.default_rng(4)
    rows = n_ranks * b
    tokens = rng.integers(1, 28, size=(rows, s + 1)).astype(np.int64)
    tokens_lens = np.array([s - (i % 4) for i in range(rows)])
    for i, n in enumerate(tokens_lens):
        tokens[i, n:] = 0
    features_lens = np.array([t - 5 * i for i in range(rows)])
    cond = np.zeros((rows, t), bool)
    for i, n in enumerate(features_lens):
        cond[i, 2 + i: 2 + i + int(n) // (2 + i % 2)] = True
    return {"tokens": tokens, "tokens_lens": tokens_lens,
            "features": (rng.standard_normal((rows, t, 20)) * 0.5).astype(np.float32),
            "features_lens": features_lens,
            "noise": rng.standard_normal((rows, t, 20)).astype(np.float32),
            "t": rng.uniform(0.1, 0.9, size=(rows, 1, 1)).astype(np.float32),
            "cond": cond}


def test_two_ranks_give_jax_global_batch_gradient(tmp_path, monkeypatch):
    """Two gloo processes, each on half of the global batch: the summed
    gradient on every rank equals JAX's value_and_grad of compute_fm_loss
    on the whole batch (regularizers off, the condition mask pinned on both
    sides); after 3 Trainer steps with the regularizers on, the ranks'
    parameters are bit-identical, the hours count both ranks' frames and
    only rank 0 wrote checkpoints or logs."""
    jcfg = JZipVoiceConfig(**TINY)
    params, model = _weights(0)
    torch.save(model.state_dict(), tmp_path / "model.pt")
    g = _global_batch(2)
    np.savez(tmp_path / "batch.npz", **g)
    cfg = json.dumps({k: list(v) if isinstance(v, tuple) else v for k, v in TINY.items()})
    steps = 3
    failure = []

    def ranks():
        try:
            dryrun.spawn("torch_dp_worker:run", 2,
                         {"cfg": cfg, "model_path": str(tmp_path / "model.pt"),
                          "batch_path": str(tmp_path / "batch.npz"), "out": str(tmp_path),
                          "steps": steps}, timeout=180, path=[str(TESTS)])
        except Exception as ex:  # noqa: BLE001 - re-raised in the test's thread
            failure.append(ex)

    worker = threading.Thread(target=ranks)
    worker.start()  # the JAX reference compiles meanwhile
    monkeypatch.setattr(jzv, "condition_time_mask", lambda *a, **k: jnp.asarray(g["cond"]))

    def jloss(p):
        return jzv.compute_fm_loss(p, jcfg, *(jnp.asarray(g[k]) for k in (
            "tokens", "tokens_lens", "features", "features_lens", "noise", "t")),
            jax.random.PRNGKey(0))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    ref = {k: v.numpy() for k, v in from_jax_params(_np_tree(jg)).items()}
    worker.join(timeout=200)
    assert not worker.is_alive()
    if failure:
        raise failure[0]

    synced = [torch.load(tmp_path / f"grads-{r}.pt") for r in range(2)]
    for res in synced:
        assert abs(res["loss"] - float(jl)) <= 1e-5 * float(jl)
        for name, grad in res["grads"].items():
            assert _rel_l2(grad.numpy(), ref[name]) < 1e-4, name
    # each rank's share is its sum over the global count, so the shares
    # differ and add up to the global loss
    assert synced[0]["local_loss"] != synced[1]["local_loss"]
    for name, grad in synced[0]["grads"].items():
        assert torch.equal(grad, synced[1]["grads"][name]), name

    trained = [torch.load(tmp_path / f"params-{r}.pt") for r in range(2)]
    assert trained[0]["losses"] == trained[1]["losses"]
    assert all(np.isfinite(trained[0]["losses"]))
    for name, v in trained[0]["params"].items():
        assert torch.equal(v, trained[1]["params"][name]), name
    frames = float(np.sum(g["features_lens"][:2]))
    assert trained[0]["seen_seconds"] == pytest.approx(3 * 2 * frames / 93.75)
    written = sorted(p.name for p in (tmp_path / "exp-0").iterdir())
    assert {f"checkpoint-{i}.pt" for i in range(1, steps + 1)} <= set(written)
    assert "train_log.jsonl" in written
    assert list((tmp_path / "exp-1").iterdir()) == []


def test_ranks_draw_their_own_rows(monkeypatch):
    """Two ranks given the same rows: t, the noise, the condition mask and
    a context's per-row masks differ; the per-layer gates (host draws) and
    the batch-shared positional-encoding dropout agree; rank 0 draws as a
    single process does."""
    feats = torch.zeros(3, 16, 4)
    lens = torch.tensor([16, 12, 9])
    draws = {}
    for r in (0, 1, None):
        monkeypatch.setattr(mesh, "rank", lambda r=r: r or 0)
        t, noise, k_loss = tstep.draw_t_and_noise(11, feats)
        mask = tzv.condition_time_mask(lens, 16, torch.Generator().manual_seed(
            mesh.fold_rank(k_loss)))
        ctx = tzf.TrainCtx(5, {}, "cpu")
        gates = [ctx.gate(0.5) for _ in range(32)]
        draws[r] = (t, noise, mask, gates, ctx.uniform((3, 1, 1)),
                    torch.rand(8, generator=ctx.shared_gen))
    (t0, n0, m0, g0, u0, s0), (t1, n1, m1, g1, u1, s1) = draws[0], draws[1]
    assert not torch.equal(t0, t1) and not torch.equal(n0, n1)
    assert not torch.equal(m0, m1) and not torch.equal(u0, u1)
    assert g0 == g1 and torch.equal(s0, s1)
    for a, b in zip(draws[0], draws[None]):
        assert a == b if isinstance(a, list) else torch.equal(a, b)


def test_dryrun_two_processes():
    """train/dryrun.run_dryrun(2): the train, distill and dialog CLIs with
    --distributed over gloo, bf16, in two processes: finite losses equal on
    both ranks, bit-identical parameters, only rank 0's files; then the
    sequence-parallel sampler over both ranks, the same output on each and
    within 2e-5 of one process's."""
    losses = dryrun.run_dryrun(2, timeout=240)
    assert sorted(losses) == ["dialog", "distill", "zipvoice"]


def test_diagnostics_match_jax():
    """param_diagnostics on the port's model (weights carried from JAX's)
    and activation_diagnostics of the fm_decoder on one input: the same
    keys and statistics as JAX's, within 1e-4 relative (parameters in the
    torch layout, so a Linear or conv weight's shape differs but not its
    size, and per-dim profiles are not compared)."""
    jcfg = JZipVoiceConfig(**TINY)
    params, model = _weights(1)
    scalars = ("abs_mean", "rms", "pos_frac", "min", "max")

    ours, ref = tdiag.param_diagnostics(model), jdiag.param_diagnostics(params)
    assert sorted(ours) == sorted(ref)
    for name, s in ours.items():
        assert np.prod(s["shape"]) == np.prod(ref[name]["shape"]), name
        for k in scalars:
            assert s[k] == pytest.approx(ref[name][k], rel=1e-4, abs=1e-7), (name, k)

    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 24, 3 * 20)).astype(np.float32)
    tv = np.array([0.3, 0.6], np.float32)
    ours = tdiag.activation_diagnostics(model.fm_decoder, torch.from_numpy(x),
                                        t=torch.from_numpy(tv))
    ref = jdiag.activation_diagnostics(params["fm_decoder"], jcfg.fm_decoder_config(), x,
                                       t=tv)
    assert list(ours) == list(ref)
    assert "encoders.0.layer0.feed_forward1" in ours
    assert "entropy" in ours["encoders.0.layer0.self_attn_weights"]
    for name, s in ours.items():
        want = ref[name]
        assert s["shape"] == want["shape"], name
        for k in scalars + (("entropy",) if "entropy" in want else ()):
            assert s[k] == pytest.approx(want[k], rel=1e-4, abs=1e-6), (name, k)
        assert sorted(s.get("dims", {})) == sorted(want.get("dims", {})), name
        for d, prof in s.get("dims", {}).items():
            for k, v in prof.items():
                np.testing.assert_allclose(v, want["dims"][d][k], rtol=1e-4, atol=1e-5,
                                           err_msg=f"{name} dim {d} {k}")
        if "eigs" in want:
            np.testing.assert_allclose(s["eigs"], want["eigs"], rtol=1e-3, atol=1e-5,
                                       err_msg=name)
    lines = tdiag.format_diagnostics(ours).splitlines()
    want = jdiag.format_diagnostics(ref).splitlines()
    assert [ln.split()[0] for ln in lines] == [ln.split()[0] for ln in want]


def test_find_nonfinite_matches_jax():
    """The names of the tensors holding inf or nan in a nested dict, and
    in a module's parameters, equal JAX's find_nonfinite on the same
    tree."""
    tree = {"a": np.ones(3, np.float32), "b": {"c": np.array([1.0, np.nan], np.float32),
                                              "d": np.array([np.inf], np.float32),
                                              "e": np.arange(3)},
            "f": np.zeros((2, 2), np.float32)}
    want = jhooks.find_nonfinite(tree)
    assert want == ["b.c", "b.d"]
    assert thooks.find_nonfinite(tree) == want
    assert thooks.find_nonfinite(
        {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else
         {kk: torch.from_numpy(vv) for kk, vv in v.items()} for k, v in tree.items()}) == want
    lin = torch.nn.Linear(2, 2)
    with torch.no_grad():
        lin.bias[0] = float("nan")
    assert thooks.find_nonfinite(lin) == ["bias"]
    assert not thooks.warn_nonfinite(lin)
    with pytest.raises(FloatingPointError, match="bias"):
        thooks.assert_all_finite(lin)
