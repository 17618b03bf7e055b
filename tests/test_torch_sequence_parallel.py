"""The port's sequence-parallel sampler (``models/zipvoice.sp_sample``: the
fm_decoder's frame axis over a seq group of gloo processes,
``tests/torch_sp_worker.py`` a rank) against the JAX package's
``sp_sample_jit`` over its 8-device seq mesh and against the port's own
``sample`` in one process, at tests/test_sequence_parallel.py's TINY
(T = 128, B = 2, CFG, 2 steps):

* over 2 and 4 processes: within atol 1e-4 of JAX's sharded sampler and
  within 2e-5 (JAX's bound) of one process's;
* the collectives a request pinned (the counterpart of JAX's HLO
  assertions): an all-gather of k, of both SelfAttention values and of the
  NonlinAttention values a layer, of the key mask a stack, and one of the
  output; two halo exchanges a layer; B1's and B2's plain versions entered
  with each rank's Tq = T / n rows against all Tk = T keys;
* the refusals: a frame count not divisible by n x the largest
  downsampling factor, a stack whose rank holds fewer frames than its
  convolution's halo, the fused eval flags;
* the collectives' adjoints (gather_frames, halo, scatter_frames) and the
  balancer's and whitening's seq-summed statistics over two gloo ranks
  under autograd, against the whole-sequence ops in one process.
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
from zipvoice_tpu.parallel.mesh import make_seq_mesh as jmake_seq_mesh
from zipvoice_tpu.parallel.mesh import sp_sample_jit
from zipvoice_tpu_torch.config import ZipVoiceConfig
from zipvoice_tpu_torch.io.checkpoint import from_jax_params, load_into
from zipvoice_tpu_torch.models import zipvoice as tzv
from zipvoice_tpu_torch.nn import zipformer as tzf
from zipvoice_tpu_torch.parallel import mesh
from zipvoice_tpu_torch.train import dryrun

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
KW = dict(num_step=2, guidance_scale=1.0, t_shift=0.5)
T = 128


def _weights(seed):
    init = tzv.init_zipvoice(ZipVoiceConfig(**TINY), torch.Generator().manual_seed(seed))
    tree = jax.tree.map(jnp.asarray, state_dict_to_params(
        {k: v.numpy() for k, v in init.state_dict().items()}))
    with torch.device("meta"):
        model = tzv.ZipVoiceModel(ZipVoiceConfig(**TINY))
    return tree, load_into(model, from_jax_params(
        jax.tree.map(lambda a: np.asarray(a, np.float32), tree)))


def _inputs():
    """tests/test_sequence_parallel.py's request."""
    rng = np.random.default_rng(0)
    b = 2
    return {"tokens": rng.integers(1, TINY["vocab_size"], (b, 24)).astype(np.int32),
            "tokens_lens": np.array([20, 16], np.int32),
            "prompt_features": (rng.standard_normal((b, T, 16)) * 0.1).astype(np.float32),
            "prompt_features_lens": np.array([40, 32], np.int32),
            "features_lens": np.array([128, 100], np.int32),
            "noise": rng.standard_normal((b, T, 16)).astype(np.float32)}


ORDER = ("tokens", "tokens_lens", "prompt_features", "prompt_features_lens", "features_lens",
         "noise")


def test_sp_sample_matches_jax_and_one_process(tmp_path):
    params, model = _weights(0)
    torch.save(model.state_dict(), tmp_path / "model.pt")
    x = _inputs()
    np.savez(tmp_path / "inputs.npz", **x)
    cfg = json.dumps({k: list(v) if isinstance(v, tuple) else v for k, v in TINY.items()})
    failure = []

    def ranks(n):
        try:
            dryrun.spawn("torch_sp_worker:run", n,
                         {"cfg": cfg, "model_path": str(tmp_path / "model.pt"),
                          "inputs_path": str(tmp_path / "inputs.npz"), "out": str(tmp_path),
                          "tag": f"sp{n}", "kw": KW}, timeout=240, path=[str(TESTS)])
        except Exception as ex:  # noqa: BLE001 - re-raised in the test's thread
            failure.append(ex)

    threads = [threading.Thread(target=ranks, args=(n,)) for n in (2, 4)]
    for th in threads:
        th.start()

    # JAX's sharded sampler over its 8-device seq mesh, meanwhile
    jcfg = JZipVoiceConfig(**TINY)

    def run(p, tok, tl, pf, pl, fl, nz):
        return jzv.sample(p, jcfg, tok, tl, pf, pl, fl, nz, **KW)

    ref_jax = np.asarray(sp_sample_jit(run, jmake_seq_mesh(8))(
        params, *(jnp.asarray(x[k]) for k in ORDER)), np.float32)
    with torch.no_grad():
        ref_one = tzv.sample(model, *(torch.from_numpy(x[k]) for k in ORDER), **KW).numpy()
    for th in threads:
        th.join(timeout=260)
        assert not th.is_alive()
    if failure:
        raise failure[0]

    layers, stacks = sum(TINY["fm_decoder_num_layers"]), len(TINY["fm_decoder_num_layers"])
    calls = KW["num_step"]  # one 2B CFG batch a step
    for n in (2, 4):
        res = [torch.load(tmp_path / f"sp{n}-{r}.pt") for r in range(n)]
        for r in res:
            out = r["out"].numpy()
            assert out.shape == (2, T, 16)
            np.testing.assert_allclose(out, ref_jax, rtol=0, atol=1e-4)
            np.testing.assert_allclose(out, ref_one, rtol=0, atol=2e-5)
            assert np.array_equal(out, res[0]["out"].numpy())
            assert r["counts"] == {"all_reduce": 0, "halo": 2 * layers * calls,
                                   "all_gather": (4 * layers + stacks) * calls + 1}
            # the fm_decoder's B1 and B2 on each rank's rows against all keys
            for kernel, per_layer in (("B1", 1), ("B2", 2)):
                rect = [e for e in r["entries"][kernel] if e[0] != e[1]]
                assert len(rect) == per_layer * layers * calls, (kernel, r["entries"][kernel])
                assert all(tq * n == tk for tq, tk in rect)


def _fake_seq_mesh(n):
    return mesh.Mesh({"seq": n}, {"seq": 0}, {"seq": None})


@pytest.mark.parametrize("frames,match", [
    (130, "divisible by 4"),  # 2 ranks x the largest downsampling factor 2
    (8, "shorter than its convolution's halo"),  # the factor-2 stack: 2 frames a rank, halo 3
])
def test_sp_refuses_frame_counts(frames, match):
    """The frame count must split into whole downsampling groups on every
    rank, and every rank's frames must cover each stack's halo: stricter
    than JAX's "divisible by the mesh size", by design (ROADMAP.md §C)."""
    _, model = _weights(1)
    x = _inputs()
    x["prompt_features"] = x["prompt_features"][:, :1].repeat(frames, 1)
    x["noise"] = x["noise"][:, :1].repeat(frames, 1)
    x["features_lens"] = np.array([frames, frames - 2], np.int32)
    x["prompt_features_lens"] = np.array([2, 2], np.int32)
    with pytest.raises(ValueError, match=match):
        tzv.sp_sample(model, _fake_seq_mesh(2), *(torch.from_numpy(x[k]) for k in ORDER),
                      **KW)


@pytest.mark.parametrize("flag", ["set_fused_eval", "set_fused_conv"])
def test_sp_refuses_the_fused_eval_path(flag):
    _, model = _weights(1)
    x = _inputs()
    getattr(tzf, flag)(True)
    try:
        with pytest.raises(ValueError, match="unfused"):
            tzv.sp_sample(model, _fake_seq_mesh(2), *(torch.from_numpy(x[k]) for k in ORDER),
                          **KW)
    finally:
        getattr(tzf, flag)(False)


def test_sp_collectives_refuse_autograd(tmp_path):
    """Named for the refusal it replaced: gather_frames, halo and
    scatter_frames now have their adjoints as their backwards.  Over two
    gloo ranks under autograd (``tests/torch_sp_worker.adjoints``), each
    rank's input gradient of the sum of every rank's loss equals the
    gradient of the whole-sequence op in one process: a concatenation, the
    zero-padded sequence's windows, a slice; the balancer's and the
    whitening's backwards on a (B, T, C) tensor split along T (their
    statistics over the seq group) equal theirs on the whole tensor, within
    1e-6 (channel statistics away from the balancer's limits).  A rank's
    frames must still cover the halo."""
    import torch_sp_worker as w
    from zipvoice_tpu_torch.nn import regularizers as treg

    dryrun.spawn("torch_sp_worker:adjoints", 2, {"out": str(tmp_path)}, timeout=120,
                 path=[str(TESTS)])
    ranks = [torch.load(tmp_path / f"adjoints-{r}.pt") for r in range(2)]
    a = w.adjoint_inputs(2)
    t = w.ADJ_T

    def whole(x, fn):
        x = x.clone().requires_grad_(True)
        fn(x).backward()
        return x.grad

    pad = (0, 0, w.LEFT, w.RIGHT)
    ref = {
        "gather": whole(a["x"], lambda x: sum((x * wr).sum() for wr in a["w_gather"])),
        "halo": whole(a["x"], lambda x: sum(
            (torch.nn.functional.pad(x, pad)[:, r * t: r * t + w.LEFT + t + w.RIGHT] * wr).sum()
            for r, wr in enumerate(a["w_halo"]))),
        "scatter": whole(a["x"], lambda x: sum(
            (x[:, r * t:(r + 1) * t] * wr).sum() for r, wr in enumerate(a["w_scatter"]))),
        "balancer": whole(a["bal"], lambda x: (treg.balancer(x, True, **w.BALANCER)
                                               * a["g"]).sum()),
        "whiten": whole(a["white"], lambda x: (treg.whiten(x, True, **w.WHITEN)
                                               * a["g"]).sum()),
    }
    assert float((ref["balancer"] - a["g"]).abs().max()) > 1e-3  # the balancer acts
    assert float((ref["whiten"] - a["g"]).abs().max()) > 1e-3  # the whitening acts
    for r, res in enumerate(ranks):
        mine = slice(r * t, (r + 1) * t)
        for name, want in ref.items():
            got = res["grads"][name]
            want = want if name == "scatter" else want[:, mine]
            err = float((got - want).abs().max())
            assert err <= 1e-6 * max(1.0, float(want.abs().max())), (r, name, err)
        assert res["counts"]["gather"] == {"all_gather": 1, "all_reduce": 1, "halo": 0}
        assert res["counts"]["halo"] == {"all_gather": 0, "all_reduce": 0, "halo": 2}
        assert res["counts"]["scatter"] == {"all_gather": 1, "all_reduce": 0, "halo": 0}
        # the balancer: the (B, T) sums, then the RMS of its gradient; the
        # whitening: the mean, the covariance, then the norms
        assert res["counts"]["balancer"] == {"all_gather": 0, "all_reduce": 2, "halo": 0}
        assert res["counts"]["whiten"] == {"all_gather": 0, "all_reduce": 3, "halo": 0}

    seq = _fake_seq_mesh(2)
    with pytest.raises(ValueError, match="cover the halo"):
        mesh.halo(torch.zeros(2, 1, 4), 2, 2, seq)
    with torch.no_grad():
        with pytest.raises(ValueError, match="cover the halo"):
            mesh.halo(torch.zeros(2, 1, 4), 2, 2, seq)
