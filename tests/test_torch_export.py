"""The port's model export against the JAX package's on the CPU at a tiny
width: a ``torch.export`` round trip of the sampler, the export CLI's
programs (plain, int8 and with an explicit timestep grid) against JAX's
exported programs on the same inputs, B1 and B2 as custom-op nodes of
every program and their fake implementations, the inference CLI over the
artifacts in both modes, and the artifacts' device binding."""

import functools
import json
import os
import sys

import numpy as np
import pytest

import torch
from jax import export as jexport
from torch._subclasses.fake_tensor import FakeTensorMode

from zipvoice_tpu.bin import export_model as jexport_model
from zipvoice_tpu_torch.audio.vocos import VocosConfig, init_vocos
from zipvoice_tpu_torch.audio.wav import read_wav, write_wav
from zipvoice_tpu_torch.bin import export_model, infer_exported
from zipvoice_tpu_torch.config import ZipVoiceConfig
from zipvoice_tpu_torch.io.model_dir import load_model_dir
from zipvoice_tpu_torch.models import zipvoice as tzv
from zipvoice_tpu_torch.ops import attention as att
from zipvoice_tpu_torch.text.tokenizer import write_token_file

# torch's CPU ops share one OpenMP pool a process; pytest-xdist runs a
# process a worker, and pools sized to every core oversubscribe the machine
# by the worker count, which slows torch's ops by orders of magnitude
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

TINY = dict(
    fm_decoder_downsampling_factor=(1, 2, 1),
    fm_decoder_num_layers=(1, 1, 1),
    fm_decoder_cnn_module_kernel=(9, 7, 9),
    fm_decoder_feedforward_dim=96,
    fm_decoder_num_heads=2,
    fm_decoder_dim=64,
    text_encoder_num_layers=1,
    text_encoder_feedforward_dim=48,
    text_encoder_cnn_module_kernel=5,
    text_encoder_num_heads=2,
    text_encoder_dim=48,
    time_embed_dim=32,
    text_embed_dim=48,
    query_head_dim=8,
    value_head_dim=8,
    pos_head_dim=4,
    pos_dim=48,
    feat_dim=16,
)
TOKENS = {"_": 0, " ": 1, **{ch: i + 2 for i, ch in enumerate("abcdefghijklmnopqrstuvwxyz")}}
S, T, F = 32, 128, 16  # the programs' static token and frame sizes, the mel width
CUSTOM_OPS = {"zipvoice.rel_probs.default", "zipvoice.probs_apply.default"}


def _custom_ops(ep):
    return {str(n.target) for n in ep.graph.nodes
            if n.op == "call_function" and str(n.target).startswith("zipvoice.")}


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A tiny model dir (the port's init, torch layout), a Vocos checkpoint
    and a 1/3 s prompt wav (31 frames)."""
    d = tmp_path_factory.mktemp("export")
    write_token_file(TOKENS, str(d / "tokens.txt"))
    (d / "model.json").write_text(json.dumps({
        "model": {k: list(v) if isinstance(v, tuple) else v for k, v in TINY.items()},
        "feature": {"sampling_rate": 24000, "type": "vocos", "n_mels": F},
    }))
    cfg = ZipVoiceConfig(**TINY, vocab_size=len(TOKENS), pad_id=0)
    torch.save({"model": tzv.init_zipvoice(cfg, torch.Generator().manual_seed(0)).state_dict()},
               d / "model.pt")
    torch.save(init_vocos(VocosConfig(input_channels=F, dim=32, intermediate_dim=64,
                                      num_layers=2, n_fft=1024, hop_length=256),
                          torch.Generator().manual_seed(1)), d / "vocos.bin")
    prompt = (np.random.default_rng(0).standard_normal((1, 8000)) * 0.05).astype(np.float32)
    write_wav(d / "prompt.wav", prompt, 24000)
    return d


def _export(model_dir, out, *extra):
    """Both packages' export CLIs on the model dir: (the port's dir, JAX's dir)."""
    common = ["--model-dir", str(model_dir), "--num-step", "2", "--max-tokens", str(S),
              "--max-frames", str(T), *extra]
    export_model.main(common + ["--out-dir", str(out / "torch"), "--device", "cpu"])
    argv = sys.argv
    sys.argv = ["export_model", *common, "--out-dir", str(out / "jax")]
    try:
        jexport_model.main()
    finally:
        sys.argv = argv
    return out / "torch", out / "jax"


@pytest.fixture(scope="module")
def exported(model_dir, tmp_path_factory):
    return _export(model_dir, tmp_path_factory.mktemp("plain"))


def _sampler_inputs(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(1, len(TOKENS), (1, S)), np.array([20]),
            (rng.standard_normal((1, T, F)) * 0.1).astype(np.float32), np.array([40]),
            np.array([120]), rng.standard_normal((1, T, F)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _load(path):
    """An artifact, loaded once a test process (loading is seconds)."""
    return infer_exported.load_exported(path, "cpu")


def _both(tdir, jdir, name, args):
    """The port's and JAX's program ``name`` on the same numpy inputs
    (integers as int64 in the port, int32 in JAX)."""
    ep = _load(tdir / f"{name}.pt2")
    assert _custom_ops(ep) == CUSTOM_OPS
    with torch.no_grad():
        got = ep.module()(*(torch.from_numpy(np.asarray(a)) for a in args))
    jprog = jexport.deserialize(bytearray((jdir / f"{name}.stablehlo").read_bytes()))
    want = jprog.call(*(a.astype(np.int32) if a.dtype.kind == "i" else a for a in args))
    return got.numpy(), np.asarray(want)


def test_export_sampler_roundtrip(model_dir, exported):
    """The export CLI's 2-step sampler, saved and loaded: equal to the
    direct call on the model dir's weights within 1e-5, with B1 and B2 as
    custom-op nodes."""
    model = load_model_dir(str(model_dir)).model.eval()
    ep = _load(exported[0] / "sampler_fused.pt2")
    assert _custom_ops(ep) == CUSTOM_OPS  # and of the other two in _both
    args = tuple(torch.from_numpy(np.asarray(a)) for a in _sampler_inputs())
    with torch.no_grad():
        direct = tzv.sample(model, *args, num_step=2, guidance_scale=1.0, t_shift=0.5)
        loaded = ep.module()(*args)
    np.testing.assert_allclose(loaded.numpy(), direct.numpy(), atol=1e-5)


def test_export_cli_matches_jax(exported):
    """The three programs of both export CLIs on the same inputs, within
    1e-4; the step program on both sides of the t = 0.5 switch."""
    tdir, jdir = exported
    got, want = _both(tdir, jdir, "sampler_fused", _sampler_inputs())
    np.testing.assert_allclose(got, want, atol=1e-4)
    a = _sampler_inputs(2)
    got, want = _both(tdir, jdir, "text_model", (a[0], a[1], a[4]))
    np.testing.assert_allclose(got, want, atol=1e-4)
    r = np.random.default_rng(3)
    feats = [r.standard_normal((1, T, F)).astype(np.float32) for _ in range(3)]
    mask = np.arange(T)[None, :] >= 100
    for t in (0.3, 0.7):
        got, want = _both(tdir, jdir, "fm_decoder_step", (np.float32(t), *feats, mask))
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_export_cli_options_match_jax(model_dir, tmp_path):
    """The fused sampler of both export CLIs with --quantize int8 and an
    explicit timestep grid, on the same inputs, within 1e-4."""
    tdir, jdir = _export(model_dir, tmp_path, "--quantize", "int8", "--timesteps", "0,0.6,1")
    got, want = _both(tdir, jdir, "sampler_fused", _sampler_inputs())
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("mode", ["fused", "host-loop"])
def test_infer_exported_cli(model_dir, exported, tmp_path, mode):
    """The inference CLI over the artifacts end to end: a finite wav of
    (gen_len - 1) * hop samples."""
    out = tmp_path / "out.wav"
    res = infer_exported.main([
        "--export-dir", str(exported[0]), "--model-dir", str(model_dir),
        "--tokenizer", "simple", "--vocoder-path", str(model_dir / "vocos.bin"),
        "--mode", mode, "--num-step", "2", "--prompt-wav", str(model_dir / "prompt.wav"),
        "--prompt-text", "hi", "--text", "hello", "--res-wav-path", str(out), "--device", "cpu"])
    wav, sr = read_wav(out)
    assert sr == 24000 and np.isfinite(wav).all()
    assert wav.shape[-1] == res["wav"].shape[-1] > 0 and wav.shape[-1] % 256 == 0
    assert res["x1"].shape == (1, T, F)


def test_exported_artifact_bound_to_device_type(exported):
    """A CPU artifact is refused for the card (before anything runs)."""
    path = exported[0] / "fm_decoder_step.pt2"
    assert infer_exported.artifact_device_type(path) == "cpu"
    with pytest.raises(ValueError, match="exported for 'cpu'"):
        infer_exported.load_exported(path, "cuda")


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_attention_ops_fake_impls(out_dtype, masked):
    """B1's and B2's custom ops under FakeTensorMode give the real output's
    shape and dtype (what keeps them single nodes of an exported program)."""
    g = torch.Generator().manual_seed(0)
    b, t, h, qd, pd, vd = 2, 12, 2, 8, 4, 8
    q, k = torch.randn(b, t, h, qd, generator=g), torch.randn(b, t, h, qd, generator=g)
    pq, pe = torch.randn(b, t, h, pd, generator=g), torch.randn(2 * t - 1, h, pd, generator=g)
    v = torch.randn(b, t, h, vd, generator=g).to(out_dtype)
    mask = (torch.arange(t)[None, :] >= torch.tensor([[t], [t - 3]])) if masked else None
    real_p = torch.ops.zipvoice.rel_probs(q, k, pq, pe, mask, out_dtype)
    real_o = torch.ops.zipvoice.probs_apply(real_p, v)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = [mode.from_tensor(x) if x is not None else None for x in (q, k, pq, pe, mask, v)]
        fake_p = torch.ops.zipvoice.rel_probs(*fake[:5], out_dtype)
        fake_o = torch.ops.zipvoice.probs_apply(fake_p, fake[5])
    for real, f in ((real_p, fake_p), (real_o, fake_o)):
        assert f.shape == real.shape and f.dtype == real.dtype
    assert att.rel_attention_probs.launches == 0  # the CPU runs the plain versions
