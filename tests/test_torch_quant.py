"""The port's int8 serving against the JAX package on the CPU at tiny widths:
the quantized weights and scales bit for bit (JAX's weights carried across
by ``from_jax_params``), the set of quantized linears, the int8 linear in
both modes, the quantized pipelines on the same explicit noise (two
modes live side by side too), the scales' f32 cast policy, the infer and serve CLIs with
--quantize, and the FLOPs counts and metric primitives."""

import base64
import gc
import json
import os
import threading
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zipvoice_tpu.config import ZipVoiceConfig as JConfig
from zipvoice_tpu.eval import metrics as jmetrics
from zipvoice_tpu.io.checkpoint import state_dict_to_params
from zipvoice_tpu.io.model_dir import load_model_dir as jload_model_dir
from zipvoice_tpu.models.pipeline import ZipVoicePipeline as JPipeline
from zipvoice_tpu.nn import functional as jF
from zipvoice_tpu.ops import quant as jquant
from zipvoice_tpu.utils import flops as jflops
from zipvoice_tpu_torch.audio.vocos import VocosConfig, init_vocos
from zipvoice_tpu_torch.audio.wav import read_wav, wav_bytes, write_wav
from zipvoice_tpu_torch.config import ZipVoiceConfig
from zipvoice_tpu_torch.eval import metrics
from zipvoice_tpu_torch.io.checkpoint import from_jax_params, load_into
from zipvoice_tpu_torch.io.model_dir import load_model_dir
from zipvoice_tpu_torch.models import dialog as tdialog
from zipvoice_tpu_torch.models import zipvoice as tzv
from zipvoice_tpu_torch.models.pipeline import ZipVoicePipeline
from zipvoice_tpu_torch.nn.functional import int8_matmul, linear_int8, quantize_rows
from zipvoice_tpu_torch.ops import quant
from zipvoice_tpu_torch.text.tokenizer import write_token_file
from zipvoice_tpu_torch.utils import flops

# torch's CPU ops share one OpenMP pool a process; pytest-xdist runs a
# process a worker, and pools sized to every core oversubscribe the machine
# by the worker count, which slows torch's ops by orders of magnitude
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

TINY = dict(
    fm_decoder_downsampling_factor=(1, 2, 1),
    fm_decoder_num_layers=(1, 1, 1),
    fm_decoder_cnn_module_kernel=(9, 7, 9),
    fm_decoder_feedforward_dim=128,
    fm_decoder_num_heads=2,
    fm_decoder_dim=64,
    text_encoder_num_layers=1,
    text_encoder_feedforward_dim=64,
    text_encoder_cnn_module_kernel=5,
    text_encoder_num_heads=2,
    text_encoder_dim=48,
    time_embed_dim=32,
    text_embed_dim=48,
    query_head_dim=8,
    value_head_dim=8,
    pos_head_dim=4,
    pos_dim=48,
    feat_dim=20,
)
TOKENS = {"_": 0, " ": 1, **{ch: i + 2 for i, ch in enumerate("abcdefghijklmnopqrstuvwxyz")}}
VOCOS = dict(input_channels=20, dim=32, intermediate_dim=64, num_layers=2,
             n_fft=1024, hop_length=256)
BUCKETS = dict(token_bucket=8, frame_bucket=32)


def _jax_paths(tree, key):
    """Dotted paths of the dicts of a JAX tree that hold ``key``."""
    out = set()

    def walk(d, path):
        if isinstance(d, dict):
            if key in d:
                out.add(".".join(path))
            for k, v in d.items():
                walk(v, path + (k,))

    walk(tree, ())
    return out


def _port_from_jax(kind: str):
    """(the JAX tree, the port's model loaded from it by from_jax_params) of
    a tiny base or dialog-stereo model drawn by the port's init."""
    cfg = ZipVoiceConfig(**TINY, vocab_size=len(TOKENS), pad_id=0)
    g = torch.Generator().manual_seed(0)
    init = (tzv.init_zipvoice(cfg, g) if kind == "base"
            else tdialog.init_zipvoice_dialog(cfg, stereo=True, generator=g))
    params = state_dict_to_params({k: v.numpy() for k, v in init.state_dict().items()})
    with torch.device("meta"):
        model = (tzv.ZipVoiceModel(cfg) if kind == "base"
                 else tdialog.ZipVoiceDialogModel(cfg, stereo=True))
    return params, load_into(model, from_jax_params(params)).eval()


@pytest.mark.parametrize("kind,min_elems", [("base", 4096), ("base", 1), ("stereo", 1)])
def test_quantized_weights_equal_jax(kind, min_elems):
    """The same linears quantize (the fidelity closers, the time-embed MLPs
    and the two-stream heads stay float), with JAX's int8 weights
    (transposed) and f32 scales bit for bit."""
    params, model = _port_from_jax(kind)
    jq = jquant.quantize_linear_int8(
        jax.tree.map(lambda a: np.asarray(a, np.float32), params), min_elems=min_elems)
    quant.quantize_linear_int8(model, min_elems=min_elems)
    names = {n for n, m in model.named_modules() if isinstance(m, quant.QuantizedLinear)}
    assert names == _jax_paths(jq, "weight_int8") and names
    for closer in ("fm_decoder.out_proj", "fm_decoder.in_proj", "text_encoder.out_proj",
                   "fm_decoder.time_embed.0", "fm_decoder.time_embed.2",
                   "fm_decoder.encoders.0.time_emb.1"):
        if kind == "base":
            assert isinstance(model.get_submodule(closer), torch.nn.Linear), closer
    # per-layer projections quantize, their module out_projs included
    assert "fm_decoder.encoders.0.layers.0.feed_forward1.in_proj" in names
    assert min_elems > 1 or "fm_decoder.encoders.0.layers.0.self_attn1.out_proj" in names
    for name in names:
        m, j = model.get_submodule(name), jq
        for k in name.split("."):
            j = j[k]
        assert m.weight_int8.dtype == torch.int8 and m.weight_scale.dtype == torch.float32
        np.testing.assert_array_equal(m.weight_int8.numpy(), np.asarray(j["weight_int8"]).T)
        np.testing.assert_array_equal(m.weight_scale.numpy(), np.asarray(j["weight_scale"]))


def test_dequantize_and_bytes():
    """Dequantized weights equal JAX's dequantize bit for bit, and the
    quantized model is under 0.55x the float one."""
    params, model = _port_from_jax("base")
    before = quant.quantized_bytes(model)
    jq = jquant.quantize_linear_int8(
        jax.tree.map(lambda a: np.asarray(a, np.float32), params), min_elems=256)
    quant.quantize_linear_int8(model, min_elems=256)
    assert quant.quantized_bytes(model) < 0.55 * before
    assert quant.quantized_bytes(model) == jquant.quantized_bytes(jq)
    jd = jquant.dequantize_linear_int8(jq)
    quant.dequantize_linear_int8(model)
    assert not any(isinstance(m, quant.QuantizedLinear) for m in model.modules())
    for name in _jax_paths(jq, "weight_int8"):
        j = jd
        for k in name.split("."):
            j = j[k]
        np.testing.assert_array_equal(model.get_submodule(name).weight.detach().numpy(),
                                      np.asarray(j["weight"]).T)


@pytest.mark.parametrize("dynamic", [False, True], ids=["int8", "int8-dynamic"])
def test_int8_linear_matches_jax(dynamic):
    """linear_int8 against JAX's linear on an int8 tree, same inputs:
    weight-only within rtol 1e-5 / atol 1e-5; dynamic with JAX's int8
    activations and int32 products exactly and the output within 1e-6
    relative."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((96, 64)).astype(np.float32)  # JAX layout (in, out)
    b = rng.standard_normal(64).astype(np.float32)
    x = (rng.standard_normal((4, 7, 96)) * 2.0).astype(np.float32)
    jp = jquant.quantize_linear_int8({"lin": {"weight": w, "bias": b}}, min_elems=1)["lin"]
    q, scale = quant.quantize_weight(torch.from_numpy(w.T.copy()))
    jF.set_int8_dynamic(dynamic)
    try:
        want = np.asarray(jF.linear(jp, jnp.asarray(x)))
    finally:
        jF.set_int8_dynamic(False)
    got = linear_int8(torch.from_numpy(x), q, scale, torch.from_numpy(b), dynamic).numpy()
    if not dynamic:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        return
    x32 = jnp.asarray(x).reshape(-1, 96)
    s_x = jnp.maximum(jnp.max(jnp.abs(x32), axis=-1, keepdims=True) / 127.0, 1e-12)
    jqx = jnp.clip(jnp.round(x32 / s_x), -127, 127).astype(jnp.int8)
    jy = jax.lax.dot_general(jqx, jp["weight_int8"], (((1,), (0,)), ((), ())),
                             preferred_element_type=jnp.int32)
    qx, ts_x = quantize_rows(torch.from_numpy(x).reshape(-1, 96))
    np.testing.assert_array_equal(qx.numpy(), np.asarray(jqx))
    np.testing.assert_array_equal(ts_x.numpy(), np.asarray(s_x))
    np.testing.assert_array_equal(torch._int_mm(qx, q.t()).numpy(), np.asarray(jy))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("m", [1, 5, 16, 17])
@pytest.mark.parametrize("k,n", [(100, 100), (192, 100), (96, 36)])
def test_int8_dynamic_every_shape_matches_jax(m, k, n):
    """int8-dynamic at row counts and widths that torch._int_mm's card
    kernel refuses (M <= 16, K or N not a multiple of 8; ``int8_matmul``
    pads them with zeros on every device): the int32 product equals JAX's
    bit for bit, the output within test_int8_linear_matches_jax's tolerance
    of JAX's linear."""
    rng = np.random.default_rng(1000 * m + k + n)
    w = rng.standard_normal((k, n)).astype(np.float32)  # JAX layout (in, out)
    b = rng.standard_normal(n).astype(np.float32)
    x = (rng.standard_normal((m, k)) * 2.0).astype(np.float32)
    jp = jquant.quantize_linear_int8({"lin": {"weight": w, "bias": b}}, min_elems=1)["lin"]
    q, scale = quant.quantize_weight(torch.from_numpy(w.T.copy()))
    jF.set_int8_dynamic(True)
    try:
        want = np.asarray(jF.linear(jp, jnp.asarray(x)))
    finally:
        jF.set_int8_dynamic(False)
    got = linear_int8(torch.from_numpy(x), q, scale, torch.from_numpy(b), True).numpy()
    x32 = jnp.asarray(x)
    s_x = jnp.maximum(jnp.max(jnp.abs(x32), axis=-1, keepdims=True) / 127.0, 1e-12)
    jqx = jnp.clip(jnp.round(x32 / s_x), -127, 127).astype(jnp.int8)
    jy = jax.lax.dot_general(jqx, jp["weight_int8"], (((1,), (0,)), ((), ())),
                             preferred_element_type=jnp.int32)
    qx, _ = quantize_rows(torch.from_numpy(x))
    y = int8_matmul(qx, q)
    assert y.dtype == torch.int32 and y.shape == (m, n)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    assert got.shape == want.shape == (m, n)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A tiny model dir (the port's init, torch layout), a Vocos checkpoint
    and a 1 s prompt wav."""
    d = tmp_path_factory.mktemp("quant")
    write_token_file(TOKENS, str(d / "tokens.txt"))
    (d / "model.json").write_text(json.dumps({
        "model": {k: list(v) if isinstance(v, tuple) else v for k, v in TINY.items()},
        "feature": {"sampling_rate": 24000, "type": "vocos", "n_mels": 20},
    }))
    cfg = ZipVoiceConfig(**TINY, vocab_size=len(TOKENS), pad_id=0)
    torch.save({"model": tzv.init_zipvoice(cfg, torch.Generator().manual_seed(0)).state_dict()},
               d / "model.pt")
    torch.save(init_vocos(VocosConfig(**VOCOS), torch.Generator().manual_seed(1)),
               d / "vocos.bin")
    prompt = (np.random.default_rng(0).standard_normal((1, 24000)) * 0.05).astype(np.float32)
    write_wav(d / "prompt.wav", prompt, 24000)
    return d


def _pipeline(d, **kw):
    ta = load_model_dir(str(d), tokenizer_name="simple")
    return ZipVoicePipeline(model=ta.model, model_cfg=ta.model_cfg, feat_cfg=ta.feat_cfg,
                            tokenizer=ta.tokenizer, device="cpu", **BUCKETS, **kw)


def _sample(p, noise):
    mel, gen = p.sample_features([3, 4, 5, 6, 7, 8], [5, 6], PROMPT_FEATS, num_step=2,
                                 guidance_scale=1.0, t_shift=0.5, noise=noise)
    return np.asarray(mel.float() if isinstance(mel, torch.Tensor) else mel)[:gen]


PROMPT_FEATS = (np.random.default_rng(2).standard_normal((9, 20)) * 0.1).astype(np.float32)


NOISE = np.random.default_rng(7).standard_normal((1, 64, 20)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_mels(model_dir):
    """{mode: mel} of JAX's quantized pipeline on NOISE, one mode at a time
    (JAX's dynamic mode is a process-global switch)."""
    ja = jload_model_dir(model_dir=str(model_dir), tokenizer_name="simple")
    out = {}
    for mode in quant.MODES:
        jp = JPipeline(params=ja.params, model_cfg=ja.model_cfg, feat_cfg=ja.feat_cfg,
                       tokenizer=ja.tokenizer, quantize=mode, **BUCKETS)
        try:
            out[mode] = _sample(jp, NOISE)
        finally:
            del jp
            gc.collect()
            jF.set_int8_dynamic(False)
    return out


def _assert_int8_mel_matches(mode, jmel, tmel, quant_mse=None):
    """Weight-only: the mel within 1e-4 (the float pipelines' own
    tolerance).  Dynamic: a row's activation rounding can flip between the
    packages (their f32 inputs to it differ in the last bits), so the
    tolerance is on the mel MSE (``eval/metrics.mel_mse``, the repo's
    fidelity metric): under 1e-8 between the packages, and, given the
    quantization's own MSE against the float pipeline on the same inputs
    (about 1.5e-6), that tolerance at least 100x under it."""
    err = float(np.abs(jmel - tmel).max())
    if mode == "int8":
        assert err < 1e-4, err
        return
    mse = metrics.mel_mse(jmel, tmel)
    assert mse < 1e-8, (mse, err)
    if quant_mse is not None:
        assert 100 * 1e-8 <= quant_mse, (mse, quant_mse, err)


@pytest.mark.parametrize("mode", ["int8", "int8-dynamic"])
def test_pipeline_int8_matches_jax(model_dir, jax_mels, mode):
    """Both packages' quantized pipelines on the same weights and explicit
    noise (``_assert_int8_mel_matches``)."""
    tmel = _sample(_pipeline(model_dir, quantize=mode), NOISE)
    quant_mse = metrics.mel_mse(_sample(_pipeline(model_dir), NOISE), tmel)
    _assert_int8_mel_matches(mode, jax_mels[mode], tmel, quant_mse)


def test_pipeline_int8_modes_coexist(model_dir, jax_mels):
    """The mode lives on each model's layers: two live pipelines with
    different int8 modes, run in turns, each give JAX's result for its own
    mode (JAX refuses the second one; the port has no switch to share)."""
    p1 = _pipeline(model_dir, quantize="int8")
    p2 = _pipeline(model_dir, quantize="int8-dynamic")
    first = _sample(p1, NOISE)
    dyn = _sample(p2, NOISE)
    again = _sample(p1, NOISE)
    np.testing.assert_array_equal(first, again)
    _assert_int8_mel_matches("int8", jax_mels["int8"], again)
    _assert_int8_mel_matches("int8-dynamic", jax_mels["int8-dynamic"], dyn)


def test_bf16_pipeline_keeps_scales_f32(model_dir):
    """The quantized bf16 pipeline: int8 weights, f32 scales, every other
    floating tensor bf16; the caller's model stays float."""
    ta = load_model_dir(str(model_dir), tokenizer_name="simple")
    p = ZipVoicePipeline(model=ta.model, model_cfg=ta.model_cfg, feat_cfg=ta.feat_cfg,
                         dtype=torch.bfloat16, device="cpu", quantize="int8", **BUCKETS)
    q = [m for m in p.model.modules() if isinstance(m, quant.QuantizedLinear)]
    assert q and all(m.weight_int8.dtype == torch.int8 and m.weight_scale.dtype == torch.float32
                     for m in q)
    rest = [t for n, t in list(p.model.named_parameters()) + list(p.model.named_buffers())
            if t.is_floating_point() and not n.endswith("weight_scale")]
    assert rest and all(t.dtype == torch.bfloat16 for t in rest)
    assert not any(isinstance(m, quant.QuantizedLinear) for m in ta.model.modules())
    assert not any(m.dynamic for m in q)
    mel = _sample(p, np.random.default_rng(7).standard_normal((1, 64, 20)).astype(np.float32))
    assert np.isfinite(mel).all()


@pytest.mark.parametrize("mode", ["int8", "int8-dynamic"])
def test_infer_cli_quantize(model_dir, tmp_path, mode):
    from zipvoice_tpu_torch.bin.infer_zipvoice import main

    out = tmp_path / "q.wav"
    (m,) = main(["--model-dir", str(model_dir), "--vocoder-path", str(model_dir / "vocos.bin"),
                 "--tokenizer", "simple", "--device", "cpu", "--num-step", "2",
                 "--prompt-wav", str(model_dir / "prompt.wav"), "--prompt-text", "hi there",
                 "--text", "hello world", "--res-wav-path", str(out), "--quantize", mode])
    wav, sr = read_wav(out)
    assert sr == 24000 and wav.shape[-1] > 0 and np.isfinite(wav).all()
    assert m["wav_seconds"] > 0


def test_serve_cli_quantize(model_dir):
    """The serve CLI's server over an int8 pipeline answers a request."""
    from zipvoice_tpu_torch.bin.serve import build_server, get_parser

    srv = build_server(get_parser().parse_args([
        "--model-dir", str(model_dir), "--vocoder-path", str(model_dir / "vocos.bin"),
        "--tokenizer", "simple", "--device", "cpu", "--dtype", "float32", "--port", "0",
        "--num-step", "2", "--quantize", "int8"]))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        prompt, sr = read_wav(model_dir / "prompt.wav")
        body = json.dumps({"text": "hello world", "prompt_text": "hi there",
                           "prompt_wav_b64": base64.b64encode(wav_bytes(prompt, sr)).decode()})
        req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/synthesize",
                                     data=body.encode(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            data = resp.read()
        assert resp.status == 200 and data[:4] == b"RIFF" and len(data) > 44
    finally:
        srv.shutdown()
        thread.join(timeout=30)
    assert not thread.is_alive()
    q = [m for m in srv.pipeline.model.modules() if isinstance(m, quant.QuantizedLinear)]
    assert q and not any(m.dynamic for m in q)


@pytest.mark.parametrize("tiny", [False, True], ids=["default", "tiny"])
def test_flops_equal_jax(tiny):
    kw = dict(TINY, vocab_size=40, pad_id=0) if tiny else {}
    jcfg, tcfg = JConfig(**kw), ZipVoiceConfig(**kw)
    for t in (1, 37, 640, 1024):
        assert flops.zipformer_fwd_flops(tcfg.fm_decoder_config(), t, 2) == \
            jflops.zipformer_fwd_flops(jcfg.fm_decoder_config(), t, 2)
        assert flops.text_encoder_flops(tcfg, t) == jflops.text_encoder_flops(jcfg, t)
        assert flops.vocos_fwd_flops(t) == jflops.vocos_fwd_flops(t)
        for doubling in (True, False):
            assert flops.sampler_flops(tcfg, t, 64, 16, doubling) == \
                jflops.sampler_flops(jcfg, t, 64, 16, doubling)
        assert flops.train_step_flops(tcfg, 8, t, 100) == jflops.train_step_flops(jcfg, 8, t, 100)


def test_peak_and_mfu():
    assert flops.peak_bf16_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert flops.peak_bf16_tflops("NVIDIA H100 PCIe") == 756.0
    assert flops.mfu(989e12, 2.0, "NVIDIA H100 80GB HBM3") == 0.5
    with pytest.raises(ValueError, match="no bf16 peak"):
        flops.peak_bf16_tflops("TPU v5 lite")


def test_metrics_equal_jax():
    pairs = [("Hello, world! It's me.", "hello word its me"),
             ("The cat sat on the mat", "the cat sat on mat the"),
             ("", "extra words"), ("‘quoted’ text", "'quoted' text")]
    for ref, hyp in pairs:
        assert metrics.wer(ref, hyp) == jmetrics.wer(ref, hyp)
        assert metrics.normalize_transcript(ref) == jmetrics.normalize_transcript(ref)
        assert metrics.edit_ops(ref.split(), hyp.split()) == \
            jmetrics.edit_ops(ref.split(), hyp.split())
    assert metrics.corpus_wer(pairs) == jmetrics.corpus_wer(pairs)
    dialog = ("[S1] Hi there (laughs) [S2] Hello, friend! [S1] 好的。",
              "[S1] hello friend [S2] hi there hao de")
    for lang in ("en", "zh"):
        assert metrics.cp_wer(*dialog, lang=lang) == jmetrics.cp_wer(*dialog, lang=lang)
    assert metrics.split_dialog_turns(dialog[0]) == jmetrics.split_dialog_turns(dialog[0])
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((30, 20)), rng.standard_normal((25, 20))
    assert metrics.cosine_similarity(a[:25], b) == jmetrics.cosine_similarity(a[:25], b)
    assert metrics.mel_mse(a, b) == jmetrics.mel_mse(a, b)
