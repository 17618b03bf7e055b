"""zipvoice_tpu_torch's serving entry points on the CPU with a tiny random
model: synthesize_batch's rows against the JAX package's batched sampler
on the same inputs and noise (mel within 1e-4), the long-form plan equal to
JAX's, the one-program path, batch rows, long-form carry, streaming and
warmup against their JAX counterparts' contracts, and the dynamic-batching
HTTP server over a CPU pipeline."""

import base64
import gc
import json
import os
import struct
import threading
import urllib.error
import urllib.request
import weakref

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from test_torch_pipeline import VOCOS, _pipelines, assets  # noqa: F401 — fixture
from zipvoice_tpu_torch.audio.vocos import VocosConfig, load_vocos_params
from zipvoice_tpu_torch.audio.wav import read_wav, read_wav_bytes, wav_bytes
from zipvoice_tpu_torch.io.model_dir import load_model_dir
from zipvoice_tpu_torch.models.pipeline import ZipVoicePipeline
from zipvoice_tpu_torch.serve.server import TTSServer

# torch's CPU ops share one OpenMP pool a process; pytest-xdist runs a
# process a worker, and pools sized to every core oversubscribe the machine
# by the worker count, which slows torch's ops by orders of magnitude
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

BUCKETS = dict(token_bucket=8, frame_bucket=32)
KW = dict(num_step=2, guidance_scale=1.0)


def _port_pipeline(d, vocos_sd):
    ta = load_model_dir(str(d), tokenizer_name="simple")
    return ZipVoicePipeline(model=ta.model, model_cfg=ta.model_cfg, feat_cfg=ta.feat_cfg,
                            vocos_params=load_vocos_params(vocos_sd),
                            vocos_cfg=VocosConfig(**VOCOS), tokenizer=ta.tokenizer,
                            device="cpu", **BUCKETS)


def _prompt(seconds=1.0, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, int(24000 * seconds))) * 0.05).astype(np.float32)


def _pcm(wav):
    return np.round(np.asarray(wav) * 32767)


def test_batch_rows_match_jax_sample_fn(assets):  # noqa: F811
    """Three requests of different lengths and prompts in one batch: each
    row's mel equals the JAX package's batched sampler on the same padded
    inputs and the same explicit noise (1e-4: the Euler steps accumulate
    the per-module f32 error, as in test_sample_and_synthesize_match_jax)."""
    d, vocos_sd = assets
    jp, tp = _pipelines(d, vocos_sd)
    texts = ["hello world", "good day to you", "hi"]
    prompts = [_prompt(1.0, 0), _prompt(0.7, 1), _prompt(1.2, 2)]
    tok = tp.tokenizer.texts_to_token_ids
    pre = []
    for text, wav in zip(texts, prompts):
        pf, rms = tp.prompt_features(wav, 24000)
        pre.append({"tokens": tok([text])[0], "prompt_tokens": tok(["hi there"])[0],
                    "prompt_feats": pf, "prompt_rms": rms})
    batch = tp._prepare_batch([p["tokens"] for p in pre],
                              [p["prompt_tokens"] for p in pre],
                              [p["prompt_feats"] for p in pre], 1.0, 0)
    t_pad = batch.noise.shape[1]
    noise = np.random.default_rng(7).standard_normal((3, t_pad, 20)).astype(np.float32)

    run = jp._sample_fn(2, 1.0, 0.5)
    args = [a.numpy() for a in batch.args[:-1]]
    jmel, jgen = run(jp.params, *(jnp.asarray(a.astype(np.int32) if a.dtype == np.int64
                                              else a) for a in args), jnp.asarray(noise))
    assert list(np.asarray(jgen)) == batch.gen_lens

    tp._noise = lambda seed, shape: torch.from_numpy(noise[seed:seed + 1])
    res = tp.synthesize_batch(None, None, None, None, seeds=[0, 1, 2], precomputed=pre,
                              **KW)
    for i, r in enumerate(res):
        gen = batch.gen_lens[i]
        assert r.features.shape == (gen, 20)
        err = float(np.abs(np.asarray(jmel)[i, :gen] - r.features).max())
        assert err < 1e-4, (i, err)
        assert r.wav.shape == ((gen - 1) * 256,)


def test_long_form_plan_matches_jax(assets):  # noqa: F811
    d, vocos_sd = assets
    jp, tp = _pipelines(d, vocos_sd)
    cases = [
        ("the quick brown fox jumps over the lazy dog. " * 6, 3.0),
        ("你好世界这是一句话。" * 12, 8.0),  # CJK with no spaces anywhere
        ("pi is 3.14 ok", 30.0),  # Latin decimals stay together
        ("hello there! 今天天气不错。确实很好。 how are you? fine; thanks.", 1.0),
    ]
    for text, secs in cases:
        assert tp._long_form_plan(text, secs) == jp._long_form_plan(text, secs)
    assert len(tp._long_form_plan(*cases[1])) >= 3


def test_synthesize_fused_matches_split(assets):  # noqa: F811
    """The one sample + vocoder + PCM16 program gives the split path's wav
    (same seed) within 2 PCM16 counts."""
    d, vocos_sd = assets
    tp = _port_pipeline(d, vocos_sd)
    kw = dict(text="hello world", prompt_text="hi there", prompt_wav=_prompt(),
              prompt_sr=24000, seed=7, **KW)
    split, fused = tp.synthesize(**kw), tp.synthesize_fused(**kw)
    assert fused.wav.shape == split.wav.shape and fused.features is None
    assert np.abs(_pcm(fused.wav) - _pcm(split.wav)).max() <= 2
    assert fused.metrics["rtf"] > 0


def test_batch_row_matches_single_request(assets):  # noqa: F811
    """With seeds, a batch row equals the same request served alone in the
    same buckets (within 2 PCM16 counts)."""
    d, vocos_sd = assets
    tp = _pipelines(d, vocos_sd)[1]
    texts = ["hello world", "hello there"]  # one token and frame bucket
    prompt = _prompt()
    res = tp.synthesize_batch(texts, ["hi there"] * 2, [prompt] * 2, [24000] * 2,
                              seeds=[7, 2**32 + 8], **KW)
    for text, seed, row in zip(texts, (7, 8), res):
        alone = tp.synthesize_fused(text, "hi there", prompt, 24000, seed=seed, **KW)
        assert row.wav.shape == alone.wav.shape
        assert np.abs(_pcm(row.wav) - _pcm(alone.wav)).max() <= 2


def test_long_form_zero_carry_uses_original_prompt(assets):  # noqa: F811
    """carry_seconds=0 conditions every chunk on the original prompt (a
    mel[-0:] slice would carry the whole previous chunk)."""
    d, vocos_sd = assets
    tp = _port_pipeline(d, vocos_sd)
    seen = []
    real = tp.sample_features

    def spy(tokens, prompt_tokens, prompt_feats, **kw):
        seen.append(int(prompt_feats.shape[0]))
        return real(tokens, prompt_tokens, prompt_feats, **kw)

    tp.sample_features = spy
    res = tp.synthesize_long(
        text="the quick brown fox jumps over the lazy dog. " * 4, prompt_text="hi",
        prompt_wav=_prompt(0.8, 4), prompt_sr=24000, max_chunk_seconds=2.0,
        carry_seconds=0.0, **KW)
    assert res.metrics["chunks"] >= 2 and len(seen) == res.metrics["chunks"]
    assert all(n == seen[0] for n in seen[1:]), seen
    assert np.isfinite(res.wav).all()


def test_stream_length_matches_long(assets):  # noqa: F811
    """The streamed segments tile synthesize_long's wav: equal total length,
    equal values after the last join's receptive field."""
    d, vocos_sd = assets
    tp = _port_pipeline(d, vocos_sd)
    kwargs = dict(text="hello there. how are you. fine thanks. good bye now.",
                  prompt_text="hi", prompt_wav=_prompt(), prompt_sr=24000,
                  max_chunk_seconds=1.0, seed=4, **KW)
    segs = list(tp.synthesize_stream(**kwargs))
    assert len(segs) >= 2
    streamed = np.concatenate(segs)
    res = tp.synthesize_long(**kwargs)
    assert len(streamed) == len(res.wav), (len(streamed), len(res.wav))
    tail = len(streamed) - len(segs[-1]) + 16 * VOCOS["hop_length"]
    np.testing.assert_allclose(streamed[tail:], res.wav[tail:], atol=1e-3)
    assert np.isfinite(streamed).all()


def _shape_keys(tp):
    """{(program, batch, s_pad, t_pad)} of the graph keys: the sampling
    programs' first input is (B, s_pad) tokens, the vocoder's (B, T, F)."""
    out = set()
    for k in tp.graphs.keys():
        first = k.inputs[0][0]
        if k.name == "vocode_i16":
            out.add((k.name, first[0], None, first[1]))
        else:
            out.add((k.name, first[0], first[1], k.inputs[2][0][1]))
    return out


def test_warmup_fills_memo(assets):  # noqa: F811
    """warmup() creates the sampler, vocoder and one-program keys of its
    buckets, batched ones for batch_sizes; a request in a warmed bucket
    adds none."""
    d, vocos_sd = assets
    tp = _port_pipeline(d, vocos_sd)
    tp.warmup(num_step=2, seconds=(0.5,), token_counts=(4,), batch_sizes=(2,))
    assert [k[0][0][1] for k in tp._memo__sample_fn] == [2]
    assert len(tp._memo__sample_pcm_fn) == 1 and len(tp._memo__vocode_i16_fn) == 1
    # 0.5 s: 11 prompt frames + 4 x 11 generated -> t_pad 64; 1 + 4 tokens
    # + pad -> s_pad 8
    want = {("sample", 1, 8, 64), ("sample", 2, 8, 64), ("sample_pcm", 1, 8, 64),
            ("vocode_i16", 1, None, 64), ("vocode_i16", 2, None, 64)}
    assert _shape_keys(tp) == want
    assert {k.flags for k in tp.graphs.keys() if k.name != "vocode_i16"} == {(False, False)}
    rng = np.random.default_rng(1)
    tokens = list(rng.integers(1, tp.model_cfg.vocab_size, 4))
    pf = rng.standard_normal((11, 20)).astype(np.float32) * 0.01
    tp.sample_features(tokens, tokens[:1], pf, **KW)
    assert _shape_keys(tp) == want and tp.captures == 0  # the CPU captures nothing


def test_pipeline_is_garbage_collectable(assets):  # noqa: F811
    """Dropping a warmed pipeline frees it: the program memos and the
    graphs live on the instance, no class-level cache pins it."""
    d, vocos_sd = assets
    tp = _port_pipeline(d, vocos_sd)
    tp.warmup(num_step=2, seconds=(0.5,), token_counts=(4,))
    assert tp._memo__sample_fn and tp.graphs.keys()
    ref = weakref.ref(tp)
    del tp
    gc.collect()
    assert ref() is None


# --------------------------------------------------------------------- server


@pytest.fixture(scope="module")
def server(assets):  # noqa: F811
    d, vocos_sd = assets
    srv = TTSServer(_port_pipeline(d, vocos_sd), port=0, max_batch=4, max_wait_ms=200.0,
                    num_step=2, guidance_scale=1.0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv
    srv.shutdown()
    thread.join(timeout=30)
    assert not thread.is_alive()


def _post(port, path, payload, accept_json=False, timeout=300):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Accept": "application/json"} if accept_json else {}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


def _payload(text, prompt=None, **extra):
    prompt = _prompt() if prompt is None else prompt
    return {"text": text, "prompt_text": "hi there",
            "prompt_wav_b64": base64.b64encode(wav_bytes(prompt, 24000)).decode(),
            "num_step": 2, "seed": 7, **extra}


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
        return json.loads(resp.read())


def test_server_healthz_and_single_request(server):
    health = _get(server.port, "/healthz")
    assert health == {"status": "ok", "device": "cpu"}
    status, ctype, body = _post(server.port, "/synthesize", _payload("hello world"))
    assert status == 200 and ctype == "audio/wav"
    wav, sr = read_wav_bytes(body)
    assert sr == 24000 and wav.shape[-1] > 0 and wav.shape[-1] % 256 == 0
    assert np.isfinite(wav).all()


def test_server_concurrent_requests_batch(server):
    before = dict(server.batcher.stats)
    results = [None] * 3

    def hit(i):
        results[i] = _post(server.port, "/synthesize",
                           _payload(f"hello world number {i}"), accept_json=True)

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    for status, _, body in results:
        assert status == 200
        payload = json.loads(body)
        wav, sr = read_wav_bytes(base64.b64decode(payload["wav_b64"]))
        assert sr == 24000 and np.isfinite(wav).all()
        assert abs(payload["seconds"] - wav.shape[-1] / 24000) < 1e-6
    after = server.batcher.stats
    assert after["requests"] - before["requests"] == 3
    assert after["batches"] - before["batches"] < 3  # two or more shared a batch
    stats = _get(server.port, "/stats")
    assert stats["requests"] >= 3 and stats["errors"] == 0 and stats["audio_seconds"] > 0
    assert {"latency_p50", "latency_p95", "aggregate_rtf", "streams"} <= set(stats)


@pytest.mark.parametrize("payload", [
    {"text": "no prompt"},
    _payload("hello", prompt=np.zeros((1, 24000), np.float32)),  # silent prompt
    _payload("hello", num_step=13),  # custom sampling on a pinned server
], ids=["bad_request", "silent_prompt", "custom_sampling_pinned"])
def test_server_rejects_with_400(server, payload):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server.port, "/synthesize", payload, timeout=60)
    assert e.value.code == 400


def test_server_long_form_request(server):
    status, _, body = _post(server.port, "/synthesize", _payload(
        "the quick brown fox jumps over the lazy dog " * 3, long_form=True))
    wav, sr = read_wav_bytes(body)
    assert status == 200 and sr == 24000 and wav.shape[-1] > 0
    assert np.isfinite(wav).all()


def test_server_streaming_framing(server):
    """Chunked-transfer WAV with the unknown-length header (sizes
    0xFFFFFFFF), whose PCM body decodes to finite audio."""
    status, ctype, body = _post(server.port, "/synthesize_stream", _payload(
        "hello world. good morning. see you later.", seed=5), timeout=600)
    assert status == 200 and ctype == "audio/wav"
    assert body[:4] == b"RIFF" and body[8:12] == b"WAVE"
    assert struct.unpack("<I", body[4:8])[0] == 0xFFFFFFFF
    pcm = np.frombuffer(body[44:], dtype="<i2").astype(np.float32) / 32768.0
    assert pcm.size > 0 and np.isfinite(pcm).all()
    assert _get(server.port, "/stats")["streams"] >= 1


def test_read_wav_matches_bytes(tmp_path):
    x = _prompt(0.1)
    (tmp_path / "a.wav").write_bytes(wav_bytes(x, 16000))
    a, sr = read_wav(tmp_path / "a.wav")
    b, sr_b = read_wav_bytes(wav_bytes(x, 16000))
    assert sr == sr_b == 16000 and np.array_equal(a, b)
