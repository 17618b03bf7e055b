"""zipvoice_tpu_torch's pipeline and CLI against zipvoice_tpu's on the CPU
with a tiny random model: the 2-step sampled mel within 1e-4 (Euler steps
accumulate the per-module error), synthesize() to PCM16 within 2 counts,
the CLI end to end with --device cpu, and the silent-prompt error."""

import functools
import json
import os

import numpy as np
import pytest

import jax
import torch

from zipvoice_tpu.audio.vocos import VocosConfig as JVocosConfig
from zipvoice_tpu.audio.vocos import load_vocos_params as jload_vocos
from zipvoice_tpu.io.checkpoint import params_to_state_dict
from zipvoice_tpu.io.model_dir import load_model_dir as jload_model_dir
from zipvoice_tpu.models import zipvoice as jzv
from zipvoice_tpu.models.pipeline import ZipVoicePipeline as JPipeline
from zipvoice_tpu_torch.audio.vocos import VocosConfig, init_vocos
from zipvoice_tpu_torch.audio.wav import read_wav, write_wav
from zipvoice_tpu_torch.config import ZipVoiceConfig
from zipvoice_tpu_torch.io.model_dir import load_model_dir
from zipvoice_tpu_torch.models.pipeline import ZipVoicePipeline
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


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """Model dir from JAX init weights (torch layout on disk), a vocoder
    checkpoint in the published layout, and a 1 s prompt wav."""
    d = tmp_path_factory.mktemp("model")
    write_token_file(TOKENS, str(d / "tokens.txt"))
    (d / "model.json").write_text(json.dumps({
        "model": {k: list(v) if isinstance(v, tuple) else v for k, v in TINY.items()},
        "feature": {"sampling_rate": 24000, "type": "vocos", "n_mels": 20},
    }))
    cfg = ZipVoiceConfig(**TINY, vocab_size=len(TOKENS), pad_id=0)
    params = jzv.init_zipvoice(jax.random.PRNGKey(0), cfg)
    torch.save({"model": {k: torch.from_numpy(np.array(v))
                          for k, v in params_to_state_dict(params).items()}},
               d / "model.pt")
    vocos_sd = init_vocos(VocosConfig(**VOCOS), torch.Generator().manual_seed(1))
    torch.save(vocos_sd, d / "vocos.bin")
    prompt = (np.random.default_rng(0).standard_normal((1, 24000)) * 0.05).astype(
        np.float32)
    write_wav(d / "prompt.wav", prompt, 24000)
    return d, vocos_sd


def _pipelines(d, vocos_sd):
    from zipvoice_tpu_torch.audio.vocos import load_vocos_params

    ja = jload_model_dir(model_dir=str(d), tokenizer_name="simple")
    jp = JPipeline(params=ja.params, model_cfg=ja.model_cfg, feat_cfg=ja.feat_cfg,
                   vocos_params=jload_vocos({k: v.numpy() for k, v in vocos_sd.items()}),
                   vocos_cfg=JVocosConfig(**VOCOS), tokenizer=ja.tokenizer, **BUCKETS)
    ta = load_model_dir(str(d), tokenizer_name="simple")
    tp = ZipVoicePipeline(model=ta.model, model_cfg=ta.model_cfg, feat_cfg=ta.feat_cfg,
                          vocos_params=load_vocos_params(vocos_sd),
                          vocos_cfg=VocosConfig(**VOCOS), tokenizer=ta.tokenizer,
                          device="cpu", **BUCKETS)
    return jp, tp


def test_sample_and_synthesize_match_jax(assets):
    d, vocos_sd = assets
    jp, tp = _pipelines(d, vocos_sd)
    prompt, sr = read_wav(d / "prompt.wav")
    tok = tp.tokenizer.texts_to_token_ids
    tokens, prompt_tokens = tok(["hello world"])[0], tok(["hi there"])[0]

    jpf, jrms = jp.prompt_features(prompt, sr)
    tpf, trms = tp.prompt_features(prompt, sr)
    assert abs(jrms - trms) < 1e-7
    assert float(np.abs(np.asarray(jpf) - tpf.numpy()).max()) < 1e-5

    # explicit noise: torch.Generator and jax.random draw different numbers
    noise = np.random.default_rng(7).standard_normal((1, 256, 20)).astype(np.float32)
    kw = dict(num_step=2, guidance_scale=1.0, t_shift=0.5, noise=noise)
    jmel, jgen = jp.sample_features(tokens, prompt_tokens, np.asarray(jpf), **kw)
    tmel, tgen = tp.sample_features(tokens, prompt_tokens, np.asarray(jpf), **kw)
    assert jgen == tgen
    assert float(np.abs(np.asarray(jmel) - tmel.numpy()).max()) < 1e-4

    for p in (jp, tp):  # both sample from the same explicit noise
        p.sample_features = functools.partial(p.sample_features, noise=noise)
    args = dict(text="hello world", prompt_text="hi there", prompt_wav=prompt,
                prompt_sr=sr, num_step=2, guidance_scale=1.0)
    jres, tres = jp.synthesize(**args), tp.synthesize(**args)
    assert tres.wav.shape == jres.wav.shape == ((tgen - 1) * 256,)
    counts = np.abs(np.round(jres.wav * 32767) - np.round(tres.wav * 32767)).max()
    assert counts <= 2, counts
    assert {"rtf", "rtf_no_vocoder", "rtf_vocoder"} <= set(tres.metrics)


def test_cli_main_cpu(assets, tmp_path):
    from zipvoice_tpu_torch.bin.infer_zipvoice import main

    d, _ = assets
    (tmp_path / "list.tsv").write_text(
        f"a\thi there\t{d / 'prompt.wav'}\thello world\n"
        f"b\thi there\t{d / 'prompt.wav'}\tgood day to you\n"
    )
    metrics = main([
        "--model-dir", str(d), "--vocoder-path", str(d / "vocos.bin"),
        "--tokenizer", "simple", "--test-list", str(tmp_path / "list.tsv"),
        "--res-dir", str(tmp_path / "out"), "--num-step", "2", "--device", "cpu",
    ])
    assert len(metrics) == 2
    for name in ("a", "b"):
        wav, sr = read_wav(tmp_path / "out" / f"{name}.wav")
        assert sr == 24000 and wav.shape[-1] > 0 and wav.shape[-1] % 256 == 0
        assert np.isfinite(wav).all()


def test_cli_refuses_what_is_not_ported(assets, tmp_path, monkeypatch):
    """Without --model-dir or --vocoder-path the CLI asks the Hugging Face
    Hub's cache (offline and empty here), which raises its own error."""
    from huggingface_hub.errors import LocalEntryNotFoundError

    from tests import torch_hub_cache
    from zipvoice_tpu_torch.bin.infer_zipvoice import main

    d, _ = assets
    torch_hub_cache.offline(monkeypatch, tmp_path / "empty-hub")
    base = ["--vocoder-path", str(d / "vocos.bin"), "--tokenizer", "simple",
            "--device", "cpu", "--prompt-wav", str(d / "prompt.wav"),
            "--prompt-text", "hi", "--text", "yo"]
    for argv, repo in ((base, "k2-fsa/ZipVoice"),  # no --model-dir
                       (base[2:] + ["--model-dir", str(d)],  # no --vocoder-path
                        "charactr/vocos-mel-24khz")):
        with pytest.raises(LocalEntryNotFoundError) as e:
            main(argv)
        assert torch_hub_cache.offline_miss(e.value, repo)


def test_serve_cli_refuses_what_is_not_ported(assets, tmp_path, monkeypatch):
    """Without --vocoder-path or --model-dir the serve CLI asks the Hugging
    Face Hub's cache (offline and empty here), which raises its own error;
    an unknown quantize mode is refused."""
    from huggingface_hub.errors import LocalEntryNotFoundError

    from tests import torch_hub_cache
    from zipvoice_tpu_torch.bin.serve import main

    d, _ = assets
    torch_hub_cache.offline(monkeypatch, tmp_path / "empty-hub")
    base = ["--model-dir", str(d), "--vocoder-path", str(d / "vocos.bin"),
            "--device", "cpu"]
    with pytest.raises(LocalEntryNotFoundError) as e:  # no --vocoder-path
        main(base[:2] + ["--tokenizer", "simple", "--device", "cpu"])
    assert torch_hub_cache.offline_miss(e.value, "charactr/vocos-mel-24khz")
    with pytest.raises(LocalEntryNotFoundError) as e:
        main(["--tokenizer", "simple", "--device", "cpu"])  # no --model-dir
    assert torch_hub_cache.offline_miss(e.value, "k2-fsa/ZipVoice")
    ta = load_model_dir(str(d), tokenizer_name="simple")
    with pytest.raises(ValueError, match="unknown quantize mode"):
        ZipVoicePipeline(model=ta.model, model_cfg=ta.model_cfg, feat_cfg=ta.feat_cfg,
                         tokenizer=ta.tokenizer, device="cpu", quantize="int4")


def test_cli_long_form_cpu(assets, tmp_path):
    """--long-form runs synthesize_long: two sentence chunks, one wav."""
    from zipvoice_tpu_torch.bin.infer_zipvoice import main

    d, _ = assets
    out = tmp_path / "long.wav"
    metrics = main([
        "--model-dir", str(d), "--vocoder-path", str(d / "vocos.bin"),
        "--tokenizer", "simple", "--device", "cpu", "--num-step", "2",
        "--prompt-wav", str(d / "prompt.wav"), "--prompt-text", "hi there",
        "--text", "hello world. good day to you.", "--long-form",
        "--res-wav-path", str(out),
    ])
    assert metrics[0]["chunks"] == 1  # both sentences fit one 20 s chunk
    wav, sr = read_wav(out)
    assert sr == 24000 and wav.shape[-1] > 0 and np.isfinite(wav).all()


def test_silent_prompt_raises(assets):
    d, vocos_sd = assets
    _, tp = _pipelines(d, vocos_sd)
    with pytest.raises(ValueError, match="silent"):
        tp.synthesize(text="hello", prompt_text="hi",
                      prompt_wav=np.zeros((1, 24000), np.float32), prompt_sr=24000,
                      num_step=2)
