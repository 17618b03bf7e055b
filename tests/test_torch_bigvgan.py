"""The port's BigVGAN path against the JAX package on the CPU, f32: the
generator at tests/test_bigvgan.py's tiny config on weights through both
loaders (the published weight-normed layout, and the JAX tree through
``from_jax_params``), the BigVGAN log-mel and ``extract_features``, the
prompt fbank's replicated last frame, and a tiny ``synthesize`` with
``vocoder="bigvgan"`` (sampled mel within 1e-4, PCM16 within 2 counts)
plus the infer CLI on a ``generator.``-prefixed checkpoint."""

import functools
import json
import os

import numpy as np
import pytest

import torch

from zipvoice_tpu.audio import bigvgan as jbig
from zipvoice_tpu.audio import mel as jmel
from zipvoice_tpu.config import FeatureConfig as JFeatureConfig
from zipvoice_tpu.io.model_dir import load_model_dir as jload_model_dir
from zipvoice_tpu.models.pipeline import ZipVoicePipeline as JPipeline
from zipvoice_tpu_torch.audio import bigvgan as tbig
from zipvoice_tpu_torch.audio import mel as tmel
from zipvoice_tpu_torch.audio.wav import read_wav, write_wav
from zipvoice_tpu_torch.config import FeatureConfig, ZipVoiceConfig
from zipvoice_tpu_torch.io.checkpoint import from_jax_params
from zipvoice_tpu_torch.io.model_dir import load_model_dir
from zipvoice_tpu_torch.models import zipvoice as tzv
from zipvoice_tpu_torch.models.pipeline import ZipVoicePipeline
from zipvoice_tpu_torch.text.tokenizer import write_token_file

# torch's CPU ops share one OpenMP pool a process; pytest-xdist runs a
# process a worker, and pools sized to every core oversubscribe the machine
# by the worker count, which slows torch's ops by orders of magnitude
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

# tests/test_bigvgan.py's CFG
CFG = tbig.BigVGANConfig(num_mels=8, upsample_initial_channel=16, upsample_rates=(2, 2),
                         upsample_kernel_sizes=(4, 4), resblock_kernel_sizes=(3,),
                         resblock_dilations=((1, 3),), aa_kernel_size=12)
JCFG = jbig.BigVGANConfig(**{f: getattr(CFG, f) for f in CFG.__dataclass_fields__})
# a tiny generator at the pipeline's hop (16 x 16 = 256) for the synthesize test
SYNTH = tbig.BigVGANConfig(num_mels=20, upsample_initial_channel=16, upsample_rates=(16, 16),
                           upsample_kernel_sizes=(32, 32), resblock_kernel_sizes=(3,),
                           resblock_dilations=((1,),))
JSYNTH = jbig.BigVGANConfig(**{f: getattr(SYNTH, f) for f in SYNTH.__dataclass_fields__})
TINY = dict(
    fm_decoder_downsampling_factor=(1, 2, 1), fm_decoder_num_layers=(1, 1, 1),
    fm_decoder_cnn_module_kernel=(9, 7, 9), fm_decoder_feedforward_dim=128,
    fm_decoder_num_heads=2, fm_decoder_dim=64, text_encoder_num_layers=1,
    text_encoder_feedforward_dim=64, text_encoder_cnn_module_kernel=5,
    text_encoder_num_heads=2, text_encoder_dim=48, time_embed_dim=32, text_embed_dim=48,
    query_head_dim=8, value_head_dim=8, pos_head_dim=4, pos_dim=48, feat_dim=20,
)
TOKENS = {"_": 0, " ": 1, **{ch: i + 2 for i, ch in enumerate("abcdefghijklmnopqrstuvwxyz")}}
BUCKETS = dict(token_bucket=8, frame_bucket=32)


def _published(cfg, seed):
    """A random generator's state_dict in the published layout:
    weight_g / weight_v for every conv and the snake parameters under
    ``.act.``."""
    model = tbig.init_bigvgan(cfg, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith(".weight"):
            sd[k + "_v"] = torch.randn(v.shape, generator=g)
            sd[k + "_g"] = 0.3 + 0.5 * torch.rand((v.shape[0], 1, 1), generator=g)
        elif k.endswith(("alpha", "beta")):
            sd[k.rsplit(".", 1)[0] + ".act." + k.rsplit(".", 1)[1]] = v
        else:
            sd[k] = v
    return sd


@pytest.mark.parametrize("loader", ["published", "jax_bridge"])
def test_bigvgan_decode_matches_jax(loader):
    sd = _published(CFG, 0)
    jparams = jbig.load_bigvgan_params({k: v.numpy() for k, v in sd.items()})
    if loader == "published":
        params = tbig.load_bigvgan_params(sd)
    else:
        params = from_jax_params(jax_tree(jparams))
    model = tbig.build_bigvgan(params)
    assert model.cfg == CFG
    mel = np.random.default_rng(0).standard_normal((2, 23, CFG.num_mels)).astype(np.float32)
    ref = np.asarray(jbig.bigvgan_decode(jparams, mel, JCFG))
    with torch.no_grad():
        out = tbig.bigvgan_decode(model, torch.from_numpy(mel)).numpy()
    assert out.shape == ref.shape == (2, 23 * CFG.hop_length)
    assert 0.01 < float(np.abs(ref).max()) < 1.0  # the final clamp does not hide the error
    assert float(np.abs(out - ref).max()) < 1e-5


def jax_tree(tree):
    import jax

    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def test_log_mel_and_extract_features_match_jax():
    """24000 samples take the replicate branch of the frame contract with
    bigvgan's smaller pad (93 STFT frames for 94), 24100 the crop; stereo
    keeps two channels' mels, channel-major."""
    r = np.random.default_rng(1)
    cfg, jcfg = FeatureConfig(type="bigvgan"), JFeatureConfig(type="bigvgan")
    for n in (24000, 24100):
        wav = (r.standard_normal((2, n)) * 0.1).astype(np.float32)
        for ch in (1, 2):
            ref = np.asarray(jmel.extract_features(wav, jcfg, num_channels=ch))
            out = tmel.extract_features(torch.from_numpy(wav), cfg, num_channels=ch).numpy()
            assert out.shape == ref.shape == ((n + 128) // 256, 100 * ch)
            assert float(np.abs(out - ref).max()) < 1e-4, (n, ch)
    ref = np.asarray(jmel.bigvgan_log_mel(wav, jcfg))
    out = tmel.bigvgan_log_mel(torch.from_numpy(wav), cfg).numpy()
    assert out.shape == ref.shape == (2, n // 256, 100)
    assert float(np.abs(out - ref).max()) < 1e-4
    assert tmel.stft_pad_amount(cfg) == 384


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """A bigvgan model dir (tiny seeded random weights, simple tokens), the
    tiny generator at hop 256 as a ``generator.``-prefixed published
    checkpoint, and a 1 s prompt (24000 samples: the replicate branch)."""
    d = tmp_path_factory.mktemp("bigvgan_model")
    write_token_file(TOKENS, str(d / "tokens.txt"))
    (d / "model.json").write_text(json.dumps({
        "model": {k: list(v) if isinstance(v, tuple) else v for k, v in TINY.items()},
        "feature": {"sampling_rate": 24000, "type": "bigvgan", "n_mels": 20}}))
    model = tzv.init_zipvoice(ZipVoiceConfig(**TINY, vocab_size=len(TOKENS), pad_id=0),
                              torch.Generator().manual_seed(0))
    torch.save({"model": model.state_dict()}, d / "model.pt")
    sd = _published(SYNTH, 3)
    torch.save({f"generator.{k}": v for k, v in sd.items()}, d / "bigvgan_generator.pt")
    prompt = (np.random.default_rng(0).standard_normal((1, 24000)) * 0.05).astype(np.float32)
    write_wav(d / "prompt.wav", prompt, 24000)
    return d, sd


def _pipelines(d, sd, monkeypatch):
    # the JAX pipeline decodes with BigVGANConfig(): point it at the tiny one
    monkeypatch.setattr(jbig, "BigVGANConfig", lambda: JSYNTH)
    ja = jload_model_dir(model_dir=str(d), tokenizer_name="simple")
    jp = JPipeline(params=ja.params, model_cfg=ja.model_cfg, feat_cfg=ja.feat_cfg,
                   vocos_params=jbig.load_bigvgan_params({k: v.numpy() for k, v in sd.items()}),
                   tokenizer=ja.tokenizer, vocoder="bigvgan", **BUCKETS)
    ta = load_model_dir(str(d), tokenizer_name="simple")
    tp = ZipVoicePipeline(model=ta.model, model_cfg=ta.model_cfg, feat_cfg=ta.feat_cfg,
                          vocos_params=tbig.load_bigvgan_params(sd), tokenizer=ta.tokenizer,
                          device="cpu", vocoder="bigvgan", **BUCKETS)
    return jp, tp


def test_prompt_features_replicates_last_frame(assets, monkeypatch):
    """The bucketed prompt fbank of a 24000-sample prompt: 93 STFT frames
    for the frame contract's 94, so the last frame repeats, as JAX's
    pipeline and the unbucketed extract_features do."""
    d, sd = assets
    jp, tp = _pipelines(d, sd, monkeypatch)
    prompt, sr = read_wav(d / "prompt.wav")
    jpf, _ = jp.prompt_features(prompt, sr)
    tpf, _ = tp.prompt_features(prompt, sr)
    assert tpf.shape == (94, 20) and torch.equal(tpf[-1], tpf[-2])
    assert float(np.abs(np.asarray(jpf) - tpf.numpy()).max()) < 1e-5
    full = tmel.extract_features(torch.from_numpy(prompt * (0.1 / np.sqrt(np.mean(prompt ** 2)))),
                                 tp.feat_cfg) * tp.feat_cfg.feat_scale
    assert float((full - tpf).abs().max()) < 1e-5


def test_synthesize_bigvgan_matches_jax(assets, monkeypatch, tmp_path):
    """The sampled mel, then synthesize() through BigVGAN to PCM16; the
    infer CLI picks BigVGAN from the model's features, strips the
    ``generator.`` prefix and writes the same wav as the pipeline."""
    from zipvoice_tpu_torch.bin.infer_zipvoice import main

    d, sd = assets
    jp, tp = _pipelines(d, sd, monkeypatch)
    prompt, sr = read_wav(d / "prompt.wav")
    noise = np.random.default_rng(7).standard_normal((1, 256, 20)).astype(np.float32)
    for p in (jp, tp):  # both sample from the same explicit noise
        p.sample_features = functools.partial(p.sample_features, noise=noise)
    tok = tp.tokenizer.texts_to_token_ids
    jm, jgen = jp.sample_features(tok(["hello world"])[0], tok(["hi there"])[0],
                                  np.asarray(jp.prompt_features(prompt, sr)[0]),
                                  num_step=2, guidance_scale=1.0)
    tm, tgen = tp.sample_features(tok(["hello world"])[0], tok(["hi there"])[0],
                                  tp.prompt_features(prompt, sr)[0], num_step=2,
                                  guidance_scale=1.0)
    assert jgen == tgen and float(np.abs(np.asarray(jm) - tm.numpy()).max()) < 1e-4
    args = dict(text="hello world", prompt_text="hi there", prompt_wav=prompt, prompt_sr=sr,
                num_step=2, guidance_scale=1.0)
    jres, tres = jp.synthesize(**args), tp.synthesize(**args)
    assert tres.wav.shape == jres.wav.shape == ((tgen - 1) * 256,)
    counts = np.abs(np.round(jres.wav * 32767) - np.round(tres.wav * 32767)).max()
    assert counts <= 2, counts
    assert [k.static for k in tp.graphs.keys() if k.name == "vocode_i16"] == [("bigvgan",)]

    out = tmp_path / "cli.wav"
    main(["--model-dir", str(d), "--tokenizer", "simple", "--vocoder-path",
          str(d / "bigvgan_generator.pt"), "--prompt-wav", str(d / "prompt.wav"),
          "--prompt-text", "hi there", "--text", "hello world", "--num-step", "2",
          "--res-wav-path", str(out), "--device", "cpu"])
    wav, _ = read_wav(out)
    ta = load_model_dir(str(d), tokenizer_name="simple")
    ref = ZipVoicePipeline(model=ta.model, model_cfg=ta.model_cfg, feat_cfg=ta.feat_cfg,
                           vocos_params=tbig.load_bigvgan_params(sd), tokenizer=ta.tokenizer,
                           device="cpu", vocoder="bigvgan").synthesize(**args).wav
    assert wav.shape == (1, ref.shape[0])
    assert np.abs(np.round(wav[0] * 32767) - np.round(ref * 32767)).max() <= 1
    with pytest.raises(SystemExit, match="not yet ported"):
        main(["--model-dir", str(d), "--tokenizer", "simple", "--prompt-wav",
              str(d / "prompt.wav"), "--prompt-text", "hi", "--text", "hello",
              "--device", "cpu"])
