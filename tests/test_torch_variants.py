"""The port's inference variants against the JAX package on the CPU at tiny
widths (2 layers a stack), with the JAX parameters carried across by
``from_jax_params`` and the same numpy-seeded inputs and noise: ZipVoice-Distill's sampler, the
dialog speaker parity and text embedding, the two-stream fm_decoder on both
streams, ``sample_dialog`` mono and stereo, each variant's pipeline
(``sample_features``, ``vocode_stereo``) and the variant CLIs end to end.
Features within 1e-4 absolute in f32 (Euler steps accumulate the
per-module error); PCM16 within 2 counts."""

import functools
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zipvoice_tpu.audio.vocos import VocosConfig as JVocosConfig
from zipvoice_tpu.audio.vocos import load_vocos_params as jload_vocos
from zipvoice_tpu.config import ZipVoiceConfig as JConfig
from zipvoice_tpu.io.checkpoint import state_dict_to_params
from zipvoice_tpu.io.model_dir import load_model_dir as jload_model_dir
from zipvoice_tpu.models import dialog as jdialog
from zipvoice_tpu.models import distill as jdistill
from zipvoice_tpu.models import zipvoice as jzv
from zipvoice_tpu.models.pipeline import ZipVoicePipeline as JPipeline
from zipvoice_tpu.nn.zipformer import tts_zipformer_forward as jtts_forward
from zipvoice_tpu.sampling.euler import euler_sample as jeuler_sample
from zipvoice_tpu_torch.audio.vocos import VocosConfig, init_vocos, load_vocos_params
from zipvoice_tpu_torch.audio.wav import read_wav, write_wav
from zipvoice_tpu_torch.config import ZipVoiceConfig
from zipvoice_tpu_torch.io.checkpoint import from_jax_params, load_into
from zipvoice_tpu_torch.io.model_dir import load_model_dir
from zipvoice_tpu_torch.models import dialog as tdialog
from zipvoice_tpu_torch.models import zipvoice as tzv
from zipvoice_tpu_torch.models.distill import distill_config
from zipvoice_tpu_torch.models.pipeline import ZipVoicePipeline
from zipvoice_tpu_torch.nn.zipformer import tts_zipformer_forward
from zipvoice_tpu_torch.sampling.euler import euler_sample
from zipvoice_tpu_torch.text.espeak_map import VENDORED_ESPEAK_MAP
from zipvoice_tpu_torch.text.tokenizer import write_token_file

# torch's CPU ops share one OpenMP pool a process; pytest-xdist runs a
# process a worker, and pools sized to every core oversubscribe the machine
# by the worker count, which slows torch's ops by orders of magnitude
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

TINY = dict(
    fm_decoder_downsampling_factor=(1, 2, 1),
    fm_decoder_num_layers=(2, 2, 2),
    fm_decoder_cnn_module_kernel=(9, 7, 9),
    fm_decoder_feedforward_dim=96,
    fm_decoder_num_heads=2,
    fm_decoder_dim=48,
    text_encoder_num_layers=2,
    text_encoder_feedforward_dim=64,
    text_encoder_cnn_module_kernel=5,
    text_encoder_num_heads=2,
    text_encoder_dim=32,
    time_embed_dim=32,
    text_embed_dim=32,
    query_head_dim=8,
    value_head_dim=8,
    pos_head_dim=4,
    pos_dim=32,
    feat_dim=16,
    guidance_scale_embed_dim=32,
)
F = TINY["feat_dim"]
VOCAB = 362  # the released dialog vocabulary puts [S1]/[S2] at 360/361
VOCOS = dict(input_channels=F, dim=32, intermediate_dim=64, num_layers=2,
             n_fft=1024, hop_length=256)
BUCKETS = dict(token_bucket=16, frame_bucket=32)
TOL = 1e-4


def _configs(**kw):
    return JConfig(**TINY, vocab_size=VOCAB, pad_id=0, **kw), \
        ZipVoiceConfig(**TINY, vocab_size=VOCAB, pad_id=0, **kw)


def _init(kind: str, seed: int = 0):
    """Seeded random weights of a variant ("distill", "dialog", "stereo")
    in the port's layout (the JAX package's init runs op by op on the CPU,
    seconds a model)."""
    _, cfg = _configs()
    g = torch.Generator().manual_seed(seed)
    if kind in ("base", "distill"):
        return tzv.init_zipvoice(distill_config(cfg) if kind == "distill" else cfg, g)
    return tdialog.init_zipvoice_dialog(cfg, stereo=kind == "stereo", generator=g)


@functools.lru_cache(maxsize=None)
def _models(kind: str):
    """(the JAX parameter tree, the port's model loaded from that tree
    through from_jax_params) of one variant."""
    sd = {k: v.numpy() for k, v in _init(kind).state_dict().items()}
    params = state_dict_to_params(sd)
    _, cfg = _configs()
    with torch.device("meta"):
        model = (tzv.ZipVoiceModel(distill_config(cfg)) if kind == "distill"
                 else tdialog.ZipVoiceDialogModel(cfg, stereo=kind == "stereo"))
    return params, load_into(model, from_jax_params(params)).eval()


def _jit(fn, *static, **kw):
    """fn(params, *static, *arrays, **kw) as one compiled program over
    (params, *arrays): compiling it once is faster on the CPU than running
    the JAX package's forward op by op."""
    if not static:
        return jax.jit(fn)
    return jax.jit(lambda params, *arrays: fn(params, *static, *arrays, **kw))


def _inputs(seed, b, t, width, lens):
    r = np.random.default_rng(seed)
    xs = [r.standard_normal((b, t, width)).astype(np.float32) for _ in range(2)]
    tc = r.standard_normal((b, t, F)).astype(np.float32)
    mask = np.arange(t)[None, :] >= np.asarray(lens)[:, None]
    return xs[0], tc, xs[1], mask


def test_distill_euler_sample_matches_jax():
    """One fm_decoder call a step at batch B with the scale embedded, no
    CFG batch."""
    jcfg, _ = _configs()
    params, model = _models("distill")
    assert model.fm_decoder.guidance_scale_embed.weight.shape == (32, 32)
    noise, tc, sc, mask = _inputs(1, 2, 48, F, [48, 37])
    kw = dict(num_step=2, guidance_scale=3.0, t_shift=0.5, distill=True)
    ref = _jit(jeuler_sample, jdistill.distill_config(jcfg), **kw)(
        params, *map(jnp.asarray, (noise, tc, sc, mask)))
    with torch.no_grad():
        out = euler_sample(model, *map(torch.from_numpy, (noise, tc, sc, mask)), **kw)
    assert float(np.abs(out.numpy() - np.asarray(ref)).max()) < TOL


def test_speaker_parity_and_dialog_text_embed_match_jax():
    jcfg, _ = _configs()
    params, model = _models("dialog")
    a, b = tdialog.SPK_A_ID_DEFAULT, tdialog.SPK_B_ID_DEFAULT
    tokens = [[a, 3, 4, 5, b, 6, 7, a, 8], [b, 9, 10]]
    padded = jzv.pad_labels(tokens, 0)
    lens = np.array([len(t) for t in tokens])
    ref_par = np.asarray(jdialog.speaker_parity(jnp.asarray(padded), 0))
    par = tdialog.speaker_parity(torch.from_numpy(padded).long(), 0)
    np.testing.assert_array_equal(par.numpy(), ref_par)
    assert par[1].tolist() == [1, 1, 1, -1, -1, -1, -1, -1, -1, -1]
    ref = _jit(jdialog.forward_text_embed, jcfg)(params, jnp.asarray(padded),
                                                 jnp.asarray(lens))
    with torch.no_grad():
        out = tdialog.forward_text_embed(model, torch.from_numpy(padded).long(),
                                         torch.from_numpy(lens))
    assert float(np.abs(out.numpy() - np.asarray(ref)).max()) <= 1e-5


@pytest.mark.parametrize("stream,width", [(0, 5 * F), (1, 3 * F), (1, 5 * F)])
def test_two_stream_fm_decoder_matches_jax(stream, width):
    """Stream 0 takes 5F and emits 2F, stream 1 takes 3F and emits F; a
    width that is not the requested stream's input flips to the other."""
    jcfg, _ = _configs()
    params, model = _models("stereo")
    assert model.fm_decoder.in_proj[0].weight.shape == (48, 5 * F)
    assert model.fm_decoder.out_proj[1].weight.shape == (F, 48)
    r = np.random.default_rng(4)
    x = r.standard_normal((2, 40, width)).astype(np.float32)
    t = np.array([0.3, 0.7], np.float32)
    mask = np.arange(40)[None, :] >= np.array([40, 31])[:, None]
    ref = _jit(lambda p, x, t, m: jtts_forward(p, jcfg.fm_decoder_config(), x, t=t,
                                               padding_mask=m, stream=stream))(
        params["fm_decoder"], *map(jnp.asarray, (x, t, mask)))
    with torch.no_grad():
        out = tts_zipformer_forward(model.fm_decoder, torch.from_numpy(x),
                                    torch.from_numpy(t), torch.from_numpy(mask),
                                    stream=stream)
    assert out.shape == (2, 40, 2 * F if width == 5 * F else F)
    assert float(np.abs(out.numpy() - np.asarray(ref)).max()) < 1e-5


@pytest.mark.parametrize("stereo", [False, True])
def test_sample_dialog_matches_jax(stereo):
    jcfg, _ = _configs()
    params, model = _models("stereo" if stereo else "dialog")
    a, b = tdialog.SPK_A_ID_DEFAULT, tdialog.SPK_B_ID_DEFAULT
    padded = jzv.pad_labels([[a, 3, 4, b, 5, 6, 7], [b, 8, 9, a, 10]], 0)
    lens = np.array([7, 5])
    width = F * (2 if stereo else 1)
    r = np.random.default_rng(6)
    pf = r.standard_normal((2, 64, width)).astype(np.float32)
    noise = r.standard_normal((2, 64, width)).astype(np.float32)
    pf_lens, f_lens = np.array([20, 14]), np.array([64, 50])
    kw = dict(num_step=2, guidance_scale=1.5, t_shift=0.5)
    ref = _jit(jdialog.sample_dialog, jcfg, **kw)(params, *map(jnp.asarray, (
        padded, lens, pf, pf_lens, f_lens, noise)))
    with torch.no_grad():
        out = tdialog.sample_dialog(model, torch.from_numpy(padded).long(),
                                    *map(torch.from_numpy, (lens, pf, pf_lens, f_lens,
                                                            noise)), **kw)
    assert out.shape == (2, 64, width)
    assert float(np.abs(out.numpy() - np.asarray(ref)).max()) < TOL


# ---------------------------------------------------------------------------
# pipelines and CLIs over model dirs
# ---------------------------------------------------------------------------

def _tokens(spk_ids):
    """The espeak block, filler tokens and [S1]/[S2] at ``spk_ids``."""
    token2id = dict(VENDORED_ESPEAK_MAP)
    free = [i for i in range(len(token2id), VOCAB) if i not in spk_ids]
    token2id.update({f"<filler{i}>": i for i in free})
    token2id.update({"[S1]": spk_ids[0], "[S2]": spk_ids[1]})
    return token2id


KINDS = {  # model dir -> variant
    "zipvoice": "base",
    "zipvoice_distill": "distill",
    "zipvoice_dialog": "dialog",
    "zipvoice_dialog_stereo": "stereo",
    "zipvoice_dialog_elsewhere": "dialog",
}


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    """A model dir a variant (seeded random weights, torch layout on disk;
    the dialog ones with [S1]/[S2] at 360/361), a dialog dir whose turn
    tokens sit elsewhere, a vocoder checkpoint and 1 s prompts (mono and
    stereo)."""
    root = tmp_path_factory.mktemp("variants")
    dirs = {}
    for i, (name, kind) in enumerate(KINDS.items()):
        d = root / name
        d.mkdir()
        spk = (200, 201) if name.endswith("elsewhere") else (360, 361)
        write_token_file(_tokens(spk), str(d / "tokens.txt"))
        (d / "model.json").write_text(json.dumps({
            "model": {k: list(v) if isinstance(v, tuple) else v for k, v in TINY.items()},
            "feature": {"sampling_rate": 24000, "type": "vocos", "n_mels": F},
        }))
        torch.save({"model": _init(kind, seed=10 + i).state_dict()}, d / "model.pt")
        dirs[name] = d
    vocos_sd = init_vocos(VocosConfig(**VOCOS), torch.Generator().manual_seed(1))
    torch.save(vocos_sd, root / "vocos.bin")
    r = np.random.default_rng(0)
    for name, ch in (("prompt.wav", 1), ("prompt1.wav", 1), ("prompt2.wav", 1),
                     ("stereo.wav", 2)):
        write_wav(root / name, (r.standard_normal((ch, 24000)) * 0.05).astype(np.float32),
                  24000)
    return root, dirs, vocos_sd


def _pipelines(d, name, vocos_sd):
    from zipvoice_tpu_torch.io.model_dir import MODEL_REGISTRY

    reg = MODEL_REGISTRY[name]
    ja = jload_model_dir(model_dir=str(d), model_name=name)
    jp = JPipeline(params=ja.params, model_cfg=ja.model_cfg, feat_cfg=ja.feat_cfg,
                   vocos_params=jload_vocos({k: v.numpy() for k, v in vocos_sd.items()}),
                   vocos_cfg=JVocosConfig(**VOCOS), tokenizer=ja.tokenizer,
                   distill=reg["distill"], variant=reg["variant"], **BUCKETS)
    ta = load_model_dir(str(d), model_name=name)
    tp = ZipVoicePipeline(model=ta.model, model_cfg=ta.model_cfg, feat_cfg=ta.feat_cfg,
                          vocos_params=load_vocos_params(vocos_sd),
                          vocos_cfg=VocosConfig(**VOCOS), tokenizer=ta.tokenizer,
                          device="cpu", distill=reg["distill"], variant=reg["variant"],
                          **BUCKETS)
    return jp, tp


@pytest.mark.parametrize("name,text,prompt_text", [
    ("zipvoice_distill", "Hello world, this is a test.", "How are you?"),
    ("zipvoice_dialog", "[S1] Hello there. [S2] Hi, how are you?", "[S1] Fine. [S2] Yes."),
    ("zipvoice_dialog_stereo", "[S1] Hello there. [S2] Hi!", "[S1] Fine. [S2] Yes."),
    ("zipvoice_dialog_elsewhere", "[S1] Hello there. [S2] Hi!", "[S1] Fine. [S2] Yes."),
])
def test_pipeline_variants_match_jax(model_dirs, name, text, prompt_text):
    """Each variant's tokens, prompt fbank and sampled mel against JAX's
    pipeline, and the stereo PCM16 (vocode_stereo) within 2 counts.  The
    dialog sampler takes the turn ids 360/361, not the tokenizer's: with
    [S1]/[S2] elsewhere in tokens.txt no position is a turn, every token is
    speaker A's, as in the JAX package."""
    root, dirs, vocos_sd = model_dirs
    model_name = name.replace("_elsewhere", "")
    jp, tp = _pipelines(dirs[name], model_name, vocos_sd)
    stereo = model_name.endswith("stereo")
    prompt, sr = read_wav(root / ("stereo.wav" if stereo else "prompt.wav"))
    tokens = tp.tokenizer.texts_to_token_ids([text])[0]
    prompt_tokens = tp.tokenizer.texts_to_token_ids([prompt_text])[0]
    assert tokens == jp.tokenizer.texts_to_token_ids([text])[0]
    if model_name != "zipvoice_distill":
        turn = tp.tokenizer.spk_a_id
        assert tokens[0] == turn == (200 if name.endswith("elsewhere") else 360)
        par = tdialog.speaker_parity(torch.tensor([tokens]), 0)
        assert par.max().item() == (0 if name.endswith("elsewhere") else 1)

    jpf, _ = jp.prompt_features(prompt, sr)
    tpf, _ = tp.prompt_features(prompt, sr)
    assert tpf.shape == (jpf.shape[0], F * (2 if stereo else 1))
    assert float(np.abs(np.asarray(jpf) - tpf.numpy()).max()) < 1e-5
    width = tp.sample_feat_dim
    noise = np.random.default_rng(7).standard_normal((1, 256, width)).astype(np.float32)
    kw = dict(num_step=2, guidance_scale=3.0 if jp.distill else 1.5, t_shift=0.5,
              noise=noise)
    jmel, jgen = jp.sample_features(tokens, prompt_tokens, np.asarray(jpf), **kw)
    tmel, tgen = tp.sample_features(tokens, prompt_tokens, np.asarray(jpf), **kw)
    assert jgen == tgen and tmel.shape[-1] == width
    assert float(np.abs(np.asarray(jmel) - tmel.numpy()).max()) < TOL
    if stereo:
        jwav = jp.vocode_stereo(np.asarray(jmel), jgen)
        twav = tp.vocode_stereo(jmel, tgen)
        assert twav.shape == jwav.shape == (2, (tgen - 1) * 256)
        counts = np.abs(np.round(jwav * 32767) - np.round(twav * 32767)).max()
        assert counts <= 2, counts


def test_pipeline_keys_tell_variants_apart(model_dirs):
    """A distill and a base pipeline in one process keep their own graph
    sets, and a program's key names its variant and its sample width."""
    root, dirs, vocos_sd = model_dirs
    ta = load_model_dir(str(dirs["zipvoice_distill"]), model_name="zipvoice_distill")
    common = dict(model_cfg=ta.model_cfg, feat_cfg=ta.feat_cfg, tokenizer=ta.tokenizer,
                  vocos_params=load_vocos_params(vocos_sd), vocos_cfg=VocosConfig(**VOCOS),
                  device="cpu", **BUCKETS)
    dist = ZipVoicePipeline(model=ta.model, distill=True, **common)
    base = ZipVoicePipeline(model=ta.model, **common)
    pf = np.zeros((20, F), np.float32)
    for p in (dist, base):
        p.sample_features([5, 6, 7], [8, 9], pf, num_step=2, guidance_scale=3.0)
    (kd,), (kb,) = dist.graphs.keys(), base.graphs.keys()
    assert dist.graphs is not base.graphs
    assert kd.static[:2] == ("zipvoice", True) and kb.static[:2] == ("zipvoice", False)
    # an int8 pipeline quantizes a copy and keeps its own graph set: its
    # key equals the float pipeline's, whose graphs it never sees
    q = ZipVoicePipeline(model=ta.model, distill=True, quantize="int8", **common)
    q.sample_features([5, 6, 7], [8, 9], pf, num_step=2, guidance_scale=3.0)
    (kq,) = q.graphs.keys()
    assert q.graphs is not dist.graphs and kq == kd
    assert type(ta.model.fm_decoder.encoders[0].layers[0].feed_forward1.in_proj) is torch.nn.Linear
    with pytest.raises(ValueError, match="zipvoice variant only"):
        ZipVoicePipeline(model=ta.model, distill=True, variant="dialog", **common)
    st = load_model_dir(str(dirs["zipvoice_dialog_stereo"]),
                        model_name="zipvoice_dialog_stereo")
    stereo = ZipVoicePipeline(model=st.model, variant="dialog_stereo",
                              **dict(common, tokenizer=st.tokenizer))
    mel = torch.zeros((64, 2 * F))
    assert stereo.vocode_stereo(mel, 40).shape == (2, 39 * 256)
    assert stereo.vocode(mel[:, :F], 40).shape == (39 * 256,)
    vk = [k for k in stereo.graphs.keys() if k.name == "vocode_i16"]
    assert [k.inputs[0][0] for k in vk] == [(1, 64, 2 * F), (1, 64, F)]


@pytest.mark.parametrize("model_name,channels", [("zipvoice_dialog", 1),
                                                 ("zipvoice_dialog_stereo", 2)])
def test_dialog_cli_cpu(model_dirs, tmp_path, model_name, channels):
    """The dialog CLI end to end: a merged and a split prompt (4- and
    6-column test list); the wav has the model's channel count and
    (gen_len - 1) * 256 samples."""
    from zipvoice_tpu_torch.audio.mel import compute_num_frames
    from zipvoice_tpu_torch.bin.infer_zipvoice_dialog import main

    root, dirs, _ = model_dirs
    tok = load_model_dir(str(dirs[model_name]), model_name=model_name).tokenizer

    def samples(prompt_text, prompt_samples, text):
        pf = compute_num_frames(prompt_samples, 256)
        n_prompt, n_text = (len(tok.texts_to_token_ids([x])[0]) for x in (prompt_text, text))
        total = tzv.predict_features_lens(np.array([pf]), np.array([n_prompt]),
                                          np.array([n_text]))[0]
        return (int(total) - pf - 1) * 256

    merged = root / ("stereo.wav" if channels == 2 else "prompt.wav")
    (tmp_path / "list.tsv").write_text(
        f"merged\t[S1] hi there [S2] yes\t{merged}\t[S1] good day. [S2] to you.\n"
        f"split\thi there\t{root / 'prompt1.wav'}\tyes\t{root / 'prompt2.wav'}\t"
        f"[S1] good day. [S2] to you.\n")
    metrics = main(["--model-name", model_name, "--model-dir", str(dirs[model_name]),
                    "--vocoder-path", str(root / "vocos.bin"), "--test-list",
                    str(tmp_path / "list.tsv"), "--res-dir", str(tmp_path / "out"),
                    "--num-step", "2", "--device", "cpu"])
    assert len(metrics) == 2
    text = "[S1] good day. [S2] to you."
    for name, prompt_text, prompt_samples in (
            ("merged", "[S1] hi there [S2] yes", 24000),
            ("split", "[S1]hi there[S2]yes", 48000)):
        wav, sr = read_wav(tmp_path / "out" / f"{name}.wav")
        assert sr == 24000 and np.isfinite(wav).all()
        assert wav.shape == (channels, samples(prompt_text, prompt_samples, text))


def test_distill_cli_cpu_default_tokenizer(model_dirs, tmp_path):
    """--model-name zipvoice_distill with no --tokenizer: emilia, English
    through the offline G2P; 8 steps and guidance 3.0 by default."""
    from zipvoice_tpu_torch.bin.infer_zipvoice import main

    root, dirs, _ = model_dirs
    out = tmp_path / "distill.wav"
    metrics = main(["--model-name", "zipvoice_distill", "--model-dir",
                    str(dirs["zipvoice_distill"]), "--vocoder-path", str(root / "vocos.bin"),
                    "--prompt-wav", str(root / "prompt.wav"), "--prompt-text",
                    "How are you?", "--text", "Hello world, this is a test.",
                    "--res-wav-path", str(out), "--device", "cpu"])
    wav, sr = read_wav(out)
    assert sr == 24000 and wav.shape[0] == 1 and wav.shape[1] > 0
    assert np.isfinite(wav).all() and metrics[0]["wav_seconds"] > 0


def test_default_entry_points_use_emilia(model_dirs, tmp_path):
    """With no tokenizer named, load_model_dir and every CLI take emilia,
    and the base infer CLI synthesizes with it."""
    from zipvoice_tpu_torch.bin import _train_common, infer_zipvoice, serve
    from zipvoice_tpu_torch.text.tokenizer import EmiliaTokenizer

    root, dirs, _ = model_dirs
    assert isinstance(load_model_dir(str(dirs["zipvoice"])).tokenizer, EmiliaTokenizer)
    assert infer_zipvoice.get_parser().get_default("tokenizer") == "emilia"
    assert serve.get_parser().get_default("tokenizer") == "emilia"
    train = __import__("argparse").ArgumentParser()
    _train_common.add_common_args(train)
    assert train.get_default("tokenizer") == "emilia"
    out = tmp_path / "base.wav"
    infer_zipvoice.main(["--model-dir", str(dirs["zipvoice"]), "--vocoder-path",
                         str(root / "vocos.bin"), "--prompt-wav", str(root / "prompt.wav"),
                         "--prompt-text", "How are you?", "--text", "Hello world.",
                         "--num-step", "2", "--res-wav-path", str(out), "--device", "cpu"])
    wav, sr = read_wav(out)
    assert sr == 24000 and wav.shape[0] == 1 and wav.shape[1] > 0
