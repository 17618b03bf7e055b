"""Models and vocoders fetched through the Hugging Face Hub's cache, on the
CPU with an offline cache in tmp_path (``tests/torch_hub_cache.py``; no test
contacts the network): ``maybe_download`` returns the snapshot directory
that the JAX package's returns on the same cache; ``load_model_dir(None)``
loads tensors bit-equal to a load of that directory; the infer CLI with
neither --model-dir nor --vocoder-path writes the wav of the run with both
(Vocos, and BigVGAN for a bigvgan model.json); the serve and dialog CLIs
build with no --model-dir; the golden dry run reports the ``hf://`` source
as JAX's does; a file absent from the cache raises the hub's error; without
``huggingface_hub`` the fetch fails naming it."""

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from huggingface_hub.errors import LocalEntryNotFoundError

from tests import torch_hub_cache as hub
from zipvoice_tpu.bin import golden_acceptance as jcli
from zipvoice_tpu.io import model_dir as jmodel_dir
from zipvoice_tpu_torch.audio.bigvgan import BigVGANConfig, init_bigvgan
from zipvoice_tpu_torch.audio.vocos import VocosConfig, init_vocos
from zipvoice_tpu_torch.audio.wav import read_wav, write_wav
from zipvoice_tpu_torch.bin import golden_acceptance as tcli
from zipvoice_tpu_torch.bin.infer_zipvoice import VOCODER_HUB, load_vocoder_params
from zipvoice_tpu_torch.config import ZipVoiceConfig
from zipvoice_tpu_torch.io.model_dir import HF_REPO, load_model_dir, maybe_download
from zipvoice_tpu_torch.models.dialog import init_zipvoice_dialog
from zipvoice_tpu_torch.models.zipvoice import init_zipvoice
from zipvoice_tpu_torch.text.espeak_map import VENDORED_ESPEAK_MAP
from zipvoice_tpu_torch.text.tokenizer import write_token_file

# torch's CPU ops share one OpenMP pool a process; pytest-xdist runs a
# process a worker, and pools sized to every core oversubscribe the machine
# by the worker count, which slows torch's ops by orders of magnitude
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

TINY = dict(
    fm_decoder_downsampling_factor=(1, 2, 1), fm_decoder_num_layers=(1, 1, 1),
    fm_decoder_cnn_module_kernel=(9, 7, 9), fm_decoder_feedforward_dim=128,
    fm_decoder_num_heads=2, fm_decoder_dim=64, text_encoder_num_layers=1,
    text_encoder_feedforward_dim=64, text_encoder_cnn_module_kernel=5,
    text_encoder_num_heads=2, text_encoder_dim=48, time_embed_dim=32, text_embed_dim=48,
    query_head_dim=8, value_head_dim=8, pos_head_dim=4, pos_dim=48, feat_dim=20,
)
TOKENS = {"_": 0, " ": 1, **{ch: i + 2 for i, ch in enumerate("abcdefghijklmnopqrstuvwxyz")}}
VOCOS = dict(input_channels=20, dim=32, intermediate_dim=64, num_layers=2,
             n_fft=1024, hop_length=256)
# a tiny generator at the pipeline's hop (16 x 16 = 256)
BIGVGAN = BigVGANConfig(num_mels=20, upsample_initial_channel=16, upsample_rates=(16, 16),
                        upsample_kernel_sizes=(32, 32), resblock_kernel_sizes=(3,),
                        resblock_dilations=((1,),))
FILES = ("model.pt", "model.json", "tokens.txt")


def _model_dir(d, features="vocos", dialog=False):
    d.mkdir()
    if dialog:  # the released dialog layout: [S1]/[S2] at 360/361
        tokens = dict(VENDORED_ESPEAK_MAP)
        tokens.update({f"<filler{i}>": i for i in range(len(tokens), 360)})
        tokens.update({"[S1]": 360, "[S2]": 361})
    else:
        tokens = TOKENS
    write_token_file(tokens, str(d / "tokens.txt"))
    (d / "model.json").write_text(json.dumps({
        "model": {k: list(v) if isinstance(v, tuple) else v for k, v in TINY.items()},
        "feature": {"sampling_rate": 24000, "type": features, "n_mels": 20}}))
    cfg = ZipVoiceConfig(**TINY, vocab_size=len(tokens), pad_id=0)
    g = torch.Generator().manual_seed(3)
    model = init_zipvoice_dialog(cfg, generator=g) if dialog else init_zipvoice(cfg, g)
    torch.save({"model": model.state_dict()}, d / "model.pt")
    return d


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """Local dirs (a vocos and a bigvgan base model, a dialog model), the
    two vocoders' checkpoints and a 1 s prompt."""
    root = tmp_path_factory.mktemp("hub_assets")
    torch.save(init_vocos(VocosConfig(**VOCOS), torch.Generator().manual_seed(1)),
               root / "pytorch_model.bin")
    gen = init_bigvgan(BIGVGAN, torch.Generator().manual_seed(2))
    torch.save({f"generator.{k}": v for k, v in gen.state_dict().items()},
               root / "bigvgan_generator.pt")
    write_wav(root / "prompt.wav",
              (np.random.default_rng(0).standard_normal((1, 24000)) * 0.05).astype(np.float32),
              24000)
    return dict(root=root, vocos=_model_dir(root / "vocos_model"),
                bigvgan=_model_dir(root / "bigvgan_model", "bigvgan"),
                dialog=_model_dir(root / "dialog_model", dialog=True))


def _cache(tmp_path, monkeypatch, assets, model="vocos", subdir="zipvoice",
           vocoder="vocos", skip=()):
    """An offline cache holding ``assets[model]`` as ``HF_REPO/subdir`` and
    the ``vocoder``'s published checkpoint (None: none), less ``skip``."""
    cache = tmp_path / "hub"
    for f in FILES:
        if f not in skip:
            hub.put(cache, HF_REPO, f"{subdir}/{f}", assets[model] / f)
    if vocoder is not None:
        repo, name = VOCODER_HUB[vocoder]
        hub.put(cache, repo, name, assets["root"] / name)
    hub.offline(monkeypatch, cache)
    return cache


def test_maybe_download_equals_jax(assets, tmp_path, monkeypatch):
    cache = _cache(tmp_path, monkeypatch, assets, vocoder=None)
    want = hub.snapshot(cache, HF_REPO) / "zipvoice"
    assert maybe_download("zipvoice") == jmodel_dir.maybe_download("zipvoice") == want
    assert sorted(p.name for p in want.iterdir()) == sorted(FILES)


def test_load_model_dir_from_hub_bit_equal(assets, tmp_path, monkeypatch):
    cache = _cache(tmp_path, monkeypatch, assets, vocoder=None)
    fetched = load_model_dir(None, tokenizer_name="simple")
    local = load_model_dir(str(hub.snapshot(cache, HF_REPO) / "zipvoice"),
                           tokenizer_name="simple")
    a, b = fetched.model.state_dict(), local.model.state_dict()
    assert list(a) == list(b) and len(a) > 100
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert fetched.model_cfg == local.model_cfg and fetched.defaults == local.defaults


@pytest.mark.parametrize("vocoder", ["vocos", "bigvgan"])
def test_infer_cli_without_paths(assets, tmp_path, monkeypatch, vocoder):
    """Neither --model-dir nor --vocoder-path: the model from HF_REPO and
    the vocoder its features name, each through the cache; the wav equals
    the run with both paths sample for sample."""
    from zipvoice_tpu_torch.bin.infer_zipvoice import main

    _cache(tmp_path, monkeypatch, assets, model=vocoder, vocoder=vocoder)
    base = ["--tokenizer", "simple", "--prompt-wav", str(assets["root"] / "prompt.wav"),
            "--prompt-text", "hi there", "--text", "hello world", "--num-step", "2",
            "--device", "cpu"]
    main(base + ["--res-wav-path", str(tmp_path / "hub.wav")])
    main(base + ["--model-dir", str(assets[vocoder]), "--vocoder-path",
                 str(assets["root"] / VOCODER_HUB[vocoder][1]),
                 "--res-wav-path", str(tmp_path / "local.wav")])
    fetched, sr = read_wav(tmp_path / "hub.wav")
    local, _ = read_wav(tmp_path / "local.wav")
    assert sr == 24000 and fetched.shape == local.shape and fetched.shape[1] > 0
    assert np.array_equal(fetched, local)


def test_serve_and_dialog_cli_without_model_dir(assets, tmp_path, monkeypatch):
    from zipvoice_tpu_torch.bin import infer_zipvoice_dialog, serve

    _cache(tmp_path, monkeypatch, assets)
    server = serve.build_server(serve.get_parser().parse_args(
        ["--tokenizer", "simple", "--device", "cpu", "--port", "0"]))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    server.shutdown()
    thread.join(timeout=30)
    assert not thread.is_alive() and server.pipeline.model_cfg.feat_dim == TINY["feat_dim"]
    hub.put(tmp_path / "hub", HF_REPO, "zipvoice_dialog/model.pt", assets["dialog"] / "model.pt")
    for f in ("model.json", "tokens.txt"):
        hub.put(tmp_path / "hub", HF_REPO, f"zipvoice_dialog/{f}", assets["dialog"] / f)
    out = tmp_path / "dialog.wav"
    infer_zipvoice_dialog.main(
        ["--prompt-wav", str(assets["root"] / "prompt.wav"), "--prompt-text",
         "[S1] hi there [S2] yes", "--text", "[S1] good day. [S2] to you.", "--num-step", "2",
         "--res-wav-path", str(out), "--device", "cpu"])
    wav, sr = read_wav(out)
    assert sr == 24000 and wav.shape[0] == 1 and wav.shape[1] > 0 and np.isfinite(wav).all()


def test_dry_run_reports_hf_source(assets, tmp_path, monkeypatch, capsys):
    """No --model-dirs: every model's hf:// source and the hub importable,
    ready; equal to the JAX package's dry run but for its invocation."""
    args = ["--models", "all", "--reference-path", str(tmp_path / "no-reference"), "--dry-run"]
    assert tcli.main(args) == 0
    ours = json.loads(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["golden_acceptance"] + args)
    with pytest.raises(SystemExit) as e:
        jcli.main()
    assert e.value.code == 0
    ref = json.loads(capsys.readouterr().out)
    for key in ("mode", "models", "fixture", "reference", "status"):
        assert ours[key] == ref[key], key
    assert ours["status"] == "ready"
    assert ours["models"]["zipvoice_dialog"] == {
        "files": {}, "hf_hub": "importable",
        "source": "hf://k2-fsa/ZipVoice/zipvoice_dialog/{model.pt,model.json,tokens.txt}"}


def test_file_absent_from_cache_raises_hub_error(assets, tmp_path, monkeypatch):
    from zipvoice_tpu_torch.bin.infer_zipvoice import main

    _cache(tmp_path, monkeypatch, assets, vocoder=None, skip=("tokens.txt",))
    with pytest.raises(LocalEntryNotFoundError) as e:
        maybe_download("zipvoice")
    assert hub.offline_miss(e.value, HF_REPO) and "tokens.txt" in str(e.value.__cause__)
    with pytest.raises(LocalEntryNotFoundError) as e:
        load_vocoder_params(None, "bigvgan")
    assert hub.offline_miss(e.value, VOCODER_HUB["bigvgan"][0])
    with pytest.raises(LocalEntryNotFoundError) as e:  # the model local, the vocoder not
        main(["--model-dir", str(assets["vocos"]), "--tokenizer", "simple", "--prompt-wav",
              str(assets["root"] / "prompt.wav"), "--prompt-text", "hi", "--text", "yo",
              "--device", "cpu"])
    assert hub.offline_miss(e.value, VOCODER_HUB["vocos"][0])


def test_without_huggingface_hub(assets, tmp_path, monkeypatch, capsys):
    """huggingface_hub unimportable: every fetch raises ImportError naming
    it, and the dry run reports it MISSING, not ready, as JAX's does."""
    from zipvoice_tpu.eval import golden as jgolden
    from zipvoice_tpu_torch.eval import golden

    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(ImportError, match="huggingface_hub"):
        maybe_download("zipvoice")
    with pytest.raises(ImportError, match="huggingface_hub"):
        load_model_dir(None)
    with pytest.raises(ImportError, match="huggingface_hub"):
        load_vocoder_params(None)
    with pytest.raises(ImportError, match="huggingface_hub"):
        golden.golden_acceptance("zipvoice", None, tmp_path / "no-reference", device="cpu")
    with pytest.raises(ImportError, match="huggingface_hub"):
        jgolden.golden_acceptance("zipvoice", None, str(tmp_path / "no-reference"))
    args = ["--models", "zipvoice", "--reference-path", str(tmp_path / "no-reference"),
            "--dry-run"]
    assert tcli.main(args) == 1
    ours = json.loads(capsys.readouterr().out)
    assert ours["status"] == "not-ready"
    assert ours["models"]["zipvoice"]["hf_hub"] == "MISSING (pass --model-dirs or install)"
