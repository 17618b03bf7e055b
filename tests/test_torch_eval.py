"""The evaluation models and CLIs of the port against the JAX package's on the
CPU, offline (random weights, no download): UTMOS22-strong and the
ECAPA-TDNN head on a tiny WavLM (state_dict keys and shapes equal, forwards
on the same weights equal within 1e-6), the fairseq-to-HF WavLM key
converter (equal maps), the MOS CLI on a locally saved checkpoint and the
cpSIM CLI with a fake encoder (equal output files), ``wer.score_pairs``
(equal dicts) and ``wer.load_asr``'s refusals without the weights (the
same errors).  Nothing here imports the port's evaluation models at
collection, and ``transformers`` only builds the tiny WavLM."""

import os
import sys

import numpy as np
import pytest
import torch

from zipvoice_tpu_torch.audio.wav import write_wav

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

TINY_WAVLM = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                  intermediate_size=64, conv_dim=[8] * 7, conv_kernel=[10, 3, 3, 3, 3, 2, 2],
                  conv_stride=[5, 2, 2, 2, 2, 2, 2], feat_extract_norm="layer",
                  do_stable_layer_norm=True, conv_bias=True, num_buckets=16,
                  max_bucket_distance=40)


def _randomize(sd, seed):
    """Seeded random values for every float tensor (BatchNorm variances
    positive, so that eval-mode outputs stay finite)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in sd.items():
        if not v.dtype.is_floating_point:
            out[k] = v
        elif "running_var" in k:
            out[k] = torch.rand(v.shape, generator=g) * 0.5 + 0.5
        else:
            out[k] = torch.randn(v.shape, generator=g) * 0.1
    return out


def _shapes(model):
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def test_utmos_keys_and_forward_match_jax():
    from zipvoice_tpu.eval.models.utmos import UTMOS22Strong as JUTMOS
    from zipvoice_tpu_torch.eval.models.utmos import UTMOS22Strong

    ref, ours = JUTMOS(), UTMOS22Strong()
    assert _shapes(ours) == _shapes(ref)
    sd = _randomize(ref.state_dict(), 0)
    ref.load_state_dict(sd)
    ours.load_state_dict(sd)
    ref.eval(), ours.eval()
    wave = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 16000))
                            .astype(np.float32) * 0.1)
    with torch.no_grad():
        a, b = ours(wave), ref(wave)
    assert a.shape == (2,) and torch.isfinite(a).all()
    torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_ecapa_keys_and_forward_match_jax():
    from transformers import WavLMConfig, WavLMModel

    from zipvoice_tpu.eval.models.ecapa_tdnn_wavlm import ECAPA_TDNN_WavLM as JECAPA
    from zipvoice_tpu_torch.eval.models.ecapa_tdnn_wavlm import (
        ECAPA_TDNN_WavLM,
        extract_hidden_states_s3prl_convention,
    )

    torch.manual_seed(0)
    ssl = WavLMModel(WavLMConfig(**TINY_WAVLM))
    ours = ECAPA_TDNN_WavLM(feat_dim=32, channels=16, emb_dim=8, ssl=ssl)
    ref = JECAPA(feat_dim=32, channels=16, emb_dim=8, ssl=WavLMModel(WavLMConfig(**TINY_WAVLM)))
    assert _shapes(ours) == _shapes(ref)
    sd = _randomize(ref.state_dict(), 2)
    ours.load_state_dict(sd)
    ref.load_state_dict(sd)
    ours.eval(), ref.eval()
    wave = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 8000))
                            .astype(np.float32))
    with torch.no_grad():
        a, b = ours(wave), ref(wave)
    assert a.shape == (2, 8) and torch.isfinite(a).all()
    torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    hooks = extract_hidden_states_s3prl_convention(ours.ssl, wave)
    with torch.no_grad():
        states = ours.ssl(wave, output_hidden_states=True).hidden_states
    assert len(hooks) == len(states) == 3
    for h, s in zip(hooks, states):
        torch.testing.assert_close(h, s, rtol=0, atol=0)


def test_wavlm_converter_matches_jax():
    from zipvoice_tpu.eval.models.ecapa_tdnn_wavlm import convert_wavlm_fairseq_to_hf as jconv
    from zipvoice_tpu_torch.eval.models.ecapa_tdnn_wavlm import convert_wavlm_fairseq_to_hf

    keys = ["mask_emb", "post_extract_proj.weight", "layer_norm.bias",
            "feature_extractor.conv_layers.0.0.weight", "feature_extractor.conv_layers.0.2.1.bias",
            "feature_extractor.conv_layers.3.2.1.weight", "encoder.pos_conv.0.weight_g",
            "encoder.pos_conv.0.weight_v", "encoder.pos_conv.0.bias",
            "encoder.layers.1.self_attn.grep_linear.weight", "encoder.layers.1.self_attn.grep_a",
            "encoder.layers.0.self_attn.relative_attention_bias.weight",
            "encoder.layers.0.self_attn.k_proj.weight", "encoder.layers.0.fc2.bias",
            "encoder.layers.0.final_layer_norm.weight", "label_embs_concat"]
    sd = {k: torch.full((1,), float(i)) for i, k in enumerate(keys)}
    ours, ref = convert_wavlm_fairseq_to_hf(sd), jconv(sd)
    assert list(ours) == list(ref) and len(ours) == len(keys) - 1
    assert all(torch.equal(ours[k], ref[k]) for k in ours)


def _wavs(d, n, rate, seed=0):
    d.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        write_wav(d / f"u{i}.wav", (rng.standard_normal((1, 16000)) * 0.1).astype(np.float32),
                  rate)


def test_mos_cli_matches_jax(tmp_path, monkeypatch):
    """Both MOS CLIs on a locally saved random UTMOS checkpoint: the same
    output file, one finite score a wav."""
    from zipvoice_tpu.eval import mos as jmos
    from zipvoice_tpu_torch.eval import mos
    from zipvoice_tpu_torch.eval.models.utmos import UTMOS22Strong

    torch.manual_seed(0)
    ckpt = tmp_path / "utmos22_strong.pt"
    torch.save(UTMOS22Strong().state_dict(), ckpt)
    _wavs(tmp_path / "wavs", 2, 24000)
    args = ["--wav-dir", str(tmp_path / "wavs"), "--checkpoint", str(ckpt)]
    res = mos.main(args + ["--out", str(tmp_path / "port.tsv"), "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["mos", *args, "--out", str(tmp_path / "jax.tsv")])
    jmos.main()
    lines = (tmp_path / "port.tsv").read_text().strip().split("\n")
    assert (tmp_path / "port.tsv").read_text() == (tmp_path / "jax.tsv").read_text()
    assert lines[0].startswith("UTMOS\t") and len(lines) == 3
    assert np.isfinite(res["UTMOS"]) and [n for n, _ in res["rows"]] == ["u0", "u1"]


class FakeEncoder:
    """tests/test_eval.py's spectral-centroid embedding: separates two tones."""

    def __init__(self, *a, **k):
        pass

    def embed(self, wav, sr):
        w = np.asarray(wav, np.float64).ravel()
        spec = np.abs(np.fft.rfft(w[: 4096]))
        freqs = np.arange(spec.size)
        c = (spec * freqs).sum() / (spec.sum() + 1e-9)
        return np.array([1.0, c / 1000.0])


def test_cpsim_cli_matches_jax(tmp_path, monkeypatch):
    """A stereo conversation with swapped channels against split prompts:
    both CLIs write the same file and the best permutation scores ~1."""
    import zipvoice_tpu.eval.sim as jsim
    import zipvoice_tpu_torch.eval.sim as tsim
    from zipvoice_tpu.eval import cpsim as jcpsim
    from zipvoice_tpu_torch.eval import cpsim

    sr = 24000
    t = np.arange(sr) / sr
    spk = [np.sin(2 * np.pi * f * t).astype(np.float32) for f in (220, 1760)]
    (tmp_path / "gen").mkdir()
    write_wav(tmp_path / "gen" / "c0.wav", np.stack([spk[1], spk[0]]), sr)
    write_wav(tmp_path / "p1.wav", spk[0][None, :], sr)
    write_wav(tmp_path / "p2.wav", spk[1][None, :], 16000)
    (tmp_path / "list.tsv").write_text(
        f"c0\tt1\tt2\t{tmp_path / 'p1.wav'}\t{tmp_path / 'p2.wav'}\ttext\n"
        f"missing\tt1\tt2\t{tmp_path / 'p1.wav'}\t{tmp_path / 'p2.wav'}\ttext\n")
    monkeypatch.setattr(tsim, "SpeakerEncoder", FakeEncoder)
    monkeypatch.setattr(jsim, "SpeakerEncoder", FakeEncoder)
    args = ["--wav-dir", str(tmp_path / "gen"), "--test-list", str(tmp_path / "list.tsv"),
            "--prompt-mode", "split"]
    res = cpsim.main(args + ["--out", str(tmp_path / "port.tsv"), "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["cpsim", *args, "--out", str(tmp_path / "jax.tsv")])
    jcpsim.main()
    assert (tmp_path / "port.tsv").read_text() == (tmp_path / "jax.tsv").read_text()
    assert res["cpSIM"] > 0.99 and len(res["rows"]) == 1
    enc = FakeEncoder()
    tracks = [spk[1], spk[0]]
    assert tsim.cp_sim(enc, tracks, spk, sr) == jsim.cp_sim(enc, tracks, spk, sr)


@pytest.mark.parametrize("protocol", ["seedtts", "hubert", "dialog"])
def test_score_pairs_matches_jax(protocol):
    from zipvoice_tpu.eval.wer import score_pairs as jscore
    from zipvoice_tpu_torch.eval.wer import score_pairs

    pairs = [("u0", "hello world", "hello world"), ("u1", "a b c d", "a x c d"),
             ("u2", "It's a test, isn't it?", "its a  test isnt it"),
             ("u3", "[S1] good morning [S2] how are you", "[S1] how are you [S2] good morning")]
    zh = [("z0", "你好世界", "你好地球"), ("z1", "聽說", "听说")]
    for lang, ps in (("en", pairs), ("zh", zh)):
        kw = (dict(dialog=True) if protocol == "dialog" else dict(protocol=protocol))
        assert score_pairs(ps, lang, **kw) == jscore(ps, lang, **kw)
    res = score_pairs(pairs[:2], "en")
    assert res["wer_avg"] == pytest.approx(0.125) and res["wer"] == pytest.approx(1 / 6)


def test_load_asr_refuses_without_weights(tmp_path):
    """paraformer and whisperd need --model-dir; a model dir without the
    model's subdirectory raises FileNotFoundError: JAX's messages."""
    from zipvoice_tpu.eval.wer import load_asr as jload
    from zipvoice_tpu_torch.eval.wer import load_asr

    for key, model_dir, exc in (("paraformer", None, ValueError),
                                ("whisperd", None, ValueError),
                                ("whisper", str(tmp_path), FileNotFoundError)):
        with pytest.raises(exc) as ours:
            load_asr(key, model_dir, device="cpu")
        with pytest.raises(exc) as ref:
            jload(key, model_dir)
        assert str(ours.value) == str(ref.value)
