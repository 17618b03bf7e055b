"""Data preparation in the port against the JAX package on the CPU: the four
CLIs of ``egs/zipvoice/run.sh``'s stages 0-1 and the offline features
(``bin/prepare_dataset``, ``prepare_tokens``, ``make_tokens``,
``compute_fbank``) on the same tiny TSVs, and the training collator's
native batch loading.

Tolerances:
- manifests (3- and 5-column rows, the dropped rows, the resampled copies),
  the 6-column token TSV and both ``make_tokens`` modes: byte-equal;
- fbank shards and index: the same names, keys, shapes and index rows; each
  float16 feature within one float16 ulp plus 2e-5 of JAX's (the f32 fbanks
  of the two packages differ by up to ~1.5e-5, torch's FFT against JAX's,
  so a value may round to the neighbouring float16, and near zero the f32
  difference exceeds a float16 ulp);
- the collator's audio with the native loader on and off, and against
  JAX's per-file ``load_audio``, at equal rates: within 1e-6.
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from zipvoice_tpu_torch.audio.wav import write_wav
from zipvoice_tpu_torch.text.tokenizer import write_token_file

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

CHARS = {"_": 0, " ": 1, **{c: i + 2 for i, c in enumerate("abcdefghijklmnopqrstuvwxyz")}}
TEXTS = ["hello world", "the quick brown fox", "jumps over the lazy dog", "good day to you",
         "see you soon", "a test of the data", "one more line"]


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """A raw corpus: whole files at 24, 16 and 48 kHz, a stereo file, a
    5-column segment row, a segment past its file's end and an unreadable
    row.  Returns the directory (raw.tsv)."""
    d = tmp_path_factory.mktemp("raw")
    rng = np.random.default_rng(5)
    rows = []
    for i, (sr, ch, sec) in enumerate([(24000, 1, 1.5), (16000, 1, 1.2), (48000, 1, 1.1),
                                       (24000, 2, 1.4), (24000, 1, 1.3)]):
        p = d / f"u{i}.wav"
        write_wav(p, (rng.standard_normal((ch, int(sec * sr))) * 0.1).astype(np.float32), sr)
        rows.append(f"u{i}\t{TEXTS[i]}\t{p}")
    rows.append(f"u5\t{TEXTS[5]}\t{d / 'u4.wav'}\t0.2\t1.0")    # a segment
    rows.append(f"u6\t{TEXTS[6]}\t{d / 'u0.wav'}\t0.5\t9.0")    # past the file's end
    (d / "bad.wav").write_bytes(b"not a wav")
    rows.append(f"u7\t{TEXTS[0]}\t{d / 'bad.wav'}")               # unreadable
    (d / "raw.tsv").write_text("\n".join(rows) + "\n")
    return d


def _run_jax(monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", [module.__name__, *argv])
    module.main()


@pytest.mark.parametrize("resample", [True, False])
def test_prepare_dataset_matches_jax(raw, tmp_path, monkeypatch, resample):
    """Kept and dropped rows, the 5-column output and the resampled copies
    (16 and 48 kHz to 24 kHz) byte-equal to JAX's; without --resample-dir
    the other rates are dropped."""
    from zipvoice_tpu.bin import prepare_dataset as jprep
    from zipvoice_tpu_torch.bin import prepare_dataset as tprep

    def argv(tag):
        a = ["--tsv-path", str(raw / "raw.tsv"), "--output-dir", str(tmp_path / tag)]
        return a + (["--resample-dir", str(tmp_path / f"{tag}_rs")] if resample else [])

    res = tprep.main(argv("port"))
    _run_jax(monkeypatch, jprep, argv("jax"))
    ours = (tmp_path / "port" / "custom_train.tsv").read_text()
    ref = (tmp_path / "jax" / "custom_train.tsv").read_text()
    assert ours == ref.replace(str(tmp_path / "jax_rs"), str(tmp_path / "port_rs"))
    assert res["manifest"] == str(tmp_path / "port" / "custom_train.tsv")
    kept = [line.split("\t")[0] for line in ours.splitlines()]
    want = ["u0", "u1", "u2", "u3", "u4", "u5"] if resample else ["u0", "u3", "u4", "u5"]
    assert kept == want and res["kept"] == len(want) and res["dropped"] == 8 - len(want)
    if resample:
        for uid in ("u1", "u2"):
            assert (tmp_path / "port_rs" / f"{uid}.wav").read_bytes() == \
                (tmp_path / "jax_rs" / f"{uid}.wav").read_bytes()


@pytest.fixture(scope="module")
def prepared(raw, tmp_path_factory):
    """The port's stage-0 manifest of the raw corpus, resampled to 24 kHz."""
    from zipvoice_tpu_torch.bin import prepare_dataset

    d = tmp_path_factory.mktemp("prepared")
    return Path(prepare_dataset.main(["--tsv-path", str(raw / "raw.tsv"), "--output-dir",
                                      str(d), "--resample-dir", str(d / "rs")])["manifest"])


@pytest.mark.parametrize("tokenizer,manifest", [("emilia", "prepared"), ("espeak", "raw")])
def test_prepare_tokens_matches_jax(raw, prepared, tmp_path, monkeypatch, tokenizer, manifest):
    """The 6-column token TSV byte-equal to JAX's: from the 5-column
    manifest, and from a 3-column one whose durations are probed."""
    from zipvoice_tpu.bin import prepare_tokens as jtok
    from zipvoice_tpu_torch.bin import prepare_tokens as ttok
    from zipvoice_tpu_torch.data.dataset import read_tsv_manifest

    src = prepared
    if manifest == "raw":
        src = tmp_path / "raw3.tsv"
        src.write_text("".join(line + "\n" for line in (raw / "raw.tsv").read_text().splitlines()
                               if len(line.split("\t")) == 3 and "bad.wav" not in line))
    ttok.main(["--manifest", str(src), "--output", str(tmp_path / "port.tsv"),
               "--tokenizer", tokenizer])
    _run_jax(monkeypatch, jtok, ["--manifest", str(src), "--output", str(tmp_path / "jax.tsv"),
                                 "--tokenizer", tokenizer])
    ours = (tmp_path / "port.tsv").read_text()
    assert ours == (tmp_path / "jax.tsv").read_text()
    utts = read_tsv_manifest(tmp_path / "port.tsv")
    assert len(utts) == len(read_tsv_manifest(src)) and all(u.token_strs for u in utts)


@pytest.mark.parametrize("mode", ["simple", "dialog", "emilia"])
def test_make_tokens_matches_jax(prepared, tmp_path, monkeypatch, mode):
    """tokens.txt byte-equal to JAX's: corpus mode (simple, and dialog with
    [S1]/[S2] reserved) and the emilia layout from a small pinyin list."""
    from zipvoice_tpu.bin import make_tokens as jmake
    from zipvoice_tpu_torch.bin import make_tokens as tmake

    if mode == "emilia":
        pinyin = tmp_path / "pinyin.txt"
        pinyin.write_text("ni3\nhao3\nzhong1\nguo2\nma\nlv4\nxue2\nsheng1\nr\n\ner2\n")
        argv = ["--emilia-pinyin", str(pinyin)]
    else:
        manifest = prepared
        if mode == "dialog":
            manifest = tmp_path / "dialog.tsv"
            manifest.write_text("".join(
                f"d{i}\t[S1] {a}. [S2] {b}?\t{prepared}\n"
                for i, (a, b) in enumerate(zip(["hello there", "fine"], ["hi", "good"]))))
        argv = ["--manifest", str(manifest), "--manifest", str(prepared), "--tokenizer", mode]
    tmake.main(argv + ["--output", str(tmp_path / "port.txt")])
    _run_jax(monkeypatch, jmake, argv + ["--output", str(tmp_path / "jax.txt")])
    ours = (tmp_path / "port.txt").read_text()
    assert ours == (tmp_path / "jax.txt").read_text() and ours.startswith("_\t0\n")
    if mode == "dialog":
        assert ours.splitlines()[1:3] == ["[S1]\t1", "[S2]\t2"]


def _f16_ulp(x: np.ndarray) -> np.ndarray:
    return np.spacing(np.abs(x.astype(np.float16))).astype(np.float32)


@pytest.mark.parametrize("feat_type,channels", [("vocos", 1), ("bigvgan", 1), ("vocos", 2)])
def test_compute_fbank_matches_jax(prepared, tmp_path, monkeypatch, feat_type, channels):
    """Shards of two utterances: the shard names, the index TSV, each
    shard's keys and shapes equal to JAX's, each float16 feature within one
    float16 ulp plus 2e-5.  The segment row is featurized over its segment only."""
    from zipvoice_tpu.bin import compute_fbank as jfb
    from zipvoice_tpu_torch.bin import compute_fbank as tfb

    argv = ["--manifest", str(prepared), "--type", feat_type, "--num-channels", str(channels),
            "--shard-size", "2"]
    index = tfb.main(argv + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    _run_jax(monkeypatch, jfb, argv + ["--output-dir", str(tmp_path / "jax")])
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == ["custom_train_feats.tsv"] + [f"custom_train_feats_{i:05d}.npz"
                                                   for i in range(3)]
    assert Path(index).read_text() == (tmp_path / "jax" / "custom_train_feats.tsv").read_text()
    worst = 0.0
    for name in names[1:]:
        ours, ref = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
        assert ours.files == ref.files
        for uid in ours.files:
            a, b = ours[uid], ref[uid]
            assert a.dtype == b.dtype == np.float16 and a.shape == b.shape
            diff = np.abs(a.astype(np.float32) - b.astype(np.float32))
            assert (diff <= np.maximum(_f16_ulp(a), _f16_ulp(b)) + 2e-5).all(), (name, uid)
            worst = max(worst, float(diff.max()))
    frames = {row.split("\t")[0]: int(row.split("\t")[4])
              for row in Path(index).read_text().splitlines()}
    assert frames["u5"] == round(0.8 * 24000 / 256)  # the segment [0.2, 1.0) s
    assert worst <= 2 ** -6


def test_precomputed_collator_reads_port_shards(prepared, tmp_path):
    """PrecomputedFeatureCollator over compute_fbank's shards: each row is
    its shard's features scaled to model space, padded to the buckets."""
    from zipvoice_tpu_torch.bin import compute_fbank
    from zipvoice_tpu_torch.data.dataset import PrecomputedFeatureCollator, read_tsv_manifest
    from zipvoice_tpu_torch.text.tokenizer import get_tokenizer

    index = compute_fbank.main(["--manifest", str(prepared), "--output-dir", str(tmp_path),
                                "--shard-size", "4", "--device", "cpu"])
    write_token_file(CHARS, str(tmp_path / "tokens.txt"))
    utts = read_tsv_manifest(prepared)
    col = PrecomputedFeatureCollator(get_tokenizer("simple", str(tmp_path / "tokens.txt")),
                                     index, str(tmp_path))
    batch = col(utts)
    assert batch["features"].shape[0] == 8 and batch["features"].shape[1] % 64 == 0
    shards = {}
    for row in Path(index).read_text().splitlines():
        uid, _, _, shard, n = row.split("\t")
        shards.setdefault(shard, np.load(tmp_path / shard))
        i = [u.uid for u in utts].index(uid)
        assert batch["features_lens"][i] == int(n)
        np.testing.assert_array_equal(batch["features"][i, : int(n)],
                                      shards[shard][uid].astype(np.float32) * 0.1)


def _collator(tmp_path, module, tokenizer_fn, feat_cfg, **kw):
    write_token_file(CHARS, str(tmp_path / "tokens.txt"))
    return module.OnDeviceFbankCollator(tokenizer_fn("simple", str(tmp_path / "tokens.txt")),
                                        feat_cfg, pad_id=0, **kw)


def test_collator_native_batches_match_numpy_and_jax(raw, tmp_path, monkeypatch):
    """Whole-file rows at the model's rate (a mono and a stereo file): the
    native batch (one batch_load_wav call) equals the per-file numpy batch
    within 1e-6, features too, and each row's audio equals JAX's per-file
    load_audio within 1e-6.  Rows at other rates take the native loader
    too, resampled to ceil(n * 24000 / sr) samples."""
    from zipvoice_tpu.config import FeatureConfig as JFeatureConfig
    from zipvoice_tpu.data import dataset as jdata
    from zipvoice_tpu.text.tokenizer import get_tokenizer as jget_tokenizer
    from zipvoice_tpu_torch.config import FeatureConfig
    from zipvoice_tpu_torch.data import dataset as tdata
    from zipvoice_tpu_torch.ops import native
    from zipvoice_tpu_torch.text.tokenizer import get_tokenizer

    rows = [f"u{i}\t{TEXTS[i]}\t{raw / f'u{i}.wav'}" for i in (0, 3, 4)]
    (tmp_path / "m.tsv").write_text("\n".join(rows) + "\n")
    col = _collator(tmp_path, tdata, get_tokenizer, FeatureConfig(), device="cpu")
    calls = []
    real = native.batch_load_wav
    monkeypatch.setattr(native, "batch_load_wav", lambda *a, **k: calls.append(a) or real(*a, **k))
    fast = col(tdata.read_tsv_manifest(tmp_path / "m.tsv"))
    fast_audio = col._load_batch_audio(tdata.read_tsv_manifest(tmp_path / "m.tsv"))
    assert len(calls) == 2
    monkeypatch.setattr(native, "available", lambda: False)
    slow = col(tdata.read_tsv_manifest(tmp_path / "m.tsv"))
    slow_audio = col._load_batch_audio(tdata.read_tsv_manifest(tmp_path / "m.tsv"))
    assert len(calls) == 2
    for a, b in zip(fast_audio, slow_audio):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    for k in ("tokens", "tokens_lens", "features_lens"):
        np.testing.assert_array_equal(fast[k], slow[k])
    np.testing.assert_allclose(fast["features"].numpy(), slow["features"].numpy(), rtol=0,
                               atol=1e-6)
    jcol = _collator(tmp_path, jdata, jget_tokenizer, JFeatureConfig())
    for u, a in zip(jdata.read_tsv_manifest(tmp_path / "m.tsv"), fast_audio):
        np.testing.assert_allclose(a, jcol.load_audio(u), rtol=0, atol=1e-6)
    monkeypatch.undo()

    (tmp_path / "r.tsv").write_text(f"u1\tx\t{raw / 'u1.wav'}\nu2\ty\t{raw / 'u2.wav'}\n")
    utts = tdata.read_tsv_manifest(tmp_path / "r.tsv")
    calls.clear()
    monkeypatch.setattr(native, "batch_load_wav", lambda *a, **k: calls.append(a) or real(*a, **k))
    audio = col._load_batch_audio(utts)
    assert len(calls) == 1
    assert [len(a) for a in audio] == [-(-u.num_samples * 24000 // u.sample_rate) for u in utts]


def test_collator_segment_and_stereo_rows_take_load_audio(raw, tmp_path, monkeypatch):
    """A segment row, and the three-channel stereo collator, read file by
    file (the native loader reads whole files and downmixes)."""
    from zipvoice_tpu_torch.config import FeatureConfig
    from zipvoice_tpu_torch.data import dataset as tdata
    from zipvoice_tpu_torch.ops import native
    from zipvoice_tpu_torch.text.tokenizer import get_tokenizer

    monkeypatch.setattr(native, "batch_load_wav", lambda *a, **k: pytest.fail("native path"))
    (tmp_path / "s.tsv").write_text(f"u0\tx\t{raw / 'u0.wav'}\nu5\ty\t{raw / 'u4.wav'}\t0.2\t1.0\n")
    col = _collator(tmp_path, tdata, get_tokenizer, FeatureConfig(), device="cpu")
    audio = col._load_batch_audio(tdata.read_tsv_manifest(tmp_path / "s.tsv"))
    assert [len(a) for a in audio] == [36000, 19200]
    (tmp_path / "st.tsv").write_text(f"u3\tx\t{raw / 'u3.wav'}\n")
    col3 = _collator(tmp_path, tdata, get_tokenizer, FeatureConfig(), device="cpu",
                     three_channel=True)
    assert col3._load_batch_audio(tdata.read_tsv_manifest(tmp_path / "st.tsv"))[0].shape == \
        (2, int(1.4 * 24000))
