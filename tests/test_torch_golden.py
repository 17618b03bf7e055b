"""The port's golden acceptance (``eval/golden.py``, ``bin/golden_acceptance.py``)
against the JAX package's on the CPU: on tiny model dirs written by the JAX
package (its init and ``params_to_state_dict``), the tree and tokenizer
reports of all four variants equal JAX's key for key, and so do the reports
on broken checkpoints, the battery's red cases, the parity gate (a model
with no dir fetched through an offline, empty hub cache), GOLDEN.json and
the dry run.  At full width (``ZipVoiceConfig()``, 123M) the port's
meta-device module tree equals JAX's parameter tree, name and shape, for
every variant."""

import functools
import json
import os
import sys

import numpy as np
import pytest

import jax
import torch

import zipvoice_tpu.text.en_g2p as jen_g2p
import zipvoice_tpu.text.tokenizer as jtok
from zipvoice_tpu.bin import golden_acceptance as jcli
from zipvoice_tpu.config import ZipVoiceConfig as JConfig
from zipvoice_tpu.eval import golden as jgolden
from zipvoice_tpu.io.checkpoint import params_to_state_dict
from zipvoice_tpu.models.dialog import init_zipvoice_dialog, init_zipvoice_dialog_stereo
from zipvoice_tpu.models.distill import init_zipvoice_distill
from zipvoice_tpu.models.zipvoice import init_zipvoice
import zipvoice_tpu_torch.text.en_g2p as ten_g2p
import zipvoice_tpu_torch.text.tokenizer as ttok
from zipvoice_tpu_torch.bin import golden_acceptance as tcli
from zipvoice_tpu_torch.config import ZipVoiceConfig
from zipvoice_tpu_torch.eval import golden
from zipvoice_tpu_torch.io.model_dir import build_model

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
SPK_A, SPK_B = 28, 29
VARIANTS = ["zipvoice", "zipvoice_distill", "zipvoice_dialog", "zipvoice_dialog_stereo"]
JAX_INIT = {"zipvoice": init_zipvoice, "zipvoice_distill": init_zipvoice_distill,
            "zipvoice_dialog": init_zipvoice_dialog,
            "zipvoice_dialog_stereo": init_zipvoice_dialog_stereo}
DW = "fm_decoder.encoders.0.layers.0.conv_module1.depthwise_conv.weight"


def _tokens():
    tokens = {"_": 0, " ": 1}
    for i, ch in enumerate("abcdefghijklmnopqrstuvwxyz"):
        tokens[ch] = i + 2
    tokens["[S1]"] = SPK_A
    tokens["[S2]"] = SPK_B
    return tokens


def _write_dir(d, sd, name="model.pt", wrap=True):
    """A model dir of the tiny config holding the state dict ``sd``."""
    d.mkdir()
    ttok.write_token_file(_tokens(), str(d / "tokens.txt"))
    model_json = {"model": {k: list(v) if isinstance(v, tuple) else v for k, v in TINY.items()},
                  "feature": {"sampling_rate": 24000, "type": "vocos", "n_mels": 20}}
    (d / "model.json").write_text(json.dumps(model_json))
    if name.endswith(".safetensors"):
        from safetensors.numpy import save_file

        save_file({k: np.array(v) for k, v in sd.items()}, str(d / name))
    else:
        tsd = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
        torch.save({"model": tsd} if wrap else tsd, d / name)
    return d


@pytest.fixture(scope="module")
def state_dicts():
    """Each variant's tiny JAX init as a torch-layout numpy state dict."""
    cfg = JConfig(**TINY, vocab_size=len(_tokens()), pad_id=0)
    return {name: {k: np.asarray(v) for k, v in
                   params_to_state_dict(JAX_INIT[name](jax.random.PRNGKey(0), cfg)).items()}
            for name in VARIANTS}


@pytest.fixture(scope="module")
def dirs(state_dicts, tmp_path_factory):
    root = tmp_path_factory.mktemp("golden")
    return {name: _write_dir(root / name, sd) for name, sd in state_dicts.items()}


@pytest.mark.parametrize("variant", VARIANTS)
def test_reports_equal_jax(dirs, variant):
    """Clean dirs: the tree and tokenizer reports equal JAX's, and pass."""
    d = str(dirs[variant])
    tree = golden.check_tree(variant, d, "cpu")
    assert tree == jgolden.check_tree(variant, d)
    assert tree["status"] == "pass" and tree["n_tensors"] > 100, tree
    tok = golden.check_tokenizer(variant, d)
    assert tok == jgolden.check_tokenizer(variant, d)
    assert tok["status"] == "pass", tok["sub"]
    n_dialog = len(golden.DIALOG_BATTERY) if "dialog" in variant else 0
    assert tok["battery_checked"] == len(golden.SENTENCE_BATTERY) + n_dialog
    assert tok["en_g2p_backend"] == tok["en_g2p_pinned_with"] == "offline-fallback"
    if "dialog" in variant:
        assert tok["spk_ids"] == [SPK_A, SPK_B]


def _dropped(sd):
    sd = dict(sd)
    del sd["fm_decoder.out_proj.bias"]
    return sd


def _misshaped(sd):
    sd = dict(sd)
    w = sd["fm_decoder.out_proj.weight"]
    sd["fm_decoder.out_proj.weight"] = np.zeros((w.shape[0] + 1, w.shape[1]), w.dtype)
    return sd


def _depthwise_2d(sd):
    return {**sd, DW: sd[DW][:, 0, :]}


# (checked as, the dir's variant, state-dict edit, written as, expectation)
BROKEN = {
    "wrong_variant": ("zipvoice_dialog", "zipvoice", None, {}, "equal"),
    "extra_key": ("zipvoice", "zipvoice",
                  lambda sd: {**sd, "extra.weight": np.ones((3, 4), np.float32)}, {}, "equal"),
    "missing_key": ("zipvoice", "zipvoice", _dropped, {}, "equal"),
    "misshaped": ("zipvoice", "zipvoice", _misshaped, {}, "equal"),
    "module_prefix": ("zipvoice_distill", "zipvoice_distill",
                      lambda sd: {f"module.{k}": v for k, v in sd.items()}, {}, "equal"),
    # the prefix stripped, the later of two equal names is kept
    "module_duplicate": ("zipvoice", "zipvoice",
                         lambda sd: {**sd, "module.embed.weight": np.ones((2, 2), np.float32)},
                         {}, "equal"),
    # JAX's round trip drops a leading dot: reported as the extra "scale"
    "leading_dot": ("zipvoice", "zipvoice",
                    lambda sd: {**sd, ".scale": np.ones((), np.float32)}, {}, "equal"),
    "bare_state_dict": ("zipvoice_dialog_stereo", "zipvoice_dialog_stereo", None,
                        {"wrap": False}, "equal"),
    "safetensors": ("zipvoice_dialog", "zipvoice_dialog", None,
                    {"name": "model.safetensors"}, "equal"),
    # JAX refuses a depthwise weight whose middle axis is not 1, and a name
    # under a tensor's name; so does the port
    "depthwise_middle_axis": ("zipvoice", "zipvoice",
                              lambda sd: {**sd, DW: np.repeat(sd[DW], 2, axis=1)}, {}, "raise"),
    "prefix_collision": ("zipvoice", "zipvoice",
                         lambda sd: {**sd, "embed.weight.extra": np.ones((), np.float32)},
                         {}, "raise"),
    # a 2-D (C, K) depthwise weight: JAX's round trip reads it as (C, 1, K)
    # and passes; so does the port's checkpoint reading
    "depthwise_2d": ("zipvoice", "zipvoice", _depthwise_2d, {}, "equal"),
}


@pytest.mark.parametrize("case", list(BROKEN))
def test_broken_checkpoint_reports_equal_jax(state_dicts, dirs, tmp_path, case):
    name, source, edit, how, expect = BROKEN[case]
    d = str(dirs[source]) if edit is None and not how else str(
        _write_dir(tmp_path / case, (edit or dict)(state_dicts[source]), **how))
    if expect == "raise":
        with pytest.raises((AssertionError, IndexError)):
            jgolden.check_tree(name, d)
        with pytest.raises(ValueError):
            golden.check_tree(name, d, "cpu")
        return
    ref = jgolden.check_tree(name, d)
    ours = golden.check_tree(name, d, "cpu")
    assert ours == ref
    if case == "wrong_variant":
        assert ours["status"] == "fail"
        assert any("spk_embed" in k for k in ours["missing"]), ours
    elif case in ("module_prefix", "bare_state_dict", "safetensors", "depthwise_2d"):
        assert ours["status"] == "pass"
        assert ours["n_tensors"] == len(state_dicts[source])
    else:
        assert ours["status"] == "fail"
        assert ours["n_tensors"] == len(state_dicts[source]) + (case in ("extra_key",
                                                                         "leading_dot")) - (
            case == "missing_key")
    if case == "leading_dot":
        assert ours["extra"] == ["scale"]
    if case == "module_duplicate":
        assert ours["shape_mismatch"] == ["embed.weight"]


def test_depthwise_2d_loads_and_passes_cli(state_dicts, dirs, tmp_path):
    """A checkpoint whose depthwise conv weight is 2-D (C, K): the port's
    ``load_model_dir`` loads it into the weights of the 3-D one, whose
    depthwise conv computes the same output bit for bit, and the golden CLI
    writes GOLDEN.json with the tree ``pass`` (exit 0), as JAX's does."""
    from zipvoice_tpu_torch.io.model_dir import load_model_dir

    d = _write_dir(tmp_path / "dw2d", _depthwise_2d(state_dicts["zipvoice"]))
    flat = load_model_dir(str(d), tokenizer_name="simple").model
    ref = load_model_dir(str(dirs["zipvoice"]), tokenizer_name="simple").model
    for k, v in ref.state_dict().items():
        assert torch.equal(flat.state_dict()[k], v), k
    conv = DW.rsplit(".", 1)[0]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, TINY["fm_decoder_dim"], 13)).astype(np.float32))
    with torch.no_grad():
        got, want = flat.get_submodule(conv)(x), ref.get_submodule(conv)(x)
    assert torch.equal(got, want)
    out = tmp_path / "golden.json"
    assert tcli.main(["--models", "zipvoice", "--model-dirs", str(d), "--reference-path",
                      str(tmp_path / "no-reference"), "--output", str(out),
                      "--device", "cpu"]) == 0
    tree = json.loads(out.read_text())["reports"][0]["checks"][0]
    assert tree["check"] == "tree" and tree["status"] == "pass", tree


def _patch_en_regression(mp, tok_mod, en_mod):
    real = en_mod.fallback_phonemize_clause
    mp.setattr(en_mod, "fallback_phonemize_clause", lambda clause: "ʔʔ " + real(clause))


def _patch_zh_regression(mp, tok_mod, en_mod):
    real = tok_mod.split_pinyin
    mp.setattr(tok_mod, "split_pinyin", lambda py: ["xx0"] + real(py)[1:])


def _patch_crash(mp, tok_mod, en_mod):
    def boom(text):
        raise ValueError("tokenizer regression")

    mp.setattr(tok_mod, "hanzi_to_pinyin", boom)


def _patch_backend_mismatch(mp, tok_mod, en_mod):
    # a working engine other than the one the goldens were pinned with
    mp.setattr(tok_mod, "espeak_phonemize",
               lambda text, lang="en-us": ["ʔ"] + en_mod.fallback_phonemize(text))
    mp.setattr(tok_mod, "active_g2p_backend", lambda lang="en-us": "espeak-ng")


def _patch_swallowed_crash(mp, tok_mod, en_mod):
    # a broken engine: the tokenizer logs it and yields []
    def broken_engine(text, lang="en-us"):
        raise RuntimeError("espeak-ng subprocess died")

    mp.setattr(tok_mod, "espeak_phonemize", broken_engine)
    mp.setattr(tok_mod, "active_g2p_backend", lambda lang="en-us": "espeak-ng")


RED = {
    "en_regression": (_patch_en_regression, "fail"),
    "zh_regression": (_patch_zh_regression, "fail"),
    "crash": (_patch_crash, "fail"),
    "backend_mismatch": (_patch_backend_mismatch, "gated"),
    "swallowed_crash": (_patch_swallowed_crash, "fail"),
    "no_fixture": (None, "gated"),
}


@pytest.mark.parametrize("case", list(RED))
def test_battery_red_cases_equal_jax(dirs, tmp_path, monkeypatch, case):
    patch, status = RED[case]
    d = str(dirs["zipvoice"])
    fixture = None
    if case == "no_fixture":
        fixture = tmp_path / "empty_goldens.json"
        fixture.write_text(json.dumps({"emilia": {}, "dialog": {}}))
        fixture = str(fixture)
    reports = []
    for tok_mod, en_mod, check in ((jtok, jen_g2p, jgolden.check_tokenizer),
                                   (ttok, ten_g2p, golden.check_tokenizer)):
        with monkeypatch.context() as mp:
            if patch is not None:
                patch(mp, tok_mod, en_mod)
            reports.append(check("zipvoice", d, fixture))
    ref, ours = reports
    assert ours == ref
    assert ours["status"] == status, ours["sub"]
    if case == "backend_mismatch":
        assert "re-pin" in ours["sub"]["battery"]
    elif case == "swallowed_crash":
        assert "error: empty tokenization" in ours["battery_ids"].values()
    elif case == "no_fixture":
        assert ours["battery_checked"] == 0
    else:
        assert ours["battery_failed"]


def test_golden_acceptance_parity_gate(dirs, tmp_path, monkeypatch):
    """No reference: JAX's report, parity gated.  A reference path present
    without the reference package: both raise on its import.  No model dir:
    both ask the Hugging Face Hub's cache (offline and empty here), which
    raises its own error."""
    from huggingface_hub.errors import LocalEntryNotFoundError

    from tests import torch_hub_cache

    d = str(dirs["zipvoice_dialog"])
    absent = str(tmp_path / "no-reference")
    ours = golden.golden_acceptance("zipvoice_dialog", d, absent, device="cpu")
    assert ours == jgolden.golden_acceptance("zipvoice_dialog", d, absent)
    assert ours["checks"][-1] == {"check": "parity", "status": "gated: no reference"}
    assert [c["status"] for c in ours["checks"][:2]] == ["pass", "pass"]
    assert ours["status"] == "gated"
    present = tmp_path / "reference"
    present.mkdir()
    for fn, kw in ((golden.golden_acceptance, {"device": "cpu"}),
                   (jgolden.golden_acceptance, {})):
        with pytest.raises(ModuleNotFoundError, match="zipvoice"):
            fn("zipvoice_dialog", d, str(present), **kw)
    torch_hub_cache.offline(monkeypatch, tmp_path / "empty-hub")
    for fn, kw in ((golden.golden_acceptance, {"device": "cpu"}),
                   (jgolden.golden_acceptance, {})):
        with pytest.raises(LocalEntryNotFoundError) as e:
            fn("zipvoice", None, absent, **kw)
        assert torch_hub_cache.offline_miss(e.value, "k2-fsa/ZipVoice")
    if not torch.cuda.is_available():  # the card by default: without one it raises
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            golden.golden_acceptance("zipvoice", d, absent)


def _jax_cli(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["golden_acceptance"] + argv)
    with pytest.raises(SystemExit) as e:
        jcli.main()
    return e.value.code


@pytest.mark.parametrize("name,code", [("zipvoice", 0), ("zipvoice_dialog", 1)])
def test_cli_golden_json_equals_jax(dirs, tmp_path, monkeypatch, name, code):
    """GOLDEN.json in JAX's schema; exit 0 on a clean dir, 1 on a base
    checkpoint checked as dialog (tree fail, spk_embed missing)."""
    args = ["--models", name, "--model-dirs", str(dirs["zipvoice"]),
            "--reference-path", str(tmp_path / "no-reference")]
    assert tcli.main(args + ["--output", str(tmp_path / "ours.json"), "--device", "cpu"]) == code
    assert _jax_cli(monkeypatch, args + ["--output", str(tmp_path / "ref.json")]) == code
    ours = json.loads((tmp_path / "ours.json").read_text())
    assert ours == json.loads((tmp_path / "ref.json").read_text())
    assert ours["overall"] == ("pass" if code == 0 else "fail")
    tree = ours["reports"][0]["checks"][0]
    assert tree["status"] == ("pass" if code == 0 else "fail")
    if code:
        assert any("spk_embed" in k for k in tree["missing"])


@pytest.mark.parametrize("case", ["ready", "missing_file", "not_given", "reference_present"])
def test_cli_dry_run(dirs, tmp_path, monkeypatch, capsys, case):
    """ready for complete dirs, a model with no dir (fetched from the hub:
    its hf:// source, the hub importable) and a reference present;
    not-ready for a missing file.  Each equal to JAX's report but its
    invocation."""
    d = {name: str(p) for name, p in dirs.items()}
    if case == "missing_file":
        broken = tmp_path / "broken"
        broken.mkdir()
        (broken / "model.json").write_text((dirs["zipvoice"] / "model.json").read_text())
        d["zipvoice_distill"] = str(broken)
    elif case == "not_given":
        d["zipvoice_dialog"] = ""
    ref_path = tmp_path / "reference"
    if case == "reference_present":
        ref_path.mkdir()
    args = ["--models", "all", "--model-dirs", ",".join(d[n] for n in VARIANTS),
            "--reference-path", str(ref_path), "--dry-run"]
    code = tcli.main(args)
    ours = json.loads(capsys.readouterr().out)
    assert code == (1 if case == "missing_file" else 0)
    assert ours["status"] == ("not-ready" if case == "missing_file" else "ready")
    assert "zipvoice_tpu_torch.bin.golden_acceptance" in ours["invocation"]
    assert _jax_cli(monkeypatch, args) == code
    ref = json.loads(capsys.readouterr().out)
    for key in ("mode", "models", "fixture", "reference", "status"):
        assert ours[key] == ref[key], key
    if case == "not_given":
        assert ours["models"]["zipvoice_dialog"] == {
            "files": {}, "hf_hub": "importable",
            "source": "hf://k2-fsa/ZipVoice/zipvoice_dialog/{model.pt,model.json,tokens.txt}"}
        assert "--model-dirs " + ",".join(d[n] for n in VARIANTS) in ours["invocation"]
    if case == "reference_present":
        assert ours["reference"] == "ok"
    if case == "missing_file":
        assert ours["models"]["zipvoice_distill"]["files"] == {
            "model.json": "ok", "tokens.txt": "MISSING", "model.pt|model.safetensors": "MISSING"}


@pytest.mark.parametrize("variant", VARIANTS)
def test_full_width_tree_equals_jax(variant):
    """At ZipVoiceConfig() (123M) the port's meta-device state_dict equals
    JAX's parameter tree through params_to_state_dict, name and shape (the
    JAX tree from jax.eval_shape, its leaves zero-copy broadcasts)."""
    vocab = 362  # the released emilia vocabulary with [S1]/[S2]
    shapes = jax.eval_shape(functools.partial(JAX_INIT[variant], cfg=JConfig(vocab_size=vocab)),
                            jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape),
                                    shapes)
    ref = {k: tuple(np.shape(v)) for k, v in params_to_state_dict(leaves).items()}
    ours = {k: tuple(v.shape)
            for k, v in build_model(variant, ZipVoiceConfig(vocab_size=vocab)).state_dict().items()}
    assert ours == ref
    assert 120e6 < sum(int(np.prod(s)) for s in ours.values()) < 125e6
