"""Mel parity (``eval/parity.py``) on the CPU at the JAX package's tiny
parity config (tests/test_eval.py): the port's ``run_parity`` against the
reference stand-in (``tests/torch_reference_standin``) meets the budgets
for all four variants, f32 < 1e-3 and bf16 < 1e-2 and above f32; the JAX
package's ``run_parity``, pointed at the same stand-in, is < 1e-3 for the
base and the stereo dialog variant, which holds the stand-in to the API the
reference offers; golden acceptance with the stand-in as its reference
reports parity ``pass`` in JAX's schema; the CLI's exit code."""

import json
import os

import pytest
import torch

from tests.torch_reference_standin import PATH as STANDIN, unload
from zipvoice_tpu.eval import parity as jparity
from zipvoice_tpu_torch.config import ZipVoiceConfig
from zipvoice_tpu_torch.eval import golden, parity
from zipvoice_tpu_torch.models.dialog import init_zipvoice_dialog
from zipvoice_tpu_torch.models.distill import init_zipvoice_distill
from zipvoice_tpu_torch.models.zipvoice import init_zipvoice
from zipvoice_tpu_torch.text.tokenizer import write_token_file

# torch's CPU ops share one OpenMP pool a process; pytest-xdist runs a
# process a worker, and pools sized to every core oversubscribe the machine
# by the worker count, which slows torch's ops by orders of magnitude
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

# tests/test_eval.py's tiny parity config
TINY = dict(
    fm_decoder_downsampling_factor=[1, 2, 1],
    fm_decoder_num_layers=[1, 1, 1],
    fm_decoder_cnn_module_kernel=[9, 7, 9],
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
    feat_dim=20,
)
VOCAB = 40
# the tiny vocabulary's speaker-turn tokens: ids that exist in it
SPK_A, SPK_B = 38, 39
VARIANTS = ["zipvoice", "zipvoice_distill", "zipvoice_dialog", "zipvoice_dialog_stereo"]
INIT = {"zipvoice": init_zipvoice, "zipvoice_distill": init_zipvoice_distill,
        "zipvoice_dialog": lambda cfg, g: init_zipvoice_dialog(cfg, False, g),
        "zipvoice_dialog_stereo": lambda cfg, g: init_zipvoice_dialog(cfg, True, g)}
SHAPE = dict(num_step=4, seconds=1.5, prompt_seconds=0.5)


def _spk(variant):
    return dict(spk_a_id=SPK_A, spk_b_id=SPK_B) if "dialog" in variant else {}


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """A tiny model dir a variant: seeded random weights (the JAX init's
    statistics), tokens tk1..tk37 plus [S1] / [S2]."""
    root = tmp_path_factory.mktemp("parity")
    token2id = {"_": 0, **{f"tk{i}": i for i in range(1, SPK_A)}, "[S1]": SPK_A, "[S2]": SPK_B}
    cfg = ZipVoiceConfig(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in TINY.items()}, vocab_size=VOCAB, pad_id=0)
    out = {}
    for name in VARIANTS:
        d = root / name
        d.mkdir()
        write_token_file(token2id, str(d / "tokens.txt"))
        (d / "model.json").write_text(json.dumps(
            {"model": TINY, "feature": {"sampling_rate": 24000, "type": "vocos",
                                        "n_mels": 20}}))
        model = INIT[name](cfg, torch.Generator().manual_seed(0))
        torch.save({"model": model.state_dict()}, d / "model.pt")
        out[name] = d
    return out


@pytest.fixture(autouse=True)
def standin():
    """The stand-in's ``zipvoice`` modules leave sys.modules after each test."""
    yield
    unload()


@pytest.mark.parametrize("variant", VARIANTS)
def test_port_parity_meets_budgets(dirs, variant):
    kw = dict(SHAPE, model_name=variant, device="cpu", **_spk(variant))
    mse = parity.run_parity(str(dirs[variant]), STANDIN, **kw)
    assert mse < parity.BUDGETS["float32"], mse
    mse_bf16 = parity.run_parity(str(dirs[variant]), STANDIN, dtype="bfloat16", **kw)
    assert mse_bf16 < parity.BUDGETS["bfloat16"], mse_bf16
    assert mse_bf16 > mse  # bf16 really ran in bf16


@pytest.mark.parametrize("variant", ["zipvoice", "zipvoice_dialog_stereo"])
def test_jax_parity_against_standin(dirs, variant):
    """The JAX package's harness, written against the real reference, runs
    on the stand-in and finds it within the f32 budget."""
    mse = jparity.run_parity(str(dirs[variant]), str(STANDIN), model_name=variant,
                             **SHAPE, **_spk(variant))
    assert mse < 1e-3, mse


def test_golden_acceptance_parity_pass(dirs):
    """A reference present: parity runs at the variant's defaults and
    reports ``pass`` in JAX's schema (sub.{float32,bfloat16}.{mel_mse,
    budget,status})."""
    rep = golden.golden_acceptance("zipvoice_dialog", str(dirs["zipvoice_dialog"]),
                                   STANDIN, seconds=1.5, device="cpu")
    par = rep["checks"][-1]
    assert par["check"] == "parity" and par["status"] == "pass", par
    assert set(par["sub"]) == {"float32", "bfloat16"}
    for dt, sub in par["sub"].items():
        assert set(sub) == {"mel_mse", "budget", "status"}
        assert sub["budget"] == parity.BUDGETS[dt] and sub["status"] == "pass"
        assert 0.0 <= sub["mel_mse"] < sub["budget"]
    assert rep["checks"][0]["status"] == "pass"


def test_cli_exit_code(dirs, capsys):
    argv = ["--model-dir", str(dirs["zipvoice"]), "--reference-path", str(STANDIN),
            "--num-step", "2", "--seconds", "1.5", "--prompt-seconds", "0.5",
            "--device", "cpu"]
    assert parity.main(argv) == 0
    out = capsys.readouterr().out.splitlines()
    assert [line.split("=")[0] for line in out] == ["mel_mse[zipvoice][float32]",
                                                    "mel_mse[zipvoice][bfloat16]"]
    assert all(line.endswith("PASS") for line in out)
    with pytest.raises(ValueError, match="prompt-seconds"):
        parity.main(argv[:-6] + ["--seconds", "1.0", "--prompt-seconds", "1.0",
                                 "--device", "cpu"])
