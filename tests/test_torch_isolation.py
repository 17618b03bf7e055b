"""The port stands alone: importing every module of zipvoice_tpu_torch and
chip_smoke.py pulls in neither JAX nor any zipvoice_tpu module (nor
transformers, which only building an evaluation model imports), and a CUDA
request on a machine without CUDA raises instead of running on the CPU."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import zipvoice_tpu_torch
names = ["chip_smoke"] + [m.name for m in pkgutil.walk_packages(
    zipvoice_tpu_torch.__path__, "zipvoice_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.") or m == "jaxlib"
                or m.startswith("jaxlib.") or m == "zipvoice_tpu"
                or m.startswith("zipvoice_tpu."))
# the evaluation models import transformers lazily, where a model is built
lazy = sorted(m for m in sys.modules if m == "transformers" or m.startswith("transformers."))
print(json.dumps({"imported": names, "leaked": leaked + lazy}))
"""


def test_port_imports_no_jax_and_no_jax_package():
    proc = subprocess.run([sys.executable, "-c", _PROBE, str(REPO)],
                          capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "zipvoice_tpu_torch.ops.attention" in res["imported"]
    assert "zipvoice_tpu_torch.bin.infer_zipvoice" in res["imported"]
    for name in ("bin.train_zipvoice", "train.trainer", "train.scaled_adam",
                 "train.checkpoint", "train.schedules", "data.dataset", "data.prefetch",
                 "nn.regularizers", "ops.melspec", "ops.convglu", "utils.tb_writer",
                 "serve.server", "bin.serve", "utils.memo", "utils.graphs",
                 "text.tokenizer", "text.normalizer", "text.numbers", "text.espeak_map",
                 "text.en_g2p", "text.pinyin_data", "text.zh", "text.spm",
                 "models.distill", "models.dialog", "bin.infer_zipvoice_dialog",
                 "audio.bigvgan", "train.distill_step", "bin.train_zipvoice_distill",
                 "bin.train_zipvoice_dialog", "bin.train_zipvoice_dialog_stereo",
                 "bin.generate_averaged_model", "parallel.mesh", "utils.diagnostics",
                 "utils.hooks", "train.dryrun", "ops.quant", "bin.export_model",
                 "bin.infer_exported", "utils.flops", "eval.metrics", "ops.native",
                 "bin.prepare_dataset", "bin.prepare_tokens", "bin.make_tokens",
                 "bin.compute_fbank", "eval.models.utmos", "eval.models.ecapa_tdnn_wavlm",
                 "eval.mos", "eval.sim", "eval.cpsim", "eval.wer"):
        assert f"zipvoice_tpu_torch.{name}" in res["imported"]
    assert res["leaked"] == []


def test_cuda_request_without_cuda_raises():
    from zipvoice_tpu_torch.utils.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_pipeline_defaults_to_cuda():
    """The pipeline's default device is the card: without one it raises."""
    from zipvoice_tpu_torch.config import FeatureConfig, ZipVoiceConfig
    from zipvoice_tpu_torch.models.pipeline import ZipVoicePipeline
    from zipvoice_tpu_torch.models.zipvoice import ZipVoiceModel

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with torch.device("meta"):
        model = ZipVoiceModel(ZipVoiceConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ZipVoicePipeline(model=model, model_cfg=ZipVoiceConfig(),
                         feat_cfg=FeatureConfig())


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
