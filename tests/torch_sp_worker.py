"""One rank of tests/test_torch_sequence_parallel.py, started by
``zipvoice_tpu_torch.train.dryrun.spawn`` (imports torch and the port
only): ``sp_sample`` over a seq mesh of every rank on the full inputs,
with the collectives counted and the (Tq, Tk) of every entry into B1's and
B2's plain versions recorded; rank 0 saves the output."""

import json
from pathlib import Path

import numpy as np
import torch


def run(cfg: str, model_path: str, inputs_path: str, out: str, tag: str, kw: dict):
    from zipvoice_tpu_torch.config import ZipVoiceConfig
    from zipvoice_tpu_torch.io.checkpoint import load_into
    from zipvoice_tpu_torch.models import zipvoice as tzv
    from zipvoice_tpu_torch.ops import attention as ta
    from zipvoice_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    mesh.init_from_env("cpu", backend="gloo")
    cfg = ZipVoiceConfig(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in json.loads(cfg).items()})
    with torch.device("meta"):
        model = tzv.ZipVoiceModel(cfg)
    model = load_into(model, torch.load(model_path))
    x = {k: torch.from_numpy(v) for k, v in np.load(inputs_path).items()}
    entries = {"B1": [], "B2": []}
    probs_plain, apply_plain = ta.rel_attention_probs_plain, ta.rel_attention_probs_apply_plain

    def b1(q, k, *a, **kw_):
        entries["B1"].append((q.shape[1], k.shape[1]))
        return probs_plain(q, k, *a, **kw_)

    def b2(probs, v):
        entries["B2"].append(tuple(probs.shape[2:]))
        return apply_plain(probs, v)

    ta.rel_attention_probs_plain, ta.rel_attention_probs_apply_plain = b1, b2
    seq = mesh.make_seq_mesh()
    mesh.reset_counts()
    y = tzv.sp_sample(model, seq, x["tokens"], x["tokens_lens"], x["prompt_features"],
                      x["prompt_features_lens"], x["features_lens"], x["noise"], **kw)
    res = {"counts": dict(mesh.COUNTS), "entries": entries, "out": y}
    torch.save(res, Path(out) / f"{tag}-{mesh.rank()}.pt")
    mesh.shutdown()
