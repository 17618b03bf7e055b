"""Training checkpoints: save / load / resume, the running model average,
averaging two checkpoints, and keep-last-k pruning.

A checkpoint is a ``torch.save`` dict: ``"model"`` is the module's
state_dict under the published names (so the file serves as a model dir's
``model.pt``), ``"model_avg"`` the running average in float64,
``"model_ema"`` the distillation's EMA teacher (a state_dict; stage two
only), ``"opt_state"`` the optimizer state, ``"sampler"`` the data
sampler's resume state, and the bookkeeping scalars (batch_idx_train, epoch, ...) sit
at the top level.
"""

from __future__ import annotations

import glob
import logging
import os
import re
from typing import Any, Dict, List, Optional

import torch
from torch import nn


def _cpu(sd: Dict[str, torch.Tensor], dtype=None) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", dtype=dtype or v.dtype).clone() for k, v in sd.items()}


def save_checkpoint(filename: str, model: nn.Module,
                    model_avg: Optional[Dict[str, torch.Tensor]] = None,
                    opt_state: Any = None, sampler_state: Any = None,
                    info: Optional[Dict] = None,
                    model_ema: Optional[Dict[str, torch.Tensor]] = None):
    """Write atomically (a temporary file, then a rename).  ``model`` is a
    module or a state_dict."""
    sd = model.state_dict() if isinstance(model, nn.Module) else model
    ckpt: Dict[str, Any] = {"model": _cpu(sd)}
    if model_avg is not None:
        ckpt["model_avg"] = _cpu(model_avg, torch.float64)
    if model_ema is not None:
        ckpt["model_ema"] = _cpu(model_ema)
    if opt_state is not None:
        ckpt["opt_state"] = opt_state
    if sampler_state is not None:
        ckpt["sampler"] = sampler_state
    ckpt.update(info or {})
    tmp = f"{filename}.tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, filename)


def load_checkpoint(filename: str) -> Dict[str, Any]:
    """-> {"model": state_dict, "model_avg": f64 state_dict or None,
    "model_ema": state_dict or None, "opt_state", "sampler", "info": the
    remaining top-level entries}.  The average keeps its saved dtype
    (float64)."""
    ckpt = torch.load(filename, map_location="cpu", weights_only=False)
    out = {
        "model": ckpt.pop("model"),
        "model_avg": ckpt.pop("model_avg", None),
        "model_ema": ckpt.pop("model_ema", None),
        "opt_state": ckpt.pop("opt_state", None),
        "sampler": ckpt.pop("sampler", None),
    }
    out["info"] = ckpt
    return out


def init_averaged_model(model: nn.Module) -> Dict[str, torch.Tensor]:
    """A float64 copy of the module's state on the host."""
    return _cpu(model.state_dict(), torch.float64)


@torch.no_grad()
def update_averaged_model(model_avg: Dict[str, torch.Tensor], model: nn.Module,
                          batch_idx_train: int, average_period: int) -> None:
    """avg <- cur * (period / batch) + avg * (1 - period / batch), in float64,
    in place."""
    w_cur = average_period / batch_idx_train
    for k, v in model.state_dict().items():
        avg = model_avg[k]
        avg.mul_(1.0 - w_cur).add_(v.detach().to("cpu", torch.float64) * w_cur)


def average_checkpoints_with_averaged_model(filename_start: str,
                                            filename_end: str) -> Dict[str, torch.Tensor]:
    """The average over batches (start, end] from the two running averages:
    (avg_end * end - avg_start * start) / (end - start), computed without
    overflow.  Returns a float32 state_dict.  Checkpoints written without a
    running average (by other tools) give the plain mean of the two
    checkpoints' ``model`` weights, with a warning."""
    cs = torch.load(filename_start, map_location="cpu", weights_only=False)
    ce = torch.load(filename_end, map_location="cpu", weights_only=False)
    if "model_avg" not in cs or "model_avg" not in ce:
        logging.warning(
            "model_avg missing in %s / %s; falling back to the plain mean of "
            "the two checkpoints' raw weights (NOT the running-average "
            "differencing recipe)", filename_start, filename_end,
        )
        return {k: ((v.double() + cs["model"][k].double()) / 2.0).float()
                for k, v in ce["model"].items()}
    period = cs["average_period"]
    b_start = (cs["batch_idx_train"] // period) * period
    b_end = (ce["batch_idx_train"] // period) * period
    interval = b_end - b_start
    if interval <= 0:
        raise ValueError(f"checkpoints out of order: {b_start} -> {b_end}")
    weight_end = b_end / interval
    weight_start = 1.0 - weight_end
    return {
        k: ((v_end.double() + cs["model_avg"][k].double() * (weight_start / weight_end))
            * weight_end).float()
        for k, v_end in ce["model_avg"].items()
    }


def find_checkpoints(out_dir: str, iteration: int = 0) -> List[str]:
    """checkpoint-*.pt sorted by batch index, newest first.  iteration > 0
    keeps those >= iteration; < 0 those <= -iteration."""
    pattern = re.compile(r"checkpoint-(\d+).pt$")
    found = []
    for f in glob.glob(os.path.join(out_dir, "checkpoint-*.pt")):
        m = pattern.search(f)
        if m:
            found.append((int(m.group(1)), f))
    if iteration > 0:
        found = [x for x in found if x[0] >= iteration]
    elif iteration < 0:
        found = [x for x in found if x[0] <= -iteration]
    return [f for _, f in sorted(found, reverse=True)]


def remove_checkpoints(out_dir: str, topk: int):
    if topk < 1:
        raise ValueError(f"keep at least one checkpoint, got {topk}")
    for f in find_checkpoints(out_dir)[topk:]:
        os.remove(f)
