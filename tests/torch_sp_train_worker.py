"""Ranks of tests/test_torch_sp_training.py, started by
``zipvoice_tpu_torch.train.dryrun.spawn`` (imports torch and the port
only).

``two``: a world of two ranks.  Sequence parallelism over both (dp = 1 x
sp = 2): compute_fm_loss with the condition mask, noise and t pinned (no
regularizers), the gradients synced; the same with the text encoder's
regularizers on and the fm_decoder's off; the stereo dialog loss with its
energy penalty, pinned the same way (``dialog_model``'s weights); 3
regularized f32 steps through
``make_train_step(mesh=make_dp_sp_mesh(1, 2))``; the pinned gradient and
the first regularized step again with both fused eval flags set, which
training ignores (``fused_flags``); then one f32 step
without the regularizers on a dp = 2 mesh (``make_dp_sp_mesh(2, 1)``), each
data rank on its half of the rows.

``four``: a world of four ranks.  sp = 4 (dp = 1), pinned as ``two``'s
first check; then one f32 step without the regularizers on dp = 2 x sp = 2
(``make_dp_sp_mesh(2, 2)``), each data row on its half of the rows.

Each saves its losses, synced gradients, parameters and collective counts."""

import json
from pathlib import Path

import numpy as np
import torch


def _setup(cfg: str, model_path: str):
    from zipvoice_tpu_torch.config import ZipVoiceConfig
    from zipvoice_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    mesh.init_from_env("cpu", backend="gloo")
    cfg = ZipVoiceConfig(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in json.loads(cfg).items()})
    return cfg, lambda: _model(cfg, model_path)


def _model(cfg, model_path: str):
    from zipvoice_tpu_torch.io.checkpoint import load_into
    from zipvoice_tpu_torch.models import zipvoice as tzv

    with torch.device("meta"):
        model = tzv.ZipVoiceModel(cfg)
    return load_into(model, torch.load(model_path))


def dialog_model(cfg):
    """The stereo dialog model the dialog check trains (seeded weights)."""
    from zipvoice_tpu_torch.models import dialog as tdialog

    return tdialog.init_zipvoice_dialog(cfg, stereo=True,
                                        generator=torch.Generator().manual_seed(3))


def dialog_loss(model, g, **kw):
    """The stereo dialog loss (energy penalty weight 1) on the pinned batch's
    2F-wide features and noise, the suffix mask pinned to its mask."""
    from zipvoice_tpu_torch.models import dialog as tdialog

    drawn = tdialog.condition_time_mask_suffix
    tdialog.condition_time_mask_suffix = lambda *a, **k: g["cond"]
    try:
        return tdialog.compute_fm_loss_dialog(
            model, g["tokens"], g["tokens_lens"], g["features2"], g["features_lens"],
            g["noise2"], g["t"], 0, se_weight=1.0, stereo=True, **kw)
    finally:
        tdialog.condition_time_mask_suffix = drawn


def _pinned(model, g, m, schedules=None, dialog=False):
    """compute_fm_loss (the stereo dialog loss if ``dialog``) on the whole
    batch under mesh m with the condition mask, noise and t pinned; the
    synced (loss, gradients, collectives)."""
    from zipvoice_tpu_torch.models import zipvoice as tzv
    from zipvoice_tpu_torch.parallel import mesh

    drawn = tzv.condition_time_mask
    tzv.condition_time_mask = lambda *a, **k: g["cond"]
    replicated = tzv.seq_replicated_params(model)
    params = list(model.parameters())
    mesh.reset_counts()
    try:
        with mesh.use_mesh(m):
            if dialog:
                loss = dialog_loss(model, g)
            else:
                loss = tzv.compute_fm_loss(model, g["tokens"], g["tokens_lens"], g["features"],
                                           g["features_lens"], g["noise"], g["t"], 0,
                                           schedules=schedules)
            loss.backward()
            (loss,) = mesh.all_reduce_gradients(params, [loss.detach()], replicated)
    finally:
        tzv.condition_time_mask = drawn
    return {"loss": float(loss), "counts": dict(mesh.COUNTS),
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()}}


def _step(model, m, batch, seed, schedules=None):
    """One f32 make_train_step step under mesh m; (loss, parameters after)."""
    from zipvoice_tpu_torch.train.scaled_adam import ScaledAdam
    from zipvoice_tpu_torch.train.step import TrainConfig, make_train_step

    step = make_train_step(model, ScaledAdam(model.named_parameters()),
                           TrainConfig(compute_dtype="float32"), mesh=m)
    loss = float(step(batch, seed, 1, 0.0, schedules)["loss"])
    return loss, {k: v.detach().clone() for k, v in model.state_dict().items()}


def _rows(g, m):
    """This rank's data row's rows of the batch, whole along T."""
    n, d = m.size("data"), m.index["data"]
    b = g["tokens"].shape[0] // n
    return {k: np.ascontiguousarray(g[k][d * b:(d + 1) * b].numpy())
            for k in ("tokens", "tokens_lens", "features", "features_lens")}


def two(cfg: str, model_path: str, batch_path: str, out: str):
    from zipvoice_tpu_torch.parallel import mesh
    from zipvoice_tpu_torch.train.scaled_adam import ScaledAdam
    from zipvoice_tpu_torch.train.schedules import zipvoice_schedules
    from zipvoice_tpu_torch.train.step import TrainConfig, make_train_step

    cfg, fresh = _setup(cfg, model_path)
    g = {k: torch.from_numpy(v) for k, v in np.load(batch_path).items()}
    sp = mesh.make_dp_sp_mesh(1, 2)
    res = {"pinned": _pinned(fresh(), g, sp)}
    scheds = zipvoice_schedules(1000.0, cfg)
    text_only = {"text_encoder": scheds["text_encoder"], "fm_decoder": None}
    res["text_regularized"] = _pinned(fresh(), g, sp, text_only)
    res["dialog"] = _pinned(dialog_model(cfg), g, sp, dialog=True)

    model = fresh()
    step = make_train_step(model, ScaledAdam(model.named_parameters()),
                           TrainConfig(compute_dtype="float32"), mesh=sp)
    batch = _rows(g, sp)
    res["steps"] = []
    for i in range(3):
        before = {k: v.detach().clone() for k, v in model.state_dict().items()}
        res["steps"].append({"params": before,
                             "loss": float(step(batch, 5 + i, i + 1, 0.0, scheds)["loss"])})
    res["trained"] = {k: v.detach().clone() for k, v in model.state_dict().items()}
    res["fused_flags"] = fused_flags(fresh, g, sp, batch, scheds)

    dp = mesh.make_dp_sp_mesh(2, 1)
    res["dp_loss"], res["dp_params"] = _step(fresh(), dp, _rows(g, dp), 9)
    torch.save(res, Path(out) / f"two-{mesh.rank()}.pt")
    mesh.shutdown()


def fused_flags(fresh, g, sp, batch, scheds):
    """``two``'s pinned gradient and its first regularized step (seed 5)
    with set_fused_eval and set_fused_conv on: (pinned, (loss, parameters
    after the step))."""
    from zipvoice_tpu_torch.nn import zipformer as tzf

    tzf.set_fused_eval(True)
    tzf.set_fused_conv(True)
    try:
        return {"pinned": _pinned(fresh(), g, sp), "step": _step(fresh(), sp, batch, 5, scheds)}
    finally:
        tzf.set_fused_eval(False)
        tzf.set_fused_conv(False)


def four(cfg: str, model_path: str, batch_path: str, out: str):
    from zipvoice_tpu_torch.parallel import mesh

    cfg, fresh = _setup(cfg, model_path)
    g = {k: torch.from_numpy(v) for k, v in np.load(batch_path).items()}
    res = {"pinned": _pinned(fresh(), g, mesh.make_dp_sp_mesh(1, 4))}
    m = mesh.make_dp_sp_mesh(2, 2)
    res["index"] = dict(m.index)
    res["dp_sp_loss"], res["dp_sp_params"] = _step(fresh(), m, _rows(g, m), 9)
    torch.save(res, Path(out) / f"four-{mesh.rank()}.pt")
    mesh.shutdown()
