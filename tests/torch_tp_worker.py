"""Ranks of tests/test_torch_tensor_parallel.py, started by
``zipvoice_tpu_torch.train.dryrun.spawn`` (imports torch and the port
only).

``pinned``: tensor parallelism over every rank (dp = 1): compute_fm_loss on
the whole batch with the condition mask, noise and t pinned (no
regularizers), the gradients synced, then ScaledAdam updates on those
gradients; then, from the initial weights again, 3 steps through
``make_train_step(mesh=...)`` with the regularizers on.  It saves the
gathered gradients, the loss, the gathered parameters after the updates,
the diagnostics, each step's gathered parameters before it, its gathered
synced gradient and loss, the local feedforward shapes and the collective
counts of a step.

``step``: one f32 step on a data x model mesh of the world (n_model
given), each data row on its own rows of the batch; saves this rank's
shards, the gathered parameters and the gathered synced gradient."""

import json
from pathlib import Path

import numpy as np
import torch


def _model(cfg, model_path: str, m):
    """The saved weights, sharded over the model axis of mesh m."""
    from zipvoice_tpu_torch.io.checkpoint import load_into
    from zipvoice_tpu_torch.models import zipvoice as tzv
    from zipvoice_tpu_torch.parallel import mesh

    with torch.device("meta"):
        model = tzv.ZipVoiceModel(cfg)
    model = load_into(model, torch.load(model_path))
    return mesh.shard_module(model, mesh.tp_param_shardings(model), m)


def _setup(cfg: str):
    from zipvoice_tpu_torch.config import ZipVoiceConfig
    from zipvoice_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    mesh.init_from_env("cpu", backend="gloo")
    return ZipVoiceConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in json.loads(cfg).items()})


def _gather_grads(model):
    """Every parameter's .grad at full shape (split ones gathered over the
    model group along their split dimension)."""
    import torch.distributed as dist

    out = {}
    for name, p in model.named_parameters():
        shard = getattr(p, "tp_shard", None)
        if shard is None:
            out[name] = p.grad.clone()
            continue
        parts = [torch.empty_like(p.grad) for _ in range(shard.size)]
        dist.all_gather(parts, p.grad.contiguous(), group=shard.group)
        out[name] = torch.cat(parts, dim=p.tp_dim)
    return out


def pinned(cfg: str, model_path: str, batch_path: str, out: str, lr: float, updates: int):
    from zipvoice_tpu_torch.models import zipvoice as tzv
    from zipvoice_tpu_torch.parallel import mesh
    from zipvoice_tpu_torch.train.scaled_adam import ScaledAdam
    from zipvoice_tpu_torch.train.schedules import zipvoice_schedules
    from zipvoice_tpu_torch.train.step import TrainConfig, make_train_step

    cfg = _setup(cfg)
    r = mesh.rank()
    tp = mesh.make_mesh(n_data=1, n_model=mesh.world_size())
    model = _model(cfg, model_path, tp)
    opt = ScaledAdam(model.named_parameters())
    g = {k: torch.from_numpy(v) for k, v in np.load(batch_path).items()}

    pinned_mask = tzv.condition_time_mask
    tzv.condition_time_mask = lambda *a, **k: g["cond"]
    mesh.reset_counts()
    try:
        with mesh.use_mesh(tp):
            loss = tzv.compute_fm_loss(model, g["tokens"], g["tokens_lens"], g["features"],
                                       g["features_lens"], g["noise"], g["t"], 0)
            loss.backward()
            (loss,) = mesh.all_reduce_gradients(opt.params, [loss.detach()])
    finally:
        tzv.condition_time_mask = pinned_mask
    loss_counts = dict(mesh.COUNTS)
    grads = _gather_grads(model)
    diags, synced = [], [p.grad.clone() for p in opt.params]
    for _ in range(updates):
        for p, s in zip(opt.params, synced):
            p.grad = s.clone()
        d = opt.step(lr)
        diags.append({"frac": float(d["grad_dominant_frac"]),
                      "name": opt.names[int(d["grad_dominant_idx"])]})
    updated = mesh.unshard_state_dict(model)

    model = _model(cfg, model_path, tp)
    step = make_train_step(model, ScaledAdam(model.named_parameters()),
                           TrainConfig(compute_dtype="float32"), mesh=tp)
    batch = {k: g[k].numpy() for k in ("tokens", "tokens_lens", "features", "features_lens")}
    scheds = zipvoice_schedules(1000.0, cfg)
    step_counts, steps = [], []
    for i in range(3):
        before = mesh.unshard_state_dict(model)
        mesh.reset_counts()
        step_loss = float(step(batch, 5 + i, i + 1, 0.0, scheds)["loss"])
        step_counts.append(dict(mesh.COUNTS))
        steps.append({"params": before, "grads": _gather_grads(model), "loss": step_loss})
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters() if hasattr(p, "tp_shard")}
    torch.save({"loss": float(loss), "grads": grads, "updated": updated, "diags": diags,
                "loss_counts": loss_counts, "step_counts": step_counts, "steps": steps,
                "trained": mesh.unshard_state_dict(model), "shapes": shapes,
                "n_ff": sum(1 for m in model.modules() if hasattr(m, "tp_shard"))},
               Path(out) / f"pinned-{r}.pt")
    mesh.shutdown()


def step(cfg: str, model_path: str, batch_path: str, out: str, n_model: int, tag: str,
         regularizers: bool):
    from zipvoice_tpu_torch.parallel import mesh
    from zipvoice_tpu_torch.train.scaled_adam import ScaledAdam
    from zipvoice_tpu_torch.train.schedules import zipvoice_schedules
    from zipvoice_tpu_torch.train.step import TrainConfig, make_train_step

    cfg = _setup(cfg)
    r = mesh.rank()
    m = mesh.make_mesh(n_model=n_model)
    model = _model(cfg, model_path, m)
    g = np.load(batch_path)
    n_data, d = m.size("data"), m.index["data"]
    b = g["tokens"].shape[0] // n_data
    batch = {k: np.ascontiguousarray(g[k][d * b:(d + 1) * b])
             for k in ("tokens", "tokens_lens", "features", "features_lens")}
    step = make_train_step(model, ScaledAdam(model.named_parameters()),
                           TrainConfig(compute_dtype="float32"), mesh=m)
    scheds = zipvoice_schedules(1000.0, cfg) if regularizers else None
    loss = float(step(batch, 9, 1, 0.0, scheds)["loss"])
    torch.save({"loss": loss, "index": dict(m.index), "grads": _gather_grads(model),
                "shards": {k: v.detach().clone() for k, v in model.state_dict().items()},
                "full": mesh.unshard_state_dict(model)},
               Path(out) / f"{tag}-{r}.pt")
    mesh.shutdown()
