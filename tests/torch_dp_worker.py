"""One rank of tests/test_torch_distributed.py's data-parallel check,
started by ``zipvoice_tpu_torch.train.dryrun.spawn`` (imports torch and the
port only).

The rank takes its rows of a global batch, computes compute_fm_loss on
them with the condition mask pinned (no regularizers) and sums the
gradients over the ranks; then it trains 3 steps through the Trainer on
its rows with the regularizers and their real draws, its exp dir its own.
It saves the synced gradients, the global loss and the final parameters."""

import json
from pathlib import Path

import numpy as np
import torch


def run(cfg: str, model_path: str, batch_path: str, out: str, steps: int):
    from zipvoice_tpu_torch.config import ZipVoiceConfig
    from zipvoice_tpu_torch.io.checkpoint import load_into
    from zipvoice_tpu_torch.models import zipvoice as tzv
    from zipvoice_tpu_torch.parallel import mesh
    from zipvoice_tpu_torch.train.scaled_adam import ScaledAdam
    from zipvoice_tpu_torch.train.step import TrainConfig
    from zipvoice_tpu_torch.train.trainer import Trainer, TrainerOptions

    torch.set_num_threads(1)
    mesh.init_from_env("cpu", backend="gloo")
    r, n = mesh.rank(), mesh.world_size()
    cfg = ZipVoiceConfig(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in json.loads(cfg).items()})
    with torch.device("meta"):
        model = tzv.ZipVoiceModel(cfg)
    model = load_into(model, torch.load(model_path))
    mesh.broadcast_module(model)

    g = np.load(batch_path)
    b = g["tokens"].shape[0] // n
    local = {k: torch.from_numpy(np.ascontiguousarray(v[r * b:(r + 1) * b]))
             for k, v in g.items()}
    pinned = tzv.condition_time_mask
    tzv.condition_time_mask = lambda *a, **k: local["cond"]
    try:
        loss = tzv.compute_fm_loss(model, local["tokens"], local["tokens_lens"],
                                   local["features"], local["features_lens"],
                                   local["noise"], local["t"], 0)
    finally:
        tzv.condition_time_mask = pinned
    loss.backward()
    (total,) = mesh.all_reduce_gradients(list(model.parameters()), [loss.detach()])
    torch.save({"grads": {k: p.grad.clone() for k, p in model.named_parameters()},
                "loss": float(total), "local_loss": float(loss.detach())},
               Path(out) / f"grads-{r}.pt")
    model.zero_grad()

    trainer = Trainer(cfg, model, ScaledAdam(model.named_parameters()),
                      TrainConfig(compute_dtype="float32"),
                      TrainerOptions(exp_dir=str(Path(out) / f"exp-{r}"), save_every_n=1,
                                     log_interval=1, average_period=1))
    # host arrays, as the collator gives them
    batch = {k: local[k].numpy() for k in ("tokens", "tokens_lens", "features",
                                           "features_lens")}
    losses = [float(trainer.step_and_log(batch)["loss"]) for _ in range(steps)]
    torch.save({"params": {k: v.detach().clone() for k, v in model.state_dict().items()},
                "losses": losses, "seen_seconds": trainer.seen_seconds},
               Path(out) / f"params-{r}.pt")
    mesh.shutdown()
