"""The flow-matching training step and the validation step, on one device
a process.

Master weights stay f32 in the module; the forward runs in
``compute_dtype`` (every op casts the weights it uses), and t and the noise
are drawn in f32 before the compute dtype applies.  Randomness comes from a
per-step integer seed (the trainer derives it from its seed and the batch
index), so a step is reproducible; a rank draws its rows from its own fold
of it (``parallel/mesh.fold_rank``).  In a process group the loss is this
rank's share of the global-batch mean, and the gradients (with the loss
riding along) are summed over the ranks before the update, so every rank
applies the global batch's gradient and the metrics are global.

``make_train_step(..., mesh=make_mesh(n_data, n_model))`` runs the step
under a data x model mesh (``parallel/mesh.use_mesh``): the draws fold by
the data index, so the ranks of a model group draw the same rows' values,
and the loss normalizer and the gradient sum run over the data group
only.  With n_model > 1 the model must be sharded first
(``parallel/mesh.shard_module``), and the optimizer built on the shards.

``make_train_step(..., mesh=make_dp_sp_mesh(n_data, n_seq))`` trains
sequence-parallel, the JAX package's data x seq step: every rank of a seq
group passes its data row's whole rows (tokens, lengths, features at the
full T); t and the noise are drawn at the full T from the data index's
fold, and ``compute_fm_loss`` gives each rank its T / n_seq frames of the
fm_decoder.  The loss normalizer and the gradients are summed over data x
seq, the gradients of the token embedding and the text encoder (run whole
on every rank of a seq group) averaged over the seq group.  The dialog
losses (``models/dialog.compute_fm_loss_dialog``) split their frames the
same way.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import numpy as np
import torch

from zipvoice_tpu_torch.models.dialog import compute_fm_loss_dialog
from zipvoice_tpu_torch.models.zipvoice import (
    ZipVoiceModel,
    compute_fm_loss,
    seq_replicated_params,
)
from zipvoice_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_gradients,
    fold_rank,
    global_sum,
    use_mesh,
)
from zipvoice_tpu_torch.train.lr_schedule import eden_lr, fixed_lr
from zipvoice_tpu_torch.train.scaled_adam import ScaledAdam

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    base_lr: float = 0.02
    lr_batches: float = 7500.0
    lr_epochs: float = 10.0
    warmup_batches: float = 500.0
    condition_drop_ratio: float = 0.2
    compute_dtype: str = "bfloat16"  # "float32" | "bfloat16"
    schedule: str = "eden"  # "eden" | "fixed"
    # training-time stochastic regularizers (dropout, layerdrop, balancers,
    # whitening, ...); their schedule values are computed on the host per step
    use_regularizers: bool = True
    # the loss: "base" (interior-span condition mask) or "dialog" (suffix
    # mask + speaker embeddings); "dialog" with stereo=True adds the
    # both-speaking energy penalty weighted by se_weight
    loss: str = "base"
    stereo: bool = False
    se_weight: float = 0.0


def batch_to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """tokens / lengths (host numpy or tensors) and features on ``device``."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}


def _loss_fn(train_cfg: TrainConfig):
    """The loss of ``train_cfg.loss``, as compute_fm_loss's signature."""
    if train_cfg.loss == "base":
        return compute_fm_loss
    if train_cfg.loss != "dialog":
        raise ValueError(f"unknown loss {train_cfg.loss!r}")
    return functools.partial(compute_fm_loss_dialog, se_weight=train_cfg.se_weight,
                             stereo=train_cfg.stereo)


def draw_t_and_noise(seed: int, features: torch.Tensor):
    """A step's draws from its seed: t (B, 1, 1) ~ U(0, 1) in f32, the
    noise drawn in f32 and cast to the features' dtype (both from the
    rank's fold), and the loss's own seed."""
    dev = features.device
    k_t, k_noise, k_loss = np.random.default_rng(seed).integers(0, 2**62, size=3)
    gen = torch.Generator(device=dev)
    t = torch.rand((features.shape[0], 1, 1), generator=gen.manual_seed(fold_rank(k_t)),
                   device=dev)
    noise = torch.randn(features.shape, generator=gen.manual_seed(fold_rank(k_noise)),
                        device=dev).to(features.dtype)
    return t, noise, int(k_loss)


def learning_rate(train_cfg: TrainConfig, step_idx: int, epoch: float) -> float:
    if train_cfg.schedule == "eden":
        return eden_lr(train_cfg.base_lr, step_idx, epoch, lr_batches=train_cfg.lr_batches,
                       lr_epochs=train_cfg.lr_epochs, warmup_batches=train_cfg.warmup_batches)
    return fixed_lr(train_cfg.base_lr)


def make_train_step(model: ZipVoiceModel, opt: ScaledAdam, train_cfg: TrainConfig = TrainConfig(),
                    mesh: Optional[Mesh] = None):
    """step(batch, seed, step_idx, epoch, schedules=None) -> metrics.

    batch: tokens (B, S), tokens_lens (B,), features (B, T, F) f32,
    features_lens (B,): this rank's rows (the same on the ranks of a model
    group, and of a seq group, whole, at the full T).  The metrics are device scalars (loss, the clip diagnostics)
    and the float lr; reading them is the caller's sync.  mesh: a data x
    model mesh (module docstring), or None for the world as the data
    group."""
    dtype = _DTYPES[train_cfg.compute_dtype]
    loss_fn = _loss_fn(train_cfg)
    if (mesh is not None and mesh.size("model") > 1
            and not any(hasattr(p, "tp_shard") for p in model.parameters())):
        raise ValueError("a mesh with a model axis needs the model sharded over it first "
                         "(parallel/mesh.shard_module)")
    seq_replicated = (seq_replicated_params(model)
                      if mesh is not None and mesh.size("seq") > 1 else [])

    def step(batch, seed: int, step_idx: int, epoch: float,
             schedules: Optional[Dict] = None) -> Dict:
        with use_mesh(mesh):
            return _step(batch, seed, step_idx, epoch, schedules)

    def _step(batch, seed, step_idx, epoch, schedules) -> Dict:
        dev = next(model.parameters()).device
        batch = batch_to_device(batch, dev)
        features = batch["features"].to(dtype)
        t, noise, k_loss = draw_t_and_noise(seed, features)
        loss = loss_fn(model, batch["tokens"], batch["tokens_lens"], features,
                       batch["features_lens"], noise, t, k_loss,
                       condition_drop_ratio=train_cfg.condition_drop_ratio,
                       schedules=schedules)
        opt.zero_grad()
        loss.backward()
        (loss,) = all_reduce_gradients(opt.params, [loss.detach()], seq_replicated)
        lr = learning_rate(train_cfg, step_idx, epoch)
        diag = opt.step(lr)
        return {"loss": loss, "lr": lr, **diag}

    return step


def make_eval_step(model: ZipVoiceModel, train_cfg: TrainConfig = TrainConfig()):
    """Validation loss averaged over 4 fixed timesteps per utterance, on
    the training objective, over the global batch."""
    dtype = _DTYPES[train_cfg.compute_dtype]
    loss_fn = _loss_fn(train_cfg)

    @torch.no_grad()
    def eval_step(batch, seed: int) -> torch.Tensor:
        dev = next(model.parameters()).device
        batch = batch_to_device(batch, dev)
        features = batch["features"].to(dtype)
        b = features.shape[0]
        losses = []
        for i, tv in enumerate((0.1, 0.35, 0.65, 0.9)):
            k_noise, k_loss = np.random.default_rng([seed, i]).integers(0, 2**62, size=2)
            t = torch.full((b, 1, 1), tv, dtype=dtype, device=dev)
            noise = torch.randn(features.shape, device=dev,
                                generator=torch.Generator(device=dev).manual_seed(
                                    fold_rank(k_noise)))
            losses.append(loss_fn(model, batch["tokens"], batch["tokens_lens"],
                                  features, batch["features_lens"], noise.to(dtype),
                                  t, int(k_loss)))
        return global_sum(torch.mean(torch.stack(losses)))

    return eval_step
