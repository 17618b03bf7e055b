"""The distillation training step, on one device a process.

A step draws its (t, d_fix, d_ema) triple on the host (``draw_t_schedule``),
runs the teacher's two hops without autograd and the student's hop with it
(``models/distill.compute_distill_loss``), and updates the student with
ScaledAdam.  Only the student's fm_decoder trains: the other parameters get
no gradient, which ScaledAdam takes as zeros, so they keep their values.
In stage ``second`` the teacher then moves toward the student by EMA (decay
0.9999, f32).  In a process group the step is data-parallel as
``train/step.py``'s: per-row draws from the rank's fold of the seed, the
losses normalized over the global batch, the gradients and the losses summed
over the ranks before the update.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from zipvoice_tpu_torch.models.distill import compute_distill_loss, ema_update
from zipvoice_tpu_torch.models.zipvoice import ZipVoiceModel
from zipvoice_tpu_torch.parallel.mesh import all_reduce_gradients, fold_rank
from zipvoice_tpu_torch.train.scaled_adam import ScaledAdam
from zipvoice_tpu_torch.train.step import _DTYPES, TrainConfig, batch_to_device

EMA_DECAY = 0.9999


def draw_t_schedule(rng: np.random.Generator) -> Tuple[np.float32, np.float32, np.float32]:
    """The host-side (t, d_fix, d_ema) draw: t ~ U(0, 1), d_fix ~
    U(0, min(0.3, 1 - t)), d_ema ~ U(0, min(0.3, 1 - t - d_fix))."""
    t_value = rng.random()
    d_fix = rng.uniform(0.0, min(0.3, 1.0 - t_value))
    d_ema = rng.uniform(0.0, min(0.3, 1.0 - t_value - d_fix))
    return np.float32(t_value), np.float32(d_fix), np.float32(d_ema)


def make_distill_train_step(student: ZipVoiceModel, teacher: ZipVoiceModel, opt: ScaledAdam,
                            train_cfg: TrainConfig, stage: str = "first"):
    """step(batch, seed, t_triple) -> metrics {"loss", "ref_loss" (device
    scalars), "lr"}.  The learning rate is train_cfg.base_lr throughout;
    the student and (stage ``second``) the teacher are updated in place."""
    dtype = _DTYPES[train_cfg.compute_dtype]

    def step(batch, seed: int, t_triple) -> Dict:
        dev = next(student.parameters()).device
        batch = batch_to_device(batch, dev)
        features = batch["features"].to(dtype)
        loss, ref_loss = compute_distill_loss(
            student, teacher, batch["tokens"], batch["tokens_lens"], features,
            batch["features_lens"], fold_rank(seed), *t_triple, stage=stage)
        opt.zero_grad()
        loss.backward()
        loss, ref_loss = all_reduce_gradients(opt.params, [loss.detach(), ref_loss])
        lr = float(train_cfg.base_lr)
        opt.step(lr)
        if stage == "second":
            ema_update(teacher, student, EMA_DECAY)
        return {"loss": loss, "ref_loss": ref_loss, "lr": lr}

    return step
