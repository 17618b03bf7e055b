"""Training loop: steps, metrics, validation, checkpoints, averaging.

The regularizer schedules are evaluated on the host each step from the
data-normalized batch count and passed to the step as Python floats.
Metrics are read from the device only at the logging cadence, so a step
does not wait for the previous one.

In a process group (``parallel/mesh``) every rank runs the same loop on its
own shard of the data: hours of speech and the schedules count the global
batch (a rank's frames times the world size, as each rank holds an equal
share), the metrics and the validation loss are global, and only rank 0
writes: checkpoints, their rotation, the log, TensorBoard and bad-model.pt.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import logging
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from zipvoice_tpu_torch.parallel.mesh import rank, world_size
from zipvoice_tpu_torch.train import checkpoint as ckpt
from zipvoice_tpu_torch.train.scaled_adam import ScaledAdam
from zipvoice_tpu_torch.train.step import TrainConfig, make_eval_step, make_train_step


class MetricsTracker:
    """Exp-decayed running averages: tot = tot * (1 - decay) + cur * decay."""

    def __init__(self, decay: float = 1.0 / 200):
        self.decay = decay
        self.tot: Dict[str, float] = {}

    def update(self, metrics: Dict[str, float]) -> Dict[str, float]:
        for k, v in metrics.items():
            v = float(v)
            if k in self.tot:
                self.tot[k] = self.tot[k] * (1 - self.decay) + v * self.decay
            else:
                self.tot[k] = v
        return dict(self.tot)


@dataclasses.dataclass
class TrainerOptions:
    exp_dir: str = "exp"
    num_epochs: int = 11
    start_epoch: int = 1
    save_every_n: int = 5000
    keep_last_k: int = 30
    average_period: int = 200
    valid_interval: int = 10000
    log_interval: int = 50
    seed: int = 42
    # >0: the Eden epoch term is keyed to hours of seen speech
    lr_hours: float = 0.0
    # regularizer schedules count step * max_duration / ref_duration batches
    max_duration: float = 200.0
    ref_duration: float = 600.0
    # finetuning offsets the schedule count so regularizers start relaxed
    batch_count_offset: float = 0.0
    inf_check: bool = False
    # feature frames per second (features_lens -> seen hours)
    frame_rate: float = 93.75


def step_seed(seed: int, batch_idx: int) -> int:
    """The per-step random seed derived from the run seed and batch index."""
    return int(np.random.SeedSequence([seed, batch_idx]).generate_state(1, np.uint64)[0]
               >> 2)


class Trainer:
    def __init__(self, model_cfg, model: torch.nn.Module, opt: ScaledAdam,
                 train_cfg: TrainConfig, options: TrainerOptions):
        self.model_cfg = model_cfg
        self.model = model
        self.opt = opt
        self.train_cfg = train_cfg
        self.opts = options
        self.model_avg = ckpt.init_averaged_model(model)
        self.batch_idx_train = 0
        self.seen_seconds = 0.0
        self.epoch = options.start_epoch
        self.best_train_loss = float("inf")
        self.best_valid_loss = float("inf")
        self.step_fn = make_train_step(model, opt, train_cfg)
        # a variant with an objective a batch (the stereo alternation) sets
        # the step of the next batch here
        self.active_step_fn = None
        self.eval_fn = make_eval_step(model, train_cfg)
        self.tracker = MetricsTracker()
        self._sched_fn = None
        if train_cfg.use_regularizers:
            from zipvoice_tpu_torch.train.schedules import zipvoice_schedules

            self._sched_fn = lambda count: zipvoice_schedules(count, model_cfg)
        Path(options.exp_dir).mkdir(parents=True, exist_ok=True)
        self._log_path = Path(options.exp_dir) / "train_log.jsonl"
        self._tb = None

    # ---------------------------------------------------------------- utils

    def _epoch_value(self) -> float:
        """Real epochs, or hours of speech re-keyed so that Eden's epoch knee
        falls at lr_hours."""
        if self.opts.lr_hours > 0:
            return self.seen_seconds / 3600.0 / self.opts.lr_hours * self.train_cfg.lr_epochs
        return float(self.epoch - 1)

    def _log(self, record: Dict):
        if rank() != 0:
            return
        record = {k: (float(v) if hasattr(v, "item") else v) for k, v in record.items()}
        with open(self._log_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self._tb is None:
            from zipvoice_tpu_torch.utils.tb_writer import TBWriter

            self._tb = TBWriter(Path(self.opts.exp_dir) / "tensorboard")
        step = int(record.get("step", self.batch_idx_train))
        scalars = {f"train/{k}": v for k, v in record.items()
                   if k not in ("step", "epoch") and isinstance(v, float)}
        if scalars:
            self._tb.add_scalars(step, scalars)

    # ---------------------------------------------------------------- steps

    def train_step(self, batch) -> Dict:
        self.batch_idx_train += 1
        world = world_size()
        self.seen_seconds += (float(np.sum(batch["features_lens"])) * world
                              / self.opts.frame_rate)
        schedules = None
        if self._sched_fn is not None:
            from zipvoice_tpu_torch.train.schedules import adjusted_batch_count

            count = self.opts.batch_count_offset + adjusted_batch_count(
                self.batch_idx_train, self.opts.max_duration, world, self.opts.ref_duration)
            schedules = self._sched_fn(count)
        step_fn = self.active_step_fn or self.step_fn
        metrics = step_fn(batch, step_seed(self.opts.seed, self.batch_idx_train),
                               self.batch_idx_train, self._epoch_value(), schedules)
        if self.batch_idx_train % self.opts.average_period == 0:
            ckpt.update_averaged_model(self.model_avg, self.model, self.batch_idx_train,
                                       self.opts.average_period)
        return metrics

    def validate(self, valid_batches) -> float:
        losses = [float(self.eval_fn(batch, i)) for i, batch in enumerate(valid_batches)]
        loss = float(np.mean(losses)) if losses else float("nan")
        self.best_valid_loss = min(self.best_valid_loss, loss)
        return loss

    # ------------------------------------------------------------- chkpts

    def _info(self) -> Dict:
        return {
            "batch_idx_train": self.batch_idx_train,
            "average_period": self.opts.average_period,
            "epoch": self.epoch,
            "seen_seconds": self.seen_seconds,
            "best_train_loss": self.best_train_loss,
            "best_valid_loss": self.best_valid_loss,
        }

    def save(self, filename: str, sampler_state=None, with_opt: bool = True):
        """Write a checkpoint (rank 0 only)."""
        if rank() != 0:
            return
        ckpt.save_checkpoint(filename, self.model, model_avg=self.model_avg,
                             opt_state=self.opt.state_dict() if with_opt else None,
                             sampler_state=sampler_state, info=self._info())

    def save_periodic(self, sampler_state=None):
        if self.batch_idx_train % self.opts.save_every_n == 0:
            out = Path(self.opts.exp_dir)
            self.save(str(out / f"checkpoint-{self.batch_idx_train}.pt"), sampler_state)
            if rank() == 0:
                ckpt.remove_checkpoints(str(out), self.opts.keep_last_k)

    def resume(self, filename: str):
        """Restore weights, the float64 average, the optimizer and the
        bookkeeping; returns the saved sampler state."""
        state = ckpt.load_checkpoint(filename)
        with torch.no_grad():
            for k, v in self.model.state_dict().items():
                v.copy_(state["model"][k])
        if state["model_avg"] is not None:
            self.model_avg = {k: v.to(torch.float64) for k, v in state["model_avg"].items()}
        if state["opt_state"] is not None:
            self.opt.load_state_dict(state["opt_state"])
        info = state["info"]
        self.batch_idx_train = info.get("batch_idx_train", 0)
        self.seen_seconds = info.get("seen_seconds", 0.0)
        self.epoch = info.get("epoch", 1)
        self.best_train_loss = info.get("best_train_loss", float("inf"))
        self.best_valid_loss = info.get("best_valid_loss", float("inf"))
        return state["sampler"]

    def scan_oom(self, batch) -> None:
        """One training step on ``batch`` (the largest of the epoch, to meet
        an out-of-memory failure before the run starts), then the state
        before it back bit for bit: parameters, optimizer state, the
        average, the step count, the hours seen, the best losses and the
        tracker."""
        opt = self.opt
        saved = ([p.detach().clone() for p in self.model.parameters()],
                 copy.deepcopy((opt.state, opt.step_count, opt.model_norms,
                                opt.model_norm_threshold)),
                 copy.deepcopy((self.model_avg, self.batch_idx_train, self.seen_seconds,
                                self.best_train_loss, self.best_valid_loss, self.tracker)))
        self.train_step(batch)
        opt.zero_grad()
        params, opt_state, bookkeeping = saved
        with torch.no_grad():
            for p, v in zip(self.model.parameters(), params):
                p.copy_(v)
        opt.state, opt.step_count, opt.model_norms, opt.model_norm_threshold = opt_state
        (self.model_avg, self.batch_idx_train, self.seen_seconds, self.best_train_loss,
         self.best_valid_loss, self.tracker) = bookkeeping

    # ---------------------------------------------------------------- loop

    def step_and_log(self, batch, valid_batches=None, sampler_state_fn=None) -> Dict:
        try:
            metrics = self.train_step(batch)
        except Exception:
            # keep the failing state for a post-mortem, then re-raise
            bad = Path(self.opts.exp_dir) / "bad-model.pt"
            self.save(str(bad), with_opt=False)
            if rank() == 0:
                logging.warning("step failed; saved %s", bad)
            raise
        log_now = self.batch_idx_train % self.opts.log_interval == 0
        if self.opts.inf_check or log_now:
            clip = float(metrics["grad_clip"])
            if clip < 0.1:
                idx = int(metrics["grad_dominant_idx"])
                logging.warning(
                    "step %d: grad clipped to %.3f of its norm; dominant parameter %s "
                    "(%.1f%% of rms-scaled grad^2)", self.batch_idx_train, clip,
                    self.opt.names[idx], 100.0 * float(metrics["grad_dominant_frac"]))
        if self.opts.inf_check and not np.isfinite(float(metrics["loss"])):
            from zipvoice_tpu_torch.utils.hooks import find_nonfinite

            logging.warning("inf-check: non-finite loss at step %d; bad params: %s",
                            self.batch_idx_train, find_nonfinite(self.model)[:10])
        if log_now:
            running = self.tracker.update({"loss": float(metrics["loss"]),
                                           "lr": float(metrics["lr"])})
            self.best_train_loss = min(self.best_train_loss, running["loss"])
            rec = {"step": self.batch_idx_train, "epoch": self.epoch, **running}
            logging.info("train %s", rec)
            self._log(rec)
        if valid_batches is not None and self.batch_idx_train % self.opts.valid_interval == 0:
            vl = self.validate(valid_batches)
            logging.info("valid step=%d loss=%.4f", self.batch_idx_train, vl)
            self._log({"step": self.batch_idx_train, "valid_loss": vl})
        self.save_periodic(sampler_state_fn() if sampler_state_fn is not None else None)
        return metrics
