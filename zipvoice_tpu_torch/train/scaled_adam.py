"""ScaledAdam: Adam whose tensor updates are scaled by each tensor's RMS,
with a learned per-tensor scale and median-of-history gradient clipping.

The same update as the JAX package's ``train/scaled_adam.py``, on the
parameters of a torch module, updated in place.  The step counter is a
host integer, so the schedule of the optimizer (the size update every
``size_update_period`` steps, the clipping-threshold refreshes) is decided
on the host and costs no device sync; the clip factor itself stays on the
device.

Usage: ``opt = ScaledAdam(model.named_parameters()); loss.backward();
diag = opt.step(lr)``.  ``lr_scales`` maps parameter-name prefixes to LR
multipliers (longest prefix wins; 0 freezes a tensor).

Under tensor parallelism a parameter split over a model group
(``parallel/mesh.shard_module`` tags it ``tp_shard``) keeps its moments
(exp_avg_sq, delta) at its local shape, and every reduction over the
tensor sees the whole tensor, as GSPMD gives the JAX package: its RMS, its
scale gradient sum(p * g) and its share of the clipping norm are summed
over the shards (one all-reduce for all split tensors a step, one more on
the size-update steps), a replicated tensor counted once.  Build the
optimizer after sharding.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from zipvoice_tpu_torch.parallel.mesh import model_all_reduce


@dataclasses.dataclass(frozen=True)
class ScaledAdamConfig:
    betas: Tuple[float, float] = (0.9, 0.98)
    scalar_lr_scale: float = 0.1
    eps: float = 1.0e-08
    param_min_rms: float = 1.0e-05
    param_max_rms: float = 3.0
    scalar_max: float = 10.0
    size_update_period: int = 4
    clipping_scale: Optional[float] = 2.0
    clipping_update_period: int = 100


def _rms(p: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(torch.square(p.float())))


def _whole_sums(parts: List[Optional[torch.Tensor]],
                params: List[torch.nn.Parameter]) -> List:
    """Each f32 partial sum of a split parameter summed over its model
    group, in one all-reduce (the split parameters share one group); the
    others as they are."""
    split = [i for i, p in enumerate(params) if getattr(p, "tp_shard", None) is not None]
    if not split:
        return parts
    flat = model_all_reduce(torch.stack([parts[i] for i in split]), params[split[0]].tp_shard)
    out = list(parts)
    for j, i in enumerate(split):
        out[i] = flat[j]
    return out


def _whole_numel(p: torch.nn.Parameter) -> int:
    shard = getattr(p, "tp_shard", None)
    return p.numel() * (1 if shard is None else shard.size)


def _prefix_scale(name: str, rules: Optional[Dict[str, float]]) -> float:
    scale, best = 1.0, -1
    for prefix, s in (rules or {}).items():
        if name.startswith(prefix) and len(prefix) > best:
            scale, best = float(s), len(prefix)
    return scale


class ScaledAdam:
    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 cfg: ScaledAdamConfig = ScaledAdamConfig(),
                 lr_scales: Optional[Dict[str, float]] = None):
        self.cfg = cfg
        self.names: List[str] = []
        self.params: List[torch.nn.Parameter] = []
        for name, p in named_params:
            self.names.append(name)
            self.params.append(p)
        self.lr_scales = [_prefix_scale(n, lr_scales) for n in self.names]
        self.step_count = 0
        dev = self.params[0].device
        self.state = []
        with torch.no_grad():
            rms = self._rms_all()
            for p, prms in zip(self.params, rms):
                z = lambda shape=p.shape: torch.zeros(shape, dtype=torch.float32, device=dev)  # noqa: E731
                self.state.append({
                    "exp_avg_sq": z(), "delta": z(),
                    "param_rms": z(()) if p.ndim == 0 else prms,
                    "scale_grads": z((cfg.size_update_period,)),
                    "scale_exp_avg_sq": z(()),
                })
        self.model_norms = torch.zeros(cfg.clipping_update_period, device=dev)
        self.model_norm_threshold = torch.tensor(float("inf"), device=dev)

    def _rms_all(self) -> List[torch.Tensor]:
        """Every parameter's whole-tensor RMS."""
        split = [getattr(p, "tp_shard", None) is not None for p in self.params]
        sumsq = _whole_sums([torch.sum(torch.square(p.float())) if s else None
                             for p, s in zip(self.params, split)], self.params)
        return [torch.sqrt(q / _whole_numel(p)) if s else _rms(p)
                for p, q, s in zip(self.params, sumsq, split)]

    # ------------------------------------------------------------ clipping

    def _clipping(self, grads):
        """Median-of-history clipping.  Returns (clip factor, dominant leaf
        index, its share of the rms-scaled squared gradient norm)."""
        c = self.cfg
        step = self.step_count
        dev = self.model_norms.device
        if c.clipping_scale is None:
            one = torch.ones((), device=dev)
            return one, torch.zeros((), dtype=torch.int64, device=dev), 0.0 * one
        per_leaf = torch.stack(_whole_sums([
            torch.square(g) * c.scalar_lr_scale**2 if p.ndim == 0
            else torch.sum(torch.square(g * st["param_rms"]))
            for g, p, st in zip(grads, self.params, self.state)
        ], self.params))
        tot_sumsq = torch.sum(per_leaf)
        dom_idx = torch.argmax(per_leaf)
        dom_frac = per_leaf[dom_idx] / torch.clamp(tot_sumsq, min=1e-20)
        tot_norm = torch.sqrt(tot_sumsq)
        # step 0 records no norm, so the buffer fills from step 1
        if step > 0:
            self.model_norms[step % c.clipping_update_period] = tot_norm
        period = c.clipping_update_period
        is_periodic = step % period == 0 and step > 0
        is_irregular = step in (10, 20, 40)
        if is_periodic or is_irregular:
            n_valid = period if is_periodic else step
            factor = 2.0 if is_irregular else 1.0
            # median of the largest n_valid norms (the ones collected so far)
            med = torch.sort(self.model_norms).values[
                (period - n_valid) + min(n_valid - 1, (n_valid // 4) * 2)]
            refreshed = c.clipping_scale * med * factor
            # a non-finite median keeps the previous threshold
            self.model_norm_threshold = torch.where(
                torch.isfinite(refreshed), refreshed, self.model_norm_threshold)
        thresh = self.model_norm_threshold
        clip = torch.clamp(thresh / (tot_norm + 1.0e-20), max=1.0)
        clip = torch.where(torch.isnan(clip), torch.zeros_like(clip), clip)
        if step == 0:
            clip = torch.ones_like(clip)
        clip = torch.where(torch.isinf(thresh), torch.ones_like(clip), clip)
        return clip, dom_idx, dom_frac

    # ------------------------------------------------------------ update

    @torch.no_grad()
    def _leaf_update(self, g, p, st, lr, scale_grad, prms_new):
        """scale_grad: sum(p * g) over the whole tensor; prms_new: its
        whole-tensor RMS (read on the size-update steps only)."""
        c = self.cfg
        beta1, beta2 = c.betas
        step = self.step_count
        p32 = p.float()
        scalar = p.ndim == 0
        leaf_lr = lr * (c.scalar_lr_scale if scalar else 1.0)

        st["exp_avg_sq"].mul_(beta2).add_((1 - beta2) * torch.square(g))
        bias_correction2 = 1 - beta2 ** (step + 1.0)
        eas_hat = st["exp_avg_sq"] / bias_correction2 if bias_correction2 < 0.99 \
            else st["exp_avg_sq"]
        step_delta = -leaf_lr * g / (torch.sqrt(eas_hat) + c.eps)

        if not scalar:
            period = c.size_update_period
            is_update_step = step % period == period - 1
            st["scale_grads"][step % period] = scale_grad
            if is_update_step:
                st["param_rms"] = prms_new
            prms = st["param_rms"]
            step_delta = step_delta * torch.clamp(prms, min=c.param_min_rms)
            if is_update_step:
                sgrads = st["scale_grads"]
                beta2_corr = beta2**period
                seas_new = beta2_corr * st["scale_exp_avg_sq"] + (1 - beta2_corr) * torch.mean(
                    torch.square(sgrads))
                bc2 = 1 - beta2_corr ** float((step + 1) // period)
                size_lr = lr * c.scalar_lr_scale
                scale_step = (-size_lr * (bc2**0.5) * torch.sum(sgrads)
                              / (torch.sqrt(seas_new) + c.eps))
                scale_step = torch.where(prms < c.param_min_rms,
                                         torch.zeros_like(scale_step), scale_step)
                scale_step = torch.clamp(scale_step, -0.1, 0.1)
                scale_step = torch.minimum(
                    scale_step, (c.param_max_rms - prms) / torch.clamp(prms, min=1e-20))
                if step > 0:
                    step_delta = step_delta + scale_step * p32
                st["scale_exp_avg_sq"] = seas_new

        st["delta"].mul_(beta1).add_((1 - beta1) * step_delta)
        update = st["delta"]
        if scalar:
            # clamp the parameter itself to +-scalar_max
            update = torch.clamp(p32 + update, -c.scalar_max, c.scalar_max) - p32
        p.add_(update.to(p.dtype))

    @torch.no_grad()
    def step(self, lr: float) -> Dict[str, torch.Tensor]:
        """One update from the parameters' .grad (a missing grad counts as
        zero).  Returns the diagnostics {"grad_clip", "grad_dominant_idx",
        "grad_dominant_frac"} as device scalars."""
        grads = [torch.zeros_like(p, dtype=torch.float32) if p.grad is None else p.grad.float()
                 for p in self.params]
        clip, dom_idx, dom_frac = self._clipping(grads)
        grads = [g * clip for g in grads]
        period = self.cfg.size_update_period
        scale_grads = _whole_sums([torch.sum(p.float() * g) for p, g in zip(self.params, grads)],
                                  self.params)
        # the RMS before this step's update, as the JAX package takes it
        rms = (self._rms_all() if self.step_count % period == period - 1
               else [None] * len(self.params))
        for g, p, st, s, sg, prms in zip(grads, self.params, self.state, self.lr_scales,
                                         scale_grads, rms):
            self._leaf_update(g, p, st, lr * s, sg, prms)
        self.step_count += 1
        return {"grad_clip": clip, "grad_dominant_idx": dom_idx,
                "grad_dominant_frac": dom_frac}

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    # ------------------------------------------------------------ state

    def state_dict(self) -> Dict:
        return {
            "step": self.step_count,
            "params": {n: {k: v.detach().cpu() for k, v in st.items()}
                       for n, st in zip(self.names, self.state)},
            "model_norms": self.model_norms.cpu(),
            "model_norm_threshold": self.model_norm_threshold.cpu(),
        }

    def load_state_dict(self, state: Dict):
        dev = self.model_norms.device
        self.step_count = int(state["step"])
        for n, st in zip(self.names, self.state):
            for k, v in state["params"][n].items():
                st[k] = v.to(device=dev, dtype=torch.float32)
        self.model_norms = state["model_norms"].to(dev)
        self.model_norm_threshold = state["model_norm_threshold"].to(dev)
