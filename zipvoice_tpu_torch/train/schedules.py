"""Batch-count-keyed schedules (PiecewiseLinear / ScheduledFloat equivalents).

Schedules are pure functions of the batch count, evaluated on the host
each step; their values enter the training forward as Python floats.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

from zipvoice_tpu_torch.config import ZipformerConfig


class PiecewiseLinear:
    """y(x) by linear interpolation between (x, y) knots, clamped at the ends
    (ref scaling.py:71-180)."""

    def __init__(self, *args: Tuple[float, float]):
        assert len(args) >= 1
        if len(args) == 1 and isinstance(args[0], PiecewiseLinear):
            self.pairs = list(args[0].pairs)
        else:
            self.pairs = [(float(x), float(y)) for x, y in args]
        for (x0, _), (x1, _) in zip(self.pairs[:-1], self.pairs[1:]):
            assert x1 > x0, self.pairs

    def __call__(self, x: float) -> float:
        if x <= self.pairs[0][0]:
            return self.pairs[0][1]
        if x >= self.pairs[-1][0]:
            return self.pairs[-1][1]
        for (x0, y0), (x1, y1) in zip(self.pairs[:-1], self.pairs[1:]):
            if x0 <= x <= x1:
                return y0 + (y1 - y0) * (x - x0) / (x1 - x0)
        raise AssertionError


def sched(*points) -> PiecewiseLinear:
    return PiecewiseLinear(*points)


# Default schedule set of the Zipformer layer (ref zipformer.py:134, 328-345,
# 695-699, 760, 1089) and the scaling kit (ref scaling.py:657, 296-297).
_DROPOUT = sched((0.0, 0.3), (20000.0, 0.1))
_ATTN_SKIP = sched((0.0, 0.2), (4000.0, 0.05), (16000.0, 0.0))
_CONV_SKIP = sched((0.0, 0.2), (4000.0, 0.05), (16000.0, 0.0))
_CONST_ATTN = sched((0.0, 0.25), (4000.0, 0.025))
_FF2_SKIP = sched((0.0, 0.1), (4000.0, 0.01), (50000.0, 0.0))
_FF3_SKIP = sched((0.0, 0.1), (4000.0, 0.01), (50000.0, 0.0))
_BYPASS_SCALE_MIN = sched((0.0, 0.9), (20000.0, 0.2))
_POS_EMB_SKIP = sched((0.0, 0.5), (4000.0, 0.0))
_BALANCER_PROB = sched((0.0, 0.5), (8000.0, 0.125))


def whitening_schedule(x: float, ratio: float = 2.0) -> PiecewiseLinear:
    return sched((0.0, x), (20000.0, ratio * x))


# cfg-independent schedules evaluated inside zipformer_schedules, built once
_WHITEN_4X3 = whitening_schedule(4.0, 3.0)
_WHITEN_3 = whitening_schedule(3.0)
_WHITEN_7_5 = whitening_schedule(7.5)
_WHITEN_7_5X3 = whitening_schedule(7.5, 3.0)
_WHITEN_5 = whitening_schedule(5.0)
_WHITEN_5X3 = whitening_schedule(5.0, 3.0)
_BAL_NA_MIN_ABS = sched((0.0, 0.004), (4000.0, 0.02))
_BAL_FF2_MIN_ABS = sched((0.0, 0.0), (4000.0, 0.1))
_BAL_FF3_MIN_ABS = sched((0.0, 0.0), (4000.0, 0.2))
_NONLIN_BAL_MIN_POS = sched((0.0, 0.25), (20000.0, 0.05))
_NONLIN_BAL_MAX_POS = sched((0.0, 0.75), (20000.0, 0.95))
_CONV_BAL1_MIN_POS = sched((0.0, 0.05), (8000.0, 0.025))
_CONV_BAL1_MAX_ABS = sched((0.0, 5.0), (8000.0, 10.0))
_CONV_BAL2_MIN_POS = sched((0.0, 0.1), (8000.0, 0.05))
_CONV_BAL2_MIN_ABS = sched((0.0, 0.2), (20000.0, 0.5))


@functools.lru_cache(maxsize=16)
def layerdrop_schedules(
    cfg: ZipformerConfig, warmup_batches: float = 4000.0
) -> Tuple[Tuple[PiecewiseLinear, ...], ...]:
    """Per-(stack, layer) bypass skip-rate schedules: layerdrop warms up over
    a per-layer window inside the stack's warmup span (ref zipformer.py:
    200-211, 689-700)."""
    out = []
    n = cfg.num_stacks
    for i in range(n):
        warmup_begin = warmup_batches * (i + 1) / (n + 1)
        warmup_end = warmup_batches * (i + 2) / (n + 1)
        num_layers = cfg.num_encoder_layers[i]
        final = 0.035 * (cfg.downsampling_factor[i] ** 0.5)
        delta = (warmup_end - warmup_begin) / num_layers
        stack = []
        cur = warmup_begin
        for _ in range(num_layers):
            stack.append(sched((cur, 0.5), (cur + delta, final)))
            cur += delta
        out.append(tuple(stack))
    return tuple(out)


def zipformer_schedules(
    batch_count: float, cfg: ZipformerConfig, warmup_batches: float = 4000.0
) -> Dict:
    """Evaluate every schedule at batch_count -> dict of Python floats."""
    ld = layerdrop_schedules(cfg, warmup_batches)
    return {
        "dropout": _DROPOUT(batch_count),
        "attention_skip_rate": _ATTN_SKIP(batch_count),
        "conv_skip_rate": _CONV_SKIP(batch_count),
        "const_attention_rate": _CONST_ATTN(batch_count),
        "ff2_skip_rate": _FF2_SKIP(batch_count),
        "ff3_skip_rate": _FF3_SKIP(batch_count),
        "bypass_scale_min": _BYPASS_SCALE_MIN(batch_count),
        "pos_emb_skip_rate": _POS_EMB_SKIP(batch_count),
        "balancer_prob": _BALANCER_PROB(batch_count),
        "whiten_4x3": _WHITEN_4X3(batch_count),
        "whiten_3": _WHITEN_3(batch_count),
        "whiten_7_5": _WHITEN_7_5(batch_count),
        "whiten_7_5x3": _WHITEN_7_5X3(batch_count),
        "whiten_5": _WHITEN_5(batch_count),
        "whiten_5x3": _WHITEN_5X3(batch_count),
        "balancer_na_min_abs": _BAL_NA_MIN_ABS(batch_count),
        "balancer_ff2_min_abs": _BAL_FF2_MIN_ABS(batch_count),
        "balancer_ff3_min_abs": _BAL_FF3_MIN_ABS(batch_count),
        "nonlin_balancer_min_pos": _NONLIN_BAL_MIN_POS(batch_count),
        "nonlin_balancer_max_pos": _NONLIN_BAL_MAX_POS(batch_count),
        "conv_balancer1_min_pos": _CONV_BAL1_MIN_POS(batch_count),
        "conv_balancer1_max_abs": _CONV_BAL1_MAX_ABS(batch_count),
        "conv_balancer2_min_pos": _CONV_BAL2_MIN_POS(batch_count),
        "conv_balancer2_min_abs": _CONV_BAL2_MIN_ABS(batch_count),
        "layerdrop": tuple(
            tuple(s(batch_count) for s in stack) for stack in ld
        ),
    }


def zipvoice_schedules(batch_count: float, model_cfg,
                       warmup_batches: float = 4000.0) -> Dict:
    """Per-backbone schedule dicts for a ZipVoice model (fm_decoder and
    text_encoder have different stack/layer structures)."""
    return {
        "fm_decoder": zipformer_schedules(
            batch_count, model_cfg.fm_decoder_config(), warmup_batches
        ),
        "text_encoder": zipformer_schedules(
            batch_count, model_cfg.text_encoder_config(), warmup_batches
        ),
    }


def adjusted_batch_count(
    batch_idx_train: int, max_duration: float, world_size: int,
    ref_duration: float = 600.0,
) -> float:
    """Normalize batch count by data throughput relative to the reference
    duration (ref common.py:304-312)."""
    return batch_idx_train * (max_duration * world_size) / ref_duration
