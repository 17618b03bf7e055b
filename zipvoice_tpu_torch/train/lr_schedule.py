"""Learning-rate schedules: Eden and fixed, as functions of (batch, epoch)
on the host.  ``epoch`` may be any float (the trainer re-keys it to hours
of seen speech for --lr-hours)."""

from __future__ import annotations


def eden_lr(base_lr: float, batch: float, epoch: float, lr_batches: float = 5000.0,
            lr_epochs: float = 6.0, warmup_batches: float = 500.0,
            warmup_start: float = 0.5) -> float:
    """lr = base * ((b^2+B^2)/B^2)^-0.25 * ((e^2+E^2)/E^2)^-0.25 * warmup."""
    batch, epoch = float(batch), float(epoch)
    factor = ((batch**2 + lr_batches**2) / lr_batches**2) ** -0.25 * (
        (epoch**2 + lr_epochs**2) / lr_epochs**2
    ) ** -0.25
    if batch >= warmup_batches:
        warmup = 1.0
    else:
        warmup = warmup_start + (1.0 - warmup_start) * (batch / warmup_batches)
    return base_lr * factor * warmup


def fixed_lr(base_lr: float, batch=None, epoch=None) -> float:
    return float(base_lr)
