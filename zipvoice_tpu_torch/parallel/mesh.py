"""Data parallelism across processes: one process a card, NCCL between them.

The JAX package drives every local device from one process through a
``data`` mesh and lets XLA insert the gradient psum.  The PyTorch idiom is
one process per card, started by ``torchrun`` (``python -m
torch.distributed.run``), which sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``.  This module holds
that half of ``zipvoice_tpu/parallel/mesh.py``:

* ``init_from_env``: the process group from the launcher's environment
  (NCCL on cards; gloo only when a caller passes it) and the process's
  device, ``cuda:LOCAL_RANK``;
* ``rank``, ``world_size``, ``fold_rank``: a process's place, and its own
  seed for the draws that differ row by row (t, noise, masks);
* ``broadcast_module``: rank 0's parameters and buffers to every rank,
  once before the first step;
* ``all_reduce_gradients``: one coalesced sum of every parameter's
  gradient (a missing one counts as zeros on every rank, as ScaledAdam
  takes it), with scalars riding along (the step's loss);
* ``global_sum``: a scalar summed over the ranks (the loss normalizer);
* ``barrier`` and ``shutdown``.

The losses are normalized by the valid count summed over the ranks and the
gradients summed, so every rank holds the gradient of the mean over the
global batch (JAX's), and ScaledAdam, run on equal gradients, keeps the
parameters bit-identical across ranks.  Without a process group every
function is the single-process identity.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def init_from_env(device: str = "cuda", backend: Optional[str] = None) -> torch.device:
    """Join the process group the launcher's environment describes; returns
    this process's device (``cuda:LOCAL_RANK``, or the CPU for
    ``device="cpu"``).  The backend is NCCL unless the caller names
    another: a card that NCCL cannot bring up fails the run."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        if var not in os.environ:
            raise RuntimeError(f"distributed training needs {var} in the environment "
                               "(launch with torchrun)")
    local_rank = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("distributed training on cuda, but CUDA is not available")
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)
    backend = backend or "nccl"
    if backend == "nccl" and dev.type != "cuda":
        raise RuntimeError(f"NCCL needs a CUDA device, not {dev}")
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]), **kw)
    return dev


def shutdown() -> None:
    if is_distributed():
        dist.destroy_process_group()


def barrier() -> None:
    if is_distributed():
        dist.barrier()


def fold_rank(seed: int) -> int:
    """The seed of this rank's per-row draws: ``seed`` itself on rank 0 (a
    single process draws as before), a derived one on the others."""
    r = rank()
    if r == 0:
        return int(seed)
    return int(np.random.SeedSequence([int(seed), r]).generate_state(1, np.uint64)[0] >> 2)


@torch.no_grad()
def broadcast_module(module: torch.nn.Module) -> None:
    """Copy rank 0's parameters and buffers into every rank's module."""
    if not is_distributed():
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the ranks (x itself without a process group); no
    gradient flows through the sum."""
    if not is_distributed():
        return x
    y = x.detach().clone()
    dist.all_reduce(y)
    return y


@torch.no_grad()
def all_reduce_gradients(params: Sequence[torch.nn.Parameter],
                         extras: Sequence[torch.Tensor] = ()) -> List[torch.Tensor]:
    """Sum every parameter's .grad over the ranks in one all-reduce, a
    missing gradient as zeros, and set each .grad to a view of the sum;
    ``extras`` (scalars) ride in the same buffer and come back summed.
    Without a process group nothing moves and ``extras`` come back as
    they are."""
    if not is_distributed():
        return list(extras)
    # a named range, so that a profile of the step shows the sync's share
    with torch.profiler.record_function("all_reduce_gradients"):
        flat = torch.cat(
            [(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1).float()
             for p in params] + [e.detach().reshape(-1).float() for e in extras])
        dist.all_reduce(flat)
        off = 0
        for p in params:
            n = p.numel()
            p.grad = flat[off:off + n].view_as(p).to(p.dtype)
            off += n
        return [flat[off + i].reshape(e.shape) for i, e in enumerate(extras)]
