"""Data, tensor and sequence parallelism across processes: one process a
card, NCCL between them.

The JAX package drives every local device from one process through a
named mesh and lets XLA insert the collectives.  The PyTorch idiom is one
process per card, started by ``torchrun`` (``python -m
torch.distributed.run``), which sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``; every collective is
written out here.  This module holds the port of
``zipvoice_tpu/parallel/mesh.py``:

* ``init_from_env``: the process group from the launcher's environment
  (NCCL on cards; gloo only when a caller passes it) and the process's
  device, ``cuda:LOCAL_RANK``;
* ``rank``, ``world_size``, ``fold_rank``: a process's place, and its own
  seed for the draws that differ row by row (t, noise, masks), folded by
  its data index;
* ``broadcast_module``: rank 0's parameters and buffers to every rank,
  once before the first step (and before ``shard_module``);
* ``all_reduce_gradients``: one coalesced sum of every parameter's
  gradient over the data group (a missing one counts as zeros on every
  rank, as ScaledAdam takes it), with scalars riding along (the step's
  loss); under tensor parallelism the replicated parameters' gradients
  are averaged over the model group too, so that its ranks keep equal
  replicas; under sequence parallelism the sum runs over data x seq, and
  the gradients of the parameters that every rank of a seq group runs
  whole (``seq_replicated``) are averaged over the seq group;
* ``global_sum``: a scalar summed over the data group (the loss
  normalizer), over data x seq under sequence parallelism;
* ``make_mesh(n_data, n_model)``: a data x model layout of the ranks, rank
  r at (r // n_model, r % n_model) as JAX's ``reshape(n_data, n_model)``
  places devices, with a process group for each data row (its model
  group) and each model column (its data group); ``make_seq_mesh(n_seq)``:
  one seq group; ``make_dp_sp_mesh(n_data, n_seq)``: a data x seq layout,
  rank r at (r // n_seq, r % n_seq), its data row its seq group;
  ``use_mesh``: the mesh a training step runs under, whose data group the
  gradient and loss sums and ``fold_rank`` read (without one, the data
  group is the world, as before);
* tensor parallelism (``tp_param_shardings``, ``shard_module``,
  ``unshard_state_dict``): the Megatron column/row split of every
  feedforward's hidden dimension over the model group, and its pair of
  collectives (``copy_to_model``: identity forward, all-reduce backward;
  ``reduce_from_model``: all-reduce forward, identity backward);
* sequence parallelism (``gather_frames``, ``halo``, ``scatter_frames``):
  the frames of every rank of the seq group, a rank's neighbours' edge
  frames for a convolution, and a rank's frames of a tensor that every
  rank holds whole; each has its adjoint as its backward (an all-reduce
  and a slice, the edges' cotangents sent back to their owners, an
  all-gather of the slices' cotangents), so a training step runs through
  them; ``seq_sum``: a statistic summed over the seq group, its cotangent
  passed through (the regularizers' statistics);
* ``barrier`` and ``shutdown``.

The losses are normalized by the valid count summed over the data group
and the gradients summed, so every rank holds the gradient of the mean
over the global batch (JAX's), and ScaledAdam, run on equal gradients,
keeps the parameters bit-identical across the ranks of a data group.
``COUNTS`` counts every collective call by kind (all_reduce, all_gather,
halo), as the kernels count their launches, backward calls included;
without a process group, or in a group of one, every function is the
single-process identity and counts nothing.  Every collective here is one
that gloo also runs on CUDA tensors (all_reduce, all_gather, broadcast), so
two gloo ranks can share one card where NCCL refuses them.  Under autograd
every rank must run its collectives in the same order; the ranks of a seq
group run the same layers on the same shapes, so their forwards, their
rematerialized recomputes and their backwards match call for call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
from typing import Dict, List, Optional, Sequence

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
    global _ACTIVE
    _ACTIVE = None
    if is_distributed():
        dist.destroy_process_group()


def barrier() -> None:
    if is_distributed():
        dist.barrier()


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a layout of the world's ranks over named axes:
    ``shape`` {axis: size}, ``index`` {axis: this rank's index} and
    ``groups`` {axis: the process group of the ranks that differ from this
    one only along that axis} (None for an axis of size 1)."""

    shape: Dict[str, int]
    index: Dict[str, int]
    groups: Dict[str, Optional[object]]

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def group(self, axis: str):
        return self.groups.get(axis)


def _new_groups(rows: Sequence[Sequence[int]]):
    """One process group for each list of ranks (every rank creates every
    group, in the same order); returns the one this rank belongs to, None
    where the lists hold one rank each (nothing to talk to)."""
    if len(rows[0]) == 1:
        return None
    mine, r = None, rank()
    for ranks in rows:
        g = dist.new_group(list(ranks))
        if r in ranks:
            mine = g
    return mine


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """A data x model layout of the world's ranks: rank r at (r // n_model,
    r % n_model); the model group of a rank holds the ranks of its data
    row, its data group those of its model column.  n_data defaults to
    world_size // n_model; n_data * n_model must be the world size."""
    n = world_size()
    n_data = n // n_model if n_data is None else n_data
    if n_data * n_model != n:
        raise ValueError(f"a {n_data} x {n_model} mesh needs {n_data * n_model} ranks, "
                         f"the world has {n}")
    r = rank()
    groups = {"data": None, "model": None}
    if is_distributed():
        groups["data"] = _new_groups([[d * n_model + c for d in range(n_data)]
                                      for c in range(n_model)])
        groups["model"] = _new_groups([list(range(d * n_model, (d + 1) * n_model))
                                       for d in range(n_data)])
    return Mesh({"data": n_data, "model": n_model},
                {"data": r // n_model, "model": r % n_model}, groups)


def make_seq_mesh(n_seq: Optional[int] = None) -> Mesh:
    """A 1-D layout of the world's ranks over the time axis (``seq``) for
    sequence-parallel inference: rank r holds frames [r T/n, (r+1) T/n).
    n_seq defaults to, and must be, the world size."""
    n = world_size()
    n_seq = n if n_seq is None else n_seq
    if n_seq != n:
        raise ValueError(f"a seq mesh of {n_seq} needs {n_seq} ranks, the world has {n}")
    group = _new_groups([list(range(n))]) if is_distributed() else None
    return Mesh({"seq": n}, {"seq": rank()}, {"seq": group})


def make_dp_sp_mesh(n_data: int, n_seq: int) -> Mesh:
    """A data x seq layout of the world's ranks for sequence-parallel
    training: rank r at (r // n_seq, r % n_seq), as JAX's
    ``reshape(n_data, n_seq)`` places devices.  A rank's seq group is its
    data row (the ranks that hold the same rows and split their frames),
    its data group its seq column.  n_data * n_seq must be the world
    size."""
    n = world_size()
    if n_data * n_seq != n:
        raise ValueError(f"a {n_data} x {n_seq} mesh needs {n_data * n_seq} ranks, "
                         f"the world has {n}")
    r = rank()
    groups = {"data": None, "seq": None}
    if is_distributed():
        groups["data"] = _new_groups([[d * n_seq + c for d in range(n_data)]
                                      for c in range(n_seq)])
        groups["seq"] = _new_groups([list(range(d * n_seq, (d + 1) * n_seq))
                                     for d in range(n_data)])
    return Mesh({"data": n_data, "seq": n_seq}, {"data": r // n_seq, "seq": r % n_seq},
                groups)


_ACTIVE: Optional[Mesh] = None


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Run the body under ``mesh``: fold_rank folds by its data index, and
    global_sum and all_reduce_gradients sum over its data group (data x seq
    where it has a seq axis)."""
    global _ACTIVE
    before, _ACTIVE = _ACTIVE, mesh
    try:
        yield mesh
    finally:
        _ACTIVE = before


def data_index() -> int:
    """This rank's index along the data axis of the active mesh (its rank
    without one, or in a mesh without a data axis)."""
    if _ACTIVE is not None and "data" in _ACTIVE.index:
        return _ACTIVE.index["data"]
    return rank()


def active_mesh() -> Optional[Mesh]:
    """The mesh of ``use_mesh``, None outside it."""
    return _ACTIVE


def seq_size() -> int:
    """The size of the active mesh's seq axis (1 without one)."""
    return 1 if _ACTIVE is None else _ACTIVE.size("seq")


def _data_group():
    """(group, size) of the sums over the batch: the active mesh's data
    group, or its data x seq ranks (the world) where it splits frames over
    a seq axis; else the world."""
    if _ACTIVE is not None and _ACTIVE.size("seq") > 1:
        return None, _ACTIVE.size("data") * _ACTIVE.size("seq")
    if _ACTIVE is not None and "data" in _ACTIVE.shape:
        return _ACTIVE.group("data"), _ACTIVE.size("data")
    return None, world_size()


def fold_rank(seed: int) -> int:
    """The seed of this rank's per-row draws: ``seed`` itself at data index
    0 (a single process draws as before), a derived one at the others.
    The ranks of one model group hold the same rows and draw the same."""
    r = data_index()
    if r == 0:
        return int(seed)
    return int(np.random.SeedSequence([int(seed), r]).generate_state(1, np.uint64)[0] >> 2)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

# collective calls by kind since the last reset_counts()
COUNTS = {"all_reduce": 0, "all_gather": 0, "halo": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """x summed in place over ``group`` (the world when None)."""
    dist.all_reduce(x, group=group)
    return x


def _all_gather(x: torch.Tensor, n: int, group) -> List[torch.Tensor]:
    """Every rank's x (same shape) in group rank order; bool travels as
    uint8."""
    src = x.contiguous().view(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return [p.view(torch.bool) for p in parts] if x.dtype == torch.bool else parts


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the data group, over data x seq under sequence
    parallelism (x itself without a process group); no gradient flows
    through the sum."""
    group, n = _data_group()
    if not is_distributed() or n == 1:
        return x
    COUNTS["all_reduce"] += 1
    return _all_reduce(x.detach().clone(), group)


@torch.no_grad()
def broadcast_module(module: torch.nn.Module) -> None:
    """Copy rank 0's parameters and buffers into every rank's module."""
    if not is_distributed():
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0)


@torch.no_grad()
def all_reduce_gradients(params: Sequence[torch.nn.Parameter],
                         extras: Sequence[torch.Tensor] = (),
                         seq_replicated: Sequence[torch.nn.Parameter] = ()) -> List[torch.Tensor]:
    """Sum every parameter's .grad over the data group, a missing gradient
    as zeros, and set each .grad to a view of the sum; ``extras`` (scalars)
    ride along and come back summed.  Without a process group (or in a
    mesh of one rank) nothing moves and ``extras`` come back as they are.

    Under an active mesh with a model axis, a replicated parameter's
    gradient is computed on every rank of its model group, equal but for
    the order of the card's atomic adds (an embedding's backward, B3's
    dpe): it is summed over the whole mesh and divided by the model size,
    so that the ranks of a model group keep equal replicas; a split
    parameter's gradient (``tp_shard``) is summed over the data group
    alone.

    Under an active mesh with a seq axis every gradient is summed over
    data x seq: a parameter that runs on a rank's frames (the fm_decoder)
    holds that rank's share of the sum.  A parameter in ``seq_replicated``
    runs whole on every rank of its seq group (the text encoder, whose
    frame-rate output each rank slices; ``models/zipvoice.
    seq_replicated_params`` names them) and holds the whole sum there: its
    sum is divided by the seq size, so that it counts once."""
    group, n = _data_group()
    n_model = _ACTIVE.size("model") if _ACTIVE is not None else 1
    if not is_distributed() or n * n_model == 1:
        return list(extras)
    # a named range, so that a profile of the step shows the sync's share
    with torch.profiler.record_function("all_reduce_gradients"):
        if seq_size() > 1:
            averaged = {id(p) for p in seq_replicated}
            return _sum_into_grads(params, extras, group,
                                   [seq_size() if id(p) in averaged else 1 for p in params])
        split = [p for p in params if hasattr(p, "tp_shard")] if n_model > 1 else []
        whole = [p for p in params if not hasattr(p, "tp_shard")] if n_model > 1 else params
        out = _sum_into_grads(whole, extras, None if n_model > 1 else group,
                              [n_model] * len(whole), n_model)
        if split and n > 1:
            _sum_into_grads(split, (), group, [1] * len(split))
        return out


def _sum_into_grads(params, extras, group, divide: Sequence[int],
                    divide_extras: int = 1) -> List[torch.Tensor]:
    """One all-reduce over ``group`` of the params' gradients (zeros where
    missing) and the extras; each param's sum divided by its ``divide``
    entry, the extras' by ``divide_extras``; each .grad set to a view of
    the result; returns the extras."""
    flat = torch.cat(
        [(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1).float()
         for p in params] + [e.detach().reshape(-1).float() for e in extras])
    COUNTS["all_reduce"] += 1
    _all_reduce(flat, group)
    sizes = [p.numel() for p in params] + [flat.numel() - sum(p.numel() for p in params)]
    off = 0
    for d, run in itertools.groupby(zip([*divide, divide_extras], sizes), key=lambda x: x[0]):
        n = sum(k for _, k in run)  # one division for each run of equal divisors
        if d != 1:
            flat[off:off + n] /= d
        off += n
    off = 0
    for p in params:
        k = p.numel()
        p.grad = flat[off:off + k].view_as(p).to(p.dtype)
        off += k
    return [flat[off + i].reshape(e.shape) for i, e in enumerate(extras)]


# ---------------------------------------------------------------------------
# Tensor parallelism: the feedforwards' hidden dimension over the model group
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TPShard:
    """A module's or parameter's share of a model group: the group, its
    size and this rank's index."""

    group: object
    size: int
    index: int


def model_all_reduce(x: torch.Tensor, shard: TPShard) -> torch.Tensor:
    """x (no gradient) summed over the model group, in f32, in x's dtype."""
    COUNTS["all_reduce"] += 1
    return _all_reduce(x.float().clone(), shard.group).to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return model_all_reduce(g, ctx.shard), None


class _ReduceFromModel(torch.autograd.Function):
    """The partial sums of the model group's ranks added; identity backward."""

    @staticmethod
    def forward(ctx, x, shard):
        return model_all_reduce(x, shard)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, shard: TPShard) -> torch.Tensor:
    """The input of a column-split linear (Megatron's f)."""
    return _CopyToModel.apply(x, shard)


def reduce_from_model(x: torch.Tensor, shard: TPShard) -> torch.Tensor:
    """The output of a row-split linear, summed over the shards (Megatron's
    g)."""
    return _ReduceFromModel.apply(x, shard)


def tp_param_shardings(model: torch.nn.Module) -> Dict[str, Optional[int]]:
    """Parameter name -> the dimension split over the model axis, or None
    (replicated): the JAX package's rule (``tp_param_shardings``) in the
    torch layout.  In every ``feed_forward`` module ``in_proj.weight``
    (out, in) splits by its output features (dim 0, JAX's columns of (in,
    out)), ``in_proj.bias`` likewise, ``out_proj.weight`` by its input
    features (dim 1, JAX's rows); everything else, ``out_proj.bias``
    included, is replicated."""
    spec = {}
    for name, p in model.named_parameters():
        dim = None
        if ".feed_forward" in name and p.ndim >= 1:
            if name.endswith("in_proj.weight") or name.endswith("in_proj.bias"):
                dim = 0
            elif name.endswith("out_proj.weight"):
                dim = 1
        spec[name] = dim
    return spec


@torch.no_grad()
def shard_module(model: torch.nn.Module, spec: Dict[str, Optional[int]],
                 mesh: Mesh) -> torch.nn.Module:
    """Slice ``model``'s split parameters in place to this rank's share of
    the model group (its index-th block along the split dimension).  Each
    split parameter gets ``tp_shard`` and ``tp_dim``, and each module whose
    in_proj is split gets ``tp_shard``: the forward (nn/zipformer's
    feedforward) and ScaledAdam read them.  Every rank must hold the same
    full parameters before (``broadcast_module``)."""
    n = mesh.size("model")
    if n == 1:
        return model
    shard = TPShard(mesh.group("model"), n, mesh.index["model"])
    params = dict(model.named_parameters())
    for name, dim in spec.items():
        if dim is None:
            continue
        p = params[name]
        if p.shape[dim] % n:
            raise ValueError(f"{name}: dimension {dim} of {tuple(p.shape)} does not split "
                             f"over {n} ranks")
        size = p.shape[dim] // n
        p.data = p.data.narrow(dim, shard.index * size, size).clone()
        p.tp_shard, p.tp_dim = shard, dim
        if name.endswith("in_proj.weight"):
            model.get_submodule(name[:-len(".in_proj.weight")]).tp_shard = shard
    return model


@torch.no_grad()
def unshard_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The full state dict on every rank: each split parameter gathered
    over its model group along its split dimension (a checkpoint written
    from a tensor-parallel model holds full tensors, as JAX writes global
    arrays)."""
    out = {}
    for name, t in model.state_dict(keep_vars=True).items():
        shard = getattr(t, "tp_shard", None)
        if shard is None:
            out[name] = t.detach().clone()
            continue
        COUNTS["all_gather"] += 1
        out[name] = torch.cat(_all_gather(t.detach(), shard.size, shard.group), dim=t.tp_dim)
    return out


# ---------------------------------------------------------------------------
# Sequence parallelism: the frame axis over the seq group
# ---------------------------------------------------------------------------


def _differentiable(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _gather(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    COUNTS["all_gather"] += 1
    return torch.cat(_all_gather(x, mesh.size("seq"), mesh.group("seq")), dim=dim)


def _own_frames(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """This rank's block of a tensor that holds the whole seq group's
    frames along ``dim``."""
    t = x.shape[dim] // mesh.size("seq")
    return x.narrow(dim, mesh.index["seq"] * t, t)


class _GatherFrames(torch.autograd.Function):
    """Every rank's frames concatenated; the adjoint: the cotangents of
    every rank's copy summed (an all-reduce: every rank holds the whole
    sequence's cotangent of its own copy) and this rank's frames kept."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _gather(x, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        COUNTS["all_reduce"] += 1
        # an f32 sum, in a contiguous copy (NCCL refuses a strided cotangent)
        total = _all_reduce(g.to(torch.float32, memory_format=torch.contiguous_format,
                                 copy=True), ctx.mesh.group("seq"))
        return _own_frames(total, ctx.mesh, ctx.dim).to(g.dtype), None, None


def gather_frames(x: torch.Tensor, mesh: Mesh, dim: int = 1) -> torch.Tensor:
    """Every rank's frames of x concatenated along ``dim`` in rank order:
    the full sequence on every rank of the seq group.  Differentiable."""
    if mesh.size("seq") == 1:
        return x
    if _differentiable(x):
        return _GatherFrames.apply(x, mesh, dim)
    return _gather(x, mesh, dim)


class _ScatterFrames(torch.autograd.Function):
    """This rank's frames of a tensor every rank holds whole; the adjoint:
    the ranks' cotangents of their frames gathered, so that every rank
    holds the whole tensor's cotangent."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _own_frames(x, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g.contiguous(), ctx.mesh, ctx.dim), None, None


def scatter_frames(x: torch.Tensor, mesh: Mesh, dim: int = 1) -> torch.Tensor:
    """This rank's block of frames along ``dim`` of x, a tensor that every
    rank of the seq group holds whole (computed replicated, as the text
    encoder's frame-rate condition is); no collective in the forward, an
    all-gather of the cotangents in the backward.  The frame count must
    split evenly."""
    n = mesh.size("seq")
    if x.shape[dim] % n:
        raise ValueError(f"scatter_frames: {x.shape[dim]} frames over {n} ranks")
    if n == 1:
        return x
    if _differentiable(x):
        return _ScatterFrames.apply(x, mesh, dim)
    return _own_frames(x, mesh, dim)


def _edges(x: torch.Tensor, left: int, right: int, mesh: Mesh):
    """(the ``left`` frames before this rank's, the ``right`` frames after
    them), zeros past the sequence's ends: one all-gather of every rank's
    first ``right`` and last ``left`` frames."""
    n, i = mesh.size("seq"), mesh.index["seq"]
    t = x.shape[1]
    COUNTS["halo"] += 1
    edges = _all_gather(torch.cat([x[:, :right], x[:, t - left:]], dim=1), n,
                        mesh.group("seq"))
    zeros = x.new_zeros
    before = edges[i - 1][:, right:] if i > 0 else zeros(x.shape[0], left, *x.shape[2:])
    after = edges[i + 1][:, :right] if i < n - 1 else zeros(x.shape[0], right, *x.shape[2:])
    return before, after


class _Halo(torch.autograd.Function):
    """The neighbours' edge frames attached; the adjoint: the cotangents of
    the attached frames sent back to the ranks that own them (one
    all-gather of every rank's two edge cotangents) and added to theirs."""

    @staticmethod
    def forward(ctx, x, left, right, mesh):
        ctx.args = (left, right, mesh)
        before, after = _edges(x, left, right, mesh)
        return torch.cat([before, x, after], dim=1)

    @staticmethod
    def backward(ctx, g):
        left, right, mesh = ctx.args
        t = g.shape[1] - left - right
        # the previous rank's "after" cotangent belongs to this rank's
        # first `right` frames, the next rank's "before" cotangent to its
        # last `left` frames: every rank sends both, as _edges sends frames
        from_prev, from_next = _edges(torch.cat([g[:, :left], g[:, left + t:]], dim=1),
                                      right, left, mesh)
        dx = g[:, left:left + t].clone()
        dx[:, :right] += from_prev
        dx[:, t - left:] += from_next
        return dx, None, None, None


def halo(x: torch.Tensor, left: int, right: int, mesh: Mesh) -> torch.Tensor:
    """x (B, t, C), this rank's frames, with the ``left`` frames before
    them (the previous rank's last) and the ``right`` frames after them
    (the next rank's first) attached: (B, left + t + right, C), zeros past
    the sequence's ends, as a convolution with that padding sees the full
    sequence.  The edges travel in one all-gather; differentiable, its
    backward one all-gather of the edges' cotangents."""
    n = mesh.size("seq")
    t = x.shape[1]
    if t < max(left, right):
        raise ValueError(f"halo of {left}/{right} frames from ranks of {t} frames: a rank's "
                         "frames must cover the halo")
    if n == 1:
        zeros = x.new_zeros
        return torch.cat([zeros(x.shape[0], left, *x.shape[2:]), x,
                          zeros(x.shape[0], right, *x.shape[2:])], dim=1)
    if _differentiable(x):
        return _Halo.apply(x, left, right, mesh)
    before, after = _edges(x, left, right, mesh)
    return torch.cat([before, x, after], dim=1)


class _SeqSum(torch.autograd.Function):
    """A statistic summed over the seq group; the cotangent passes through
    (every rank computes the same function of the sum, so each holds the
    whole cotangent of its own share)."""

    @staticmethod
    def forward(ctx, x, group):
        COUNTS["all_reduce"] += 1
        return _all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def seq_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """x summed over the seq group of ``mesh`` (x itself without one): the
    statistics a regularizer takes over the whole sequence.  Under autograd
    the cotangent passes through to this rank's share."""
    if mesh is None or mesh.size("seq") == 1:
        return x
    return _SeqSum.apply(x, mesh.group("seq"))
