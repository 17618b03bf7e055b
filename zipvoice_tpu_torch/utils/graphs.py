"""Captured programs: the port's counterpart of a ``jax.jit`` program.

A ``Program`` is a plain function over tensors with a static key (the
sampler's num_step, guidance scale, t_shift and timestep grid), run
through the ``GraphSet`` of its owner.  The key of one graph is the
program's name and static key, the shapes and dtypes of its inputs (batch,
token bucket, frame bucket, dtype) and the process switches the function
reads while it runs (the fused eval flags).  The weights are not in the
key: each owner (a pipeline) has a set of its own, so a graph captured
over one model, float or int8 (``ops/quant.py``), never replays for
another.

* On the CPU the function runs eagerly on every call.
* On the card the first call of a key runs the function eagerly and
  returns that result.  The eager run fills every host-side cache the
  function reads (the kernel libraries' build and load, the positional
  tables, the DFT bases), so that the capture which follows never builds a
  kernel or copies from pageable host memory.  The same function is then
  captured into a ``torch.cuda.CUDAGraph`` over static copies of the inputs.
  Later calls copy the inputs into the static buffers, replay the graph and
  clone its output.  A failed capture or replay raises; nothing falls back
  to an eager run.

All graphs of a set share one memory pool, one side stream and one lock.
With one pool, replaying one graph may overwrite another graph's static
output, so the copy-in, the replay and the copy-out of a call happen under
the lock, on the side stream, before the lock is released.

The kernel wrappers count their launches in Python (``<wrapper>.launches``).
A capture launches nothing, so its counts are taken back out; each graph
keeps the counts of its capture and adds them on every replay, so the
counters keep meaning device launches.
"""

from __future__ import annotations

import threading
from typing import Callable, NamedTuple, Sequence, Tuple, Union

import torch

from zipvoice_tpu_torch.utils.memo import instance_cache

# graphs kept a set; the least recently used is dropped beyond it
MAX_GRAPHS = 64

Output = Union[torch.Tensor, Tuple[torch.Tensor, ...]]


class GraphKey(NamedTuple):
    name: str
    static: tuple
    inputs: Tuple[Tuple[Tuple[int, ...], torch.dtype], ...]
    flags: tuple


_capture = threading.local()


def hold(t: torch.Tensor) -> torch.Tensor:
    """Return ``t``, kept alive by the graph being captured on this thread,
    if any.  A graph reads memory, not Python objects: a cached device
    table that its cache later evicts would otherwise be freed under it."""
    held = getattr(_capture, "held", None)
    if held is not None:
        held.append(t)
    return t


def launch_counters():
    """{kernel: wrapper} of every kernel wrapper whose ``launches`` counts
    its launches, by the kernel's number (B1-B9)."""
    from zipvoice_tpu_torch.ops import attention as att
    from zipvoice_tpu_torch.ops import convglu, melspec

    return {"B1": att.rel_attention_probs, "B2": att.rel_attention_probs_apply,
            "B3": att.rel_attention_consume_bwd, "B4": att.rel_attention_ds,
            "B5": att.rel_attention_apply, "B6": att.rel_attention_probs_consume,
            "B7": att.rel_attention_head0_consume, "B8": melspec.fused_log_mel,
            "B9": convglu.conv_glu_swoosh_out}


def _tensors(out: Output) -> Tuple[torch.Tensor, ...]:
    return out if isinstance(out, tuple) else (out,)


class _Graph:
    """One key's captured graph, its static inputs and output, the cached
    tensors it reads and the kernel launches one replay makes."""

    def __init__(self):
        self.graph = None
        self.inputs: Tuple[torch.Tensor, ...] = ()
        self.output: Output = ()
        self.held = []
        self.launches = []

    def replay(self, inputs: Sequence[torch.Tensor]) -> Output:
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src)
        self.graph.replay()
        for counter, n in self.launches:
            counter.launches += n
        out = self.output
        return (tuple(t.clone() for t in out) if isinstance(out, tuple)
                else out.clone())


class GraphSet:
    """The captured programs of one owner (a pipeline)."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.captures = 0
        self._lock = threading.Lock()
        self._pool = None
        self._stream = None

    @instance_cache(maxsize=MAX_GRAPHS)
    def _slot(self, key: GraphKey) -> _Graph:
        return _Graph()

    def keys(self):
        """The keys of the graphs held now, least recently used first (on
        the CPU: the keys that would have been captured)."""
        return [k[0][0][1] for k in getattr(self, self._slot._memo_attr, {})]

    def run(self, key: GraphKey, fn: Callable[..., Output],
            inputs: Sequence[torch.Tensor]) -> Output:
        if self.device.type != "cuda":
            self._slot(key)
            return fn(*inputs)
        with self._lock:
            slot = self._slot(key)
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
                self._pool = torch.cuda.graph_pool_handle()
            caller = torch.cuda.current_stream(self.device)
            self._stream.wait_stream(caller)
            with torch.cuda.stream(self._stream):
                if slot.graph is None:
                    out = fn(*inputs)
                    self._capture_into(slot, fn, inputs)
                else:
                    out = slot.replay(inputs)
            caller.wait_stream(self._stream)
        for t in _tensors(out):
            t.record_stream(caller)
        return out

    def _capture_into(self, slot: _Graph, fn, inputs):
        static = tuple(x.clone() for x in inputs)
        counters = list(launch_counters().values())
        before = [c.launches for c in counters]
        graph = torch.cuda.CUDAGraph()
        _capture.held = held = []
        try:
            # thread_local: the server's HTTP threads run the prompt fbank
            # eagerly while a stream handler may capture a new bucket
            with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                                  capture_error_mode="thread_local"):
                out = fn(*static)
        except BaseException:
            # the caching allocator keeps a failed capture's pool marked as
            # recording, so every later capture into it would fail: the
            # next one takes a fresh pool (the graphs held keep theirs)
            self._pool = torch.cuda.graph_pool_handle()
            raise
        finally:
            _capture.held = None
            launched = [c.launches - b for c, b in zip(counters, before)]
            for c, n in zip(counters, launched):
                c.launches -= n
        slot.graph, slot.inputs, slot.output, slot.held = graph, static, out, held
        slot.launches = [(c, n) for c, n in zip(counters, launched) if n]
        self.captures += 1


class Program:
    """A plain function over tensors with its static key: ``fn`` stays
    callable eagerly; calling the program runs it through ``graphs``,
    without autograd.  ``flags`` returns the process switches that ``fn``
    reads."""

    def __init__(self, graphs: GraphSet, name: str, static: tuple,
                 fn: Callable[..., Output], flags: Callable[[], tuple] = tuple):
        self.graphs, self.name, self.static = graphs, name, static
        self.fn, self.flags = fn, flags

    def key(self, inputs: Sequence[torch.Tensor]) -> GraphKey:
        return GraphKey(self.name, self.static,
                        tuple((tuple(x.shape), x.dtype) for x in inputs), self.flags())

    @torch.no_grad()
    def __call__(self, *inputs: torch.Tensor) -> Output:
        return self.graphs.run(self.key(inputs), self.fn, inputs)
