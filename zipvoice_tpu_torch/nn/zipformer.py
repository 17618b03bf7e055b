"""TTSZipformer backbone, eval and training forward, in PyTorch.

Batch-first (B, T, C) everywhere.  The modules hold parameters under the
published state_dict names (Linear weights (out, in), depthwise conv
weights (C, 1, K)), so a released checkpoint loads with strict key checking
and no transposes.  The forward is written as functions over those modules,
one per block of the reference architecture:

* ``_attention_weights``: shared q/k/pos projections, then the probs
  kernel (B1) for every attention layer, at any T;
* ``_self_attention``: the probs @ v kernel (B2) for both SelfAttention
  modules; ``_nonlin_attention`` contracts head 0 with a plain matmul;
* ``_conv_module``, ``_feedforward``, ``_bypass``, ``_encoder_layer``,
  ``_encoder_stack`` (a Python loop over layers), ``_downsample`` /
  ``_upsample`` and ``tts_zipformer_forward``.

The fused eval path (``set_fused_eval``, ``set_fused_conv``; both off by
default, as in the JAX package) serves each layer without gradient through
three more kernels: NonlinAttention recomputes head 0's probabilities
inside its contraction (B7), SelfAttention-1 computes the probabilities
with its own contraction fused (B6) and hands them to SelfAttention-2
(B2), and both ConvolutionModules run their gate, conv, SwooshR and
out-projection as one kernel (B9).  Under autograd the flags have no
effect: those kernels have no backward.

Training passes a ``TrainCtx``: the regularizers (balancers, whitening,
dropout, layerdrop, module skips, const attention, the score failsafe) are
live, and the attention takes the shared-probabilities path: B1 once per
layer without gradient, each of the three consumers contracting it in the
forward and recomputing it in its flash backward (B3).  Without a ctx the
forward is the eval one, differentiable through B1's backward (B4) and
B2's einsum adjoints.  Under autograd each layer of a multi-layer stack is
rematerialized as ``set_remat_policy`` says (``torch.utils.checkpoint``,
selectively for the policies that save part of the layer), and its random
draws come from a seed drawn before the checkpointed call, so the
recompute draws the same values as the forward.  A context's host gates
are the same on every rank of a process group; its device draws (masks,
dropout, layerdrop) are per row and come from the rank's own seed
(``parallel/mesh.fold_rank``), except the positional-encoding dropout,
which is shared by the whole batch as in the JAX package.

``set_diagnostics_tap`` reports every submodule output of a forward by
name (``utils/diagnostics.activation_diagnostics``).

Tensor parallelism (``parallel/mesh.shard_module``): a feedforward whose
hidden dimension is split over a model group runs its local in_proj
columns and out_proj rows between Megatron's pair of collectives, the
out_proj bias added once after the sum, its shared dropout mask drawn at
the full hidden width and sliced.  Everything else stays replicated.

Sequence parallelism (``sequence_parallel``, in eval and in training):
every rank runs the backbone on its block of frames.  The attention
gathers the keys, the values and the key mask over the seq group and takes
B1 and B2 (in training B1 and the consumers' B3, or B1's backward B4) on
its query rows against every key, with the window of the global positional
encoding that its rows touch; each convolution takes its neighbours' edge
frames (``parallel/mesh.halo``); downsampling stays inside a rank, since
every rank's first frame is a multiple of every stack's factor
(``check_sp_frames``).  The collectives have their adjoints as their
backwards.  In training the positional encodings' dropout is drawn on the
whole sequence's encodings before the window is cut, the balancers' and
whitenings' statistics are summed over the seq group, and the per-row
draws fold by the data index, so the ranks of a seq group draw what one
process draws.  A rematerialized layer runs under the mesh it ran under in
the forward, so its recompute repeats the forward's collectives.

Attention probabilities and normalization statistics are f32 inside;
everything else follows the input dtype.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from zipvoice_tpu_torch.config import ZipformerConfig
from zipvoice_tpu_torch.nn import regularizers as reg
from zipvoice_tpu_torch.nn.functional import (
    bias_norm,
    compact_rel_positional_encoding,
    linear,
    linear_int8,
    swoosh_l,
    swoosh_r,
    timestep_embedding,
)
from zipvoice_tpu_torch.ops.attention import (
    REL_PROBS_OP,
    rel_attention_consume,
    rel_attention_head0_consume,
    rel_attention_probs,
    rel_attention_probs_apply,
    rel_attention_probs_consume,
)
from zipvoice_tpu_torch.ops.convglu import conv_glu_swoosh_out
from zipvoice_tpu_torch.ops.quant import QuantizedLinear
from zipvoice_tpu_torch.parallel.mesh import (
    Mesh,
    copy_to_model,
    fold_rank,
    gather_frames,
    halo,
    reduce_from_model,
)

_REMAT_POLICY = "full"
REMAT_POLICIES = ("full", "all", "dots", "xprobs", "xprobs_ff", "names")
# the tensors a layer's named stages produce (the JAX package's
# checkpoint_name tags); attn_probs is the output of B1's entry point
_STAGE_NAMES = ("ff_hidden", "conv_mid", "nonlin_mid")
_NAME_STACK: list = []


def set_remat_policy(name: Optional[str]) -> None:
    """What the backward of a multi-layer stack's layer keeps from its
    forward (the JAX package's policies, same names):

    * ``None`` / ``"full"``: nothing but the layer input; the whole layer
      forward is recomputed in the backward (the default);
    * ``"all"``: no rematerialization; every intermediate the backward
      needs stays alive;
    * ``"dots"``: the matmul outputs are saved, the rest recomputed;
    * ``"xprobs"``: everything is saved but the attention probabilities,
      which B1 recomputes;
    * ``"xprobs_ff"``: as ``xprobs``, also recomputing the named stages
      ff_hidden, conv_mid and nonlin_mid;
    * ``"names"``: only the attention probabilities and the named stages
      are saved.

    The selective policies (all but ``full`` and ``all``) save every
    random draw, so the recompute advances no generator and the draws it
    does make match the forward's.  B1's and B2's entry points are custom
    ops (``ops/attention.py``), so a saved probabilities tensor or B2
    output is not recomputed and its kernel is not launched again."""
    global _REMAT_POLICY
    name = "full" if name is None else name
    if name not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {name!r}; one of {REMAT_POLICIES}")
    _REMAT_POLICY = name


@contextlib.contextmanager
def _named(name: str):
    """Tag the ops run inside as producing the named stage ``name``."""
    _NAME_STACK.append(name)
    try:
        yield
    finally:
        _NAME_STACK.pop()


_DOT_OPS = frozenset(
    getattr(torch.ops.aten, op).default for op in ("mm", "addmm", "bmm", "baddbmm"))


def _remat_policy_fn(policy: str, ctx, func, *args, **kwargs) -> CheckpointPolicy:
    if torch.Tag.nondeterministic_seeded in func.tags:
        return CheckpointPolicy.MUST_SAVE
    tag = "attn_probs" if func is REL_PROBS_OP else (_NAME_STACK[-1] if _NAME_STACK
                                                     else None)
    if policy == "dots":
        save = func in _DOT_OPS
    elif policy == "xprobs":
        save = tag != "attn_probs"
    elif policy == "xprobs_ff":
        save = tag not in ("attn_probs", *_STAGE_NAMES)
    else:  # names
        save = tag in ("attn_probs", *_STAGE_NAMES)
    return CheckpointPolicy.MUST_SAVE if save else CheckpointPolicy.PREFER_RECOMPUTE


def _checkpoint_kwargs() -> Dict:
    if _REMAT_POLICY == "full":
        return {}
    return {"context_fn": functools.partial(
        create_selective_checkpoint_contexts,
        functools.partial(_remat_policy_fn, _REMAT_POLICY))}


# The diagnostics tap: when set, fn(name, tensor) sees every submodule
# output of a forward under its dotted name (eager runs only; the JAX
# package's set_diagnostics_tap).
_DIAG_TAP = None
_DIAG_PREFIX: list = []


def set_diagnostics_tap(fn) -> None:
    """fn(name: str, value: torch.Tensor), or None to disable."""
    global _DIAG_TAP
    _DIAG_TAP = fn


@contextlib.contextmanager
def _diag_scope(name: str):
    """Push a name segment onto the tap prefix (nothing when no tap)."""
    if _DIAG_TAP is None:
        yield
        return
    _DIAG_PREFIX.append(name)
    try:
        yield
    finally:
        _DIAG_PREFIX.pop()


def _tap(name: str, x: torch.Tensor) -> None:
    if _DIAG_TAP is not None:
        _DIAG_TAP(".".join(_DIAG_PREFIX + [name]), x)


# The fused eval path (module docstring).  Off by default, as in the JAX
# package, whose default rests on a TPU measurement; on this card the
# trade-off is measured by chip_smoke.py.
_FUSED_EVAL = False
_FUSED_CONV = False


def set_fused_eval(enabled: bool) -> None:
    """Defer the attention probabilities of each eval layer to
    SelfAttention-1 (B6) and recompute head 0 in NonlinAttention (B7)."""
    global _FUSED_EVAL
    _FUSED_EVAL = bool(enabled)


def set_fused_conv(enabled: bool) -> None:
    """Run each eval ConvolutionModule after its in_proj as one kernel (B9)."""
    global _FUSED_CONV
    _FUSED_CONV = bool(enabled)


def fused_flags() -> Tuple[bool, bool]:
    """(fused eval, fused conv): the switches an eval forward reads, part of
    the key of a graph captured over it."""
    return _FUSED_EVAL, _FUSED_CONV


def _fused(flag: bool, ctx) -> bool:
    return flag and ctx is None and not torch.is_grad_enabled()


# The seq mesh the backbone's eval forward runs under (module docstring);
# None: every rank holds whole sequences.
_SEQ: Optional[Mesh] = None


def check_sp_frames(cfg: ZipformerConfig, num_frames: int, n_seq: int) -> None:
    """Raise unless ``num_frames`` frames split over ``n_seq`` ranks keep
    every stack's downsampling inside a rank (num_frames a multiple of n_seq
    times the largest factor) and every rank's frames in each stack cover
    its convolution's halo."""
    unit = n_seq * max(cfg.downsampling_factor)
    if num_frames % unit:
        raise ValueError(f"sequence parallelism over {n_seq} ranks needs a frame count "
                         f"divisible by {unit} ({n_seq} x the largest downsampling factor "
                         f"{max(cfg.downsampling_factor)}), got {num_frames}")
    for ds, kernel in zip(cfg.downsampling_factor, cfg.cnn_module_kernel):
        local = num_frames // (n_seq * ds)
        if cfg.use_conv and local < kernel // 2:
            raise ValueError(f"sequence parallelism over {n_seq} ranks: a stack at factor "
                             f"{ds} holds {local} frames a rank, shorter than its "
                             f"convolution's halo of {kernel // 2}")


@contextlib.contextmanager
def sequence_parallel(mesh: Mesh):
    """Run the backbone's forwards inside the body (eval, or training under
    autograd) on this rank's frames of the ``seq`` axis of ``mesh``.  The
    fused eval kernels (B6, B7, B9) take square tiles only, so their flags
    must be off."""
    if _FUSED_EVAL or _FUSED_CONV:
        raise ValueError("sequence parallelism runs the unfused eval path: switch "
                         "set_fused_eval / set_fused_conv off")
    with _under_seq(mesh):
        yield


@contextlib.contextmanager
def _under_seq(mesh: Optional[Mesh]):
    global _SEQ
    before, _SEQ = _SEQ, mesh
    try:
        yield
    finally:
        _SEQ = before

# ---------------------------------------------------------------------------
# Modules (parameter containers under the published names)
# ---------------------------------------------------------------------------


def _linear(in_dim: int, out_dim: int, bias: bool = True,
            initial_scale: float = 1.0) -> nn.Linear:
    """nn.Linear tagged with the ScaledLinear initial scale that
    init_zipvoice applies (U(+-1/sqrt(in)) * initial_scale)."""
    lin = nn.Linear(in_dim, out_dim, bias=bias)
    lin.initial_scale = initial_scale
    return lin


class _Scale(nn.Module):
    """A module holding one named parameter vector (bypass_scale, bias)."""

    def __init__(self, name: str, size: int, value: float):
        super().__init__()
        self.register_parameter(name, nn.Parameter(torch.full((size,), value)))


class BiasNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.log_scale = nn.Parameter(torch.tensor(1.0))
        self.bias = nn.Parameter(torch.zeros(dim))


class AttentionWeights(nn.Module):
    """RelPositionMultiheadAttentionWeights."""

    def __init__(self, cfg: ZipformerConfig):
        super().__init__()
        h = cfg.num_heads
        self.in_proj = _linear(
            cfg.encoder_dim, (2 * cfg.query_head_dim + cfg.pos_head_dim) * h,
            initial_scale=cfg.query_head_dim**-0.25,
        )
        self.linear_pos = _linear(cfg.pos_dim, h * cfg.pos_head_dim, bias=False,
                                  initial_scale=0.05)


class _InOut(nn.Module):
    """in_proj / out_proj pair (SelfAttention, FeedforwardModule,
    NonlinAttention)."""

    def __init__(self, d: int, hidden_in: int, hidden_out: int, out_scale: float):
        super().__init__()
        self.in_proj = _linear(d, hidden_in)
        self.out_proj = _linear(hidden_out, d, initial_scale=out_scale)


class ConvModule(nn.Module):
    def __init__(self, d: int, kernel: int):
        super().__init__()
        self.in_proj = _linear(d, 2 * d)
        self.depthwise_conv = nn.Conv1d(d, d, kernel, padding=kernel // 2, groups=d)
        self.out_proj = _linear(d, d, initial_scale=0.05)


class EncoderLayer(nn.Module):
    """Zipformer2EncoderLayer."""

    def __init__(self, cfg: ZipformerConfig, kernel: int):
        super().__init__()
        d, ff = cfg.encoder_dim, cfg.feedforward_dim
        vd = cfg.num_heads * cfg.value_head_dim
        self.bypass = _Scale("bypass_scale", d, 0.5)
        self.bypass_mid = _Scale("bypass_scale", d, 0.5)
        self.self_attn_weights = AttentionWeights(cfg)
        self.self_attn1 = _InOut(d, vd, vd, 0.05)
        self.self_attn2 = _InOut(d, vd, vd, 0.05)
        self.feed_forward1 = _InOut(d, ff * 3 // 4, ff * 3 // 4, 0.1)
        self.feed_forward2 = _InOut(d, ff, ff, 0.1)
        self.feed_forward3 = _InOut(d, ff * 5 // 4, ff * 5 // 4, 0.1)
        hidden = 3 * d // 4
        self.nonlin_attention = _InOut(d, 3 * hidden, hidden, 0.05)
        self.norm = BiasNorm(d)
        if cfg.use_conv:
            self.conv_module1 = ConvModule(d, kernel)
            self.conv_module2 = ConvModule(d, kernel)


class Encoder(nn.Module):
    """Zipformer2Encoder: a stack of layers plus its time-embedding
    projection (Sequential(SwooshR, Linear) -> key ``time_emb.1``)."""

    def __init__(self, cfg: ZipformerConfig, stack: int):
        super().__init__()
        kernel = cfg.cnn_module_kernel[stack]
        self.layers = nn.ModuleList(
            [EncoderLayer(cfg, kernel) for _ in range(cfg.num_encoder_layers[stack])]
        )
        if cfg.use_time_embed:
            self.time_emb = nn.Sequential(
                nn.Identity(), _linear(cfg.time_embed_dim, cfg.encoder_dim)
            )


class DownsampledEncoder(nn.Module):
    def __init__(self, cfg: ZipformerConfig, stack: int):
        super().__init__()
        ds = cfg.downsampling_factor[stack]
        self.downsample = _Scale("bias", ds, 0.0)
        self.encoder = Encoder(cfg, stack)
        self.out_combiner = _Scale("bypass_scale", cfg.encoder_dim, 0.5)


class TTSZipformer(nn.Module):
    """The backbone.  With ``in_dims`` / ``out_dims`` (one pair a stream)
    it is the two-stream variant: shared stacks, ``in_proj`` and
    ``out_proj`` as module lists (keys ``in_proj.0``, ``in_proj.1``, ...),
    and cfg.in_dim / cfg.out_dim unused."""

    def __init__(self, cfg: ZipformerConfig, in_dims: Optional[Tuple[int, int]] = None,
                 out_dims: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.cfg = cfg
        if in_dims is None:
            self.in_proj = _linear(cfg.in_dim, cfg.encoder_dim)
            self.out_proj = _linear(cfg.encoder_dim, cfg.out_dim)
        else:
            self.in_proj = nn.ModuleList([_linear(d, cfg.encoder_dim) for d in in_dims])
            self.out_proj = nn.ModuleList([_linear(cfg.encoder_dim, d) for d in out_dims])
        self.encoders = nn.ModuleList([
            Encoder(cfg, i) if ds == 1 else DownsampledEncoder(cfg, i)
            for i, ds in enumerate(cfg.downsampling_factor)
        ])
        if cfg.use_time_embed:
            t = cfg.time_embed_dim
            # Sequential(Linear, SwooshR, Linear) -> keys time_embed.0/.2
            self.time_embed = nn.Sequential(
                _linear(t, 2 * t), nn.Identity(), _linear(2 * t, t)
            )
        if cfg.use_guidance_scale_embed:
            self.guidance_scale_embed = _linear(
                cfg.guidance_scale_embed_dim, cfg.time_embed_dim, bias=False,
                initial_scale=0.1,
            )


# ---------------------------------------------------------------------------
# Training context
# ---------------------------------------------------------------------------


class TrainCtx:
    """Training-mode context: schedule values and the random draws.

    ``s`` is a schedule dict from train/schedules.zipformer_schedules.
    Gates and seeds are Python values drawn on the host from a numpy
    Generator seeded from ``seed``, the same on every rank; the per-row
    masks are drawn on ``device`` from ``gen``, seeded from the rank's fold
    of ``seed``; ``shared_gen`` (seeded from ``seed``) draws what the whole
    batch shares.  ``child`` gives a layer its own context from a seed, so
    a rematerialized layer redraws exactly what it drew in the forward.
    Subclasses (tests) may override ``gate``."""

    def __init__(self, seed: int, s: Dict, device, layerdrop: float = 0.0):
        self.seed = int(seed)
        self.s = s
        self.device = torch.device(device)
        self.host = np.random.default_rng(self.seed)
        self.layerdrop = layerdrop
        self._gen = None
        self._shared_gen = None
        self._stack = 0

    @property
    def gen(self) -> torch.Generator:
        if self._gen is None:
            self._gen = torch.Generator(device=self.device)
            self._gen.manual_seed(fold_rank(self.seed))
        return self._gen

    @property
    def shared_gen(self) -> torch.Generator:
        if self._shared_gen is None:
            self._shared_gen = torch.Generator(device=self.device)
            self._shared_gen.manual_seed(self.seed)
        return self._shared_gen

    def gate(self, prob: float) -> bool:
        """Apply-with-probability."""
        return bool(self.host.random() < prob)

    def next_seed(self) -> int:
        return int(self.host.integers(0, 2**62))

    def uniform(self, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.gen, device=self.device)

    def child(self, seed: int, layerdrop: float = 0.0) -> "TrainCtx":
        return type(self)(seed, self.s, self.device, layerdrop)


def _maybe_balancer(ctx: Optional[TrainCtx], x, prob, **kw):
    if ctx is None:
        return x
    return reg.balancer(x, ctx.gate(prob), seq=_SEQ, **kw)


def _maybe_whiten(ctx: Optional[TrainCtx], x, limit_key: str, grad_scale: float,
                  num_groups: int = 1, max_prob: float = 0.25):
    if ctx is None:
        return x
    return reg.whiten(x, ctx.gate(max_prob), num_groups=num_groups,
                      whitening_limit=ctx.s[limit_key], grad_scale=grad_scale, seq=_SEQ)


def _maybe_seq_dropout(ctx: Optional[TrainCtx], x, rate):
    if ctx is None:
        return x
    return reg.sequence_dropout(x, ctx.gen, rate)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _lin(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """An ``nn.Linear`` or an int8 ``QuantizedLinear`` (``ops/quant.py``)."""
    if isinstance(m, QuantizedLinear):
        return linear_int8(x, m.weight_int8, m.weight_scale, m.bias, m.dynamic)
    return linear(x, m.weight, m.bias)


def _attention_projections(m: AttentionWeights, cfg: ZipformerConfig, x: torch.Tensor,
                           pos_emb: torch.Tensor, ctx: Optional[TrainCtx] = None):
    """Shared q/k/pos-q/pos-emb projections and their training
    regularizers: (q, k, pq, pe, pen).  The pos-score dropout gates pq
    (the positional scores are linear in pq); pen is the failsafe penalty
    (0.0 when its gate is closed, None in eval)."""
    b, t, _ = x.shape
    h, qd, pd = cfg.num_heads, cfg.query_head_dim, cfg.pos_head_dim
    proj = _lin(m.in_proj, x)
    q = proj[..., : qd * h]
    k = proj[..., qd * h : 2 * qd * h]
    pq = proj[..., 2 * qd * h :].reshape(b, t, h, pd)
    k = _maybe_balancer(ctx, k, 0.025, min_positive=0.4, max_positive=0.6,
                        min_abs=0.0, max_abs=100.0)
    k = _maybe_whiten(ctx, k, "whiten_3", 0.025, num_groups=h)
    q = q.reshape(b, t, h, qd)
    k = k.reshape(b, t, h, qd)
    if _SEQ is not None:
        k = gather_frames(k, _SEQ)
    # pos_emb: 2T-1 rows, or under sequence parallelism the window of the
    # global ones that this rank's rows touch
    pe = _lin(m.linear_pos, pos_emb.to(x.dtype)).reshape(pos_emb.shape[0], h, pd)
    pen = None
    if ctx is not None:
        if ctx.gate(ctx.s["pos_emb_skip_rate"]):
            pq = pq * 0.0
        pen = 1.0e-04 if ctx.gate(0.1) else 0.0
    return q, k, pq, pe, pen


def _attention_weights(m: AttentionWeights, cfg: ZipformerConfig,
                       x: torch.Tensor, pos_emb: torch.Tensor,
                       key_padding_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Shared q/k/pos projections, then the probabilities (B, H, T, T) in
    x.dtype through the B1 kernel (plain version on the CPU); under
    sequence parallelism (B, H, t, T), this rank's t rows against every
    key, key_padding_mask the keys' (B, T)."""
    q, k, pq, pe, _ = _attention_projections(m, cfg, x, pos_emb)
    return rel_attention_probs(q, k, pq, pe, key_padding_mask, out_dtype=x.dtype)


class _EvalAttn:
    """Fused eval attention bundle: the shared projections, probabilities
    not yet computed.  NonlinAttention contracts head 0 by recompute (B7);
    SelfAttention-1 computes the probabilities with its contraction (B6)
    and hands them to SelfAttention-2."""

    __slots__ = ("q", "k", "pq", "pe", "mask")

    def __init__(self, q, k, pq, pe, mask):
        self.q, self.k, self.pq, self.pe, self.mask = q, k, pq, pe, mask


class _SharedAttn:
    """Training attention bundle: the shared projections plus the layer's
    probabilities (computed once by B1, no gradient).  Each consumer
    contracts ``probs`` and recomputes them in its flash backward; ``pen``
    rides on exactly one consumer."""

    __slots__ = ("q", "k", "pq", "pe", "mask", "pen", "probs")

    def __init__(self, q, k, pq, pe, mask, pen, probs):
        self.q, self.k, self.pq, self.pe = q, k, pq, pe
        self.mask, self.pen, self.probs = mask, pen, probs


def _self_attention(m: _InOut, cfg: ZipformerConfig, x: torch.Tensor, attn,
                    ctx: Optional[TrainCtx] = None, use_pen: bool = False):
    """attn: (B, H, T, T) probabilities, a _SharedAttn (training) or an
    _EvalAttn (fused eval: returns (out, probabilities))."""
    b, t, _ = x.shape
    h = cfg.num_heads
    v = _lin(m.in_proj, x).reshape(b, t, h, cfg.value_head_dim)
    if _SEQ is not None:
        v = gather_frames(v, _SEQ)
    if isinstance(attn, _EvalAttn):
        probs, o = rel_attention_probs_consume(attn.q, attn.k, attn.pq, attn.pe, attn.mask,
                                               v, out_dtype=x.dtype)
        return _lin(m.out_proj, o.reshape(b, t, h * cfg.value_head_dim)), probs
    if isinstance(attn, _SharedAttn):
        o = rel_attention_consume(attn.q, attn.k, attn.pq, attn.pe, attn.mask, attn.probs,
                                  v, score_penalty=attn.pen if use_pen else 0.0)
    else:
        o = rel_attention_probs_apply(attn.to(x.dtype), v)
    out = _lin(m.out_proj, o.reshape(b, t, h * cfg.value_head_dim))
    return _maybe_whiten(ctx, out, "whiten_7_5x3", 0.01)


def _nonlin_attention(m: _InOut, x: torch.Tensor, head0,
                      ctx: Optional[TrainCtx] = None, const_gate: bool = False) -> torch.Tensor:
    """NonlinAttention; head0: (B, T, T) head-0 probabilities, a
    _SharedAttn whose head 0 is contracted (with the const-attention branch
    when const_gate), or an _EvalAttn whose head 0 is recomputed (B7)."""
    with _named("nonlin_mid"):
        s, v, y = _lin(m.in_proj, x).chunk(3, dim=-1)
    if ctx is not None:
        s = _maybe_balancer(ctx, s, ctx.s["balancer_prob"],
                            min_positive=ctx.s["nonlin_balancer_min_pos"],
                            max_positive=ctx.s["nonlin_balancer_max_pos"],
                            min_abs=0.5, max_abs=5.0)
    v = _maybe_whiten(ctx, v, "whiten_5", 0.01)
    with _named("nonlin_mid"):
        v = v * torch.tanh(s)
    if _SEQ is not None:  # every key's values (no fused path runs here)
        v = gather_frames(v, _SEQ)
    if isinstance(head0, _EvalAttn):
        a = head0
        v = rel_attention_head0_consume(a.q, a.k, a.pq, a.pe, a.mask, v)
    elif isinstance(head0, _SharedAttn):
        a = head0
        probs0 = a.probs[:, :1]
        if const_gate:
            binary = (probs0 > 0.0).to(probs0.dtype)
            probs0 = binary / torch.clamp(binary.sum(-1, keepdim=True), min=1e-20)
        v = rel_attention_consume(a.q[:, :, :1], a.k[:, :, :1], a.pq[:, :, :1],
                                  a.pe[:, :1], a.mask, probs0, v[:, :, None, :],
                                  const_gate=const_gate)[:, :, 0]
    else:
        v = torch.matmul(head0.to(x.dtype), v)
    with _named("nonlin_mid"):
        vy = v * y
    return _maybe_whiten(ctx, _lin(m.out_proj, vy), "whiten_5x3", 0.01)


def _conv_module(m: ConvModule, x: torch.Tensor,
                 key_padding_mask: Optional[torch.Tensor],
                 ctx: Optional[TrainCtx] = None) -> torch.Tensor:
    """GLU gate -> key mask -> depthwise conv over time (SAME) -> SwooshR
    -> out linear; with the fused conv path, everything after in_proj is
    one kernel (B9), unless the out-projection is int8 (B9 takes a float
    weight)."""
    with _named("conv_mid"):
        proj = _lin(m.in_proj, x)
    if _fused(_FUSED_CONV, ctx) and not isinstance(m.out_proj, QuantizedLinear):
        conv = m.depthwise_conv
        return conv_glu_swoosh_out(proj, conv.weight, conv.bias, key_padding_mask,
                                   m.out_proj.weight, m.out_proj.bias)
    v, s = proj.chunk(2, dim=-1)
    if ctx is not None:
        s = _maybe_balancer(ctx, s, ctx.s["balancer_prob"],
                            min_positive=ctx.s["conv_balancer1_min_pos"], max_positive=1.0,
                            min_abs=1.5, max_abs=ctx.s["conv_balancer1_max_abs"])
    with _named("conv_mid"):
        v = v * torch.sigmoid(s)
        if key_padding_mask is not None:
            v = v.masked_fill(key_padding_mask[:, :, None], 0.0)
        conv = m.depthwise_conv
        padding = conv.padding
        if _SEQ is not None:  # the neighbours' frames in place of the zero padding
            v = halo(v, padding[0], padding[0], _SEQ)
            padding = 0
        out = torch.nn.functional.conv1d(
            v.transpose(1, 2), conv.weight.to(x.dtype), conv.bias.to(x.dtype),
            padding=padding, groups=conv.groups,
        ).transpose(1, 2)
    if ctx is not None:
        out = _maybe_balancer(ctx, out, ctx.s["balancer_prob"],
                              min_positive=ctx.s["conv_balancer2_min_pos"], max_positive=1.0,
                              min_abs=ctx.s["conv_balancer2_min_abs"], max_abs=10.0)
    out = _maybe_whiten(ctx, out, "whiten_7_5", 0.01)
    with _named("conv_mid"):
        out = swoosh_r(out)
    return _lin(m.out_proj, out)


def _feedforward(m: _InOut, x: torch.Tensor, ctx: Optional[TrainCtx] = None) -> torch.Tensor:
    """Linear -> [balancer] -> SwooshL -> [dropout shared over time] ->
    Linear -> [whiten].  With its hidden dimension split over a model group
    (``m.tp_shard``), the local columns and rows between the collectives
    (module docstring); the balancer is per channel, so local is right."""
    shard = getattr(m, "tp_shard", None)
    if shard is not None:
        x = copy_to_model(x, shard)
    with _named("ff_hidden"):
        h = _lin(m.in_proj, x)
    if ctx is not None:
        h = _maybe_balancer(ctx, h, ctx.s["balancer_prob"], min_positive=0.3,
                            max_positive=1.0, min_abs=0.75, max_abs=5.0)
    with _named("ff_hidden"):
        h = swoosh_l(h)
        if ctx is not None:
            width = h.shape[-1]
            h = reg.dropout_shared(h, ctx.gen, ctx.s["dropout"], shared_dim=1,
                                   columns=None if shard is None
                                   else (shard.index * width, shard.size * width))
    if shard is None:
        return _maybe_whiten(ctx, _lin(m.out_proj, h), "whiten_7_5", 0.01)
    out = reduce_from_model(linear(h, m.out_proj.weight, None), shard)
    return _maybe_whiten(ctx, out + m.out_proj.bias.to(out.dtype), "whiten_7_5", 0.01)


def _bypass(scale: torch.Tensor, src_orig: torch.Tensor, src: torch.Tensor,
            ctx: Optional[TrainCtx] = None, skip_rate: Optional[float] = None) -> torch.Tensor:
    """In training the scale is range-limited (gradient clamp, w.p. 0.6)
    and whole sequences may be layer-dropped (scale zeroed) w.p.
    skip_rate."""
    scale = scale.to(src.dtype)
    if ctx is not None:
        scale = reg.limit_param_value(scale, ctx.gate(0.6), ctx.s["bypass_scale_min"], 1.0)
        if skip_rate is not None:
            keep = ctx.uniform((src.shape[0], 1, 1)) > skip_rate
            scale = scale * keep.to(src.dtype)
    return src_orig + (src - src_orig) * scale


def _encoder_layer(m: EncoderLayer, cfg: ZipformerConfig, src: torch.Tensor,
                   pos_emb: torch.Tensor, time_emb: Optional[torch.Tensor],
                   key_padding_mask: Optional[torch.Tensor],
                   ctx: Optional[TrainCtx] = None,
                   keys_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Zipformer2EncoderLayer forward; time_emb: (B, D) or None;
    keys_mask: the attention keys' padding mask where the keys are not the
    layer's own frames (sequence parallelism), else key_padding_mask."""
    src_orig = src
    if keys_mask is None:
        keys_mask = key_padding_mask
    if ctx is not None:
        q, k, pq, pe, pen = _attention_projections(m.self_attn_weights, cfg, src, pos_emb,
                                                   ctx)
        with torch.no_grad():
            probs = rel_attention_probs(q, k, pq, pe, keys_mask, out_dtype=src.dtype)
        attn = _SharedAttn(q, k, pq, pe, keys_mask, pen, probs)
    elif _fused(_FUSED_EVAL, ctx):
        q, k, pq, pe, _ = _attention_projections(m.self_attn_weights, cfg, src, pos_emb)
        attn = _EvalAttn(q, k, pq, pe, key_padding_mask)
    else:
        attn = _attention_weights(m.self_attn_weights, cfg, src, pos_emb, keys_mask)
    if isinstance(attn, torch.Tensor):
        _tap("self_attn_weights", attn)
    elif isinstance(attn, _SharedAttn):
        _tap("self_attn_weights", attn.probs)
    te = None if time_emb is None else time_emb[:, None, :].to(src.dtype)
    if te is not None:
        src = src + te
    ff1 = _feedforward(m.feed_forward1, src, ctx)
    _tap("feed_forward1", ff1)
    src = src + ff1

    # one per-sequence attention-skip mask for nonlin-attn and both self-attns
    attn_keep = None
    if ctx is not None:
        attn_keep = (ctx.uniform((src.shape[0], 1, 1))
                     > ctx.s["attention_skip_rate"]).to(src.dtype)
    if ctx is not None:
        na = _nonlin_attention(m.nonlin_attention, src, attn, ctx,
                               ctx.gate(ctx.s["const_attention_rate"]))
    else:
        na = _nonlin_attention(m.nonlin_attention, src,
                               attn if isinstance(attn, _EvalAttn) else attn[:, 0])
    na = _maybe_balancer(ctx, na, 0.05, min_positive=0.3, max_positive=0.7,
                         min_abs=ctx.s["balancer_na_min_abs"] if ctx else 0.0,
                         max_abs=100.0)
    _tap("nonlin_attention", na)
    src = src + (na if attn_keep is None else na * attn_keep)
    sa = _self_attention(m.self_attn1, cfg, src, attn, ctx, use_pen=True)
    if isinstance(attn, _EvalAttn):
        sa, attn = sa  # SelfAttention-2 contracts the probabilities B6 wrote
        _tap("self_attn_weights", attn)
    _tap("self_attn1", sa)
    src = src + (sa if attn_keep is None else sa * attn_keep)
    if cfg.use_conv:
        if te is not None:
            src = src + te
        cv = _conv_module(m.conv_module1, src, key_padding_mask, ctx)
        if ctx is not None:
            cv = _maybe_seq_dropout(ctx, cv, ctx.s["conv_skip_rate"])
        _tap("conv_module1", cv)
        src = src + cv
    ff2 = _feedforward(m.feed_forward2, src, ctx)
    _tap("feed_forward2", ff2)
    if ctx is not None:
        ff2 = _maybe_balancer(ctx, ff2, 0.05, min_positive=0.3, max_positive=0.7,
                              min_abs=ctx.s["balancer_ff2_min_abs"], max_abs=2.0)
        ff2 = _maybe_seq_dropout(ctx, ff2, ctx.s["ff2_skip_rate"])
    src = src + ff2
    src = _bypass(m.bypass_mid.bypass_scale, src_orig, src, ctx)
    sa = _self_attention(m.self_attn2, cfg, src, attn, ctx)
    _tap("self_attn2", sa)
    src = src + (sa if attn_keep is None else sa * attn_keep)
    if cfg.use_conv:
        if te is not None:
            src = src + te
        cv = _conv_module(m.conv_module2, src, key_padding_mask, ctx)
        if ctx is not None:
            cv = _maybe_seq_dropout(ctx, cv, ctx.s["conv_skip_rate"])
        _tap("conv_module2", cv)
        src = src + cv
    ff3 = _feedforward(m.feed_forward3, src, ctx)
    _tap("feed_forward3", ff3)
    if ctx is not None:
        ff3 = _maybe_balancer(ctx, ff3, 0.05, min_positive=0.3, max_positive=0.7,
                              min_abs=ctx.s["balancer_ff3_min_abs"], max_abs=4.0)
        ff3 = _maybe_seq_dropout(ctx, ff3, ctx.s["ff3_skip_rate"])
    src = src + ff3
    if ctx is not None:
        src = _maybe_balancer(ctx, src, ctx.s["balancer_prob"], min_positive=0.45,
                              max_positive=0.55, min_abs=0.2, max_abs=4.0)
    src = bias_norm(src, m.norm.bias, m.norm.log_scale)
    src = _bypass(m.bypass.bypass_scale, src_orig, src, ctx,
                  skip_rate=ctx.layerdrop if ctx is not None else None)
    if ctx is not None:
        src = _maybe_balancer(ctx, src, ctx.s["balancer_prob"], min_positive=0.45,
                              max_positive=0.55, min_abs=0.1, max_abs=4.0)
        src = _maybe_whiten(ctx, src, "whiten_4x3", 0.01)
    _tap("output", src)
    return src


def _encoder_stack(m: Encoder, cfg: ZipformerConfig, src: torch.Tensor,
                   time_emb: Optional[torch.Tensor],
                   key_padding_mask: Optional[torch.Tensor],
                   ctx: Optional[TrainCtx] = None, stack: int = 0) -> torch.Tensor:
    keys_mask = None
    if _SEQ is None:
        pos_emb = compact_rel_positional_encoding(src.shape[1], cfg.pos_dim,
                                                  device=src.device)
    else:
        t_all = src.shape[1] * _SEQ.size("seq")  # the stack's global frame count
        pos_emb = compact_rel_positional_encoding(t_all, cfg.pos_dim, device=src.device)
        if key_padding_mask is not None:
            keys_mask = gather_frames(key_padding_mask, _SEQ)
    if ctx is not None:  # the whole sequence's dropout mask
        pos_emb = reg.dropout_shared(pos_emb, ctx.shared_gen, 0.15)
    if _SEQ is not None:
        # the window of the 2T-1 positions that this rank's rows [r0, r0 + t)
        # touch
        t, t_all = src.shape[1], pos_emb.shape[0] // 2 + 1
        r0 = t * _SEQ.index["seq"]
        pos_emb = pos_emb[t_all - r0 - t: 2 * t_all - 1 - r0]
    stack_time_emb = None
    if cfg.use_time_embed:
        if time_emb is None:
            raise ValueError("this Zipformer needs a timestep")
        stack_time_emb = _lin(m.time_emb[1], swoosh_r(time_emb))
    remat = _REMAT_POLICY != "all" and len(m.layers) > 1 and torch.is_grad_enabled()
    for i, layer in enumerate(m.layers):
        layer_ctx = None
        if ctx is not None:
            # the layer's draws come from this seed, drawn outside the
            # checkpointed call: its recompute redraws the same values
            layer_ctx = (ctx.next_seed(), ctx.s["layerdrop"][stack][i])

        def run(x, pe, te, mask, layer=layer, layer_ctx=layer_ctx, seq=_SEQ):
            # under the forward's seq mesh in the recompute too, which runs
            # in the backward, outside sequence_parallel
            lctx = None if layer_ctx is None else ctx.child(*layer_ctx)
            with _under_seq(seq):
                return _encoder_layer(layer, cfg, x, pe, te, mask, lctx, keys_mask)

        if remat:
            src = checkpoint(run, src, pos_emb, stack_time_emb, key_padding_mask,
                             use_reentrant=False, **_checkpoint_kwargs())
        else:
            with _diag_scope(f"layer{i}"):
                src = run(src, pos_emb, stack_time_emb, key_padding_mask)
    return src


def _downsample(bias: torch.Tensor, src: torch.Tensor, ds: int) -> torch.Tensor:
    """Softmax-weighted average over groups of ds frames; the last frame
    pads the final group.  (B, T, C) -> (B, ceil(T/ds), C)."""
    b, t, c = src.shape
    d_t = (t + ds - 1) // ds
    pad = d_t * ds - t
    if pad > 0:
        src = torch.cat([src, src[:, -1:, :].expand(b, pad, c)], dim=1)
    weights = torch.softmax(bias.float(), dim=0).to(src.dtype)
    return torch.einsum("btdc,d->btc", src.reshape(b, d_t, ds, c), weights)


def _upsample(src: torch.Tensor, ds: int, out_len: int) -> torch.Tensor:
    """Repeat each frame ds times, then crop to out_len."""
    return src.repeat_interleave(ds, dim=1)[:, :out_len]


def _downsampled_encoder_stack(m: DownsampledEncoder, cfg: ZipformerConfig,
                               stack: int, src: torch.Tensor,
                               time_emb: Optional[torch.Tensor],
                               key_padding_mask: Optional[torch.Tensor],
                               ctx: Optional[TrainCtx] = None):
    ds = cfg.downsampling_factor[stack]
    x = _downsample(m.downsample.bias, src, ds)
    mask = None if key_padding_mask is None else key_padding_mask[:, ::ds]
    x = _encoder_stack(m.encoder, cfg, x, time_emb, mask, ctx, stack)
    x = _upsample(x, ds, src.shape[1])
    return _bypass(m.out_combiner.bypass_scale, src, x, ctx)


def _time_embedding(m: TTSZipformer, t: torch.Tensor, dtype: torch.dtype,
                    guidance_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (B, time_embed_dim) embedding of t (plus the guidance scale's
    in the distill variant), in ``dtype``."""
    cfg = m.cfg
    # f32_closers runs the whole time-embed MLP in f32; otherwise the
    # sinusoid is cast to the compute dtype before the MLP
    emb_dtype = torch.float32 if cfg.f32_closers else dtype
    time_emb = timestep_embedding(t, cfg.time_embed_dim).to(emb_dtype)
    if guidance_scale is not None:
        gs_emb = timestep_embedding(guidance_scale, cfg.guidance_scale_embed_dim).to(emb_dtype)
        time_emb = time_emb + _lin(m.guidance_scale_embed, gs_emb)
    return _lin(m.time_embed[2], swoosh_r(_lin(m.time_embed[0], time_emb))).to(dtype)


def _stack_forward(m: TTSZipformer, i: int, h: torch.Tensor, time_emb, padding_mask,
                   ctx: Optional[TrainCtx] = None) -> torch.Tensor:
    """Stack i of the backbone (downsampled, or at the full frame rate)."""
    enc, cfg = m.encoders[i], m.cfg
    if cfg.downsampling_factor[i] == 1:
        return _encoder_stack(enc, cfg, h, time_emb, padding_mask, ctx, i)
    return _downsampled_encoder_stack(enc, cfg, i, h, time_emb, padding_mask, ctx)


def tts_zipformer_forward(
    m: TTSZipformer,
    x: torch.Tensor,
    t: Optional[torch.Tensor] = None,
    padding_mask: Optional[torch.Tensor] = None,
    guidance_scale: Optional[torch.Tensor] = None,
    ctx: Optional[TrainCtx] = None,
    stream: int = 0,
) -> torch.Tensor:
    """TTSZipformer forward.  x: (B, T, in_dim); t: (B,) timestep in [0, 1]
    or None without a time embedding; padding_mask: (B, T) bool, True =
    padded; guidance_scale: (B,) (distill variant only); ctx: training
    context or None (eval); stream: the projection pair of a two-stream
    backbone, flipped to the other one when x's width is not its input
    width (ignored otherwise).  -> (B, T, out_dim).
    """
    cfg = m.cfg
    in_proj, out_proj = m.in_proj, m.out_proj
    if isinstance(in_proj, nn.ModuleList):
        if x.shape[-1] != in_proj[stream].in_features:
            stream = 1 - stream
        in_proj, out_proj = in_proj[stream], out_proj[stream]
    h = _lin(in_proj, x)
    time_emb = None if t is None else _time_embedding(m, t, x.dtype, guidance_scale)
    for i in range(len(m.encoders)):
        h = _stack_forward(m, i, h, time_emb, padding_mask, ctx)

    if cfg.f32_closers:
        # the velocity head feeds the cancellation-prone CFG combination
        return _lin(out_proj, h.float())
    return _lin(out_proj, h)
