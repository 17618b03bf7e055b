"""TTSZipformer backbone, eval forward, in PyTorch.

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

Attention probabilities and normalization statistics are f32 inside;
everything else follows the input dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from zipvoice_tpu_torch.config import ZipformerConfig
from zipvoice_tpu_torch.nn.functional import (
    bias_norm,
    compact_rel_positional_encoding,
    linear,
    swoosh_l,
    swoosh_r,
    timestep_embedding,
)
from zipvoice_tpu_torch.ops.attention import (
    rel_attention_probs,
    rel_attention_probs_apply,
)

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
    def __init__(self, cfg: ZipformerConfig):
        super().__init__()
        self.cfg = cfg
        self.in_proj = _linear(cfg.in_dim, cfg.encoder_dim)
        self.out_proj = _linear(cfg.encoder_dim, cfg.out_dim)
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
# Forward
# ---------------------------------------------------------------------------


def _lin(m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return linear(x, m.weight, m.bias)


def _attention_weights(m: AttentionWeights, cfg: ZipformerConfig,
                       x: torch.Tensor, pos_emb: torch.Tensor,
                       key_padding_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Shared q/k/pos projections, then the probabilities (B, H, T, T) in
    x.dtype through the B1 kernel (plain version on the CPU)."""
    b, t, _ = x.shape
    h, qd, pd = cfg.num_heads, cfg.query_head_dim, cfg.pos_head_dim
    proj = _lin(m.in_proj, x)
    q = proj[..., : qd * h].reshape(b, t, h, qd)
    k = proj[..., qd * h : 2 * qd * h].reshape(b, t, h, qd)
    pq = proj[..., 2 * qd * h :].reshape(b, t, h, pd)
    pe = _lin(m.linear_pos, pos_emb.to(x.dtype)).reshape(2 * t - 1, h, pd)
    return rel_attention_probs(q, k, pq, pe, key_padding_mask, out_dtype=x.dtype)


def _self_attention(m: _InOut, cfg: ZipformerConfig, x: torch.Tensor,
                    probs: torch.Tensor) -> torch.Tensor:
    b, t, _ = x.shape
    h = cfg.num_heads
    v = _lin(m.in_proj, x).reshape(b, t, h, cfg.value_head_dim)
    o = rel_attention_probs_apply(probs.to(x.dtype), v)
    return _lin(m.out_proj, o.reshape(b, t, h * cfg.value_head_dim))


def _nonlin_attention(m: _InOut, x: torch.Tensor,
                      head0: torch.Tensor) -> torch.Tensor:
    """NonlinAttention; head0 (B, T, T) are head 0's probabilities."""
    s, v, y = _lin(m.in_proj, x).chunk(3, dim=-1)
    v = v * torch.tanh(s)
    v = torch.matmul(head0.to(x.dtype), v)
    return _lin(m.out_proj, v * y)


def _conv_module(m: ConvModule, x: torch.Tensor,
                 key_padding_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """GLU gate -> key mask -> depthwise conv over time (SAME) -> SwooshR
    -> out linear."""
    v, s = _lin(m.in_proj, x).chunk(2, dim=-1)
    v = v * torch.sigmoid(s)
    if key_padding_mask is not None:
        v = v.masked_fill(key_padding_mask[:, :, None], 0.0)
    conv = m.depthwise_conv
    out = torch.nn.functional.conv1d(
        v.transpose(1, 2), conv.weight.to(x.dtype), conv.bias.to(x.dtype),
        padding=conv.padding, groups=conv.groups,
    ).transpose(1, 2)
    return _lin(m.out_proj, swoosh_r(out))


def _feedforward(m: _InOut, x: torch.Tensor) -> torch.Tensor:
    return _lin(m.out_proj, swoosh_l(_lin(m.in_proj, x)))


def _bypass(scale: torch.Tensor, src_orig: torch.Tensor,
            src: torch.Tensor) -> torch.Tensor:
    return src_orig + (src - src_orig) * scale.to(src.dtype)


def _encoder_layer(m: EncoderLayer, cfg: ZipformerConfig, src: torch.Tensor,
                   pos_emb: torch.Tensor, time_emb: Optional[torch.Tensor],
                   key_padding_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Zipformer2EncoderLayer eval forward; time_emb: (B, D) or None."""
    src_orig = src
    probs = _attention_weights(m.self_attn_weights, cfg, src, pos_emb,
                               key_padding_mask)
    te = None if time_emb is None else time_emb[:, None, :].to(src.dtype)
    if te is not None:
        src = src + te
    src = src + _feedforward(m.feed_forward1, src)
    src = src + _nonlin_attention(m.nonlin_attention, src, probs[:, 0])
    src = src + _self_attention(m.self_attn1, cfg, src, probs)
    if cfg.use_conv:
        if te is not None:
            src = src + te
        src = src + _conv_module(m.conv_module1, src, key_padding_mask)
    src = src + _feedforward(m.feed_forward2, src)
    src = _bypass(m.bypass_mid.bypass_scale, src_orig, src)
    src = src + _self_attention(m.self_attn2, cfg, src, probs)
    if cfg.use_conv:
        if te is not None:
            src = src + te
        src = src + _conv_module(m.conv_module2, src, key_padding_mask)
    src = src + _feedforward(m.feed_forward3, src)
    src = bias_norm(src, m.norm.bias, m.norm.log_scale)
    return _bypass(m.bypass.bypass_scale, src_orig, src)


def _encoder_stack(m: Encoder, cfg: ZipformerConfig, src: torch.Tensor,
                   time_emb: Optional[torch.Tensor],
                   key_padding_mask: Optional[torch.Tensor]) -> torch.Tensor:
    pos_emb = compact_rel_positional_encoding(src.shape[1], cfg.pos_dim,
                                              device=src.device)
    stack_time_emb = None
    if cfg.use_time_embed:
        if time_emb is None:
            raise ValueError("this Zipformer needs a timestep")
        stack_time_emb = _lin(m.time_emb[1], swoosh_r(time_emb))
    for layer in m.layers:
        src = _encoder_layer(layer, cfg, src, pos_emb, stack_time_emb,
                             key_padding_mask)
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
                               key_padding_mask: Optional[torch.Tensor]):
    ds = cfg.downsampling_factor[stack]
    x = _downsample(m.downsample.bias, src, ds)
    mask = None if key_padding_mask is None else key_padding_mask[:, ::ds]
    x = _encoder_stack(m.encoder, cfg, x, time_emb, mask)
    x = _upsample(x, ds, src.shape[1])
    return _bypass(m.out_combiner.bypass_scale, src, x)


def tts_zipformer_forward(
    m: TTSZipformer,
    x: torch.Tensor,
    t: Optional[torch.Tensor] = None,
    padding_mask: Optional[torch.Tensor] = None,
    guidance_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """TTSZipformer forward.  x: (B, T, in_dim); t: (B,) timestep in [0, 1]
    or None without a time embedding; padding_mask: (B, T) bool, True =
    padded; guidance_scale: (B,) (distill variant only).  -> (B, T, out_dim).
    """
    cfg = m.cfg
    h = _lin(m.in_proj, x)
    time_emb = None
    if t is not None:
        # f32_closers runs the whole time-embed MLP in f32; otherwise the
        # sinusoid is cast to the compute dtype before the MLP
        emb_dtype = torch.float32 if cfg.f32_closers else x.dtype
        time_emb = timestep_embedding(t, cfg.time_embed_dim).to(emb_dtype)
        if guidance_scale is not None:
            gs_emb = timestep_embedding(
                guidance_scale, cfg.guidance_scale_embed_dim
            ).to(emb_dtype)
            time_emb = time_emb + _lin(m.guidance_scale_embed, gs_emb)
        time_emb = _lin(
            m.time_embed[2], swoosh_r(_lin(m.time_embed[0], time_emb))
        ).to(x.dtype)

    for i, enc in enumerate(m.encoders):
        if cfg.downsampling_factor[i] == 1:
            h = _encoder_stack(enc, cfg, h, time_emb, padding_mask)
        else:
            h = _downsampled_encoder_stack(enc, cfg, i, h, time_emb, padding_mask)

    if cfg.f32_closers:
        # the velocity head feeds the cancellation-prone CFG combination
        return _lin(m.out_proj, h.float())
    return _lin(m.out_proj, h)
