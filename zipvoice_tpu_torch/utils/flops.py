"""Analytic FLOPs for model-FLOPs utilization (MFU) on NVIDIA cards.

The PyTorch counterpart of the reference package's ``utils/flops.py``:
every count is the same.  The counts come from the model configuration
(every GEMM's dimensions are static).

Counted: every matmul and conv multiply-add as 2 FLOPs.  Not counted:
softmax, normalization, activations and elementwise adds (under 2 % of
the total).  Attention is counted at its algorithmic cost (the scores
once, three probability contractions); a fused kernel's recomputed scores
are an implementation detail, and MFU is conventionally algorithmic FLOPs
over time.
"""

from __future__ import annotations

from zipvoice_tpu_torch.config import ZipformerConfig, ZipVoiceConfig


def zipformer_fwd_flops(cfg: ZipformerConfig, t: int, batch: int = 1) -> float:
    """Forward GEMM FLOPs of one TTSZipformer call at t frames: three
    feedforwards at (3/4, 1, 5/4) x feedforward_dim, two self-attentions,
    nonlin-attention with hidden 3D/4, two conv modules, shared attention
    weights; per-stack temporal downsampling."""
    d = cfg.encoder_dim
    h, qd, pd, vd = (cfg.num_heads, cfg.query_head_dim, cfg.pos_head_dim,
                     cfg.value_head_dim)
    hidden = 3 * d // 4
    total = 0.0
    for stack in range(cfg.num_stacks):
        ds = cfg.downsampling_factor[stack]
        ts = -(-t // ds)  # ceil
        kernel = cfg.cnn_module_kernel[stack]
        per_layer = 0.0
        # attention weights: in_proj + linear_pos + qk scores + pos scores
        per_layer += 2 * ts * d * (2 * qd + pd) * h
        per_layer += 2 * (2 * ts - 1) * cfg.pos_dim * h * pd
        per_layer += 2 * h * ts * ts * qd
        per_layer += 2 * h * ts * ts * pd
        # nonlin attention: in_proj(3*hidden) + head0 contraction + out
        per_layer += 2 * ts * d * 3 * hidden
        per_layer += 2 * ts * ts * hidden
        per_layer += 2 * ts * hidden * d
        # two self-attentions: in/out proj + probs @ v
        per_layer += 2 * (2 * ts * d * h * vd + 2 * h * ts * ts * vd
                          + 2 * ts * h * vd * d)
        # two conv modules: in_proj(2D) + depthwise + out_proj
        if cfg.use_conv:
            per_layer += 2 * (2 * ts * d * 2 * d + 2 * ts * d * kernel
                              + 2 * ts * d * d)
        # three feedforwards
        for ff in (3 * cfg.feedforward_dim // 4, cfg.feedforward_dim,
                   5 * cfg.feedforward_dim // 4):
            per_layer += 2 * 2 * ts * d * ff
        total += per_layer * cfg.num_encoder_layers[stack]
        if cfg.use_time_embed:
            total += 2 * cfg.time_embed_dim * d  # per-stack time_emb linear
    # backbone in/out projections + time embed MLP
    total += 2 * t * cfg.in_dim * d + 2 * t * d * cfg.out_dim
    if cfg.use_time_embed:
        te = cfg.time_embed_dim
        total += 2 * (te * 2 * te + 2 * te * te)
    return float(total) * batch


def text_encoder_flops(cfg: ZipVoiceConfig, n_tokens: int,
                       batch: int = 1) -> float:
    """text_encoder forward + embedding projection."""
    return zipformer_fwd_flops(cfg.text_encoder_config(), n_tokens, batch) + (
        2 * n_tokens * cfg.text_embed_dim * cfg.text_encoder_dim * batch
    )


def sampler_flops(
    cfg: ZipVoiceConfig,
    t_frames: int,
    n_tokens: int,
    num_step: int,
    cfg_doubling: bool = True,
    batch: int = 1,
) -> float:
    """GEMM FLOPs of one sample() call: text encoder once + num_step Euler
    steps through fm_decoder, batch-doubled under classifier-free guidance
    (distill folds the guidance into an embedding and runs at batch 1)."""
    fm = zipformer_fwd_flops(cfg.fm_decoder_config(), t_frames, batch)
    per_step = fm * (2 if cfg_doubling else 1)
    return text_encoder_flops(cfg, n_tokens, batch) + num_step * per_step


def vocos_fwd_flops(t_frames: int, dim: int = 512, intermediate: int = 1536,
                    num_layers: int = 8, n_fft: int = 1024,
                    feat_dim: int = 100, batch: int = 1) -> float:
    """Vocos vocoder forward: embed conv7 + ConvNeXt stack (dwconv7 +
    pointwise MLP) + ISTFT head, the ISTFT counted as a matrix DFT."""
    total = 2 * t_frames * 7 * feat_dim * dim  # embed conv
    per_layer = (2 * t_frames * 7 * dim               # depthwise conv7
                 + 2 * t_frames * dim * intermediate  # pwconv1
                 + 2 * t_frames * intermediate * dim)  # pwconv2
    total += per_layer * num_layers
    total += 2 * t_frames * dim * (n_fft + 2)  # head linear
    # matmul ISTFT: (n_fft/2+1) complex bins -> n_fft samples per frame,
    # 4 real MACs per complex product
    total += 4 * t_frames * (n_fft // 2 + 1) * n_fft
    return float(total) * batch


def train_step_flops(cfg: ZipVoiceConfig, batch: int, t_frames: int,
                     n_tokens: int) -> float:
    """One CFM training step: text_encoder + fm_decoder forward and backward
    (backward ~ 2x forward GEMMs, the standard dense-layer accounting)."""
    fwd = (text_encoder_flops(cfg, n_tokens, batch)
           + zipformer_fwd_flops(cfg.fm_decoder_config(), t_frames, batch))
    return 3.0 * fwd


# dense (no sparsity) bf16 tensor-core peak a card, TFLOP/s, by a substring
# of torch.cuda.get_device_name: NVIDIA's H100 data sheet (SXM 989, PCIe
# 756).  The SXM part reports itself as "NVIDIA H100 80GB HBM3".
_PEAK_TFLOPS = (
    ("h100 pcie", 756.0),
    ("h100 80gb hbm3", 989.0),
    ("h100 sxm", 989.0),
)


def peak_bf16_tflops(device_name: str) -> float:
    """The card's dense bf16 peak in TFLOP/s; a card not in the table
    raises (there is no default figure)."""
    name = device_name.lower()
    for sub, peak in _PEAK_TFLOPS:
        if sub in name:
            return peak
    raise ValueError(f"no bf16 peak known for {device_name!r}; known: "
                     f"{[sub for sub, _ in _PEAK_TFLOPS]}")


def mfu(flops: float, seconds: float, device_name: str) -> float:
    """Model FLOPs utilization in [0, 1] against the card's bf16 peak."""
    return flops / seconds / (peak_bf16_tflops(device_name) * 1e12)
