"""Vocos vocoder (mel -> waveform) in PyTorch, on the published weights.

The charactr/vocos-mel-24khz graph: Conv1d embed (k=7) -> LayerNorm -> 8
ConvNeXt blocks (depthwise k=7, LayerNorm, pointwise MLP with exact GELU,
layer-scale gamma) -> final LayerNorm -> Linear(dim, n_fft+2) -> (log
magnitude, phase) -> exp, clip at 1e2 -> centred ISTFT.

Parameters stay in the published torch layout (``load_vocos_params`` only
drops the keys the decoder does not use), so ``pytorch_model.bin`` loads
as it is.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from zipvoice_tpu_torch.audio.stft import istft

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class VocosConfig:
    input_channels: int = 100
    dim: int = 512
    intermediate_dim: int = 1536
    num_layers: int = 8
    n_fft: int = 1024
    hop_length: int = 256


def vocos_config_from_params(p: Mapping[str, torch.Tensor],
                             hop_length: int = 256) -> VocosConfig:
    """The architecture a set of Vocos weights implies (the hop is not in
    the weights and comes from the feature config)."""
    dim, input_channels, _ = p["backbone.embed.weight"].shape
    num_layers = len({k.split(".")[2] for k in p if k.startswith("backbone.convnext.")})
    return VocosConfig(
        input_channels=int(input_channels), dim=int(dim),
        intermediate_dim=int(p["backbone.convnext.0.pwconv1.weight"].shape[0]),
        num_layers=num_layers, n_fft=int(p["head.out.weight"].shape[0]) - 2,
        hop_length=hop_length,
    )


def load_vocos_params(state_dict: Mapping[str, object]) -> Params:
    """Published Vocos state_dict -> the decoder's parameters (torch layout,
    f32 tensors on the CPU).  The torch-side mel extractor and the ISTFT
    window (rebuilt here) are dropped."""
    out: Params = {}
    for key, arr in state_dict.items():
        if key.startswith("feature_extractor.") or key.endswith("istft.window"):
            continue
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.asarray(arr))
        out[key] = t.detach().float().cpu()
    return out


@torch.no_grad()
def init_vocos(cfg: VocosConfig = VocosConfig(),
               generator: Optional[torch.Generator] = None) -> Params:
    """Random weights in the published layout with the JAX package's init
    statistics (Linear/conv U(+-1/sqrt(fan_in)), zero conv biases, unit
    LayerNorms, gamma 1/num_layers)."""

    def uni(shape, bound):
        return torch.empty(shape).uniform_(-bound, bound, generator=generator)

    def ln(prefix):
        return {f"{prefix}.weight": torch.ones(cfg.dim),
                f"{prefix}.bias": torch.zeros(cfg.dim)}

    def lin(prefix, i, o):
        b = 1.0 / math.sqrt(i)
        return {f"{prefix}.weight": uni((o, i), b), f"{prefix}.bias": uni((o,), b)}

    p: Params = {
        "backbone.embed.weight": uni((cfg.dim, cfg.input_channels, 7),
                                     1.0 / math.sqrt(7 * cfg.input_channels)),
        "backbone.embed.bias": torch.zeros(cfg.dim),
        **ln("backbone.norm"),
    }
    for i in range(cfg.num_layers):
        pre = f"backbone.convnext.{i}"
        p[f"{pre}.dwconv.weight"] = uni((cfg.dim, 1, 7), 1.0 / math.sqrt(7))
        p[f"{pre}.dwconv.bias"] = torch.zeros(cfg.dim)
        p.update(ln(f"{pre}.norm"))
        p.update(lin(f"{pre}.pwconv1", cfg.dim, cfg.intermediate_dim))
        p.update(lin(f"{pre}.pwconv2", cfg.intermediate_dim, cfg.dim))
        p[f"{pre}.gamma"] = torch.full((cfg.dim,), 1.0 / cfg.num_layers)
    p.update(ln("backbone.final_layer_norm"))
    p.update(lin("head.out", cfg.dim, cfg.n_fft + 2))
    return p


def _layer_norm(x: torch.Tensor, p: Params, prefix: str, eps: float = 1e-6):
    """LayerNorm over channels of (B, T, C) with f32 statistics."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    wt, bs = (p[f"{prefix}.{n}"].to(x.dtype).float() for n in ("weight", "bias"))
    return (y * wt + bs).to(x.dtype)


def vocos_decode(p: Params, mel: torch.Tensor,
                 cfg: VocosConfig = VocosConfig()) -> torch.Tensor:
    """mel (B, T, n_mels) -> waveform (B, (T-1)*hop) in f32.  Parameters
    are used in mel.dtype."""
    dt = mel.dtype

    def w(key):
        return p[key].to(dt)

    x = F.conv1d(mel.transpose(1, 2), w("backbone.embed.weight"),
                 w("backbone.embed.bias"), padding=3).transpose(1, 2)
    x = _layer_norm(x, p, "backbone.norm")
    for i in range(cfg.num_layers):
        pre = f"backbone.convnext.{i}"
        res = x
        x = F.conv1d(x.transpose(1, 2), w(f"{pre}.dwconv.weight"),
                     w(f"{pre}.dwconv.bias"), padding=3,
                     groups=cfg.dim).transpose(1, 2)
        x = _layer_norm(x, p, f"{pre}.norm")
        x = F.linear(x, w(f"{pre}.pwconv1.weight"), w(f"{pre}.pwconv1.bias"))
        x = F.gelu(x)
        x = F.linear(x, w(f"{pre}.pwconv2.weight"), w(f"{pre}.pwconv2.bias"))
        x = res + x * w(f"{pre}.gamma")
    x = _layer_norm(x, p, "backbone.final_layer_norm")

    out = F.linear(x, w("head.out.weight"), w("head.out.bias"))
    half = cfg.n_fft // 2 + 1
    log_mag, phase = out[..., :half], out[..., half:]
    # ISTFTHead: exp, then clip at 1e2 against exploding magnitudes
    mag = torch.clamp(torch.exp(log_mag), max=1e2)
    return istft(mag * torch.cos(phase), mag * torch.sin(phase), cfg.n_fft,
                 cfg.hop_length, center=True)
