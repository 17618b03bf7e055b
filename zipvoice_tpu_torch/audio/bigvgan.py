"""BigVGAN v2 vocoder (mel -> waveform) in PyTorch, on the published weights.

The nvidia/bigvgan_v2_24khz_100band_256x generator:

* conv_pre Conv1d(n_mels, C0=1536, k=7);
* 6 upsampling stages: ConvTranspose1d(C, C/2, k=2*rate, rate) with rates
  (4, 4, 2, 2, 2, 2), each followed by 3 AMP resblocks (kernels 3/7/11,
  dilations (1, 3, 5)) whose outputs are averaged;
* every activation is an anti-aliased snake-beta: 2x upsampling through a
  Kaiser-windowed sinc filter, snakebeta(x) = x + 1/e^beta sin^2(e^alpha x),
  2x filtered downsampling;
* activation_post, conv_post Conv1d(C_last, 1, k=7), clamp to [-1, 1] (v2:
  no bias at the end, no tanh).

The module works in (B, C, T) with torch's weight layouts.  The published
checkpoint stores weight-normed convs (weight_g / weight_v) and the snake
parameters under ``.act.``; ``load_bigvgan_params`` fuses the former
(w = g v / ||v||) and drops the latter's ``act.``, giving this module's
state_dict.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from zipvoice_tpu_torch.utils.graphs import hold

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class BigVGANConfig:
    num_mels: int = 100
    upsample_initial_channel: int = 1536
    upsample_rates: Tuple[int, ...] = (4, 4, 2, 2, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (8, 8, 4, 4, 4, 4)
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilations: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3
    snake_logscale: bool = True
    # the alias-free activation's filter taps
    aa_kernel_size: int = 12
    use_tanh_at_final: bool = False
    use_bias_at_final: bool = False

    @property
    def hop_length(self) -> int:
        return math.prod(self.upsample_rates)


# ---------------------------------------------------------------------------
# Alias-free activation
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def kaiser_sinc_filter(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """Kaiser-windowed sinc low-pass with DC gain 1 (alias-free-torch's
    kaiser_sinc_filter1d), f32."""
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    a = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    if kernel_size % 2 == 0:
        t = np.arange(-half_size, half_size) + 0.5
    else:
        t = np.arange(kernel_size) - half_size
    f = 2 * cutoff * np.kaiser(kernel_size, beta) * np.sinc(2 * cutoff * t)
    return (f / f.sum()).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _aa_filter(kernel_size: int, channels: int, gain: float, device: torch.device,
               dtype: torch.dtype) -> torch.Tensor:
    """The ratio-2 low-pass times ``gain`` as a depthwise weight (C, 1, K)."""
    f = gain * kaiser_sinc_filter(0.25, 0.3, kernel_size)
    w = torch.from_numpy(np.ascontiguousarray(f)).to(device=device, dtype=dtype)
    return w.view(1, 1, kernel_size).repeat(channels, 1, 1)


def _up2(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """UpSample1d(ratio=2): replicate pad, transposed depthwise conv with
    the filter at gain 2, crop.  (B, C, T) -> (B, C, 2T)."""
    c = x.shape[1]
    pad = kernel_size // 2 - 1
    pad_left = 2 * pad + (kernel_size - 2) // 2
    pad_right = 2 * pad + (kernel_size - 1) // 2
    w = hold(_aa_filter(kernel_size, c, 2.0, x.device, x.dtype))
    y = F.conv_transpose1d(F.pad(x, (pad, pad), mode="replicate"), w, stride=2, groups=c)
    return y[..., pad_left:y.shape[-1] - pad_right]


def _down2(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """DownSample1d(ratio=2): replicate pad, depthwise low-pass at stride
    2.  (B, C, 2T) -> (B, C, T)."""
    c = x.shape[1]
    w = hold(_aa_filter(kernel_size, c, 1.0, x.device, x.dtype))
    left = kernel_size // 2 - int(kernel_size % 2 == 0)
    xp = F.pad(x, (left, kernel_size // 2), mode="replicate")
    return F.conv1d(xp, w, stride=2, groups=c)


class SnakeBeta(nn.Module):
    """x + 1/(e^beta + 1e-9) sin^2(e^alpha x), per channel (log-scale
    parameters), inside the alias-free 2x up / down sampling."""

    def __init__(self, channels: int, aa_kernel_size: int = 12, logscale: bool = True):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))
        self.aa_kernel_size = aa_kernel_size
        self.logscale = logscale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = torch.exp(self.alpha) if self.logscale else self.alpha
        b = torch.exp(self.beta) if self.logscale else self.beta
        a, b = a.to(x.dtype)[None, :, None], b.to(x.dtype)[None, :, None]
        y = _up2(x, self.aa_kernel_size)
        y = y + (1.0 / (b + 1e-9)) * torch.square(torch.sin(a * y))
        return _down2(y, self.aa_kernel_size)


class AMPBlock1(nn.Module):
    """For each dilation d: act -> conv(d) -> act -> conv(1), a residual
    after each pair."""

    def __init__(self, channels: int, kernel_size: int, dilations: Sequence[int],
                 cfg: BigVGANConfig):
        super().__init__()
        k = kernel_size
        self.convs1 = nn.ModuleList([
            nn.Conv1d(channels, channels, k, dilation=d, padding=(k - 1) * d // 2)
            for d in dilations])
        self.convs2 = nn.ModuleList([
            nn.Conv1d(channels, channels, k, padding=(k - 1) // 2) for _ in dilations])
        self.activations = nn.ModuleList([
            SnakeBeta(channels, cfg.aa_kernel_size, cfg.snake_logscale)
            for _ in range(2 * len(dilations))])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for j, (c1, c2) in enumerate(zip(self.convs1, self.convs2)):
            xt = c2(self.activations[2 * j + 1](c1(self.activations[2 * j](x))))
            x = x + xt
        return x


class BigVGAN(nn.Module):
    """The generator: mel (B, n_mels, T) -> waveform (B, 1, T * hop)."""

    def __init__(self, cfg: BigVGANConfig = BigVGANConfig()):
        super().__init__()
        self.cfg = cfg
        c0 = cfg.upsample_initial_channel
        self.conv_pre = nn.Conv1d(cfg.num_mels, c0, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (r, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            cin, cout = c0 // 2**i, c0 // 2 ** (i + 1)
            self.ups.append(nn.ModuleList([
                nn.ConvTranspose1d(cin, cout, k, r, padding=(k - r) // 2)]))
            for kr, dil in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilations):
                self.resblocks.append(AMPBlock1(cout, kr, dil, cfg))
        c_last = c0 // 2 ** len(cfg.upsample_rates)
        self.activation_post = SnakeBeta(c_last, cfg.aa_kernel_size, cfg.snake_logscale)
        self.conv_post = nn.Conv1d(c_last, 1, 7, padding=3, bias=cfg.use_bias_at_final)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        nk = len(self.cfg.resblock_kernel_sizes)
        x = self.conv_pre(mel)
        for i, up in enumerate(self.ups):
            x = up[0](x)
            acc = self.resblocks[i * nk](x)
            for j in range(1, nk):
                acc = acc + self.resblocks[i * nk + j](x)
            x = acc / nk
        x = self.conv_post(self.activation_post(x))
        return torch.tanh(x) if self.cfg.use_tanh_at_final else torch.clamp(x, -1.0, 1.0)


def bigvgan_decode(model: BigVGAN, mel: torch.Tensor) -> torch.Tensor:
    """mel (B, T, n_mels) -> waveform (B, T * hop) in the model's dtype."""
    return model(mel.transpose(1, 2))[:, 0]


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def _fuse_weight_norm(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """w = g v / ||v||, the norm over every dim but 0 (torch weight_norm),
    computed in f64."""
    v64 = v.double()
    norm = torch.sqrt(torch.sum(v64 ** 2, dim=tuple(range(1, v.ndim)), keepdim=True))
    return (g.double() * v64 / norm).float()


def load_bigvgan_params(state_dict: Mapping[str, object]) -> Params:
    """The published generator's state_dict (weight-normed, snake
    parameters at ``activations.N.act.alpha``) -> BigVGAN's state_dict,
    f32 tensors on the CPU in torch layouts."""
    sd = {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v)))
          for k, v in state_dict.items()}
    out: Params = {}
    for k, v in sd.items():
        if k.endswith("weight_g"):
            continue
        if k.endswith("weight_v"):
            base = k[: -len("weight_v")]
            out[base + "weight"] = _fuse_weight_norm(sd[base + "weight_g"], v)
        else:
            out[k.replace(".act.", ".")] = v.float()
    return out


def bigvgan_config_from_params(p: Mapping[str, torch.Tensor]) -> BigVGANConfig:
    """The architecture a set of weights implies: widths, rates (kernel =
    2 x rate) and kernels from the shapes; the dilations of each resblock
    are the first len(convs1) of (1, 3, 5), and the filter taps the
    default (neither is in the weights)."""
    c0, num_mels, _ = p["conv_pre.weight"].shape
    ups = sorted({int(k.split(".")[1]) for k in p if k.startswith("ups.")})
    up_k = tuple(int(p[f"ups.{i}.0.weight"].shape[2]) for i in ups)
    nk_total = len({int(k.split(".")[1]) for k in p if k.startswith("resblocks.")})
    nk = nk_total // len(ups)
    res_k = tuple(int(p[f"resblocks.{j}.convs1.0.weight"].shape[2]) for j in range(nk))
    n_dil = [len({k.split(".")[3] for k in p if k.startswith(f"resblocks.{j}.convs1.")})
             for j in range(nk)]
    return BigVGANConfig(
        num_mels=int(num_mels), upsample_initial_channel=int(c0),
        upsample_rates=tuple(k // 2 for k in up_k), upsample_kernel_sizes=up_k,
        resblock_kernel_sizes=res_k,
        resblock_dilations=tuple((1, 3, 5)[:n] for n in n_dil),
        use_bias_at_final="conv_post.bias" in p,
    )


def build_bigvgan(params: Mapping[str, torch.Tensor],
                  cfg: Optional[BigVGANConfig] = None) -> BigVGAN:
    """A BigVGAN holding ``params`` (its own state_dict's keys), on their
    device; the config from the weights unless given."""
    from zipvoice_tpu_torch.io.checkpoint import load_into

    with torch.device("meta"):
        model = BigVGAN(cfg or bigvgan_config_from_params(params))
    return load_into(model, dict(params)).eval()


@torch.no_grad()
def init_bigvgan(cfg: BigVGANConfig = BigVGANConfig(),
                 generator: Optional[torch.Generator] = None) -> BigVGAN:
    """Random weights on the CPU: convs U(+-1/sqrt(fan_in)) (weights and
    biases), snake parameters N(0, 0.1^2)."""
    with torch.device("meta"):
        model = BigVGAN(cfg)
    model = model.to_empty(device="cpu")
    for name, p in model.named_parameters():
        if name.endswith(("alpha", "beta")):
            p.normal_(generator=generator).mul_(0.1)
        else:
            w = model.get_parameter(name.rsplit(".", 1)[0] + ".weight")
            bound = 1.0 / math.sqrt(w.shape[1] * w.shape[2])
            p.uniform_(-bound, bound, generator=generator)
    return model.eval()
