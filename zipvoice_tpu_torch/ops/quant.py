"""int8 linear layers for serving: weight-only or dynamic.

The PyTorch counterpart of the reference package's ``ops/quant.py``.
Every eligible ``nn.Linear`` of a model becomes a ``QuantizedLinear``:
its weight is stored as int8 with a symmetric per-output-channel f32 scale
(``max|w_row| / 127``, floored at 1e-12; rows are output channels in the
(out, in) layout).  ``nn.functional.linear_int8`` computes with it:

* weight-only (``int8``): the product against the int8 weight in the
  compute dtype with an f32 accumulator, times the f32 scale, rounded to
  the compute dtype once;
* dynamic (``int8-dynamic``): the activations are also quantized per row
  and the product runs int8 x int8 -> int32.

The mode lives on the model's ``QuantizedLinear`` modules, not in a
process switch.

Not quantized: linears under 4096 weights, embeddings, the depthwise conv
(neither is a linear here), the time-embed MLPs (they seed every layer's
additive conditioning) and the model-level heads (the fm_decoder's input
and velocity heads, the text encoder's output head, and the two-stream
heads), whose outputs feed the cancellation-prone CFG combination and the
Euler state.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

MODES = ("int8", "int8-dynamic")

# module-path components whose linears stay in float: the time-embed
# conditioning MLPs (and the lookup tables, which are not linears here)
EXCLUDE_KEYS = (
    "embed", "spk_embed", "depthwise_conv",
    "time_embed", "time_emb", "guidance_scale_embed",
)

# exact module-path suffixes of the model-level heads (not the per-layer
# out_projs, whose paths end with e.g. ("self_attn1", "out_proj"))
EXCLUDE_PATH_SUFFIXES: Tuple[Tuple[str, ...], ...] = (
    ("fm_decoder", "out_proj"),
    ("fm_decoder", "in_proj"),
    ("text_encoder", "out_proj"),
    # two-stream (dialog-stereo) heads: module lists keyed "0" / "1"
    ("fm_decoder", "out_proj", "0"),
    ("fm_decoder", "out_proj", "1"),
    ("fm_decoder", "in_proj", "0"),
    ("fm_decoder", "in_proj", "1"),
)


class QuantizedLinear(nn.Module):
    """A linear layer with an int8 weight: buffers ``weight_int8`` (out, in)
    int8 and ``weight_scale`` (out,) f32, the bias (or None), and
    ``dynamic``, whether the activations are quantized too."""

    def __init__(self, weight_int8: torch.Tensor, weight_scale: torch.Tensor,
                 bias: Optional[torch.Tensor], dynamic: bool = False):
        super().__init__()
        self.register_buffer("weight_int8", weight_int8)
        self.register_buffer("weight_scale", weight_scale)
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)
        self.dynamic = dynamic

    @property
    def in_features(self) -> int:
        return self.weight_int8.shape[1]

    @property
    def out_features(self) -> int:
        return self.weight_int8.shape[0]


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 weight, f32 scale) of an (out, in) weight, computed in f32:
    scale = max(max|w_row| / 127, 1e-12), q = clip(round(w / scale))."""
    w = w.detach().float()
    amax = w.abs().amax(dim=1)
    # a tensor divisor: the true quotient on every device (nn/functional.quantize_rows)
    scale = torch.clamp(amax / amax.new_full((), 127.0), min=1e-12)
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def _eligible(path: Tuple[str, ...], lin: nn.Linear, min_elems: int,
              exclude_keys: Sequence[str],
              exclude_path_suffixes: Sequence[Tuple[str, ...]]) -> bool:
    return (lin.weight.numel() >= min_elems
            and not any(k in path for k in exclude_keys)
            and not any(path[len(path) - len(suf):] == tuple(suf)
                        for suf in exclude_path_suffixes))


@torch.no_grad()
def quantize_linear_int8(
    model: nn.Module,
    mode: str = "int8",
    min_elems: int = 4096,
    exclude_keys: Sequence[str] = EXCLUDE_KEYS,
    exclude_path_suffixes: Sequence[Tuple[str, ...]] = EXCLUDE_PATH_SUFFIXES,
) -> nn.Module:
    """Replace each eligible ``nn.Linear`` of ``model`` in place with a
    ``QuantizedLinear`` in ``mode`` (``int8`` or ``int8-dynamic``), on the
    weight's device; returns ``model``."""
    if mode not in MODES:
        raise ValueError(f"unknown quantize mode {mode!r}; one of {MODES}")
    targets = [(name, m) for name, m in model.named_modules()
               if isinstance(m, nn.Linear)
               and _eligible(tuple(name.split(".")), m, min_elems, exclude_keys,
                             exclude_path_suffixes)]
    for name, lin in targets:
        q, scale = quantize_weight(lin.weight)
        bias = None if lin.bias is None else lin.bias.detach().clone()
        parent_name, _, attr = name.rpartition(".")
        parent = model.get_submodule(parent_name) if parent_name else model
        setattr(parent, attr, QuantizedLinear(q, scale, bias, mode == "int8-dynamic"))
    return model


@torch.no_grad()
def cast_quantized(model: nn.Module, dtype: torch.dtype,
                   device: Optional[torch.device] = None) -> nn.Module:
    """The cast policy of a quantized model, in place: int8 weights stay
    int8, ``weight_scale`` stays f32 (it multiplies the f32 accumulator;
    rounding it first would throw away precision the int8 weights keep),
    and every other floating tensor goes to ``dtype``; all move to
    ``device``.  ``nn.Module.to(dtype=...)`` would round the scales."""
    for mod in model.modules():
        for key, p in mod._parameters.items():
            if p is not None:
                mod._parameters[key] = nn.Parameter(
                    p.detach().to(device=device,
                                  dtype=dtype if p.is_floating_point() else None),
                    requires_grad=p.requires_grad)
        for key, b in mod._buffers.items():
            if b is not None:
                keep = key == "weight_scale" or not b.is_floating_point()
                mod._buffers[key] = b.to(device=device, dtype=None if keep else dtype)
    return model


@torch.no_grad()
def dequantize_linear_int8(model: nn.Module) -> nn.Module:
    """Inverse of ``quantize_linear_int8`` up to rounding, in place: each
    ``QuantizedLinear`` becomes an ``nn.Linear`` with weight int8 * scale
    (f32)."""
    for name, m in list(model.named_modules()):
        if not isinstance(m, QuantizedLinear):
            continue
        lin = nn.Linear(m.in_features, m.out_features, bias=m.bias is not None,
                        device=m.weight_int8.device)
        lin.weight.copy_(m.weight_int8.float() * m.weight_scale.float()[:, None])
        if m.bias is not None:
            lin.bias.copy_(m.bias.float())
        parent_name, _, attr = name.rpartition(".")
        setattr(model.get_submodule(parent_name) if parent_name else model, attr, lin)
    return model


def quantized_bytes(model: nn.Module) -> int:
    """Bytes of every parameter and buffer of a (possibly quantized) model."""
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))
