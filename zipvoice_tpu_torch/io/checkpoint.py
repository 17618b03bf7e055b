"""Checkpoint loading for the port, and the weight bridge from the JAX tree.

The published ZipVoice checkpoints are flat torch state_dicts keyed by
dotted module paths (a ``.pt`` holds ``{"model": state_dict, ...}`` or a
bare state_dict; DDP adds a ``module.`` prefix).  The port's modules use
exactly those names and torch layouts, so loading is a strict
``load_state_dict``.

``from_jax_params`` takes the JAX package's nested parameter tree (as
numpy arrays) and undoes its two layout changes:

* Linear ``weight``: (in, out) -> (out, in);
* depthwise conv ``weight``: (K, C) -> (C, 1, K);
* a 3-D conv ``weight`` (BigVGAN): (K, Cin, Cout) -> (Cout, Cin, K), and
  the transposed convs' (K, Cout, Cin) -> (Cin, Cout, K), the same axis
  reversal.

The token and speaker embeddings (``embed``, ``spk_embed``) are
nn.Embedding tables and are not transposed; ``guidance_scale_embed`` is a
Linear and is.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping, Union

import numpy as np
import torch
from torch import nn

_EMBEDDING_MODULES = ("embed", "spk_embed")


def _strip_module_prefix(key: str) -> str:
    return key[len("module."):] if key.startswith("module.") else key


def load_torch_state_dict(path: Union[str, Path]) -> Dict[str, np.ndarray]:
    """Load a torch ``.pt`` / ``.safetensors`` checkpoint into numpy,
    unwrapping ``{"model": sd}`` and stripping the DDP ``module.`` prefix."""
    path = Path(path)
    if path.suffix == ".safetensors":
        from safetensors.numpy import load_file

        return {_strip_module_prefix(k): v for k, v in load_file(str(path)).items()}
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "model" in ckpt and isinstance(ckpt["model"], dict):
        sd = ckpt["model"]
    else:
        sd = ckpt
    out = {}
    for k, v in sd.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        out[_strip_module_prefix(k)] = np.asarray(v)
    return out


def load_into(module: nn.Module, state_dict: Mapping[str, object]) -> nn.Module:
    """Load a flat state_dict (numpy arrays or tensors) into ``module`` with
    strict key checking.  The tensors are assigned, not copied, so the
    module may be built on the meta device and takes their (CPU) device."""
    sd = {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
          for k, v in state_dict.items()}
    module.load_state_dict(sd, strict=True, assign=True)
    return module


def from_jax_params(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX nested parameter tree -> flat torch-layout state_dict."""
    flat: Dict[str, torch.Tensor] = {}

    def walk(node, name):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, f"{name}.{k}" if name else str(k))
            return
        arr = np.asarray(node, dtype=np.float32)
        parts = name.split(".")
        if name.endswith("depthwise_conv.weight") and arr.ndim == 2:
            arr = np.transpose(arr)[:, None, :]  # (K, C) -> (C, 1, K)
        elif parts[-1] == "weight" and arr.ndim == 3:
            arr = np.transpose(arr, (2, 1, 0))
        elif (parts[-1] == "weight" and arr.ndim == 2
              and not (len(parts) >= 2 and parts[-2] in _EMBEDDING_MODULES)):
            arr = np.transpose(arr)  # (in, out) -> (out, in)
        flat[name] = torch.from_numpy(np.array(arr))  # a writable copy

    walk(tree, prefix)
    return flat
