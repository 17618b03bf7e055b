"""Numerical sanity checks: the names of the tensors holding inf or nan.

Over a module's parameters or a (nested) dict of tensors, scanned after the
fact on the host; the trainers' --inf-check mode checks between steps.
The JAX package's ``checkify_finite`` (a warning raised from inside a
jitted function) has no counterpart: an eager PyTorch forward can run
these checks on any tensor directly.
"""

from __future__ import annotations

import logging
from typing import List, Mapping, Union

import numpy as np
import torch

Tree = Union[torch.nn.Module, Mapping]


def find_nonfinite(tree: Tree, prefix: str = "") -> List[str]:
    """Dotted names of the floating-point tensors holding inf or nan: a
    module's parameters, or the leaves of a nested dict."""
    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.named_parameters())
    bad = []

    def walk(node, name):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, f"{name}.{k}" if name else str(k))
            return
        if isinstance(node, torch.Tensor):
            if node.is_floating_point() and not bool(torch.isfinite(node).all()):
                bad.append(name)
            return
        arr = np.asarray(node)
        if arr.dtype.kind == "f" and not np.isfinite(arr).all():
            bad.append(name)

    walk(tree, prefix)
    return bad


def warn_nonfinite(tree: Tree, what: str = "tree") -> bool:
    """Log each non-finite tensor; True when there is none."""
    bad = find_nonfinite(tree)
    for name in bad:
        logging.warning("%s: non-finite values in %s", what, name)
    return not bad


def assert_all_finite(tree: Tree, what: str = "tree") -> None:
    bad = find_nonfinite(tree)
    if bad:
        raise FloatingPointError(f"non-finite values in {what}: {bad[:10]}")
