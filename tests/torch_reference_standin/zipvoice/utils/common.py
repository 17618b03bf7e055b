"""``make_pad_mask`` with the reference's signature."""

import torch

from zipvoice_tpu_torch.nn.functional import make_pad_mask as _make_pad_mask


def make_pad_mask(lengths: torch.Tensor, max_len: int = 0) -> torch.Tensor:
    """(B,) lengths -> (B, max(max_len, max(lengths))) bool, True at padding."""
    return _make_pad_mask(lengths, max(max_len, int(lengths.max())))
