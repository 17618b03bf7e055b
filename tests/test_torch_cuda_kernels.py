"""The CUDA kernels of zipvoice_tpu_torch.ops.attention against their plain
versions on the card.  Marked ``cuda``: without a CUDA card every test
skips.  On a machine with one (and nvcc), run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from zipvoice_tpu_torch.ops import attention as att

pytestmark = pytest.mark.cuda

# f32: reordered sums over |scores| up to ~30; bf16: one unit in the last
# place of the output (probabilities <= 1, outputs scaled by their max)
TOL = {torch.float32: 2e-5, torch.bfloat16: 8e-3}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(gen, t, dtype, b=2, h=4, qd=32, pd=4):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    mask = torch.arange(t, device="cuda")[None, :] >= torch.tensor(
        [t, t - t // 3 - 1], device="cuda")[:, None]
    return rnd(b, t, h, qd), rnd(b, t, h, qd), rnd(b, t, h, pd), rnd(2 * t - 1, h, pd), mask


@pytest.mark.parametrize("t", [1, 40, 577, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rel_probs_kernel_matches_plain(gen, t, dtype):
    q, k, pq, pe, mask = _inputs(gen, t, dtype)
    n = att.rel_attention_probs.launches
    out = att.rel_attention_probs(q, k, pq, pe, mask)
    ref = att.rel_attention_probs_plain(q, k, pq, pe, mask)
    torch.cuda.synchronize()
    assert att.rel_attention_probs.launches == n + 1
    assert out.dtype == dtype and out.shape == (2, 4, t, t)
    assert float((out.float() - ref.float()).abs().max()) <= TOL[dtype]


@pytest.mark.parametrize("t", [1, 40, 577, 1152])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_probs_apply_kernel_matches_plain(gen, t, dtype):
    """Every row is written at any T (1152 = 9 x 128 included)."""
    q, k, pq, pe, mask = _inputs(gen, t, dtype)
    probs = att.rel_attention_probs_plain(q, k, pq, pe, mask)
    v = torch.randn((2, t, 4, 12), generator=gen, device="cuda").to(dtype)
    n = att.rel_attention_probs_apply.launches
    out = att.rel_attention_probs_apply(probs, v)
    ref = att.rel_attention_probs_apply_plain(probs, v)
    torch.cuda.synchronize()
    assert att.rel_attention_probs_apply.launches == n + 1
    scale = max(1.0, float(ref.float().abs().max()))
    assert float((out.float() - ref.float()).abs().max()) <= TOL[dtype] * scale


def test_kernels_refuse_what_they_do_not_take(gen):
    q, k, pq, pe, mask = _inputs(gen, 16, torch.float32)
    with pytest.raises(ValueError):
        att.rel_attention_probs(q, k, pq, pe[:-1], mask)
    with pytest.raises(RuntimeError, match="launch failed"):
        att.rel_attention_probs(q[..., :12], k[..., :12], pq, pe, mask)  # qd=12
    probs = att.rel_attention_probs(q, k, pq, pe, mask)
    with pytest.raises(ValueError):
        att.rel_attention_probs_apply(probs, torch.zeros((2, 16, 4, 12), device="cuda",
                                                         dtype=torch.bfloat16))
