"""The port's hand-written kernels against their plain versions, on the card.

Needs an NVIDIA GPU (nvcc for the CUDA library, triton for the Triton
kernel); skipped without one.  Run on the H100 with
``python -m pytest tests/test_torch_kernels.py -o addopts="" -m cuda``
(``-o addopts=""`` drops the repository's xdist defaults).
Tolerance: bf16 inputs and outputs, f32 math on both sides, so the two
differ by output rounding and summation order.  The limit scales with the
output: max-abs error ≤ 2e-2 · max|plain| (one bf16 ulp is at most 2^-7 of a
value, so this allows about 2.5 ulps at the largest output).
"""

import pytest
import torch

from licv_vqa_tpu_torch.models import layers as PL
from licv_vqa_tpu_torch.ops.icv_inject import icv_inject, icv_inject_reference

pytestmark = pytest.mark.cuda
REL_TOL = 2e-2


def _assert_close(got: torch.Tensor, want: torch.Tensor) -> None:
    err = (got.float() - want.float()).abs().max().item()
    assert err <= REL_TOL * want.float().abs().max().item(), err


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("shape,layout", [
    ((1, 384, 4096), "row"), ((3, 1, 4096), "row"), ((3, 1, 4096), "batch"),
    ((3, 1, 4096), "batch1"), ((2, 7, 4000), "row"), ((3, 5, 4096), "per_pos"),
    ((2, 7, 4000), "per_pos"),
])
def test_icv_inject_kernel_matches_plain(dev, shape, layout):
    g = torch.Generator(device=dev).manual_seed(0)
    b, s, d = shape
    h = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    vshape = {"row": (d,), "batch": (b, d), "batch1": (b, 1, d), "per_pos": shape}[layout]
    v = (torch.randn(vshape, generator=g, device=dev) * 0.5).to(torch.bfloat16)
    before = icv_inject.launches
    got = icv_inject(h, v)
    torch.cuda.synchronize()
    assert icv_inject.launches == before + 1
    want = icv_inject_reference(h, v)
    assert got.dtype == torch.bfloat16 and got.shape == h.shape
    _assert_close(got, want)


@pytest.mark.parametrize("b,s,h,pad,side", [
    (1, 384, 32, 50, "left"), (2, 300, 4, 37, "right"), (1, 2048, 32, 300, "left"),
])
def test_flash_kernel_matches_plain(dev, b, s, h, pad, side):
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (
        torch.randn((b, s, h, 128), generator=g, device=dev).to(torch.bfloat16)
        for _ in range(3)
    )
    valid = torch.ones((b, s), dtype=torch.int32, device=dev)
    if side == "left":
        valid[:, :pad] = 0
    else:
        valid[:, s - pad :] = 0
    before = PL.flash_attention.launches
    got = PL.flash_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert PL.flash_attention.launches == before + 1
    want = PL.flash_attention_reference(q, k, v, valid)
    assert torch.isfinite(got).all()  # pad rows too
    _assert_close(got, want)


def test_flash_kernel_takes_strided_views(dev):
    """The (B, S, H, Dh) JAX layout by strides: q/k/v as views into one
    fused (B, S, 3, H, Dh) buffer, no copies."""
    g = torch.Generator(device=dev).manual_seed(2)
    qkv = torch.randn((1, 256, 3, 8, 128), generator=g, device=dev).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    valid = torch.ones((1, 256), dtype=torch.int32, device=dev)
    got = PL.flash_attention(q, k, v, valid)
    want = PL.flash_attention_reference(q, k, v, valid)
    _assert_close(got, want)


def test_flash_kernel_rejects_other_head_dims(dev):
    x = torch.zeros((1, 256, 4, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        PL.flash_attention(x, x, x, torch.ones((1, 256), device=dev))
