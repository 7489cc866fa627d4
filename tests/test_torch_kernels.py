"""The port's hand-written kernels against their plain versions, on the card.

Needs an NVIDIA GPU (nvcc for the CUDA library, triton for the Triton
kernels); skipped without one.  Run on the H100 with
``python -m pytest tests/test_torch_kernels.py -o addopts="" -m cuda``
(``-o addopts=""`` drops the repository's xdist defaults).
Tolerance: f32 math on both sides, so the two differ by output rounding
(bf16 outputs) and summation order.  The limit scales with the output:
max-abs error ≤ 2e-2 · max|plain| for bf16 outputs (one bf16 ulp is at most
2^-7 of a value, so this allows about 2.5 ulps at the largest output) and
≤ 1e-4 · max|plain| for the f32 KL outputs, which differ only by summation
order (they read about 1e-6): a KL kernel that rounded through bf16 reads
above it.
"""

import pytest
import torch

from licv_vqa_tpu_torch.models import layers as PL
from licv_vqa_tpu_torch.ops import masked_kl_kernel as K
from licv_vqa_tpu_torch.ops.icv_inject import (
    icv_inject,
    icv_inject_backward,
    icv_inject_backward_reference,
    icv_inject_reference,
)

pytestmark = pytest.mark.cuda
REL_TOL = 2e-2
F32_REL_TOL = 1e-4


def _assert_close(got: torch.Tensor, want: torch.Tensor, tol: float = REL_TOL) -> None:
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), err


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


def test_flash_kernel_refuses_inputs_that_require_grad(dev):
    """The kernel has no backward: under autograd it raises instead of
    returning an output that would drop attention from the gradient."""
    x = torch.zeros((1, 256, 4, 128), dtype=torch.bfloat16, device=dev, requires_grad=True)
    valid = torch.ones((1, 256), device=dev)
    with pytest.raises(RuntimeError, match="Queue 2 item 2"):
        PL.flash_attention(x, x, x, valid)
    with torch.no_grad():  # the teacher's case
        assert torch.isfinite(PL.flash_attention(x, x, x, valid)).all()


@pytest.mark.parametrize("shape,layout", [
    ((2, 64, 4096), "row"), ((2, 64, 4096), "batch"), ((2, 64, 4096), "batch1"),
    ((2, 64, 4096), "per_pos"), ((1, 512, 4096), "row"), ((2, 7, 4000), "per_pos"),
])
def test_icv_inject_backward_kernel_matches_plain(dev, shape, layout):
    g = torch.Generator(device=dev).manual_seed(3)
    b, s, d = shape
    h = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    gout = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    vshape = {"row": (d,), "batch": (b, d), "batch1": (b, 1, d), "per_pos": shape}[layout]
    v = (torch.randn(vshape, generator=g, device=dev) * 0.5).to(torch.bfloat16)
    before = icv_inject_backward.launches
    dh, dv = icv_inject_backward(h, v, gout)
    torch.cuda.synchronize()
    assert icv_inject_backward.launches == before + 1
    want_dh, want_dv = icv_inject_backward_reference(h, v, gout)
    assert dh.dtype == torch.bfloat16 and dv.dtype == torch.bfloat16 and dv.shape == vshape
    _assert_close(dh, want_dh)
    _assert_close(dv, want_dv)


def test_icv_inject_autograd_launches_both_kernels(dev):
    """``icv_inject`` under autograd: the forward kernel, then the backward
    kernel, with the shift gradient reduced to the shift's shape and dtype."""
    g = torch.Generator(device=dev).manual_seed(4)
    h = torch.randn((2, 64, 4096), generator=g, device=dev).to(torch.bfloat16).requires_grad_()
    icv = (torch.randn((4096,), generator=g, device=dev) * 0.5).requires_grad_()
    gout = torch.randn((2, 64, 4096), generator=g, device=dev).to(torch.bfloat16)
    f0, b0 = icv_inject.launches, icv_inject_backward.launches
    dh, dv = torch.autograd.grad(icv_inject(h, icv.to(torch.bfloat16)), (h, icv), gout)
    assert (icv_inject.launches, icv_inject_backward.launches) == (f0 + 1, b0 + 1)
    hr, vr = h.detach().requires_grad_(), icv.detach().requires_grad_()
    want_dh, want_dv = torch.autograd.grad(
        icv_inject_reference(hr, vr.to(torch.bfloat16)), (hr, vr), gout
    )
    assert dv.dtype == torch.float32 and dv.shape == (4096,)
    _assert_close(dh, want_dh)
    _assert_close(dv, want_dv)


@pytest.mark.parametrize("n,v", [(128, 32000), (512, 32000), (15, 257)])
def test_masked_kl_kernels_match_plain(dev, n, v):
    g = torch.Generator(device=dev).manual_seed(5)
    stu = torch.randn((n, v), generator=g, device=dev) * 3
    tea = torch.randn((n, v), generator=g, device=dev) * 3
    w = (torch.rand((n,), generator=g, device=dev) < 0.7).float()
    gw = w / w.sum()
    f0, b0 = K.rowwise_kl_forward.launches, K.rowwise_kl_backward.launches
    got = K.rowwise_kl_forward(stu, tea, 1e-6)
    want = K.rowwise_kl_reference(stu, tea, 1e-6)
    for a, b in zip(got, want):
        _assert_close(a, b, F32_REL_TOL)
    dgot = K.rowwise_kl_backward(stu, tea, got[1], got[2], gw, 1e-6)
    dwant = K.rowwise_kl_backward_reference(stu, tea, want[1], want[2], gw, 1e-6)
    torch.cuda.synchronize()
    assert (K.rowwise_kl_forward.launches, K.rowwise_kl_backward.launches) == (f0 + 1, b0 + 1)
    for a, b in zip(dgot, dwant):
        _assert_close(a, b, F32_REL_TOL)


def test_masked_kl_divergence_pallas_matches_xla_with_gradients(dev):
    """The whole loss on the card: ``impl="pallas"`` (both kernels through
    the autograd Function) against ``impl="xla"``, value and the gradients
    with respect to both logit tensors and a learnable temperature."""
    from licv_vqa_tpu_torch.ops.kl import masked_kl_divergence

    g = torch.Generator(device=dev).manual_seed(6)
    stu0 = torch.randn((2, 64, 32000), generator=g, device=dev) * 3
    tea0 = torch.randn((2, 64, 32000), generator=g, device=dev) * 3
    mask = torch.rand((2, 64), generator=g, device=dev) < 0.3
    out = {}
    for impl in ("pallas", "xla"):
        stu, tea = stu0.clone().requires_grad_(), tea0.clone().requires_grad_()
        t = torch.tensor(1.3, device=dev, requires_grad=True)
        val = masked_kl_divergence(stu, tea, mask, t, 1e-6, impl=impl)
        out[impl] = (val.detach(), *torch.autograd.grad(val, (stu, tea, t)))
    for a, b in zip(out["pallas"], out["xla"]):
        _assert_close(a, b, F32_REL_TOL)
