"""The port's hand-written kernels against their plain versions, on the card.

Needs an NVIDIA GPU (nvcc for the CUDA library, triton for the Triton
kernels); skipped without one.  Run on the H100 with
``python -m pytest tests/test_torch_kernels.py -o addopts="" -m cuda``
(``-o addopts=""`` drops the repository's xdist defaults).
The causal flash forward (``csrc/flash_fwd_sm90.cuh``) is held at a
ragged S, on strided views and at the flagship teacher's (4, 2048, 32, 128),
and its two wgmma products alone on one tile against ``torch.matmul``.
The bidirectional flash kernel is held at ``chip_smoke.py`` phase 3's
shapes (the SigLIP tower's H=16, Dh=72) and at a ragged one; the ALiBi
flash kernel at MPT-7B's (H=32, Dh=128) with both paddings, on the rows
with a visible key; the fused ViT kernel at ViT-L's and ViT-H's (H=16,
Dh=64 and 80), masked and unmasked, on every row; the causal flash
backward at ``chip_smoke.py`` phase 3's shapes (dq, dk and dv each, on the
forward kernel's output and log-sum-exp), on strided views with an
expanded cotangent, bit-equal across calls; the w8a8 kernel (both entry
points, every tile) at run A's and the tuning tool's shapes and at ragged
ones, bf16 and f32 in and out, EQUAL to its plain version (the int32 sum
is exact and the epilogue the same f32 arithmetic); the int4 unpack probe's
four schedules at the tool's shape and at ragged ones; the int8 kernel on
both sides of its TMA pitch rule, on one tile and bit-equal across calls;
the ICV backward in every shift layout ((1, S, D) shared by the batch
included) at the flagship student's shape and a ragged one, bf16 or f32,
bit-equal across calls; the ICV forward with the residual add folded in,
both sites, forward and gradients; the masked KL (``csrc/masked_kl.cu``)
at 32000 and the head's 32002 columns, with zero-weight rows and every
row weighted, bit-equal across calls.
Tolerance: f32 math on both sides, so the two differ by output rounding
(bf16 outputs) and summation order.  The limit scales with the output:
max-abs error ≤ 2e-2 · max|plain| for bf16 outputs (one bf16 ulp is at most
2^-7 of a value, so this allows about 2.5 ulps at the largest output) and
≤ 1e-4 · max|plain| for the f32 KL outputs, which differ only by summation
order (they read about 1e-6): a KL kernel that rounded through bf16 reads
above it.  The quantized matmuls' f32 outputs are held to the same 1e-4.
"""

import pytest
import torch

from licv_vqa_tpu_torch.models import layers as PL
from licv_vqa_tpu_torch.ops import flash_alibi as FA
from licv_vqa_tpu_torch.ops import int4_matmul as I4
from licv_vqa_tpu_torch.ops import int4_unpack_probe as P
from licv_vqa_tpu_torch.ops import int8_matmul as I8
from licv_vqa_tpu_torch.ops import masked_kl_kernel as K
from licv_vqa_tpu_torch.ops import quantize as Q
from licv_vqa_tpu_torch.ops.icv_inject import (
    add_icv_inject,
    add_icv_inject_reference,
    icv_inject,
    icv_inject_after_add,
    icv_inject_after_add_reference,
    icv_inject_backward,
    icv_inject_backward_reference,
    icv_inject_reference,
)

pytestmark = pytest.mark.cuda
REL_TOL = 2e-2
F32_REL_TOL = 1e-4
# the fused ViT kernel's mean error over the plain output's mean magnitude
# (chip_smoke.VIT_MEAN_TOL): sees where P is rounded, which REL_TOL cannot
VIT_MEAN_TOL = 3e-4


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


@pytest.mark.parametrize("site", ["after_add", "add_after"])
@pytest.mark.parametrize("shape,layout", [
    ((3, 1, 4096), "row"), ((1, 512, 4096), "row"), ((3, 5, 4096), "batch"),
    ((3, 5, 4096), "per_pos"), ((3, 5, 4096), "pos"), ((2, 7, 4000), "row"),
])
def test_icv_inject_fused_add_matches_plain(dev, shape, layout, site):
    """The entries with the residual add folded in: one forward launch,
    bf16, within the limit of the plain add and injection."""
    g = torch.Generator(device=dev).manual_seed(8)
    b, s, d = shape
    h, x = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
    vshape = {"row": (d,), "batch": (b, d), "per_pos": shape, "pos": (1, s, d)}[layout]
    v = (torch.randn(vshape, generator=g, device=dev) * 0.5).to(torch.bfloat16)
    entry, plain = ((icv_inject_after_add, icv_inject_after_add_reference) if site == "after_add"
                    else (add_icv_inject, add_icv_inject_reference))
    before = icv_inject.launches
    got = entry(h, x, v)
    torch.cuda.synchronize()
    assert icv_inject.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == shape
    _assert_close(got, plain(h, x, v))


@pytest.mark.parametrize("site", ["after_add", "add_after"])
@pytest.mark.parametrize("layout", ["row", "pos"])
def test_icv_inject_fused_add_autograd_matches_plain(dev, site, layout):
    """Under autograd: the fused forward (the block output's writing the sum
    for the backward), then one launch of the backward kernel; the
    gradients of h, the other operand and an f32 shift within the limit of
    autograd through the plain versions."""
    g = torch.Generator(device=dev).manual_seed(9)
    shape = (2, 64, 4096)
    h, x, gout = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                  for _ in range(3))
    v = torch.randn((4096,) if layout == "row" else (1, 64, 4096), generator=g, device=dev) * 0.5
    entry, plain = ((icv_inject_after_add, icv_inject_after_add_reference) if site == "after_add"
                    else (add_icv_inject, add_icv_inject_reference))
    out = {}
    for name, fn in (("kernel", entry), ("plain", plain)):
        hh, xx, vv = (a.detach().clone().requires_grad_() for a in (h, x, v))
        f0, b0 = icv_inject.launches, icv_inject_backward.launches
        y = fn(hh, xx, vv.to(torch.bfloat16))
        out[name] = (y.detach(), *torch.autograd.grad(y, (hh, xx, vv), gout))
        torch.cuda.synchronize()
        if name == "kernel":
            assert (icv_inject.launches, icv_inject_backward.launches) == (f0 + 1, b0 + 1)
    for a, b in zip(out["kernel"], out["plain"]):
        assert a.dtype == b.dtype and a.shape == b.shape
        _assert_close(a, b)


@pytest.mark.parametrize("b,s,h,pad,side", [
    (1, 384, 32, 50, "left"), (2, 300, 4, 37, "right"), (1, 2048, 32, 300, "left"),
    # the flagship teacher's call (phase 9): four 2048-token rows, all valid
    (4, 2048, 32, 0, "left"),
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


def test_flash_fwd_sm90_tile_products_match_matmul(dev):
    """The forward template's two tensor-core products on one tile, through
    its TMA loads, 128-byte swizzle and wgmma descriptors
    (``flash_fwd_sm90_tile_check``): S = Q·Kᵀ at (64, 128)·(128, 128)ᵀ,
    both K-major, and O = bf16(S)·V with S as register fragments and V
    MN-major, each against ``torch.matmul`` in f32 (exact bf16 products
    summed in f32: the two differ by summation order only)."""
    import ctypes

    from licv_vqa_tpu_torch.csrc import load_library

    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
               for shape in ((64, 128), (128, 128), (128, 128)))
    s, o = (torch.full((64, 128), float("nan"), device=dev) for _ in range(2))
    fn = load_library("flash_attn_fwd.cu").flash_fwd_sm90_tile_check
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), s.data_ptr(), o.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    _assert_close(s, q.float() @ k.float().T, F32_REL_TOL)
    _assert_close(o, s.to(torch.bfloat16).float() @ v.float(), F32_REL_TOL)


def _tile_check(dev, source, symbol, shapes, outs, seed):
    """Inputs of ``shapes`` (bf16, from a seed), ``outs`` f32 outputs
    (NaN-filled), and one call of the entry point ``symbol``."""
    import ctypes

    from licv_vqa_tpu_torch.csrc import load_library

    g = torch.Generator(device=dev).manual_seed(seed)
    ins = [torch.randn(shape, generator=g, device=dev).to(torch.bfloat16) for shape in shapes]
    got = [torch.full(shape, float("nan"), device=dev) for shape in outs]
    fn = getattr(load_library(source), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6
    err = fn(*(x.data_ptr() for x in ins + got), torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    return ins, got


def test_flash_bidir_tile_products_match_matmul(dev):
    """The bidirectional kernel's two products at head dim 72 on one tile
    (``flash_bidir_tile_check``): S = Q·Kᵀ over the 64-dim box (128-byte
    swizzle) and the 16-dim box (32-byte swizzle, dims 72-79 zeros from
    TMA) at (64, 72)·(128, 72)ᵀ, and O = bf16(S)·V with m64n72k16 (V
    MN-major in two 128-byte swizzle boxes, N = 72 reaching 8 columns into
    the second), each against ``torch.matmul`` in f32."""
    (q, k, v), (s, o) = _tile_check(dev, "flash_attn_bidir.cu", "flash_bidir_tile_check",
                                    ((64, 72), (128, 72), (128, 72)), ((64, 128), (64, 72)), 8)
    _assert_close(s, q.float() @ k.float().T, F32_REL_TOL)
    _assert_close(o, s.to(torch.bfloat16).float() @ v.float(), F32_REL_TOL)


def test_flash_bwd_tile_products_match_matmul(dev):
    """The backward kernels' two product layouts on one 64-row tile
    (``flash_bwd_sm90_tile_check``): S = A·Bᵀ with m64n64k16, both
    K-major (the score products S = Q·Kᵀ, dP = dO·Vᵀ and their transposes),
    and O = bf16(S)·C with m64n128k16, S as register fragments and C
    MN-major (dQ += dS·K, dV += Pᵀ·dO, dK += dSᵀ·Q), against
    ``torch.matmul`` in f32."""
    (a, b, c), (s, o) = _tile_check(dev, "flash_attn_bwd.cu", "flash_bwd_sm90_tile_check",
                                    ((64, 128),) * 3, ((64, 64), (64, 128)), 9)
    _assert_close(s, a.float() @ b.float().T, F32_REL_TOL)
    _assert_close(o, s.to(torch.bfloat16).float() @ c.float(), F32_REL_TOL)


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


def test_flash_kernel_gives_gradients_and_no_grad_calls_write_no_lse(dev, monkeypatch):
    """Under autograd the forward kernel writes its log-sum-exp and the
    backward kernels run (the gradients against the plain backward on the
    same output, log-sum-exp and cotangent); without a gradient (the
    teacher's case) the forward kernel is launched alone, with no
    log-sum-exp."""
    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn((2, 256, 4, 128), generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    valid = torch.ones((2, 256), dtype=torch.int32, device=dev)
    valid[1, 180:] = 0
    calls = []
    real = PL._flash_attention_cuda
    monkeypatch.setattr(PL, "_flash_attention_cuda",
                        lambda *a, **kw: calls.append(kw.get("with_lse", False)) or real(*a, **kw))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = PL.flash_attention_backward.launches
    got = torch.autograd.grad(PL.flash_attention(*leaves, valid).float().square().sum(), leaves)
    torch.cuda.synchronize()
    assert calls == [True] and PL.flash_attention_backward.launches == before + 1
    o, lse = real(q, k, v, valid, 128 ** -0.5, with_lse=True)
    want = PL.flash_attention_bwd_reference(q, k, v, o, lse, 2 * o, valid, 128 ** -0.5)
    for a, b in zip(got, want, strict=True):
        _assert_close(a, b)
    with torch.no_grad():
        assert torch.isfinite(PL.flash_attention(*leaves, valid)).all()
    assert calls == [True, False]
    assert PL.flash_attention_backward.launches == before + 1


def _right_padded(lengths, s, dev):
    return (torch.arange(s, device=dev)[None]
            < torch.tensor(lengths, device=dev)[:, None]).to(torch.int32)


@pytest.mark.parametrize("b,s,h,lengths", [
    # chip_smoke.py phase 3's shapes: the flagship student with ragged
    # rows; JAX tools/validate_flash_tpu.py's gradient check; one 2048 row
    (4, 256, 32, (256, 201, 150, 77)), (4, 512, 8, (512, 400, 512, 100)),
    (1, 2048, 32, (1798,)),
    # a ragged tail (S not a multiple of the 64-row tile)
    (2, 300, 4, (300, 263)),
])
def test_flash_backward_kernels_match_plain(dev, b, s, h, lengths):
    """dq, dk and dv each against the plain backward on the forward kernel's
    output and log-sum-exp; the log-sum-exp against the plain one (f32)."""
    g = torch.Generator(device=dev).manual_seed(4)
    q, k, v, do = (torch.randn((b, s, h, 128), generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    valid = _right_padded(lengths, s, dev)
    scale = 128 ** -0.5
    o, lse = PL._flash_attention_cuda(q, k, v, valid, scale, with_lse=True)
    want_lse = PL.flash_attention_lse_reference(q, k, valid, scale)
    _assert_close(lse, want_lse, F32_REL_TOL)
    before = PL.flash_attention_backward.launches
    got = PL.flash_attention_backward(q, k, v, o, lse, do, valid, scale)
    torch.cuda.synchronize()
    assert PL.flash_attention_backward.launches == before + 1
    want = PL.flash_attention_bwd_reference(q, k, v, o, lse, do, valid, scale)
    for a, w in zip(got, want, strict=True):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a).all()
        _assert_close(a, w)


def test_flash_backward_takes_strided_views_and_an_expanded_cotangent(dev):
    """q/k/v as views into one fused (B, S, 3, H, Dh) buffer, and the
    cotangent a ``.sum()`` hands in (an expanded tensor, zero strides)."""
    g = torch.Generator(device=dev).manual_seed(5)
    qkv = torch.randn((2, 320, 3, 4, 128), generator=g, device=dev).to(torch.bfloat16)
    valid = _right_padded((320, 250), 320, dev)
    leaf = qkv.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(PL.flash_attention(*leaf.unbind(2), valid).sum(), leaf)
    q, k, v = qkv.unbind(2)
    o, lse = PL._flash_attention_cuda(q, k, v, valid, 128 ** -0.5, with_lse=True)
    ones = torch.ones_like(o)
    want = PL.flash_attention_bwd_reference(q, k, v, o, lse, ones, valid, 128 ** -0.5)
    for i in range(3):
        _assert_close(got[:, :, i], want[i])


def test_flash_backward_is_deterministic(dev):
    g = torch.Generator(device=dev).manual_seed(6)
    q, k, v, do = (torch.randn((2, 384, 8, 128), generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    valid = _right_padded((384, 301), 384, dev)
    o, lse = PL._flash_attention_cuda(q, k, v, valid, 0.09, with_lse=True)
    first = PL.flash_attention_backward(q, k, v, o, lse, do, valid, 0.09)
    second = PL.flash_attention_backward(q, k, v, o, lse, do, valid, 0.09)
    for a, b in zip(first, second, strict=True):
        assert torch.equal(a, b)


def test_flash_backward_rejects_other_head_dims(dev):
    x = torch.zeros((1, 256, 4, 64), dtype=torch.bfloat16, device=dev)
    lse = torch.zeros((1, 4, 256), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        PL.flash_attention_backward(x, x, x, x, lse, x, torch.ones((1, 256), device=dev), 0.1)


def _navit_valid(b, s, grids, dev, grid_w):
    """(B, S) patch validity: image i fills the top-left rows x cols of a
    padded (S / grid_w) x grid_w grid (grids cycled)."""
    valid = torch.ones((b, s), dtype=torch.int32, device=dev)
    for i in range(b):
        rows, cols = grids[i % len(grids)]
        grid = torch.zeros((s // grid_w, grid_w), dtype=torch.int32, device=dev)
        grid[:rows, :cols] = 1
        valid[i] = grid.reshape(-1)
    return valid


@pytest.mark.parametrize("b,s,grids,grid_w", [
    # chip_smoke.py phase 3's shapes: one 980x980 image; one 640x480 image
    # padded to 672x560; a 32-shot prompt's 33 images
    (1, 4900, None, None), (1, 1920, ((34, 45),), 48),
    (33, 1920, ((34, 45), (30, 45), (27, 35)), 48),
    # a ragged tail (S not a multiple of the 64-key tile), and no mask
    (2, 1100, ((20, 30), (15, 55)), 55), (3, 1000, None, None),
])
def test_flash_bidir_kernel_matches_plain(dev, b, s, grids, grid_w):
    g = torch.Generator(device=dev).manual_seed(11)
    q, k, v = (
        torch.randn((b, s, 16, 72), generator=g, device=dev).to(torch.bfloat16)
        for _ in range(3)
    )
    valid = None if grids is None else _navit_valid(b, s, grids, dev, grid_w)
    before = PL.flash_attention_bidir.launches
    got = PL.flash_attention_bidir(q, k, v, valid)
    torch.cuda.synchronize()
    assert PL.flash_attention_bidir.launches == before + 1
    want = PL.flash_attention_bidir_reference(q, k, v, valid)
    assert torch.isfinite(got).all()  # invalid rows too: each sees itself
    _assert_close(got, want)


def test_flash_bidir_kernel_takes_strided_views(dev):
    """q/k/v as views into one fused (B, S, 3, H, Dh) buffer, no copies."""
    g = torch.Generator(device=dev).manual_seed(12)
    qkv = torch.randn((2, 1024, 3, 16, 72), generator=g, device=dev).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    valid = _navit_valid(2, 1024, ((10, 30),), dev, grid_w=32)
    _assert_close(PL.flash_attention_bidir(q, k, v, valid),
                  PL.flash_attention_bidir_reference(q, k, v, valid))


def test_flash_bidir_kernel_rejects_other_head_dims_and_grad(dev):
    x = torch.zeros((1, 1024, 16, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        PL.flash_attention_bidir(x, x, x)
    y = torch.zeros((1, 1024, 16, 72), dtype=torch.bfloat16, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward only"):
        PL.flash_attention_bidir(y, y, y)


def _alibi_rows(valid: torch.Tensor) -> torch.Tensor:
    """(B, S) rows with a visible key under the ALiBi rule (k <= q and
    valid[k]): real rows and right-pad rows.  A left-pad row sees none; the
    kernel writes 0 there, the plain version a uniform average."""
    return torch.cumsum(valid, dim=1) > 0


@pytest.mark.parametrize("b,s,pad,side", [
    # chip_smoke.py phase 3's shapes (MPT-7B: 32 heads of 128), each padding
    (1, 512, 39, "left"), (1, 512, 61, "right"), (1, 2048, 301, "left"),
    (1, 2048, 250, "right"),
    # a ragged tail (S not a multiple of the 128-key tile), two rows
    (2, 300, 37, "left"),
])
def test_flash_alibi_kernel_matches_plain(dev, b, s, pad, side):
    g = torch.Generator(device=dev).manual_seed(21)
    q, k, v = (
        torch.randn((b, s, 32, 128), generator=g, device=dev).to(torch.bfloat16)
        for _ in range(3)
    )
    valid = torch.ones((b, s), dtype=torch.int32, device=dev)
    if side == "left":
        valid[:, :pad] = 0
    else:
        valid[:, s - pad :] = 0
    slopes = PL.alibi_slopes(32, dev)
    before = FA.flash_alibi_attention.launches
    with torch.no_grad():
        got = FA.flash_alibi_attention(q, k, v, valid, slopes, 128 ** -0.5)
    torch.cuda.synchronize()
    assert FA.flash_alibi_attention.launches == before + 1
    want = FA.flash_alibi_reference(q, k, v, valid, slopes, 128 ** -0.5)
    assert torch.isfinite(got).all()
    rows = _alibi_rows(valid)
    _assert_close(got[rows], want[rows])
    if side == "left":  # no visible key: the kernel writes 0
        assert (got[~rows] == 0).all()


def test_flash_alibi_kernel_takes_strided_views_and_gives_a_gradient(dev):
    """q/k/v as views into one fused (B, S, 3, H, Dh) buffer; under autograd
    the forward launches the kernel and the backward recomputes through the
    plain version."""
    g = torch.Generator(device=dev).manual_seed(22)
    qkv = torch.randn((1, 256, 3, 8, 128), generator=g, device=dev).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    valid = torch.ones((1, 256), dtype=torch.int32, device=dev)
    slopes = PL.alibi_slopes(8, dev)
    _assert_close(FA.flash_alibi_attention(q, k, v, valid, slopes, 0.09),
                  FA.flash_alibi_reference(q, k, v, valid, slopes, 0.09))
    qg = q.detach().float().requires_grad_(True)
    x = qg.to(torch.bfloat16)
    out = FA.flash_alibi_attention(x, k, v, valid, slopes, 0.09)
    (dq,) = torch.autograd.grad(out.float().square().sum(), qg)
    qr = q.detach().float().requires_grad_(True)
    ref = FA.flash_alibi_reference(qr.to(torch.bfloat16), k, v, valid, slopes, 0.09)
    (want,) = torch.autograd.grad(ref.float().square().sum(), qr)
    assert torch.isfinite(dq).all()
    _assert_close(dq, want, tol=5e-2)  # the cotangent is the kernel's output


def test_flash_alibi_kernel_rejects_other_head_dims(dev):
    x = torch.zeros((1, 256, 4, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_alibi_attention(x, x, x, torch.ones((1, 256), device=dev),
                                 PL.alibi_slopes(4, dev), 0.125)


@pytest.mark.parametrize("b,s,dh,masked", [
    # chip_smoke.py phase 3's shapes: ViT-L (Dh 64) at a test_icv bind and a
    # 32-shot bind, ViT-H (Dh 80) at a 32-shot bind, a masked case and the
    # gate's largest s
    (1, 257, 64, False), (33, 257, 64, False), (33, 257, 80, False),
    (4, 257, 80, True), (2, 1024, 80, True),
    # SigLIP's head dim under 1024 patches, and a tiny ragged one
    (2, 729, 72, True), (3, 5, 64, True),
    # the last S of the one-pass schedule and the first of the two-pass one
    (2, 264, 80, True), (2, 265, 64, False),
])
def test_vit_attention_kernel_matches_plain(dev, b, s, dh, masked):
    """Every row: a fully masked one gives the plain version's uniform
    softmax; and the mean error within ``VIT_MEAN_TOL`` (P normalised,
    then rounded, as the plain version rounds it)."""
    g = torch.Generator(device=dev).manual_seed(31)
    q, k, v = (
        torch.randn((b, s, 16, dh), generator=g, device=dev).to(torch.bfloat16)
        for _ in range(3)
    )
    valid = None
    if masked:
        valid = torch.rand((b, s), generator=g, device=dev) > 0.3
        valid[-1] = False
    before = PL.vit_attention.launches
    got = PL.vit_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert PL.vit_attention.launches == before + 1
    want = PL.vit_attention_reference(q, k, v, valid)
    assert torch.isfinite(got).all()
    _assert_close(got, want)
    mean = (got.float() - want.float()).abs().mean() / want.float().abs().mean()
    assert mean <= VIT_MEAN_TOL, mean.item()


@pytest.mark.parametrize("dh", [64, 72, 80])
def test_vit_tile_products_match_matmul(dev, dh):
    """The fused ViT kernel's one-pass products on one head
    (``vit_tile_check``): the whole 264-key score row S = Q·Kᵀ as
    m64n256k16 + m64n8k16 (keys 256-263 in the second) over the 64-dim box
    (128-byte swizzle) and, at Dh 72 and 80, the 16-dim box (32-byte
    swizzle, TMA's zeros at 72-79); O = bf16(S)·V over 17 k16 steps,
    m64n64k16 on V's first box plus m64n16k16 on its second (V MN-major),
    keys 264-271 zero; each against ``torch.matmul`` in f32."""
    import ctypes

    from licv_vqa_tpu_torch.csrc import load_library

    g = torch.Generator(device=dev).manual_seed(33)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
               for shape in ((64, dh), (264, dh), (264, dh)))
    s = torch.full((64, 264), float("nan"), device=dev)
    o = torch.full((64, dh), float("nan"), device=dev)
    fn = load_library("vit_attention.cu").vit_tile_check
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), s.data_ptr(), o.data_ptr(), dh,
             torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    _assert_close(s, q.float() @ k.float().T, F32_REL_TOL)
    _assert_close(o, s.to(torch.bfloat16).float() @ v.float(), F32_REL_TOL)


def test_vit_attention_kernel_takes_strided_views(dev):
    g = torch.Generator(device=dev).manual_seed(32)
    qkv = torch.randn((2, 257, 3, 16, 64), generator=g, device=dev).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    _assert_close(PL.vit_attention(q, k, v), PL.vit_attention_reference(q, k, v))


def test_vit_attention_kernel_rejects_other_head_dims_and_grad(dev):
    x = torch.zeros((1, 257, 16, 96), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        PL.vit_attention(x, x, x)
    y = torch.zeros((1, 257, 16, 64), dtype=torch.bfloat16, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward only"):
        PL.vit_attention(y, y, y)


@pytest.mark.parametrize("shape,layout", [
    ((2, 64, 4096), "row"), ((2, 64, 4096), "batch"), ((2, 64, 4096), "batch1"),
    ((2, 64, 4096), "per_pos"), ((1, 512, 4096), "row"), ((2, 7, 4000), "per_pos"),
    # the flagship student (phase 9) in every layout, and a ragged B.S (no
    # whole two-row steps, groups of partials cut short)
    ((4, 256, 4096), "row"), ((4, 256, 4096), "batch"), ((4, 256, 4096), "batch1"),
    ((4, 256, 4096), "per_pos"), ((3, 37, 4000), "row"), ((3, 37, 4000), "batch"),
    ((3, 37, 4000), "batch1"), ((3, 37, 4000), "per_pos"),
    # a per-position shift shared by the batch: S segments of B rows
    ((4, 256, 4096), "pos"), ((3, 37, 4000), "pos"), ((64, 2, 4096), "pos"),
])
def test_icv_inject_backward_kernel_matches_plain(dev, shape, layout):
    g = torch.Generator(device=dev).manual_seed(3)
    b, s, d = shape
    h = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    gout = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    vshape = {"row": (d,), "batch": (b, d), "batch1": (b, 1, d), "per_pos": shape,
              "pos": (1, s, d)}[layout]
    v = (torch.randn(vshape, generator=g, device=dev) * 0.5).to(torch.bfloat16)
    before = icv_inject_backward.launches
    dh, dv = icv_inject_backward(h, v, gout)
    torch.cuda.synchronize()
    assert icv_inject_backward.launches == before + 1
    want_dh, want_dv = icv_inject_backward_reference(h, v, gout)
    assert dh.dtype == torch.bfloat16 and dv.dtype == torch.bfloat16 and dv.shape == vshape
    _assert_close(dh, want_dh)
    _assert_close(dv, want_dv)


@pytest.mark.parametrize("shape", [(4, 256, 4096), (3, 37, 4000)])
@pytest.mark.parametrize("layout", ["row", "batch", "per_pos", "pos"])
def test_icv_inject_backward_is_deterministic(dev, shape, layout):
    """The shift's gradient is summed from the programs' partials in a fixed
    order, with no float atomics: two calls give equal bits (the finishers
    leave the tickets at zero for the next call)."""
    g = torch.Generator(device=dev).manual_seed(5)
    b, s, d = shape
    h = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    gout = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    vshape = {"row": (d,), "batch": (b, d), "per_pos": shape, "pos": (1, s, d)}[layout]
    v = (torch.randn(vshape, generator=g, device=dev) * 0.5).to(torch.bfloat16)
    first = icv_inject_backward(h, v, gout)
    second = icv_inject_backward(h, v, gout)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.parametrize("h_dtype,v_dtype", [(torch.bfloat16, torch.float32),
                                             (torch.float32, torch.float32),
                                             (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("layout", ["row", "batch", "per_pos"])
def test_icv_inject_backward_kernel_takes_f32(dev, h_dtype, v_dtype, layout):
    """h, g and dh in bf16 or f32, the shift and its gradient in bf16 or
    f32, each output in its input's dtype and within its limit."""
    g = torch.Generator(device=dev).manual_seed(6)
    b, s, d = 3, 37, 4000
    h = torch.randn((b, s, d), generator=g, device=dev).to(h_dtype)
    gout = torch.randn((b, s, d), generator=g, device=dev).to(h_dtype)
    vshape = {"row": (d,), "batch": (b, d), "per_pos": (b, s, d)}[layout]
    v = (torch.randn(vshape, generator=g, device=dev) * 0.5).to(v_dtype)
    dh, dv = icv_inject_backward(h, v, gout)
    want_dh, want_dv = icv_inject_backward_reference(h, v, gout)
    assert dh.dtype == h_dtype and dv.dtype == v_dtype and dv.shape == vshape
    _assert_close(dh, want_dh, REL_TOL if h_dtype == torch.bfloat16 else F32_REL_TOL)
    _assert_close(dv, want_dv, REL_TOL if v_dtype == torch.bfloat16 else F32_REL_TOL)


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


@pytest.mark.parametrize("weights", ["70%", "all", "none"])
@pytest.mark.parametrize("n,v", [(128, 32000), (512, 32000), (15, 257), (128, 32002),
                                 (7, 4099)])
def test_masked_kl_kernels_match_plain(dev, n, v, weights):
    """Both kernels against their plain versions with the row weights:
    zero-weight rows 0 (KL, log-sum-exps, both gradients), the others within
    the f32 limit; at the head's 32002 columns a row starts 8-byte aligned
    only.  "none" passes no weights (every row)."""
    g = torch.Generator(device=dev).manual_seed(5)
    stu = torch.randn((n, v), generator=g, device=dev) * 3
    tea = torch.randn((n, v), generator=g, device=dev) * 3
    w = {"70%": (torch.rand((n,), generator=g, device=dev) < 0.7).float(),
         "all": torch.ones((n,), device=dev), "none": None}[weights]
    gw = torch.rand((n,), generator=g, device=dev) if w is None else w / w.sum()
    f0, b0 = K.rowwise_kl_forward.launches, K.rowwise_kl_backward.launches
    got = K.rowwise_kl_forward(stu, tea, 1e-6, w)
    want = K.rowwise_kl_reference(stu, tea, 1e-6, w)
    for a, b in zip(got, want):
        _assert_close(a, b, F32_REL_TOL)
    dgot = K.rowwise_kl_backward(stu, tea, got[1], got[2], gw, 1e-6, w)
    dwant = K.rowwise_kl_backward_reference(stu, tea, want[1], want[2], gw, 1e-6, w)
    torch.cuda.synchronize()
    assert (K.rowwise_kl_forward.launches, K.rowwise_kl_backward.launches) == (f0 + 1, b0 + 1)
    for a, b in zip(dgot, dwant):
        _assert_close(a, b, F32_REL_TOL)
    if w is not None:
        off = w == 0
        assert all(torch.all(x[off] == 0) for x in (*got, *dgot))


@pytest.mark.parametrize("n,v", [(128, 32002), (512, 32000)])
def test_masked_kl_kernels_are_deterministic_and_skip_zero_weight_rows(dev, n, v):
    """Two calls give equal bits (the cluster's merges in rank order), and a
    zero-weight row is not read: NaN logits there leave every output finite
    and its outputs 0."""
    g = torch.Generator(device=dev).manual_seed(10)
    stu = torch.randn((n, v), generator=g, device=dev) * 3
    tea = torch.randn((n, v), generator=g, device=dev) * 3
    w = (torch.rand((n,), generator=g, device=dev) < 0.3).float()
    w[0], w[1] = 1.0, 0.0
    stu[1], tea[1] = float("nan"), float("nan")
    gw = w / w.sum()
    first = K.rowwise_kl_forward(stu, tea, 1e-6, w)
    second = K.rowwise_kl_forward(stu, tea, 1e-6, w)
    d1 = K.rowwise_kl_backward(stu, tea, first[1], first[2], gw, 1e-6, w)
    d2 = K.rowwise_kl_backward(stu, tea, first[1], first[2], gw, 1e-6, w)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip((*first, *d1), (*second, *d2)))
    assert all(torch.isfinite(x).all() for x in (*first, *d1))
    assert all(torch.all(x[1] == 0) for x in (*first, *d1))


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


def _weights(dev, k, n, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((k, n), generator=g, device=dev) * 0.02).to(torch.bfloat16)


def _acts(dev, m, k, seed):
    g = torch.Generator(device=dev).manual_seed(seed + 100)
    return torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)


@pytest.mark.parametrize("m,k,n,out_dtype", [
    (3, 4096, 4096, torch.bfloat16), (3, 4096, 11008, torch.bfloat16),
    (3, 11008, 4096, torch.bfloat16), (64, 4096, 4096, torch.bfloat16),
    (3, 4096, 32002, torch.float32), (1, 4096, 32000, torch.float32),
    (5, 96, 130, torch.bfloat16), (7, 100, 33, torch.float32), (17, 1280, 1536, torch.bfloat16),
    # more than 8 rows: several blocks of 8 activation rows, with ragged K,
    # N and rows
    (9, 100, 33, torch.float32), (40, 4096, 32002, torch.float32), (65, 256, 72, torch.bfloat16),
    (1, 4096, 32002, torch.float32), (64, 1280, 4096, torch.bfloat16),
    # either side of the TMA path's pitch rule: N % 16 (8-byte plain loads)
    # and K % 8 (x's pitch) off by a little, beside the TMA shapes above
    (3, 4096, 4104, torch.float32), (3, 4100, 4096, torch.bfloat16),
    (130, 4096, 4112, torch.float32),
])
def test_int8_kernel_matches_plain(dev, m, k, n, out_dtype):
    leaf = Q.quantize_array(_weights(dev, k, n, 7))
    x = _acts(dev, m, k, 7)
    before = I8.int8_matmul.launches
    got = I8.int8_matmul(x, leaf["q"], leaf["s"], out_dtype)
    torch.cuda.synchronize()
    assert I8.int8_matmul.launches == before + 1
    want = I8.int8_matmul_reference(x, leaf["q"], leaf["s"], out_dtype)
    assert got.dtype == out_dtype and got.shape == (m, n)
    _assert_close(got, want, REL_TOL if out_dtype == torch.bfloat16 else F32_REL_TOL)


@pytest.mark.parametrize("m,k,n", [(3, 4096, 4096), (64, 4096, 4096), (3, 4096, 32002),
                                   (65, 256, 72), (3, 11008, 4096)])
def test_int8_kernel_is_deterministic(dev, m, k, n):
    """The split-K blocks of a column tile sum their partials in rank order
    through the cluster's shared memory: two calls give equal bits, on the
    TMA path and the plain-load path."""
    leaf = Q.quantize_array(_weights(dev, k, n, 13))
    x = _acts(dev, m, k, 13)
    a = I8.int8_matmul(x, leaf["q"], leaf["s"], torch.float32)
    b = I8.int8_matmul(x, leaf["q"], leaf["s"], torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("m", [3, 20, 64])
def test_int8_fragment_layout_on_one_tile(dev, m):
    """One tile of the int8 kernel (K = 64: one stage; N = 128: one column
    tile; unit scales) with each row of x picking one in-feature: output
    row i is in-feature ``pick[i]``'s int8 row, exactly.  Holds the B
    fragments' byte-to-column interleave (tile j, column c is column
    4c + j), the rows 2t, 2t+1, 2t+8, 2t+9 of each k16 step, the exact
    widening of every byte from -128 to 127, and the A fragments of every
    m16 tile."""
    g = torch.Generator(device=dev).manual_seed(14)
    q = torch.randint(-128, 128, (64, 128), generator=g, device=dev, dtype=torch.int32)
    q[0, :] = torch.arange(-128, 0, device=dev)  # every byte value appears
    q[1, :] = torch.arange(0, 128, device=dev)
    s = torch.ones((128,), dtype=torch.float32, device=dev)
    pick = (torch.arange(m, device=dev) * 37 + 5) % 64
    pick[0] = 0
    x = torch.zeros((m, 64), dtype=torch.bfloat16, device=dev)
    x[torch.arange(m, device=dev), pick] = 1.0
    got = I8.int8_matmul(x, q.to(torch.int8), s, torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(got, q[pick].float())


@pytest.mark.parametrize("m,k,n,g,out_dtype", [
    (3, 4096, 4096, 64, torch.bfloat16), (3, 4096, 11008, 64, torch.bfloat16),
    (3, 11008, 4096, 64, torch.bfloat16), (64, 4096, 4096, 64, torch.bfloat16),
    (2, 256, 40, 32, torch.float32), (3, 512, 36, 64, torch.float32),
    (3, 128, 6, 64, torch.bfloat16),
    # more than 8 rows: several blocks of 8 activation rows (G = 16, 20,
    # 32, 64), the run-B prefill MLP and the bind-time K/V among them
    (20, 96, 40, 16, torch.float32), (64, 512, 36, 32, torch.bfloat16),
    (33, 200, 24, 20, torch.float32), (64, 11008, 4096, 64, torch.float32),
    (64, 4096, 11008, 64, torch.float32), (64, 1280, 4096, 64, torch.bfloat16),
])
def test_int4_kernel_matches_plain(dev, m, k, n, g, out_dtype):
    leaf = Q.quantize_array_int4(_weights(dev, k, n, 8), group=g)
    x = _acts(dev, m, k, 8)
    s = leaf["s"].reshape(k // g, n)
    before = I4.int4_matmul.launches
    got = I4.int4_matmul(x, leaf["q4"], s, g, out_dtype)
    torch.cuda.synchronize()
    assert I4.int4_matmul.launches == before + 1
    want = I4.int4_matmul_reference(x, leaf["q4"], s, g, out_dtype)
    assert got.dtype == out_dtype and got.shape == (m, n)
    _assert_close(got, want, REL_TOL if out_dtype == torch.bfloat16 else F32_REL_TOL)


@pytest.mark.parametrize("m", [3, 16, 40, 64])
def test_int4_fragment_layout_on_one_tile(dev, m):
    """One tile of the int4 kernel (K = 128: one 64-row stage; N = 128: one
    column tile; G = 64, unit scales) with each row of x picking one
    in-feature: output row i is in-feature ``pick[i]``'s signed nibbles,
    exactly.  Holds the B fragments' byte-to-column interleave (tile j,
    column c is column 4c + j), both planes, the rows 2t, 2t+1, 2t+8, 2t+9
    of each k16 step and the A fragments of every m16 tile."""
    g = torch.Generator(device=dev).manual_seed(12)
    q = torch.randint(-8, 8, (128, 128), generator=g, device=dev, dtype=torch.int32)
    packed = ((q[:64] + 8) | ((q[64:] & 0xF) << 4)).to(torch.uint8)
    s = torch.ones((2, 128), dtype=torch.bfloat16, device=dev)
    pick = (torch.arange(m, device=dev) * 37 + 5) % 128
    x = torch.zeros((m, 128), dtype=torch.bfloat16, device=dev)
    x[torch.arange(m, device=dev), pick] = 1.0
    got = I4.int4_matmul(x, packed, s, 64, torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(got, q[pick].float())


@pytest.mark.parametrize("m,k,n", [(3, 11008, 4096), (64, 4096, 4096), (33, 200, 24)])
def test_int4_kernel_is_deterministic(dev, m, k, n):
    """The split-K blocks of a column tile sum their partials in rank order
    through the cluster's shared memory: two calls give equal bits."""
    leaf = Q.quantize_array_int4(_weights(dev, k, n, 11), group=64 if k % 128 == 0 else 20)
    g = leaf["s"].numel() // n
    x = _acts(dev, m, k, 11)
    s = leaf["s"].reshape(g, n)
    a = I4.int4_matmul(x, leaf["q4"], s, k // g, torch.float32)
    b = I4.int4_matmul(x, leaf["q4"], s, k // g, torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_qdot_kernel_route_and_activation_backward(dev, mode):
    """A decode-shaped ``qdot`` on the card launches the kernel, and its
    activation gradient is ``gy @ W^T`` with the dequantized weight."""
    w = _weights(dev, 512, 256, 9)
    leaf = Q.quantize_array(w) if mode == "int8" else Q.quantize_array_int4(w)
    counter = I8.int8_matmul if mode == "int8" else I4.int4_matmul
    x = _acts(dev, 6, 512, 9).reshape(2, 3, 512).requires_grad_()
    before = counter.launches
    y = I8.qdot(x, leaf, preferred_element_type=torch.float32)
    (gx,) = torch.autograd.grad(y.sum(), x)
    assert counter.launches == before + 1 and y.shape == (2, 3, 256)
    wdq = Q.dequantize_tree(leaf, torch.float32)
    _assert_close(y, x.detach().float() @ wdq, F32_REL_TOL)
    _assert_close(gx, (torch.ones((2, 3, 256), device=dev) @ wdq.T).to(gx.dtype))


@pytest.mark.parametrize("m", [3, 20, 64])
def test_w8a8_integer_product_on_card_is_exact(dev, m):
    """The card's int8 x int8 -> int32 product (``torch._int_mm``, rows
    padded past 16) equals the exact product."""
    g = torch.Generator(device=dev).manual_seed(10)
    xq = torch.randint(-127, 128, (m, 4096), generator=g, device=dev, dtype=torch.int8)
    q = torch.randint(-127, 128, (4096, 1536), generator=g, device=dev, dtype=torch.int8)
    got = I8._int_product(xq, q)
    want = (xq.cpu().double() @ q.cpu().double()).float()
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("m,k,n,x_dtype,out_dtype", [
    # run A's 64-token prefill, its bind-time K/V and perceiver calls, the
    # tool's serving prefill
    (64, 4096, 4096, torch.bfloat16, torch.bfloat16), (64, 4096, 11008, torch.bfloat16,
                                                       torch.float32),
    (64, 11008, 4096, torch.bfloat16, torch.float32), (64, 1280, 4096, torch.bfloat16,
                                                       torch.bfloat16),
    (321, 1280, 1536, torch.bfloat16, torch.bfloat16),
    (4096, 4096, 11008, torch.bfloat16, torch.bfloat16),
    # ragged M, K and N (K % 4 != 0: the scalar loads), f32 activations
    (1, 1280, 64, torch.float32, torch.float32), (17, 100, 33, torch.bfloat16, torch.float32),
    (130, 258, 70, torch.float32, torch.bfloat16), (65, 64, 8, torch.bfloat16, torch.bfloat16),
    # TMA with a ragged last stage and rows past M, split over a cluster;
    # plain loads (K % 16 != 0) split; the compute tile's rows past M
    (70, 400, 144, torch.bfloat16, torch.float32), (40, 1000, 136, torch.bfloat16, torch.float32),
    (600, 272, 272, torch.bfloat16, torch.bfloat16),
])
@pytest.mark.parametrize("tile", I8.W8A8_TILES)
def test_w8a8_kernels_equal_plain(dev, m, k, n, x_dtype, out_dtype, tile):
    leaf = Q.quantize_array(_weights(dev, k, n, 11))
    x = (_acts(dev, m, k, 11) * 3).to(x_dtype)
    x[0] = 0  # the floor scale
    before = I8.w8a8_matmul.launches
    got = I8.w8a8_matmul(x, leaf["q"], leaf["s"], out_dtype, tile=tile)
    xq, xs = I8.quantize_act_rows(x)
    pre = I8.w8a8_matmul_prequantized(xq, xs, leaf["q"], leaf["s"], out_dtype, tile=tile)
    torch.cuda.synchronize()
    assert I8.w8a8_matmul.launches == before + 2
    want = I8.w8a8_matmul_reference(x, leaf["q"], leaf["s"], out_dtype)
    for y in (got, pre):
        assert y.dtype == out_dtype and y.shape == (m, n)
        assert torch.equal(y, want)


def test_w8a8_kernel_quantizes_ties_to_even_and_takes_the_qdot_route(dev):
    """Rows of exact .5 ties after scaling (absmax 127: scale 1) round to the
    even neighbour, as the plain version; ``qdot(a8=True)`` launches the
    fused kernel and its activation gradient is ``gy @ W^T``."""
    k, n = 1280, 256
    leaf = Q.quantize_array(_weights(dev, k, n, 12))
    g = torch.Generator(device=dev).manual_seed(12)
    ties = torch.randint(0, 127, (8, k), generator=g, device=dev).float() + 0.5
    ties[:, 0] = 127.0
    x = (ties * torch.where(torch.rand((8, k), generator=g, device=dev) < 0.5, -1.0, 1.0))
    x = x.to(torch.bfloat16)
    xq, _ = I8.quantize_act_rows(x)
    assert ((xq.float() - x.float()).abs() == 0.5).float().mean() > 0.9
    assert torch.equal(I8.w8a8_matmul(x, leaf["q"], leaf["s"], torch.float32),
                       I8.w8a8_matmul_reference(x, leaf["q"], leaf["s"], torch.float32))
    xr = x.reshape(2, 4, k).requires_grad_()
    before = I8.w8a8_matmul.launches
    y = I8.qdot(xr, leaf, preferred_element_type=torch.float32, a8=True)
    (gx,) = torch.autograd.grad(y.sum(), xr)
    assert I8.w8a8_matmul.launches == before + 1 and y.shape == (2, 4, n)
    wdq = Q.dequantize_tree(leaf, torch.float32)
    _assert_close(gx, (torch.ones((2, 4, n), device=dev) @ wdq.T).to(gx.dtype))


def test_w8a8_kernel_rejects_wrong_operands(dev):
    leaf = Q.quantize_array(_weights(dev, 256, 64, 13))
    x = _acts(dev, 4, 256, 13)
    with pytest.raises(TypeError):
        I8.w8a8_matmul(x.to(torch.float16), leaf["q"], leaf["s"], torch.float32)
    with pytest.raises(ValueError):
        I8.w8a8_matmul(x[:, :128], leaf["q"], leaf["s"], torch.float32)


def _probe_operands(dev, m, k, n, g, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=dev)
    q = torch.randint(-7, 8, (k, n), generator=gen, device=dev).to(torch.int8)
    s = torch.rand((k // g, n), generator=gen, device=dev) * 0.01 + 0.001
    return x, q, s


@pytest.mark.parametrize("m,k,n,g", [
    (8, 4096, 11008, 64),  # the tool's shape
    (1, 512, 36, 64), (13, 1024, 132, 32), (8, 200, 44, 20), (9, 4096, 256, 128),
    # G = 8 (eight groups a stage), G = 128 (a group over two stages) with
    # two row blocks, G = 20 through TMA (K/2 = 320: ragged last stage)
    (5, 256, 64, 8), (20, 1024, 256, 128), (3, 640, 128, 20),
])
@pytest.mark.parametrize("schedule", P.SCHEDULES)
def test_int4_unpack_probe_matches_plain(dev, m, k, n, g, schedule):
    x, q, s = _probe_operands(dev, m, k, n, g, 14)
    packed, table = P.probe_operands(q, s, schedule)
    before = P.int4_unpack_probe.launches
    got = P.int4_unpack_probe(x, packed, table, g, schedule)
    torch.cuda.synchronize()
    assert P.int4_unpack_probe.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (m, n)
    _assert_close(got, P.int4_unpack_probe_reference(x, packed, table, g, schedule),
                  F32_REL_TOL)
    w = (q.float().reshape(k // g, g, n) * s.reshape(k // g, 1, n)).reshape(k, n)
    _assert_close(got, x.to(torch.bfloat16).float() @ w, REL_TOL)  # the same function


def test_int4_unpack_probe_rejects_unaligned_shapes(dev):
    x, q, s = _probe_operands(dev, 2, 256, 34, 64, 15)
    packed, table = P.probe_operands(q, s, "a")
    with pytest.raises(ValueError):
        P.int4_unpack_probe(x, packed, table, 64, "a")  # N % 4 != 0
