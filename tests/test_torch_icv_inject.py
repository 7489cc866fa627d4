"""Port vs JAX: the ICV injection's plain version.

Held against ``_icv_inject_pallas(..., interpret=True)`` (the TPU kernel run
by the Pallas interpreter, as the JAX package's own tests run it on the
CPU) and ``icv_inject_reference``, for every shift layout.  f32 rtol=1e-5;
bf16 input within one bf16 ulp of the reference's own rounding.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from licv_vqa_tpu.ops.icv_inject import _icv_inject_pallas
from licv_vqa_tpu.ops.icv_inject import icv_inject_reference as jx_ref
from licv_vqa_tpu_torch.ops.icv_inject import icv_inject, icv_inject_reference

B, S, D = 2, 5, 128


def _shift(rng, layout):
    shape = {"row": (D,), "batch": (B, D), "batch1": (B, 1, D), "per_pos": (B, S, D)}[layout]
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("layout", ["row", "batch", "batch1", "per_pos"])
def test_plain_matches_jax_reference_and_pallas_interpret(layout):
    rng = np.random.default_rng(0)
    h = rng.normal(size=(B, S, D)).astype(np.float32)
    v = _shift(rng, layout)
    got = icv_inject(torch.from_numpy(h), torch.from_numpy(v)).numpy()
    # the JAX reference broadcasts; the (B, D) layout is the kernel's
    v_ref = v[:, None, :] if layout == "batch" else v
    want = np.asarray(jx_ref(jnp.asarray(h), jnp.asarray(v_ref)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if layout != "per_pos":  # the TPU kernel takes row-constant shifts only
        kern = np.asarray(_icv_inject_pallas(jnp.asarray(h), jnp.asarray(v), interpret=True))
        np.testing.assert_allclose(got, kern, rtol=1e-5, atol=1e-6)
    # norm preserved row by row
    np.testing.assert_allclose(
        np.linalg.norm(got, axis=-1), np.linalg.norm(h, axis=-1), rtol=1e-5
    )
    assert icv_inject.launches == 0  # CPU tensors never launch the kernel


def test_bf16_input_matches_jax():
    rng = np.random.default_rng(1)
    h = rng.normal(size=(B, S, D)).astype(np.float32)
    v = rng.normal(size=(D,)).astype(np.float32)
    ht = torch.from_numpy(h).to(torch.bfloat16)
    vt = torch.from_numpy(v).to(torch.bfloat16)
    got = icv_inject_reference(ht, vt)
    assert got.dtype == torch.bfloat16
    hj = jnp.asarray(ht.float().numpy()).astype(jnp.bfloat16)
    vj = jnp.asarray(vt.float().numpy()).astype(jnp.bfloat16)
    want = np.asarray(jx_ref(hj, vj).astype(jnp.float32))
    # f32 math on identical bf16 inputs, one rounding at the end: at most
    # one bf16 ulp apart where the f32 sums round differently
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-7, atol=0)


def test_h_equals_minus_v_is_nan_in_both():
    """No epsilon (icv_inject.py:24): s = 0 → 0·∞ = NaN, on both sides."""
    rng = np.random.default_rng(2)
    h = rng.normal(size=(1, 2, D)).astype(np.float32)
    v = -h[0, 0]
    got = icv_inject(torch.from_numpy(h), torch.from_numpy(v)).numpy()
    want = np.asarray(jx_ref(jnp.asarray(h), jnp.asarray(v)))
    assert np.isnan(got[0, 0]).all() and np.isnan(want[0, 0]).all()
    assert np.isfinite(got[0, 1]).all()
    np.testing.assert_allclose(got[0, 1], want[0, 1], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# The backward kernel's reduction of the shift's gradient (``backward_plan``)
# ---------------------------------------------------------------------------

BWD = importlib.import_module("licv_vqa_tpu_torch.ops.icv_inject")


def emulate_shift_grad(ds: torch.Tensor, plan) -> torch.Tensor:
    """``(segments, D)`` f32 of the kernel's reduction: each block adds its
    rows' ds (f32) in row order; each cluster sums its blocks' sums in rank
    order into one partial; each segment's partials are summed in cluster
    order in two halves (the first ceil(n/2) and the rest, each in order,
    then added)."""
    flat = ds.reshape(-1, ds.shape[-1]).float()
    blocks = []
    for blk in range(plan.blocks):
        acc = torch.zeros(flat.shape[1])
        for r in plan.rows(blk):
            acc = acc + flat[r]
        blocks.append(acc)
    partials = []
    for c in range(plan.clusters):  # a segment's clusters are consecutive
        tot = torch.zeros(flat.shape[1])
        for rank in range(plan.cluster):
            tot = tot + blocks[c * plan.cluster + rank]
        partials.append(tot)
    per_seg = plan.clusters // plan.segments
    per_half = -(-per_seg // 2)
    out = []
    for seg in range(plan.segments):
        if per_seg == 1:  # one cluster: its sum is the gradient
            out.append(partials[seg])
            continue
        halves = []
        for lo, hi in ((0, per_half), (per_half, per_seg)):
            tot = torch.zeros(flat.shape[1])
            for c in range(seg * per_seg + lo, seg * per_seg + hi):
                tot = tot + partials[c]
            halves.append(tot)
        out.append(halves[0] + halves[1])
    return torch.stack(out)


# (B, S): training's student, the flagship student, one 512-token row, and
# B.S not a multiple of the rows a block takes (ragged steps, empty blocks)
BWD_SHAPES = ((2, 64), (4, 256), (1, 512), (3, 37), (5, 3), (1, 1), (7, 129))


@pytest.mark.parametrize("max_blocks", [BWD.BWD_BLOCKS, 40])
@pytest.mark.parametrize("b,s", BWD_SHAPES)
@pytest.mark.parametrize("layout", ["row", "batch", "batch1", "per_pos"])
def test_backward_plan_covers_every_row_and_sums_the_shift_grad(b, s, layout, max_blocks):
    """The plan the wrapper launches: every row in exactly one block of its
    segment, whole clusters of at most 8 blocks a segment (one a block
    without a reduction), about ``max_blocks`` blocks in all (a card's one
    wave of clusters, at most ``BWD_BLOCKS``) where the rows allow, and the blocks' sums, their clusters' and the clusters' in
    order equal to ``reduce_shift_grad`` of the per-row ds (f32, max-abs
    error at most 1e-6 of max|plain|); a per-position shift takes no
    reduction."""
    d = 16
    rng = np.random.default_rng(b * 100 + s)
    ds = torch.from_numpy(rng.normal(size=(b, s, d)).astype(np.float32))
    vshape = {"row": (d,), "batch": (b, d), "batch1": (b, 1, d), "per_pos": (b, s, d)}[layout]
    shift = torch.zeros(vshape)
    kind = BWD._shift_layout(BWD._per_row_shift(torch.zeros(b, s, d), shift))
    plan = BWD.backward_plan(b, s, kind, max_blocks)
    covered = sorted(r for blk in range(plan.blocks) for r in plan.rows(blk))
    assert covered == list(range(b * s))
    for blk in range(plan.blocks):
        seg = blk // plan.blocks_per_seg
        rows = plan.rows(blk)
        assert all(seg * plan.seg_rows <= r < (seg + 1) * plan.seg_rows for r in rows)
    assert plan.rows_per_block % BWD.BWD_STEP_ROWS == 0
    assert plan.blocks_per_seg % plan.cluster == 0 and plan.cluster <= BWD.BWD_MAX_CLUSTER
    steps = -(-plan.seg_rows // BWD.BWD_STEP_ROWS)
    want = max(1, min(BWD.BWD_BLOCKS, max_blocks) // plan.segments)  # whole clusters
    assert plan.blocks_per_seg <= -(-want // plan.cluster) * plan.cluster
    assert plan.blocks_per_seg < steps + plan.cluster
    if not plan.reduce:
        assert kind == "per_pos" and plan.cluster == 1
        return
    want = BWD.reduce_shift_grad(ds, shift).float()
    got = emulate_shift_grad(ds, plan).reshape(want.shape)
    # the two differ by summation order only (about 2e-7 of max|want|)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()


@pytest.mark.parametrize("vshape,b,s,kind", [
    ((16,), 3, 5, "row"), ((1, 16), 3, 5, "row"), ((1, 1, 16), 3, 5, "row"),
    ((3, 16), 3, 5, "batch"), ((3, 1, 16), 3, 5, "batch"), ((3, 5, 16), 3, 5, "per_pos"),
    ((1, 5, 16), 1, 5, "per_pos"), ((3, 16), 3, 1, "batch"), ((16,), 1, 1, "row"),
])
def test_shift_layouts_the_backward_kernel_takes(vshape, b, s, kind):
    """Each shift layout the forward takes, read from its broadcast strides:
    one gradient row over every row, one a batch row, or one a position."""
    rows = BWD._per_row_shift(torch.zeros(b, s, 16), torch.zeros(vshape))
    assert BWD._shift_layout(rows) == kind


def test_a_shift_per_position_shared_by_the_batch_is_refused():
    """(1, S, D) broadcast over B > 1 rows would sum over b at each
    position: no segment of consecutive rows, so the kernel refuses it by
    name."""
    rows = BWD._per_row_shift(torch.zeros(3, 5, 16), torch.zeros(1, 5, 16))
    with pytest.raises(ValueError, match="not a layout"):
        BWD._shift_layout(rows)
