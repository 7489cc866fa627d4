"""Port vs JAX: the ICV injection's plain version.

Held against ``_icv_inject_pallas(..., interpret=True)`` (the TPU kernel run
by the Pallas interpreter, as the JAX package's own tests run it on the
CPU) and ``icv_inject_reference``, for every shift layout.  f32 rtol=1e-5;
bf16 input within one bf16 ulp of the reference's own rounding.  The entry
points with the residual add folded in (``icv_inject_after_add``,
``add_icv_inject``) against JAX's add then injection and injection then
add, values and ``jax.vjp`` gradients, f32, 1e-5 of max|JAX|.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from licv_vqa_tpu.ops.icv_inject import _bwd as jx_bwd
from licv_vqa_tpu.ops.icv_inject import _icv_inject_pallas
from licv_vqa_tpu.ops.icv_inject import icv_inject as jx_inject
from licv_vqa_tpu.ops.icv_inject import icv_inject_reference as jx_ref
from licv_vqa_tpu_torch.ops.icv_inject import (
    add_icv_inject,
    icv_inject,
    icv_inject_after_add,
    icv_inject_reference,
)

B, S, D = 2, 5, 128


SHIFT_SHAPES = {"row": (D,), "batch": (B, D), "batch1": (B, 1, D), "per_pos": (B, S, D),
                "pos": (1, S, D)}


def _shift(rng, layout):
    return rng.normal(size=SHIFT_SHAPES[layout]).astype(np.float32)


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


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("site", ["after_add", "add_after"])
@pytest.mark.parametrize("layout", list(SHIFT_SHAPES))
def test_fused_residual_entries_match_jax_add_and_injection(site, layout):
    """``icv_inject_after_add(h, delta, v)`` against JAX's ``h + delta`` then
    ``icv_inject`` (the block output's site), ``add_icv_inject(h, x, v)``
    against ``icv_inject`` of x then ``h + x'`` (the MLP output's): the CPU
    path (their plain versions, differentiated by autograd), value and the
    gradients with respect to h, the other operand and the shift."""
    rng = np.random.default_rng(7)
    h = rng.normal(size=(B, S, D)).astype(np.float32)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    v = (_shift(rng, layout) * 0.5).astype(np.float32)
    g = rng.normal(size=(B, S, D)).astype(np.float32)
    jv = v[:, None, :] if layout == "batch" else v  # the port's (B, D) is JAX's (B, 1, D)

    def jax_fn(hh, xx, vv):
        if site == "after_add":
            return jx_inject(hh + xx, vv)
        return hh + jx_inject(xx, vv)

    want, vjp = jax.vjp(jax_fn, jnp.asarray(h), jnp.asarray(x), jnp.asarray(jv))
    want_grads = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    want_grads[2] = want_grads[2].reshape(v.shape)

    ht, xt, vt = (torch.tensor(a, requires_grad=True) for a in (h, x, v))
    entry = icv_inject_after_add if site == "after_add" else add_icv_inject
    got = entry(ht, xt, vt)
    grads = torch.autograd.grad(got, (ht, xt, vt), torch.from_numpy(g))
    assert _rel_err(got.detach().numpy(), want) <= 1e-5
    for name, a, b in zip(("h", "x", "shift"), grads, want_grads):
        assert a.shape == b.shape and _rel_err(a.numpy(), b) <= 1e-5, name
    assert icv_inject.launches == 0  # CPU tensors never launch the kernel


@pytest.mark.parametrize("layout", list(SHIFT_SHAPES))
def test_backward_matches_jax_bwd(layout):
    """``icv_inject_backward`` (its plain version on the CPU) against JAX's
    ``_bwd``: dh, and the shift's gradient reduced to the shift's shape (a
    (1, S, D) shift shared by the B rows summed over b at each position),
    f32, 1e-5 of max|JAX|."""
    rng = np.random.default_rng(11)
    h = rng.normal(size=(B, S, D)).astype(np.float32)
    v = (_shift(rng, layout) * 0.5).astype(np.float32)
    g = rng.normal(size=(B, S, D)).astype(np.float32)
    jv = v[:, None, :] if layout == "batch" else v  # the port's (B, D) is JAX's (B, 1, D)
    want_dh, want_dv = jx_bwd((jnp.asarray(h), jnp.asarray(jv)), jnp.asarray(g))
    got_dh, got_dv = BWD.icv_inject_backward(*(torch.from_numpy(a) for a in (h, v, g)))
    assert got_dv.shape == v.shape and got_dv.dtype == torch.float32
    assert _rel_err(got_dh.numpy(), want_dh) <= 1e-5
    assert _rel_err(got_dv.numpy(), np.asarray(want_dv).reshape(v.shape)) <= 1e-5


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
@pytest.mark.parametrize("layout", ["row", "batch", "batch1", "per_pos", "pos"])
def test_backward_plan_covers_every_row_and_sums_the_shift_grad(b, s, layout, max_blocks):
    """The plan the wrapper launches: every row in exactly one block of its
    segment (the rows one gradient row sums: a position's rows of every
    batch row for a (1, S, D) shift), whole clusters of at most 8 blocks a
    segment (one a block without a reduction), about ``max_blocks`` blocks
    in all (a card's one wave of clusters, at most ``BWD_BLOCKS``) where the
    rows allow, and the blocks' sums, their clusters' and the clusters' in
    order equal to ``reduce_shift_grad`` of the per-row ds (f32, max-abs
    error at most 1e-6 of max|plain|); a per-position shift takes no
    reduction."""
    d = 16
    rng = np.random.default_rng(b * 100 + s)
    ds = torch.from_numpy(rng.normal(size=(b, s, d)).astype(np.float32))
    vshape = {"row": (d,), "batch": (b, d), "batch1": (b, 1, d), "per_pos": (b, s, d),
              "pos": (1, s, d)}[layout]
    shift = torch.zeros(vshape)
    kind = BWD._shift_layout(BWD._per_row_shift(torch.zeros(b, s, d), shift))
    plan = BWD.backward_plan(b, s, kind, max_blocks)
    covered = sorted(r for blk in range(plan.blocks) for r in plan.rows(blk))
    assert covered == list(range(b * s))
    for blk in range(plan.blocks):
        seg = blk // plan.blocks_per_seg
        assert set(plan.rows(blk)) <= set(plan.segment_rows(seg))
    if plan.reduce:  # a segment's rows are those its gradient row sums
        index = torch.arange(b * s, dtype=torch.float64).reshape(b, s, 1).expand(b, s, d)
        sums = BWD.reduce_shift_grad(index, shift).reshape(-1, d)[:, 0]
        assert sums.tolist() == [sum(plan.segment_rows(g)) for g in range(plan.segments)]
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
    ((1, 5, 16), 3, 5, "pos"),
])
def test_shift_layouts_the_backward_kernel_takes(vshape, b, s, kind):
    """Each shift layout the forward takes, read from its broadcast strides:
    one gradient row over every row, one a batch row, one a position shared
    by the batch, or one a row."""
    rows = BWD._per_row_shift(torch.zeros(b, s, 16), torch.zeros(vshape))
    assert BWD._shift_layout(rows) == kind


def test_a_shift_per_position_shared_by_the_batch_is_refused():
    """(1, S, D) broadcast over B > 1 rows is the "pos" layout, which the
    kernel takes: S segments of B rows each (row b of position j is
    b * S + j), the gradient summed over b at each position."""
    rows = BWD._per_row_shift(torch.zeros(3, 5, 16), torch.zeros(1, 5, 16))
    assert BWD._shift_layout(rows) == "pos"
    plan = BWD.backward_plan(3, 5, "pos")
    assert (plan.segments, plan.seg_rows, plan.seg_step, plan.row_step) == (5, 3, 1, 5)
    assert list(plan.segment_rows(2)) == [2, 7, 12]
