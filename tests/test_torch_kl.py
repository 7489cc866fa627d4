"""Port vs JAX: the masked temperature-KL and the ICV-injection backward
(CPU, f32).

The same numpy inputs go through ``licv_vqa_tpu.ops`` (``impl="xla"`` and the
Pallas kernel in interpret mode) and the port's ``impl="xla"`` and
``impl="pallas"`` (on the CPU: the kernels' plain versions, including the
closed-form backward).  Values and the gradients with respect to student,
teacher and temperature must agree to 1e-5 relative (max-abs error over
max-abs value; f32, the two differ in summation order).  V = 257 and
N = 15 rows: not a multiple of 8, so the JAX kernel pads rows and the port
does not.  The port's per-row op takes the row weights: a row of weight 0
is 0 in value and gradients, as JAX's masked mean makes it, for one
weighted row, a sparse, a full and an empty mask.  The CUDA kernels' plan
(a row split over a cluster of blocks, the slices' (max, Σexp) pairs merged
in rank order) is emulated at V = 32000 and 32002.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from licv_vqa_tpu.ops import kl as jx_kl
from licv_vqa_tpu_torch.ops import kl as pt_kl
from licv_vqa_tpu_torch.ops import masked_kl_kernel as pt_kernel

# the packages' ``ops`` re-export the function under the module's name
jx_inject = importlib.import_module("licv_vqa_tpu.ops.icv_inject")
pt_inject = importlib.import_module("licv_vqa_tpu_torch.ops.icv_inject")

REL = 1e-5
B, S, V = 3, 5, 257


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _kl_inputs(seed=0):
    rng = np.random.default_rng(seed)
    stu = (rng.normal(size=(B, S, V)) * 3).astype(np.float32)
    tea = (rng.normal(size=(B, S, V)) * 3).astype(np.float32)
    mask = rng.random((B, S)) < 0.6
    mask[0, 0] = True
    return stu, tea, mask


def _jax_kl_and_grads(stu, tea, mask, temp, impl):
    def f(s, t, temperature):
        return jx_kl.masked_kl_divergence(
            s, t, jnp.asarray(mask), temperature, 1e-6, impl=impl
        )

    val, grads = jax.value_and_grad(f, argnums=(0, 1, 2))(
        jnp.asarray(stu), jnp.asarray(tea), jnp.float32(temp)
    )
    return float(val), [np.asarray(g) for g in grads]


def _port_kl_and_grads(stu, tea, mask, temp, impl):
    s = torch.tensor(stu, requires_grad=True)
    t = torch.tensor(tea, requires_grad=True)
    temperature = torch.tensor(temp, dtype=torch.float32, requires_grad=True)
    val = pt_kl.masked_kl_divergence(s, t, torch.from_numpy(mask), temperature, 1e-6, impl=impl)
    grads = torch.autograd.grad(val, (s, t, temperature))
    return float(val.detach()), [g.numpy() for g in grads]


@pytest.fixture(scope="module")
def jax_refs():
    stu, tea, mask = _kl_inputs()
    return {
        impl: _jax_kl_and_grads(stu, tea, mask, 1.7, impl)
        for impl in ("xla", "pallas_interpret")
    }


@pytest.mark.parametrize("jax_impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_masked_kl_matches_jax(jax_refs, impl, jax_impl):
    stu, tea, mask = _kl_inputs()
    want_val, want_grads = jax_refs[jax_impl]
    got_val, got_grads = _port_kl_and_grads(stu, tea, mask, 1.7, impl)
    assert abs(got_val - want_val) <= REL * abs(want_val), (got_val, want_val)
    for name, g, w in zip(("student", "teacher", "temperature"), got_grads, want_grads):
        assert _rel_err(g, w) <= REL, (name, _rel_err(g, w))


def test_masked_kl_empty_mask_is_zero():
    stu, tea, _ = _kl_inputs(1)
    mask = np.zeros((B, S), bool)
    for impl in ("xla", "pallas"):
        val, grads = _port_kl_and_grads(stu, tea, mask, 1.0, impl)
        assert val == 0.0 and all(np.all(g == 0) for g in grads[:2]), impl


def _mask(kind: str, seed: int = 6) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "one":
        m = np.zeros((B, S), bool)
        m[1, 3] = True
    elif kind == "sparse":
        m = rng.random((B, S)) < 0.2
        m[2, 4] = True
    else:
        m = np.full((B, S), kind == "full")
    return m


@pytest.mark.parametrize("temp", [1.0, 1.7])
@pytest.mark.parametrize("kind", ["one", "sparse", "full", "empty"])
def test_masked_kl_pallas_with_row_weights_matches_jax(kind, temp):
    """The port's ``impl="pallas"`` on the CPU (the per-row op's plain
    versions with the mask as row weights: zero-weight rows 0 in value and
    gradients) against JAX's Pallas kernel in interpret mode: the value and
    the gradients with respect to student, teacher and temperature."""
    stu, tea, _ = _kl_inputs(3)
    mask = _mask(kind)
    want_val, want_grads = _jax_kl_and_grads(stu, tea, mask, temp, "pallas_interpret")
    got_val, got_grads = _port_kl_and_grads(stu, tea, mask, temp, "pallas")
    assert abs(got_val - want_val) <= REL * max(abs(want_val), 1e-30), (got_val, want_val)
    for name, g, w in zip(("student", "teacher", "temperature"), got_grads, want_grads):
        if not mask.any():
            assert np.all(g == 0) and np.all(w == 0), name
            continue
        assert _rel_err(g, w) <= REL, (name, _rel_err(g, w))
        if name != "temperature":  # the masked rows: zero gradients, as in JAX
            assert np.all(g[~mask] == 0) and np.all(np.asarray(w)[~mask] == 0), name


def test_zero_weight_rows_are_zero_whatever_their_logits():
    """A row of weight 0 is neither read nor differentiated: KL, log-sum-exps
    and both gradients 0, even where its logits are not finite; the other
    rows as without weights."""
    rng = np.random.default_rng(8)
    stu = torch.from_numpy(rng.normal(size=(4, V)).astype(np.float32) * 3)
    tea = torch.from_numpy(rng.normal(size=(4, V)).astype(np.float32) * 3)
    stu[1, 5] = float("nan")
    tea[3, 0] = float("inf")
    w = torch.tensor([1.0, 0.0, 0.5, 0.0])
    g = torch.tensor([0.3, 0.0, 0.2, 0.0])
    kl, lse_s, lse_t = pt_kernel.rowwise_kl_forward(stu, tea, 1e-6, w)
    ref = pt_kernel.rowwise_kl_reference(stu[[0, 2]], tea[[0, 2]], 1e-6)
    for got, want in zip((kl, lse_s, lse_t), ref):
        assert torch.all(got[[1, 3]] == 0)
        torch.testing.assert_close(got[[0, 2]], want, rtol=0, atol=0)
    dstu, dtea = pt_kernel.rowwise_kl_backward(stu, tea, lse_s, lse_t, g, 1e-6, w)
    assert torch.all(dstu[[1, 3]] == 0) and torch.all(dtea[[1, 3]] == 0)
    assert torch.isfinite(dstu).all() and torch.isfinite(dtea).all()


def test_rowwise_kl_plain_forward_and_backward_agree_with_autograd():
    """The closed-form backward (the kernel's formulas) against autograd of
    the plain forward, per row with arbitrary cotangents."""
    rng = np.random.default_rng(2)
    stu = torch.tensor(rng.normal(size=(7, V)).astype(np.float32) * 4, requires_grad=True)
    tea = torch.tensor(rng.normal(size=(7, V)).astype(np.float32) * 4, requires_grad=True)
    g = torch.tensor(rng.normal(size=(7,)).astype(np.float32))
    kl, lse_s, lse_t = pt_kernel.rowwise_kl_reference(stu, tea, 1e-6)
    want = torch.autograd.grad(kl, (stu, tea), g)
    got = pt_kernel.rowwise_kl_backward_reference(
        stu.detach(), tea.detach(), lse_s.detach(), lse_t.detach(), g, 1e-6
    )
    for a, b in zip(got, want):
        assert _rel_err(a.numpy(), b.numpy()) <= REL


def test_answer_region_mask_and_gather_match_jax():
    rng = np.random.default_rng(3)
    ids = rng.integers(1, 50, size=(4, 9)).astype(np.int32)
    ids[1, 6:] = 0
    ids[3, 2:] = 0
    lengths = np.array([2, 3, 0, 1], np.int32)
    want = np.asarray(jx_kl.answer_region_mask(jnp.asarray(ids), jnp.asarray(lengths), 0))
    got = pt_kl.answer_region_mask(torch.from_numpy(ids), torch.from_numpy(lengths), 0)
    np.testing.assert_array_equal(got.numpy(), want)

    tea = rng.normal(size=(4, 13, 6)).astype(np.float32)
    icl = np.array([5, 9, 12, 0], np.int32)
    qx = np.array([2, 3, 1, 4], np.int32)
    want = np.asarray(jx_kl.aligned_teacher_gather(
        jnp.asarray(tea), jnp.asarray(icl), jnp.asarray(qx), 9
    ))
    got = pt_kl.aligned_teacher_gather(
        torch.from_numpy(tea), torch.from_numpy(icl), torch.from_numpy(qx), 9
    )
    np.testing.assert_array_equal(got.numpy(), want)


def test_shifted_cross_entropy_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(3, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, size=(3, 7)).astype(np.int32)
    labels[0, 4:] = -100
    labels[2, :] = -100
    want = float(jx_kl.shifted_cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(pt_kl.shifted_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels)))
    assert got == pytest.approx(want, rel=1e-6)


# ---------------------------------------------------------------------------
# The CUDA kernels' plan, emulated
# ---------------------------------------------------------------------------


THREADS, CHUNK = 256, 1024  # csrc/masked_kl.cu's kThreads and kChunk


def _exp_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """exp(a - b), 0 where a is -inf (a max over no element)."""
    return torch.where(a == -torch.inf, torch.zeros_like(a), torch.exp(a - b))


def _emulated_block(x: torch.Tensor, misalign: int):
    """One block's first pass over its slice ``x`` of one operand, as the
    forward kernel runs it: the slice at shared indices [m, m + len) in
    chunks of 256 quads, each thread a running (max, Σexp) over its quads
    with the exps kept relative to its running max after each chunk.
    Returns the block's (max, Σexp) pair, the kept exps (chunks, threads,
    4) and each thread's running max after each chunk (chunks, threads)."""
    n_chunks = -(-(x.numel() + misalign) // CHUNK)
    shared = torch.full((n_chunks * CHUNK,), -torch.inf)
    shared[misalign:misalign + x.numel()] = x
    quads = shared.reshape(n_chunks, THREADS, 4)
    run, total = torch.full((THREADS,), -torch.inf), torch.zeros(THREADS)
    kept, chunk_max = torch.zeros_like(quads), torch.zeros(n_chunks, THREADS)
    for j in range(n_chunks):
        m = torch.maximum(run, quads[j].max(dim=1).values)
        kept[j] = _exp_diff(quads[j], m[:, None])
        total = total * _exp_diff(run, m) + kept[j].sum(dim=1)
        run = chunk_max[j] = m
    bmax = run.max()
    return (bmax, torch.sum(total * _exp_diff(run, bmax))), kept, chunk_max


def _emulated_forward(stu: torch.Tensor, tea: torch.Tensor, eps: float, plan):
    """The forward kernel's arithmetic in f32 (``_emulated_block`` in each
    block of the cluster), the blocks' pairs merged in rank order into the
    log-sum-exps, p and q as the kept exps times exp(running max − lse),
    the slices' KL sums added in rank order.  Returns (KL, the pairs'
    log-sum-exps)."""
    v = stu.shape[1]
    kl, lse = [], []
    for r, (x_row, y_row) in enumerate(zip(stu, tea)):
        misalign = (r * v) % 4
        blocks = [[_emulated_block(row[sl.start:sl.stop], misalign) for row in (x_row, y_row)]
                  for sl in plan.slices(v)]
        row_lse = []
        for o in range(2):
            pairs = [blk[o][0] for blk in blocks]
            m = max(pr[0] for pr in pairs)
            total = torch.tensor(0.0)
            for pm, ps in pairs:  # in rank order
                total = total + ps * torch.exp(pm - m)
            row_lse.append(m + torch.log(total))
        acc = torch.tensor(0.0)
        for (_, ks, ms), (_, kt, mt) in blocks:
            p = ks * _exp_diff(ms, row_lse[0])[:, :, None]
            q = kt * _exp_diff(mt, row_lse[1])[:, :, None]
            acc = acc + torch.sum(q * (torch.log(q + eps) - torch.log(p + eps)))
        kl.append(acc)
        lse.append(row_lse)
    return torch.stack(kl), torch.tensor(lse)


@pytest.mark.parametrize("v", [32000, 32002, 257, 4099])
@pytest.mark.parametrize("cluster", pt_kernel.KL_CLUSTERS)
def test_kl_cluster_slices_cover_the_row_and_merge_to_logsumexp(v, cluster):
    """Each split the plan can launch: whole 16-byte quads a slice (widths
    a multiple of 4 columns), no empty slice, the slices covering V once;
    the rank-order merge of the slices' (max, Σexp) pairs (each from its
    threads' running pairs over the chunks as they land) equals
    ``torch.logsumexp`` within 1e-6 relative, and the slices' KL sums the
    plain KL within 1e-5 of max|KL|.  Rows 0 and 1: at V = 32002 the second
    starts 8 bytes past a 16-byte boundary."""
    plan = pt_kernel._split(v, cluster)
    assert plan.cluster <= cluster and plan.width % 4 == 0
    cols = [c for sl in plan.slices(v) for c in sl]
    assert cols == list(range(v)) and all(len(sl) > 0 for sl in plan.slices(v))
    rng = np.random.default_rng(v + cluster)
    stu = torch.from_numpy(rng.normal(size=(2, v)).astype(np.float32) * 3)
    tea = torch.from_numpy(rng.normal(size=(2, v)).astype(np.float32) * 3)
    kl, lse = _emulated_forward(stu, tea, 1e-6, plan)
    want_kl, want_s, want_t = pt_kernel.rowwise_kl_reference(stu, tea, 1e-6)
    for got, want in ((lse[:, 0], torch.logsumexp(stu, -1)), (lse[:, 1], torch.logsumexp(tea, -1))):
        assert ((got - want).abs() <= 1e-6 * want.abs()).all()
    assert _rel_err(kl.numpy(), want_kl.numpy()) <= 1e-5


def _emulated_cluster_rows(w: np.ndarray, c: int, clusters: int):
    """The kernel's ``cluster_rows``: tiles of 256 rows, each warp's weighted
    and zero-weight rows counted by a ballot, a row's rank among its kind
    the rows before it; cluster c takes the ranks that are c modulo the
    grid's clusters.  Returns (weighted rows, zero rows) in row order."""
    lists = ([], [])
    base = [0, 0]
    for r0 in range(0, len(w), 256):
        tile = w[r0:r0 + 256]
        for kind, rows in enumerate(lists):
            hit = (tile != 0) if kind == 0 else (tile == 0)
            ranks = base[kind] + np.cumsum(hit) - 1
            rows += [r0 + i for i in np.flatnonzero(hit) if ranks[i] % clusters == c]
            base[kind] += int(hit.sum())
    return lists


@pytest.mark.parametrize("n,clusters", [(128, 30), (128, 45), (512, 30), (600, 7), (5, 45)])
def test_kl_persistent_grid_takes_every_row_once(n, clusters):
    """The persistent grid's rows: every row in exactly one cluster's list,
    the weighted ones spread evenly (answer rows lie together, so a
    contiguous split would load a few clusters), none longer than the
    kernel's lists (``KL_MAX_ROWS``)."""
    rng = np.random.default_rng(n)
    w = np.zeros(n, np.float32)
    w[n // 3:n // 3 + max(1, n // 16)] = 1.0  # one contiguous answer region
    w[rng.random(n) < 0.1] = 0.5
    got = [_emulated_cluster_rows(w, c, clusters) for c in range(clusters)]
    weighted = sorted(r for rw, _ in got for r in rw)
    zero = sorted(r for _, rz in got for r in rz)
    assert weighted == list(np.flatnonzero(w != 0)) and zero == list(np.flatnonzero(w == 0))
    sizes = [len(rw) for rw, _ in got]
    assert max(sizes) - min(sizes) <= 1
    assert max(max(sizes), max(len(rz) for _, rz in got)) <= pt_kernel.KL_MAX_ROWS


def test_kl_launch_plan_takes_the_fewest_waves_and_the_larger_cluster_on_a_tie():
    """The cluster size from the card's occupancy, by the columns a block
    takes in turn: at 128 rows, 8 blocks a row when the card runs 128 such
    clusters at once; 4 when it runs 128 of those and only 60 of 8; 8 over
    2 where 2 fit a few more clusters (the backward's occupancy on the
    H100); at 32002 columns slices of 4004 columns (the last 3974); a
    narrow row takes fewer, wider blocks; a split the card cannot run is
    skipped; the grid is the clusters the card runs at once, or one a row
    where fewer."""
    table = {8: 128, 4: 128, 2: 90, 1: 132}
    plan = pt_kernel.launch_plan(128, 32000, lambda pl: table[pl.cluster])
    assert (plan.cluster, plan.width, plan.clusters) == (8, 4000, 128)
    table[8] = 60  # three rows of 4000 columns a cluster against one of 8000
    plan = pt_kernel.launch_plan(128, 32000, lambda pl: table[pl.cluster])
    assert (plan.cluster, plan.clusters) == (4, 128)
    # two rows of 16000 columns a cluster lose to three of 4000
    table = {8: 62, 4: 62, 2: 66, 1: 0}
    plan = pt_kernel.launch_plan(128, 32000, lambda pl: table[pl.cluster])
    assert (plan.cluster, plan.clusters) == (8, 62)
    plan = pt_kernel.launch_plan(128, 32002, lambda pl: 128)
    assert (plan.cluster, plan.width) == (8, 4004)
    assert [len(sl) for sl in plan.slices(32002)][-1] == 3974
    assert pt_kernel.launch_plan(15, 257, lambda pl: 100).cluster == 1
    assert pt_kernel.launch_plan(4, 2100, lambda pl: 100).cluster == 2
    # a split whose slices do not fit a block (the card runs none) is never taken
    assert pt_kernel.launch_plan(128, 32000, lambda pl: 5 if pl.cluster == 2 else 0).cluster == 2
    with pytest.raises(ValueError, match="fits"):
        pt_kernel.launch_plan(128, 32000, lambda pl: 0)
    assert pt_kernel.launch_plan(8, 32000, lambda pl: 62).clusters == 8
    with pytest.raises(ValueError, match="exceed"):  # the kernel's row lists
        pt_kernel.launch_plan(300 * 62, 32000, lambda pl: 62)


# ---------------------------------------------------------------------------
# ICV-injection backward
# ---------------------------------------------------------------------------

D = 48
_LAYOUTS = {
    "row": ((2, 5, D), (D,)),
    "batch": ((2, 5, D), (2, D)),  # the port's per-batch-row layout
    "batch1": ((2, 5, D), (2, 1, D)),
    "per_pos": ((2, 5, D), (2, 5, D)),
    # a per-position shift shared by the batch: JAX's _bwd sums it over b
    "pos": ((2, 5, D), (1, 5, D)),
}


@pytest.mark.parametrize("layout", list(_LAYOUTS))
def test_icv_inject_grad_matches_jax(layout):
    hshape, vshape = _LAYOUTS[layout]
    rng = np.random.default_rng(5)
    h = rng.normal(size=hshape).astype(np.float32)
    v = (rng.normal(size=vshape) * 0.5).astype(np.float32)
    g = rng.normal(size=hshape).astype(np.float32)
    # JAX broadcasts a (B, D) shift against (B, S, D) as (1, B, D); the port
    # reads it per batch row, which JAX spells (B, 1, D)
    jv = v[:, None, :] if layout == "batch" else v

    def f(hh, vv):
        return jnp.sum(jx_inject.icv_inject(hh, vv) * jnp.asarray(g))

    want_dh, want_dv = jax.grad(f, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(jv))
    want_dv = np.asarray(want_dv).reshape(vshape)

    # autograd of the plain version: the port's CPU path
    ht = torch.tensor(h, requires_grad=True)
    vt = torch.tensor(v, requires_grad=True)
    out = pt_inject.icv_inject(ht, vt)
    dh, dv = torch.autograd.grad(out, (ht, vt), torch.from_numpy(g))
    assert _rel_err(dh.numpy(), want_dh) <= REL
    assert _rel_err(dv.numpy(), want_dv) <= REL

    # the written-out backward, the kernel's plain version
    dh2, dv2 = pt_inject.icv_inject_backward_reference(
        torch.from_numpy(h), torch.from_numpy(v), torch.from_numpy(g)
    )
    assert dv2.shape == vshape and dv2.dtype == torch.float32
    assert _rel_err(dh2.numpy(), want_dh) <= REL
    assert _rel_err(dv2.numpy(), want_dv) <= REL
