"""Port vs JAX: the masked temperature-KL and the ICV-injection backward
(CPU, f32).

The same numpy inputs go through ``licv_vqa_tpu.ops`` (``impl="xla"`` and the
Pallas kernel in interpret mode) and the port's ``impl="xla"`` and
``impl="pallas"`` (on the CPU: the kernels' plain versions, including the
closed-form backward).  Values and the gradients with respect to student,
teacher and temperature must agree to 1e-5 relative (max-abs error over
max-abs value; f32, the two differ in summation order).  V = 257 and
N = 15 rows: not a multiple of 8, so the JAX kernel pads rows and the port
does not.
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
# ICV-injection backward
# ---------------------------------------------------------------------------

D = 48
_LAYOUTS = {
    "row": ((2, 5, D), (D,)),
    "batch": ((2, 5, D), (2, D)),  # the port's per-batch-row layout
    "batch1": ((2, 5, D), (2, 1, D)),
    "per_pos": ((2, 5, D), (2, 5, D)),
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
