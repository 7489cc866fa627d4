"""Port vs JAX: the ICV injection's plain version.

Held against ``_icv_inject_pallas(..., interpret=True)`` (the TPU kernel run
by the Pallas interpreter, as the JAX package's own tests run it on the
CPU) and ``icv_inject_reference``, for every shift layout.  f32 rtol=1e-5;
bf16 input within one bf16 ulp of the reference's own rounding.
"""

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
