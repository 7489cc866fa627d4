"""Port vs JAX: each layer function of ``models/layers.py`` on the CPU.

The same numpy inputs (from a seed) go through the JAX function and its
port; f32, rtol=1e-5 (atol=1e-6 for values near zero).  The flash plain
version is held against JAX ``dot_product_attention`` under the segment
mask of ``flash_attention_tpu`` (layers.py:169): real rows must agree, pad
rows must be finite.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from licv_vqa_tpu.models import layers as JL
from licv_vqa_tpu_torch.models import layers as PL

RTOL, ATOL = 1e-5, 1e-6


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def _pair(rng, *shape, scale=1.0):
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def test_norms_match_jax():
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng, 2, 5, 32)
    wj, wt = _pair(rng, 32)
    bj, bt = _pair(rng, 32)
    _close(PL.rms_norm(wt, xt, 1e-6), JL.rms_norm(wj, xj, 1e-6))
    _close(PL.layer_norm(wt, bt, xt, 1e-5), JL.layer_norm(wj, bj, xj, 1e-5))
    _close(PL.layer_norm(wt, None, xt, 1e-5), JL.layer_norm(wj, None, xj, 1e-5))


def test_rope_matches_jax():
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 300, size=(2, 7)).astype(np.int32)
    cj, sj = JL.rope_cos_sin(jnp.asarray(pos), 16, 10000.0)
    ct, st = PL.rope_cos_sin(torch.from_numpy(pos), 16, 10000.0)
    _close(ct, cj)
    _close(st, sj)
    xj, xt = _pair(rng, 2, 7, 3, 16)
    _close(PL.apply_rope(xt, ct, st), JL.apply_rope(xj, cj, sj))


def test_repeat_kv_and_causal_mask_match_jax():
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng, 2, 5, 2, 4)
    _close(PL.repeat_kv(xt, 3), JL.repeat_kv(xj, 3))
    qp = np.array([[0, 1, 2, 3], [0, 0, 1, 2]], np.int32)
    kv = np.array([[1, 1, 1, 1], [0, 1, 1, 1]], bool)
    want = JL.causal_mask(jnp.asarray(qp), jnp.asarray(qp), jnp.asarray(kv))
    got = PL.causal_mask(torch.from_numpy(qp), torch.from_numpy(qp), torch.from_numpy(kv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("softcap", [None, 5.0])
def test_dot_product_attention_matches_jax(softcap):
    rng = np.random.default_rng(3)
    qj, qt = _pair(rng, 2, 6, 2, 8)
    kj, kt = _pair(rng, 2, 9, 2, 8)
    vj, vt = _pair(rng, 2, 9, 2, 8)
    mask = rng.random((2, 1, 6, 9)) > 0.3
    mask[1, 0, 2] = False  # a fully masked row: finfo.min, uniform, no NaN
    want = JL.dot_product_attention(qj, kj, vj, mask=jnp.asarray(mask), logit_softcap=softcap)
    got = PL.dot_product_attention(qt, kt, vt, mask=torch.from_numpy(mask), logit_softcap=softcap)
    assert torch.isfinite(got).all()
    _close(got, want)


def test_fully_masked_row_is_finite_like_jax():
    """Tokens before the first <image> have no visible image latent: the
    cross-attention row is fully masked (gated to 0 at idefics.py:318)."""
    rng = np.random.default_rng(4)
    qj, qt = _pair(rng, 1, 3, 2, 8)
    kj, kt = _pair(rng, 1, 4, 2, 8)
    vj, vt = _pair(rng, 1, 4, 2, 8)
    mask = np.zeros((1, 1, 3, 4), bool)
    want = JL.dot_product_attention(qj, kj, vj, mask=jnp.asarray(mask))
    got = PL.dot_product_attention(qt, kt, vt, mask=torch.from_numpy(mask))
    assert torch.isfinite(got).all()
    _close(got, want)


@pytest.mark.parametrize("side", ["left", "right"])
def test_flash_plain_version_matches_jax_segment_attention(side):
    b, s, h, dh = 2, 300, 2, 16
    rng = np.random.default_rng(5)
    qj, qt = _pair(rng, b, s, h, dh)
    kj, kt = _pair(rng, b, s, h, dh)
    vj, vt = _pair(rng, b, s, h, dh)
    valid = np.ones((b, s), np.int32)
    n_pad = [0, 37]
    for i, n in enumerate(n_pad):
        if n:
            if side == "left":
                valid[i, :n] = 0
            else:
                valid[i, s - n :] = 0
    # the JAX Pallas call's rule: k <= q (index) and seg[k] == seg[q]
    seg = valid + 1
    idx = np.arange(s)
    mask = (idx[None, :] <= idx[:, None])[None] & (seg[:, None, :] == seg[:, :, None])
    want = np.asarray(JL.dot_product_attention(qj, kj, vj, mask=jnp.asarray(mask[:, None])))
    got = PL.flash_attention(qt, kt, vt, torch.from_numpy(valid))  # CPU → plain
    got = got.numpy()
    assert np.isfinite(got).all()  # pad rows included
    real = valid.astype(bool)
    np.testing.assert_allclose(got[real], want[real], rtol=RTOL, atol=ATOL)
    assert PL.flash_attention.launches == 0  # no kernel launch for CPU tensors


def test_flash_gate_needs_cuda_and_shape():
    class Cfg:
        attention_impl = "flash"

    assert not PL.flash_attention_usable(Cfg, 512, 128, torch.device("cpu"))
    assert PL.flash_attention_usable(Cfg, 384, 128, torch.device("cuda"))
    assert PL.flash_attention_usable(Cfg, 300, 128, torch.device("cuda"))  # no %128 rule
    assert not PL.flash_attention_usable(Cfg, 255, 128, torch.device("cuda"))
    assert not PL.flash_attention_usable(Cfg, 512, 64, torch.device("cuda"))
    Cfg.attention_impl = "xla"
    assert not PL.flash_attention_usable(Cfg, 512, 128, torch.device("cuda"))


def test_mlps_match_jax():
    rng = np.random.default_rng(6)
    xj, xt = _pair(rng, 2, 3, 16)
    names = {"w_gate": (16, 24), "w_up": (16, 24), "w_down": (24, 16)}
    pj, pt = {}, {}
    for k, shp in names.items():
        pj[k], pt[k] = _pair(rng, *shp, scale=0.3)
    _close(PL.swiglu_mlp(pt, xt), JL.swiglu_mlp(pj, xj))
    gj = {"w_up": pj["w_up"], "w_down": pj["w_down"]}
    gt = {"w_up": pt["w_up"], "w_down": pt["w_down"]}
    gj["b_up"], gt["b_up"] = _pair(rng, 24)
    gj["b_down"], gt["b_down"] = _pair(rng, 16)
    _close(PL.gelu_mlp(gt, xt), JL.gelu_mlp(gj, xj))


def test_dtype_policy_maps_jax_dtypes():
    from licv_vqa_tpu_torch.core.precision import PrecisionPolicy, to_torch_dtype
    from licv_vqa_tpu_torch.models.weights import params_from_jax

    assert to_torch_dtype(jnp.bfloat16) == torch.bfloat16
    assert to_torch_dtype(np.dtype(np.float32)) == torch.float32
    assert to_torch_dtype("bf16") == torch.bfloat16
    pol = PrecisionPolicy.from_string("bf16-mixed")
    assert (pol.param_dtype, pol.loss_dtype) == (torch.bfloat16, torch.float32)
    tree = {"w": jnp.ones((2, 3), jnp.bfloat16), "ids": np.arange(3, dtype=np.int32)}
    got = params_from_jax(tree, jnp.float32)
    assert got["w"].dtype == torch.float32 and got["ids"].dtype == torch.int32
    assert pol.cast_params(got)["w"].dtype == torch.bfloat16
