"""Port vs JAX: the tiny Idefics stack end to end (CPU, f32).

The same numpy params (built by the JAX package's init and carried across
with ``params_from_jax``) and the same numpy inputs go through JAX
``bind_images`` and the port's.  Prefill logits and one cached decode step
must agree within atol=1e-4 (f32; the two differ only in summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from licv_vqa_tpu.models import idefics as jx_idefics
from licv_vqa_tpu.models.convert import convert_idefics as jx_convert_idefics
from licv_vqa_tpu.models.convert import hf_state_dict
from licv_vqa_tpu_torch.models import idefics as pt_idefics
from licv_vqa_tpu_torch.models.convert import convert_idefics as pt_convert_idefics
from licv_vqa_tpu_torch.models.weights import params_from_jax

EOS = 2
ATOL = 1e-4


def tiny_pair(seed: int = 0):
    """(jax cfg, jax params, port cfg, port params): one numpy param tree."""
    jcfg = jx_idefics.IdeficsConfig.tiny(dtype=jnp.float32)
    jparams = jx_idefics.init_idefics_params(jax.random.PRNGKey(seed), jcfg)
    jparams = jax.tree.map(np.asarray, jparams)
    # non-zero gates, so the cross-attention blocks contribute
    for key in ("alpha_xattn", "alpha_dense"):
        jparams["xattn"][key] = np.full_like(jparams["xattn"][key], 0.7)
    pcfg = pt_idefics.IdeficsConfig.tiny(dtype=torch.float32)
    pparams = params_from_jax(jparams, torch.float32)
    return jcfg, jax.tree.map(jnp.asarray, jparams), pcfg, pparams


def tiny_inputs(rng, bs=2, s=14, n_img=2, packed=False):
    """Left-padded prompts with image tokens; ``packed`` puts an EOS and a
    second episode (new <image>) into row 0."""
    img = 108
    ids = rng.integers(3, 100, size=(bs, s)).astype(np.int32)
    mask = np.ones((bs, s), np.int32)
    ids[:, 2] = img
    ids[:, 8] = img
    mask[1, :3] = 0
    ids[1, :3] = 0
    ids[1, 4] = img
    if packed:
        ids[0, 6] = EOS  # tokens after it attend no image until <image> at 8
    pixels = rng.normal(size=(bs, n_img, 28, 28, 3)).astype(np.float32)
    valid = np.ones((bs, n_img), bool)
    valid[1, 1] = packed  # a padded image slot on row 1 unless packed
    return ids, mask, pixels, valid


def icv_pair(rng, n_layers=4, d=64, flags=None):
    rows = (rng.normal(size=(n_layers, d)) * 0.5).astype(np.float32)
    if flags is None:
        return jnp.asarray(rows), torch.from_numpy(rows)
    return (
        (jnp.asarray(rows), jnp.asarray(np.asarray(flags))),
        (torch.from_numpy(rows), list(flags)),
    )


def run_both(ids, mask, pixels, valid, jicv, picv, steps=1, seed=0):
    """Prefill + ``steps`` cached greedy steps on both sides; returns the
    list of (jax logits, port logits) per call."""
    jcfg, jparams, pcfg, pparams = tiny_pair(seed)
    jbind = jx_idefics.make_idefics_forward_fns(jcfg, EOS)[1]
    pbind = pt_idefics.make_idefics_forward_fns(pcfg, EOS)[1]
    max_len = ids.shape[1] + steps + 1
    jf = jbind(jparams, jnp.asarray(pixels), jnp.asarray(valid), jnp.asarray(ids), jicv, max_len)
    pf = pbind(
        pparams, torch.from_numpy(pixels), torch.from_numpy(valid),
        torch.from_numpy(ids), picv, max_len,
    )
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
    jl, jc = jf(jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(pos), None)
    pl, pc = pf(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(pos), None)
    out = [(np.asarray(jl), pl.numpy())]
    nxt = pos[:, -1:] + 1
    for _ in range(steps):
        tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
        one = np.ones_like(tok)
        jl, jc = jf(jnp.asarray(tok), jnp.asarray(one), jnp.asarray(nxt), jc)
        pl, pc = pf(torch.from_numpy(tok), torch.from_numpy(one), torch.from_numpy(nxt), pc)
        out.append((np.asarray(jl), pl.numpy()))
        nxt = nxt + 1
    return out


@pytest.mark.parametrize("case", ["plain", "icv", "icv_subset", "packed"])
def test_bind_images_prefill_and_step_match_jax(case):
    rng = np.random.default_rng(1)
    ids, mask, pixels, valid = tiny_inputs(rng, packed=case == "packed")
    jicv = picv = None
    if case in ("icv", "packed"):
        jicv, picv = icv_pair(rng)
    elif case == "icv_subset":
        jicv, picv = icv_pair(rng, flags=[False, True, False, True])
    for jl, pl in run_both(ids, mask, pixels, valid, jicv, picv, steps=2):
        assert pl.shape == jl.shape
        np.testing.assert_allclose(pl, jl, atol=ATOL, rtol=0)


@pytest.mark.parametrize("subset", [False, True])
def test_icv_rows_reach_the_injection_cast_like_jax(subset, monkeypatch):
    """f32 ICV rows reach the injection in the model's dtype, as JAX casts
    the floating leaves (idefics.py:424-434); subset flags stay host bools
    and an off layer is skipped."""
    from licv_vqa_tpu_torch.models import decoder as pt_decoder

    rng = np.random.default_rng(5)
    ids, mask, pixels, valid = tiny_inputs(rng)
    flags = [True, False, True, False]
    _, picv = icv_pair(rng, flags=flags if subset else None)
    rows = picv[0] if subset else picv
    seen = []
    real = pt_decoder.icv_inject

    def spy(h, shift):
        seen.append(shift.clone())
        return real(h, shift)

    monkeypatch.setattr(pt_decoder, "icv_inject", spy)
    _, jparams, _, _ = tiny_pair()
    pcfg = pt_idefics.IdeficsConfig.tiny(dtype=torch.bfloat16)
    pparams = params_from_jax(jax.tree.map(np.asarray, jparams), torch.bfloat16)
    bind = pt_idefics.make_idefics_forward_fns(pcfg, EOS)[1]
    fwd = bind(
        pparams, torch.from_numpy(pixels), torch.from_numpy(valid),
        torch.from_numpy(ids), picv, ids.shape[1] + 2,
    )
    pos = torch.clamp(torch.cumsum(torch.from_numpy(mask), 1) - 1, min=0)
    logits, _ = fwd(torch.from_numpy(ids), torch.from_numpy(mask), pos, None)
    assert torch.isfinite(logits).all()
    on = [i for i, f in enumerate(flags) if f] if subset else range(4)
    assert len(seen) == len(on)
    for got, li in zip(seen, on):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got, rows[li].to(torch.bfloat16), rtol=0, atol=0)


@pytest.mark.parametrize("packed", [False, True])
def test_image_attention_onehot_matches_jax(packed):
    rng = np.random.default_rng(3)
    ids, *_ = tiny_inputs(rng, packed=packed)
    want = np.asarray(jx_idefics.image_attention_onehot(jnp.asarray(ids), 108, EOS, 2))
    got = pt_idefics.image_attention_onehot(torch.from_numpy(ids), 108, EOS, 2).numpy()
    np.testing.assert_array_equal(got, want)
    want = np.asarray(jx_idefics.last_image_onehot(jnp.asarray(ids), 108, 2))
    got = pt_idefics.last_image_onehot(torch.from_numpy(ids), 108, 2).numpy()
    np.testing.assert_array_equal(got, want)


def test_encode_images_matches_jax():
    rng = np.random.default_rng(4)
    jcfg, jparams, pcfg, pparams = tiny_pair()
    pixels = rng.normal(size=(2, 3, 28, 28, 3)).astype(np.float32)
    want = np.asarray(jx_idefics.encode_images(jcfg, jparams, jnp.asarray(pixels)))
    got = pt_idefics.encode_images(pcfg, pparams, torch.from_numpy(pixels)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_convert_idefics_equals_jax_converter():
    from tests.test_idefics_parity import _tiny_hf_idefics

    sd = hf_state_dict(_tiny_hf_idefics())
    want = jx_convert_idefics(sd, jx_idefics.IdeficsConfig.tiny(), dtype=jnp.float32)
    got = pt_convert_idefics(
        {k: torch.from_numpy(v) for k, v in sd.items()},
        pt_idefics.IdeficsConfig.tiny(),
        dtype=torch.float32,
    )

    def compare(w, g, path=""):
        if isinstance(w, dict):
            assert set(w) == set(g), path
            for k in w:
                compare(w[k], g[k], f"{path}/{k}")
            return
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, path
        np.testing.assert_array_equal(g.numpy(), w, err_msg=path)

    compare(want, got)
