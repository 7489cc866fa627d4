"""Port vs JAX: merged admission's layer and forward, and the pooled eval
chain, on tiny Idefics (CPU, f32).

``merged_decoder_layer`` and ``make_idefics_merged_admit_fn`` against JAX's
on the same numpy inputs (both lanes, the ICV on and off, the int8 KV
cache), within 1e-5.  Every question's tokens from the port's
``make_idefics_pooled_eval_chain`` equal the port's bs=1 ``beam_generate``
through ``bind_images`` (held to JAX's in ``tests/test_torch_decode.py``)
for several question counts, fewer than the pool's P groups among them
(JAX ``tests/test_eval_chain.py:29``, ``:72``), under the ICV,
``min_new_tokens``, a left-padded question, int8 weights and cache; and
equal JAX's pooled chain in one case.  A bundle's chain
(``pooled_eval_chain``) takes its subset-layer ICV as the static runner
does.  The chain's refusals raise (Idefics2's chain is
``tests/test_torch_serving_idefics2.py``'s, OpenFlamingo's
``tests/test_torch_serving_openflamingo.py``'s)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from licv_vqa_tpu.infer import eval_chain as jx_chain
from licv_vqa_tpu.models import decoder as jx_decoder
from licv_vqa_tpu.models import idefics as jx_idefics
from licv_vqa_tpu.models import layers as jx_layers
from licv_vqa_tpu_torch.infer import eval_chain as C
from licv_vqa_tpu_torch.infer.decode import beam_generate
from licv_vqa_tpu_torch.models import decoder as D
from licv_vqa_tpu_torch.models import idefics as I
from licv_vqa_tpu_torch.models import layers as L
from licv_vqa_tpu_torch.ops.quantize import quantize_layer_stack
from tests.serving_common import EOS, PAD
from tests.test_torch_idefics import tiny_pair
from tests.test_torch_serving import _one_thread  # noqa: F401  (autouse fixture)

TOL = 1e-5


@pytest.fixture(scope="module")
def tiny():
    """(port cfg, port params, jax cfg, jax params), the gates opened."""
    jcfg, jparams, pcfg, pparams = tiny_pair()
    return pcfg, pparams, jcfg, jparams


def close(got, want, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale, err_msg=what)


def t(x):
    return torch.from_numpy(np.asarray(x))


def kv_leaves(x):
    return [x["q"], x["s"]] if isinstance(x, dict) else [x]


# ---------------------------------------------------------------------------
# merged_decoder_layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("icv_on", [False, True], ids=["no_icv", "icv"])
@pytest.mark.parametrize("kv8", [False, True], ids=["bf16_cache", "int8_cache"])
def test_merged_decoder_layer_matches_jax(tiny, icv_on, kv8):
    """Both lanes of one merged layer: the decode lane (3 pool rows at their
    own write index, one of them not advancing) over a cache with earlier
    rows, the prefill lane (2 left-padded prompts) into a fresh cache.
    Hidden states and every written K/V row against JAX's layer and its
    returned rows."""
    pcfg, pparams, jcfg, jparams = tiny
    tc = dataclasses.replace(pcfg.text, kv_cache_dtype="int8" if kv8 else "bf16")
    jtc = dataclasses.replace(jcfg.text, kv_cache_dtype="int8" if kv8 else "bf16")
    rng = np.random.default_rng(3)
    nkv, dh, d = tc.n_kv_heads, tc.head_dim, tc.d_model
    b1, b2, s2, cols = 3, 2, 6, 10
    h_d = rng.normal(size=(b1, 1, d)).astype(np.float32)
    h_p = rng.normal(size=(b2, s2, d)).astype(np.float32)
    index = np.asarray([4, 6, 5])
    adv = np.asarray([[1], [0], [1]], np.int32)
    dec_pos = np.asarray([[4], [5], [3]], np.int32)
    mask_p = np.ones((b2, s2), np.int32)
    mask_p[1, :2] = 0
    pos_p = np.clip(np.cumsum(mask_p, -1) - 1, 0, None).astype(np.int32)

    def pool_cache():
        """numpy pool cache: earlier columns written, the rest zero."""
        written = np.arange(cols)[None, :] < index[:, None]
        w = written[..., None, None]
        if kv8:
            kv = [{"q": (rng.integers(-127, 128, size=(b1, cols, nkv, dh)) * w).astype(np.int8),
                   "s": (rng.uniform(0.01, 0.05, size=(b1, cols, nkv, 1)) * w).astype(np.float32)}
                  for _ in range(2)]
        else:
            kv = [(rng.normal(size=(b1, cols, nkv, dh)) * w).astype(np.float32) for _ in range(2)]
        pos = np.where(written, np.arange(cols)[None, :], 0).astype(np.int32)
        return kv, pos, written

    (k_np, v_np), pos_np, valid_np = pool_cache()
    k_np, v_np = jax.tree.map(lambda x: x[None], (k_np, v_np))  # a 1-layer stack
    icv = (rng.normal(size=(d,)) * 0.3).astype(np.float32) if icv_on else None

    # JAX: the layer returns the new rows; the caches stay as they were
    jkv = jax.tree.map(jnp.asarray, (k_np, v_np))
    jcache = {"k": jkv[0], "v": jkv[1], "pos": jnp.asarray(pos_np), "valid": jnp.asarray(valid_np),
              "index": jnp.asarray(index, jnp.int32)}
    jmask_d, _, _ = jx_decoder.decode_cache_view(jcache, jnp.asarray(dec_pos), jnp.asarray(adv), 1)
    jcache_p = jx_decoder.init_kv_cache(jtc, b2, s2 + 3)
    jl = lambda c: jax.tree.map(lambda x: x[0], c)  # noqa: E731  (a cache's layer 0)
    jmask_p, _, _ = jx_decoder.decode_cache_view(jcache_p, jnp.asarray(pos_p),
                                                 jnp.asarray(mask_p), s2)
    jrope_d = jx_layers.rope_cos_sin(jnp.asarray(dec_pos), dh, jtc.rope_theta)
    jrope_p = jx_layers.rope_cos_sin(jnp.asarray(pos_p), dh, jtc.rope_theta)
    jp = jax.tree.map(lambda x: x[0], jparams["layers"])
    jicv = None if icv is None else jnp.asarray(icv)
    jh_d, jh_p, jnew_d, jnew_p = jax.jit(jx_decoder.merged_decoder_layer, static_argnums=0)(
        jtc, jp, jnp.asarray(h_d), jnp.asarray(h_p), jrope_d, jrope_p,
        jmask_d, (jl(jkv[0]), jl(jkv[1]), jcache["index"]),
        jmask_p, (jl(jcache_p["k"]), jl(jcache_p["v"]), jcache_p["index"]),
        jnp.asarray(mask_p), jicv, jicv,
    )

    # port: the layer writes the rows into the caches in place
    pkv = jax.tree.map(lambda x: t(x).clone(), (k_np, v_np))
    pcache = {"k": pkv[0], "v": pkv[1], "pos": t(pos_np).clone(), "valid": t(valid_np).clone(),
              "index": t(index).long()}
    pmask_d, _, _ = D.decode_cache_view(pcache, t(dec_pos), t(adv), 1)
    pcache_p = D.init_kv_cache(tc, b2, s2 + 3, "cpu")
    pl = lambda c: L.layer_slice(c, 0)  # noqa: E731
    pmask_p, _, _ = D.decode_cache_view(pcache_p, t(pos_p), t(mask_p), s2)
    prope_d = L.rope_cos_sin(t(dec_pos), dh, tc.rope_theta)
    prope_p = L.rope_cos_sin(t(pos_p), dh, tc.rope_theta)
    picv = None if icv is None else t(icv)
    ph_d, ph_p = D.merged_decoder_layer(
        tc, L.layer_slice(pparams["layers"], 0), t(h_d), t(h_p), prope_d, prope_p,
        pmask_d, (pl(pkv[0]), pl(pkv[1]), pcache["index"]),
        pmask_p, (pl(pcache_p["k"]), pl(pcache_p["v"]), pcache_p["index"]),
        t(mask_p), picv, picv,
    )
    close(ph_d, jh_d, "decode lane hidden")
    close(ph_p, jh_p, "prefill lane hidden")
    rows = torch.arange(b1)
    for pc, jn in zip(pkv, jnew_d):  # each row's new column, at its own index
        for pleaf, jleaf in zip(kv_leaves(pl(pc)), kv_leaves(jn)):
            close(pleaf[rows, t(index)], np.asarray(jleaf)[:, 0], "decode lane K/V row")
    for pc, jn in zip((pcache_p["k"], pcache_p["v"]), jnew_p):
        for pleaf, jleaf in zip(kv_leaves(pl(pc)), kv_leaves(jn)):
            close(pleaf[:, :s2], jleaf, "prefill lane K/V rows")


# ---------------------------------------------------------------------------
# make_idefics_merged_admit_fn
# ---------------------------------------------------------------------------


def test_merged_admit_fn_matches_jax(tiny):
    """The whole merged forward: a pool of 3 rows prefilled by the serving
    prefill (one row not advancing), and an admission group of 2 prompts
    with their images, the ICV on.  Every output of the contract (decode
    logits, the pool cache, the prefill's last logits, cache, media and
    next positions) against JAX's."""
    pcfg, pparams, jcfg, jparams = tiny
    rng = np.random.default_rng(9)
    isz, vocab = pcfg.vision.image_size, pcfg.text.vocab_size
    cache_len = 12

    def group(b, s):
        ids = rng.integers(3, vocab - 2, size=(b, s)).astype(np.int32)
        ids[:, 1] = pcfg.image_token_id
        mask = np.ones((b, s), np.int32)
        mask[-1, :1] = 0
        px = rng.normal(size=(b, 1, isz, isz, 3)).astype(np.float32)
        return px, np.ones((b, 1), bool), ids, mask

    icv = (rng.normal(size=(pcfg.text.n_layers, pcfg.text.d_model)) * 0.1).astype(np.float32)
    pool, adm = group(3, 8), group(2, 8)
    tok = np.asarray([[5], [7], [9]], np.int32)
    adv = np.asarray([[1], [0], [1]], np.int32)

    jpre, _, _ = jx_idefics.make_idefics_serving_fns(jcfg, EOS)
    jpre = jax.jit(jpre, static_argnums=6)
    _, jcache, jmedia, jpos = jpre(jparams, *map(jnp.asarray, pool), jnp.asarray(icv), cache_len)
    jcache = dict(jcache, index=jnp.full((3,), 8, jnp.int32))
    jout = jax.jit(jx_idefics.make_idefics_merged_admit_fn(jcfg, EOS), static_argnums=11)(
        jparams, jnp.asarray(tok), jnp.asarray(adv), jpos[:, None], jcache, jmedia,
        jnp.asarray(icv), *map(jnp.asarray, adm), cache_len)

    ppre, _, _ = I.make_idefics_serving_fns(pcfg, EOS)
    with torch.inference_mode():
        _, pcache, pmedia, ppos = ppre(pparams, *map(t, pool), t(icv), cache_len)
        pcache["index"] = torch.full((3,), 8, dtype=torch.long)
        pout = I.make_idefics_merged_admit_fn(pcfg, EOS)(
            pparams, t(tok), t(adv), ppos[:, None], pcache, pmedia, t(icv), *map(t, adm),
            cache_len)
    names = ("dec_logits", "cache", "pre_last_logits", "pre_cache", "pre_media", "pre_next_pos")
    for name, got, want in zip(names, pout, jout):
        if name in ("cache", "pre_cache"):
            for key in ("k", "v", "pos", "valid"):
                close(got[key], want[key], f"{name}[{key}]")
        elif name == "pre_media":
            close(got["latents"], want["latents"], name)
            close(got["step_onehot"], want["step_onehot"], name)
            for g, w in zip(got["xattn_kv"], want["xattn_kv"]):
                close(g, w, name)
        else:
            close(got, want, name)
    assert pout[3]["index"] == 8 and pout[0].shape == (3, 1, vocab)


# ---------------------------------------------------------------------------
# the chains
# ---------------------------------------------------------------------------


def questions(cfg, n, seed, s=12):
    """(ids, mask, pixels, valid) of n one-image questions, (N, 1, ...);
    question 1 (where there is one) left-padded."""
    rng = np.random.default_rng(seed)
    isz = cfg.vision.image_size
    ids = rng.integers(3, cfg.text.vocab_size - 2, size=(n, 1, s)).astype(np.int32)
    ids[:, :, 3] = cfg.image_token_id
    mask = np.ones_like(ids)
    if n > 1:
        mask[1, :, :3] = 0
        ids[1, :, :3] = PAD
    pixels = rng.normal(size=(n, 1, 1, isz, isz, 3)).astype(np.float32)
    return ids, mask, pixels, np.ones((n, 1, 1), bool)


def beam_reference(cfg, params, qs, icv, max_new, k=3, min_new=0):
    """The port's bs=1 ``beam_generate`` of each question: (N, 1, max_new)."""
    _, bind = I.make_idefics_forward_fns(cfg, EOS)
    ids, mask, pixels, valid = qs
    out = []
    with torch.inference_mode():
        for i in range(len(ids)):
            s = ids.shape[-1]
            fwd = bind(params, t(pixels[i]), t(valid[i]), t(ids[i]), icv, s + max_new + 1)
            out.append(beam_generate(fwd, t(ids[i]), t(mask[i]), max_new_tokens=max_new,
                                     eos_token_id=EOS, pad_token_id=PAD, num_beams=k,
                                     min_new_tokens=min_new)[:, s:])
    return torch.stack(out)


def icv_rows(cfg, seed):
    rng = np.random.default_rng(seed)
    return t((rng.normal(size=(cfg.text.n_layers, cfg.text.d_model)) * 0.1).astype(np.float32))


@pytest.mark.parametrize("n", [1, 2, 4, 5, 7])
def test_pooled_chain_matches_beam_generate(tiny, n):
    """P = 3 groups (max_new 4): N = 1 and 2 end inside the warm-up, N = 4
    fills the pool once, N = 5 and 7 wrap around the drain; the ICV and a
    left-padded question."""
    cfg, params, _, _ = tiny
    qs = questions(cfg, n, 50 + n)
    icv = icv_rows(cfg, n)
    chain = C.make_idefics_pooled_eval_chain(cfg, EOS, num_beams=3, max_new_tokens=4,
                                             pad_token_id=PAD)
    got = chain(params, *map(t, qs), icv)
    assert got.shape == (n, 1, 4)
    torch.testing.assert_close(got, beam_reference(cfg, params, qs, icv, 4), rtol=0, atol=0)


@pytest.mark.parametrize("max_new,min_new", [(2, 0), (5, 2)])
def test_pooled_chain_other_depths_and_min_new(tiny, max_new, min_new):
    """P = 1 (max_new 2: one group, every iteration a finalize and an
    admission) and P = 4 with EOS suppressed for 2 steps (the per-group
    step decides the suppression)."""
    cfg, params, _, _ = tiny
    qs = questions(cfg, 4, 60 + max_new)
    chain = C.make_idefics_pooled_eval_chain(cfg, EOS, num_beams=3, max_new_tokens=max_new,
                                             min_new_tokens=min_new, pad_token_id=PAD)
    want = beam_reference(cfg, params, qs, None, max_new, min_new=min_new)
    torch.testing.assert_close(chain(params, *map(t, qs), None), want, rtol=0, atol=0)


def test_bundle_chain_takes_raw_pixels_and_a_subset_layer_icv():
    """``pooled_eval_chain`` on a bundle with ``lmm.intervention_layer=[1,3]``
    takes the processor's uint8 pixels and the checkpoint's 2 ICV rows as
    the static runner's generate does (``ModelBundle.model_pixels`` and
    ``model_icv``): per question the static beam's tokens at bs 1."""
    from licv_vqa_tpu_torch.infer.runner import make_generate_fn
    from tests.test_torch_idefics import tiny_inputs
    from tests.test_torch_speculative import _tiny_bundle

    bundle = _tiny_bundle(["lmm.intervention_layer=[1,3]"])
    for key in ("alpha_xattn", "alpha_dense"):  # open the gates: the images count
        bundle.params["xattn"][key].fill_(0.7)
    rng = np.random.default_rng(12)
    ids, mask, _, valid = tiny_inputs(rng, bs=3)
    pixels = rng.integers(0, 256, size=(3, 2, 28, 28, 3)).astype(np.uint8)
    icv = t((rng.normal(size=(2, 64)) * 0.5).astype(np.float32))
    kw = {"num_beams": 3, "max_new_tokens": 4}
    gen, s = make_generate_fn(bundle, kw), ids.shape[1]
    want = torch.stack([gen(bundle.params, *(t(x[i:i + 1]) for x in (ids, mask, pixels, valid)),
                            icv)[:, s:] for i in range(3)])
    got = C.pooled_eval_chain(bundle, kw)(*(t(x[:, None]) for x in (ids, mask, pixels, valid)),
                                          icv)
    torch.testing.assert_close(got, want.to(got.dtype), rtol=0, atol=0)


def test_pooled_chain_int8_weights_and_cache(tiny):
    """int8 decoder and cross-attention weights and the int8 KV cache
    (the pool's ``{"q", "s"}`` planes written, permuted and attended)."""
    cfg, params, _, _ = tiny
    params = dict(params, layers=quantize_layer_stack(params["layers"]),
                  xattn=quantize_layer_stack(params["xattn"]))
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, kv_cache_dtype="int8"))
    qs = questions(cfg, 4, 80)
    chain = C.make_idefics_pooled_eval_chain(cfg, EOS, num_beams=3, max_new_tokens=4,
                                             pad_token_id=PAD)
    torch.testing.assert_close(chain(params, *map(t, qs), None),
                               beam_reference(cfg, params, qs, None, 4), rtol=0, atol=0)


def test_pooled_chain_matches_jax_pooled_chain(tiny):
    """JAX's ``make_idefics_pooled_eval_chain`` on the same arrays (its
    history starts at 0, so PAD is 0 here)."""
    pcfg, pparams, jcfg, jparams = tiny
    qs = questions(pcfg, 4, 90)
    icv = icv_rows(pcfg, 90)
    want = jax.jit(jx_chain.make_idefics_pooled_eval_chain(
        jcfg, EOS, num_beams=3, max_new_tokens=4))(jparams, *map(jnp.asarray, qs),
                                                    jnp.asarray(icv.numpy()))
    chain = C.make_idefics_pooled_eval_chain(pcfg, EOS, num_beams=3, max_new_tokens=4,
                                             pad_token_id=PAD)
    np.testing.assert_array_equal(chain(pparams, *map(t, qs), icv).numpy(), np.asarray(want))


def test_what_the_chains_do_not_take_raises(tiny):
    cfg, _, _, _ = tiny
    with pytest.raises(ValueError, match="max_new_tokens >= 2"):
        C.make_idefics_pooled_eval_chain(cfg, EOS, max_new_tokens=1)
