"""Port vs JAX: OpenFlamingo's serving functions, merged admission, engines
and pooled chain on tiny-flamingo (CPU, f32).

The params are ``tests/test_torch_openflamingo.tiny_pair``'s: JAX's
``init_openflamingo_params`` with its constant leaves perturbed (the
cross-attention gates open), carried over by ``params_from_jax``.  JAX's
functions are called directly, never its engines.

- ``make_openflamingo_serving_fns``'s prefill (last logits, cache, the
  per-slot media, next positions) and two decode steps, and one call of
  ``make_openflamingo_merged_admit_fn`` (both lanes: the pool's logits and
  cache at per-row write indices, the admission group's last logits,
  cache, media and next positions), against JAX's same functions on the
  same numpy inputs: a left-padded row, three images with one
  ``pixel_valid`` off, the ICV on and off, the int8 KV cache under ALiBi;
  within 1e-5 of the output's scale (at least 1).
- The greedy engine, plain and merged admission, and the beam engine give,
  per request, the port's bs=1 ``greedy_generate``/``beam_generate``
  through ``bind_images`` over a pool of mixed image counts, the ICV and
  ``min_new`` included; the int8 weights and KV cache too (JAX
  ``tests/test_serving.py:15``, ``:128``, ``:428``).
- ``make_openflamingo_pooled_eval_chain`` gives ``beam_generate``'s tokens
  and JAX's chain's on the inputs of JAX ``tests/test_eval_chain.py:119``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from licv_vqa_tpu.infer import eval_chain as jx_chain
from licv_vqa_tpu.models import openflamingo as jx
from licv_vqa_tpu_torch.infer import eval_chain as C
from licv_vqa_tpu_torch.infer import serving as S
from licv_vqa_tpu_torch.infer.decode import beam_generate, greedy_generate
from licv_vqa_tpu_torch.models import openflamingo as OF
from licv_vqa_tpu_torch.ops.quantize import quantize_layer_stack
from tests.serving_common import EOS, PAD
from tests.test_torch_openflamingo import IMG, tiny_pair
from tests.test_torch_serving import _one_thread  # noqa: F401  (autouse fixture)
from tests.test_torch_serving import mixed_image_requests, requests, serve

TOL = 1e-5


def close(got, want, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale, err_msg=what)


def t(x):
    return torch.from_numpy(np.array(x))


def with_kv8(jcfg, pcfg, kv8: bool):
    kvc = "int8" if kv8 else "bf16"
    return (dataclasses.replace(jcfg, text=dataclasses.replace(jcfg.text, kv_cache_dtype=kvc)),
            dataclasses.replace(pcfg, text=dataclasses.replace(pcfg.text, kv_cache_dtype=kvc)))


def icv_rows(cfg, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(cfg.text.n_layers, cfg.text.d_model)) * 0.1).astype(np.float32)


def group(rng, b, s, n_img):
    """``b`` prompts of ``s`` tokens, ``n_img`` ``<image>`` tokens each, the
    last row left-padded by two and its last image off."""
    ids = rng.integers(3, 120, size=(b, s)).astype(np.int32)
    for j in range(n_img):
        ids[:, 2 + 3 * j] = IMG
    mask = np.ones((b, s), np.int32)
    mask[-1, :2], ids[-1, :2] = 0, PAD
    pixels = rng.normal(size=(b, n_img, 28, 28, 3)).astype(np.float32)
    valid = np.ones((b, n_img), bool)
    if n_img > 1:
        valid[-1, -1] = False
    return pixels, valid, ids, mask


def kv_leaves(x):
    return [x["q"], x["s"]] if isinstance(x, dict) else [x]


def close_cache(got, want, what, keys=("k", "v", "pos", "valid")):
    for key in keys:
        for g, w in zip(kv_leaves(got[key]), kv_leaves(want[key])):
            close(g, w, f"{what}[{key}]")


def close_media(got, want, what):
    assert set(got) == set(want) == {"latents", "step_onehot", "xattn_kv"}
    close(got["latents"], want["latents"], f"{what} latents")
    close(got["step_onehot"], want["step_onehot"], f"{what} step_onehot")
    for g, w in zip(got["xattn_kv"], want["xattn_kv"]):
        close(g, w, f"{what} xattn_kv")


CASES = ["plain", "icv", "kv8_icv"]


# ---------------------------------------------------------------------------
# the serving and merged functions against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
def test_serving_prefill_and_decode_step_match_jax(case):
    """The prefill into a fresh cache, then two cached decode steps."""
    jcfg, jparams, pcfg, pparams = tiny_pair()
    jcfg, pcfg = with_kv8(jcfg, pcfg, case.startswith("kv8"))
    rng = np.random.default_rng(5)
    inputs = group(rng, 2, 12, 3)
    icv = icv_rows(pcfg, 5) if "icv" in case else None
    jicv = None if icv is None else jnp.asarray(icv)
    picv = None if icv is None else t(icv)
    cache_len = 15
    jpre, jstep, _ = jx.make_openflamingo_serving_fns(jcfg, EOS)
    ppre, pstep, paxes = OF.make_openflamingo_serving_fns(pcfg, EOS)
    assert paxes == {"latents": (0, 1), "step_onehot": (0, 2), "xattn_kv": (1, 2)}
    assert {k: v[0] for k, v in paxes.items()} == jx.SERVING_MEDIA_AXES
    jout = jax.jit(jpre, static_argnums=6)(jparams, *map(jnp.asarray, inputs), jicv, cache_len)
    with torch.inference_mode():
        pout = ppre(pparams, *map(t, inputs), picv, cache_len)
        close(pout[0], jout[0], "prefill last logits")
        assert pout[0].dtype == torch.float32
        close_cache(pout[1], jout[1], "prefill cache")
        close_media(pout[2], jout[2], "prefill media")
        np.testing.assert_array_equal(pout[3].numpy(), np.asarray(jout[3]))
        jcache, pcache, pos = jout[1], pout[1], np.asarray(jout[3])[:, None]
        jstep = jax.jit(jstep)
        for step in range(2):
            tok = np.asarray([[7 + step], [9]], np.int32)
            one = np.ones_like(tok)
            jl, jcache = jstep(jparams, jnp.asarray(tok), jnp.asarray(one), jnp.asarray(pos),
                               jcache, jicv, jout[2])
            pl, pcache = pstep(pparams, t(tok), t(one), t(pos), pcache, picv, pout[2])
            close(pl, jl, f"decode step {step} logits")
            pos = pos + 1
        close_cache(pcache, jcache, "decode cache", ("k", "v"))


@pytest.mark.parametrize("case", CASES)
def test_merged_admit_fn_matches_jax(case):
    """One merged forward: a pool of 3 rows (one image each) prefilled by
    the serving prefill, each at its own write index (one row not
    advancing), and an admission group of 2 prompts of 3 images (one off).
    Both lanes' outputs against JAX's."""
    jcfg, jparams, pcfg, pparams = tiny_pair()
    jcfg, pcfg = with_kv8(jcfg, pcfg, case.startswith("kv8"))
    rng = np.random.default_rng(9)
    pool, adm = group(rng, 3, 10, 1), group(rng, 2, 12, 3)
    icv = icv_rows(pcfg, 9) if "icv" in case else None
    jicv = None if icv is None else jnp.asarray(icv)
    picv = None if icv is None else t(icv)
    cache_len = 16
    tok = np.asarray([[5], [7], [9]], np.int32)
    adv = np.asarray([[1], [0], [1]], np.int32)
    index = np.asarray([10, 11, 10])

    jpre = jax.jit(jx.make_openflamingo_serving_fns(jcfg, EOS)[0], static_argnums=6)
    _, jcache, jmedia, jpos = jpre(jparams, *map(jnp.asarray, pool), jicv, cache_len)
    jcache = dict(jcache, index=jnp.asarray(index, jnp.int32))
    jout = jax.jit(jx.make_openflamingo_merged_admit_fn(jcfg, EOS), static_argnums=11)(
        jparams, jnp.asarray(tok), jnp.asarray(adv), jpos[:, None], jcache, jmedia, jicv,
        *map(jnp.asarray, adm), cache_len)

    ppre = OF.make_openflamingo_serving_fns(pcfg, EOS)[0]
    with torch.inference_mode():
        _, pcache, pmedia, ppos = ppre(pparams, *map(t, pool), picv, cache_len)
        pcache["index"] = t(index).long()
        pout = OF.make_openflamingo_merged_admit_fn(pcfg, EOS)(
            pparams, t(tok), t(adv), ppos[:, None], pcache, pmedia, picv, *map(t, adm),
            cache_len)
    names = ("dec_logits", "cache", "pre_last_logits", "pre_cache", "pre_media", "pre_next_pos")
    for name, got, want in zip(names, pout, jout):
        if name in ("cache", "pre_cache"):
            close_cache(got, want, name)
            close(got["index"], want["index"], f"{name}[index]")
        elif name == "pre_media":
            close_media(got, want, name)
        else:
            close(got, want, name)
    assert pout[0].shape == (3, 1, pcfg.text.vocab_size) and pout[2].dtype == torch.float32


# ---------------------------------------------------------------------------
# the engines against the port's bs=1 decodes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    """(port cfg, port params)."""
    _, _, pcfg, pparams = tiny_pair()
    return pcfg, pparams


def reference(cfg, params, req, icv=None, beams=1):
    """The port's bs=1 unpadded decode of one request through
    ``bind_images``, trimmed at EOS (inclusive): the engine's output
    contract."""
    _, bind = OF.make_openflamingo_forward_fns(cfg, EOS)
    ids = t(np.asarray(req.input_ids, np.int32)[None])
    px = t(np.asarray(req.pixel_values)[None])
    pv = torch.ones((1, px.shape[1]), dtype=torch.bool)
    kw = dict(max_new_tokens=req.max_new, eos_token_id=EOS, pad_token_id=PAD,
              min_new_tokens=req.min_new)
    with torch.inference_mode():
        fwd = bind(params, px, pv, ids, icv, ids.shape[1] + req.max_new + 1)
        mask = torch.ones_like(ids)
        if beams > 1:
            out = beam_generate(fwd, ids, mask, num_beams=beams, length_penalty=0.0, **kw)
        else:
            out = greedy_generate(fwd, ids, mask, **kw)
    gen = out[0, ids.shape[1]:].numpy()
    hits = np.nonzero(gen == EOS)[0]
    return gen[: hits[0] + 1] if len(hits) else gen


def engine(cfg, params, beams=1, merged=False, **kw):
    prefill, decode, axes = OF.make_openflamingo_serving_fns(cfg, EOS)
    if merged:
        kw["merged_admit_fn"] = OF.make_openflamingo_merged_admit_fn(cfg, EOS)
    cls = S.ServingEngine
    if beams > 1:
        cls, kw["num_beams"] = S.BeamServingEngine, beams
    return cls(prefill, decode, axes, cfg.text, params, eos_token_id=EOS, pad_token_id=PAD, **kw)


def int8_model(cfg, params):
    """int8 decoder and cross-attention weights, the int8 KV cache."""
    params = dict(params, layers=quantize_layer_stack(params["layers"]),
                  xattn=quantize_layer_stack(params["xattn"]))
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, kv_cache_dtype="int8")), \
        params


# (beams, merged, int8, requests, ICV, engine options)
ENGINE_CASES = {
    # 7 requests of 1-3 images through 3 slots: slot reuse, buckets 8 and
    # 16, groups of 2 and 1, the ICV and min_new
    "greedy_icv_min_new": (1, False, False, lambda c: requests(c, 17, 4, min_new=1)
                           + mixed_image_requests(c, 17, 3), True,
                           dict(n_slots=3, admit_sizes=(2, 1))),
    "greedy_merged_icv_min_new": (1, True, False, lambda c: requests(c, 17, 4, min_new=1)
                                  + mixed_image_requests(c, 17, 3), True,
                                  dict(n_slots=3, admit_sizes=(2, 1))),
    # the int8 KV cache under ALiBi at the pool's per-row index, merged
    "greedy_merged_int8_kv8": (1, True, True, lambda c: mixed_image_requests(c, 23, 5), False,
                               dict(n_slots=2, admit_sizes=(2, 1))),
    # 5 requests through 2 groups of 3 beams (tests/test_serving.py:128)
    "beam3_icv": (3, False, False, lambda c: mixed_image_requests(c, 31, 5), True,
                  dict(n_slots=2, admit_sizes=(2, 1))),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engines_match_the_bs1_decodes(tiny, case):
    cfg, params = tiny
    beams, merged, int8, make, with_icv, kw = ENGINE_CASES[case]
    if int8:
        cfg, params = int8_model(cfg, params)
    reqs = make(cfg)
    icv = t(icv_rows(cfg, 17)) if with_icv else None
    opts = dict(icv_scaled=icv, out_cap=8, prompt_buckets=(8, 16), sync_steps=2, max_images=3,
                **kw)
    eng = engine(cfg, params, beams, merged, **opts)
    got = serve(eng, reqs)
    assert set(got) == {r.uid for r in reqs}
    for r in reqs:
        np.testing.assert_array_equal(got[r.uid], reference(cfg, params, r, icv, beams),
                                      err_msg=str(r.uid))
    if merged:
        assert eng.merged_admits > 0, "no admission rode a merged forward"
        plain = serve(engine(cfg, params, **opts), reqs)
        for uid in got:
            np.testing.assert_array_equal(got[uid], plain[uid], err_msg=str(uid))


# ---------------------------------------------------------------------------
# the pooled chain
# ---------------------------------------------------------------------------


def test_pooled_chain_matches_beam_generate_and_jax():
    """JAX ``tests/test_eval_chain.py:119``'s inputs: 5 questions of 10
    tokens, the image token second, question 2 left-padded, the ICV; P = 3
    groups (max_new 4: the drain wraps around).  Per question the port's
    bs=1 ``beam_generate`` through ``bind_images``, and JAX's jitted chain
    on the same arrays."""
    jcfg, jparams, pcfg, pparams = tiny_pair()
    rng = np.random.default_rng(29)
    n, s, max_new, k = 5, 10, 4, 3
    ids = rng.integers(3, pcfg.text.vocab_size, size=(n, 1, s)).astype(np.int32)
    ids[:, :, 1] = IMG
    mask = np.ones_like(ids)
    mask[2, :, :2] = 0
    ids[2, :, :2] = PAD
    pixels = rng.normal(size=(n, 1, 1, 28, 28, 3)).astype(np.float32)
    valid = np.ones((n, 1, 1), bool)
    icv = (rng.normal(size=(pcfg.text.n_layers, pcfg.text.d_model)) * 0.1).astype(np.float32)
    qs = (ids, mask, pixels, valid)
    chain = C.make_openflamingo_pooled_eval_chain(pcfg, EOS, num_beams=k, max_new_tokens=max_new,
                                                  pad_token_id=PAD)
    got = chain(pparams, *map(t, qs), t(icv))
    assert got.shape == (n, 1, max_new)
    _, bind = OF.make_openflamingo_forward_fns(pcfg, EOS)
    with torch.inference_mode():
        for i in range(n):
            fwd = bind(pparams, t(pixels[i]), t(valid[i]), t(ids[i]), t(icv), s + max_new + 1)
            want = beam_generate(fwd, t(ids[i]), t(mask[i]), max_new_tokens=max_new,
                                 eos_token_id=EOS, pad_token_id=PAD, num_beams=k)[:, s:]
            np.testing.assert_array_equal(got[i].numpy(), want.numpy(), err_msg=f"question {i}")
    jchain = jax.jit(jx_chain.make_openflamingo_pooled_eval_chain(
        jcfg, EOS, num_beams=k, max_new_tokens=max_new))
    want = jchain(jparams, *map(jnp.asarray, qs), jnp.asarray(icv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
