"""Port vs JAX: Idefics2's serving, merged admission, NaViT admission groups
and pooled chain on tiny Idefics2 (CPU, f32).

The params are ``tests/test_torch_idefics2.tiny_pair``'s: JAX's
``init_idefics2_params`` with its constant leaves perturbed, carried over
by ``params_from_jax``.  JAX's functions are called directly, never its
engines.

- ``make_idefics2_serving_fns``'s prefill and decode step, and one call of
  ``make_idefics2_merged_admit_fn`` (both lanes: the pool's logits and
  cache, the admission group's last logits, cache and next positions),
  against JAX's same functions on the same numpy inputs, the ICV at the
  MLP output on and off, NaViT masks on the prefill; within 1e-5 of the
  output's scale (at least 1).  The tiny decoder has 4 heads over 2 KV
  heads, so GQA's packed projections are held here too.
- The greedy and beam engines give, per request, the port's bs=1
  ``greedy_generate``/``beam_generate`` through ``bind_images``, trimmed at
  EOS (JAX ``tests/test_serving.py:15``, ``:128``), the ICV and ``min_new``
  included; merged admission gives plain admission's tokens
  (``tests/test_serving_merged.py:48``).
- NaViT: a bundle's engines (``ServingEngine.from_bundle``) on requests
  whose images have four real shapes and three padded ones give the static
  bind path's tokens with the same masks (JAX ``tests/test_serving.py:478``),
  the admissions split by mask shape.
- ``make_idefics2_pooled_eval_chain`` gives ``beam_generate``'s tokens and
  JAX's chain's (``tests/test_eval_chain.py:120``).
- The Idefics-9B engine still refuses a mask.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from licv_vqa_tpu.infer import eval_chain as jx_chain
from licv_vqa_tpu.models import idefics2 as jx
from licv_vqa_tpu_torch.infer import eval_chain as C
from licv_vqa_tpu_torch.infer import serving as S
from licv_vqa_tpu_torch.infer.decode import beam_generate, greedy_generate
from licv_vqa_tpu_torch.models import idefics2 as I2
from tests.serving_common import EOS, PAD, _make_requests
from tests.test_torch_idefics2 import tiny_pair
from tests.test_torch_serving import _one_thread  # noqa: F401  (autouse fixture)

TOL = 1e-5
NAVIT_SIZE = 56  # the position table of the NaViT cases: 4x4 patches


def close(got, want, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale, err_msg=what)


def t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def tiny():
    """(port cfg, port params, jax cfg, jax params)."""
    jcfg, jparams, pcfg, pparams = tiny_pair()
    return pcfg, pparams, jcfg, jparams


def icv_rows(cfg, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(cfg.text.n_layers, cfg.text.d_model)) * 0.1).astype(np.float32)


def navit_group(rng, b, s, n_lat):
    """``b`` left-padded prompts with one run of ``n_lat`` image tokens and
    one image each, 42x28 pixels padded from the real 28x14 of row 0 and
    42x28 of the others (the padding zero, as the processor leaves it)."""
    ids = rng.integers(3, 110, size=(b, s)).astype(np.int32)
    ids[:, 2:2 + n_lat] = 118
    mask = np.ones((b, s), np.int32)
    mask[-1, :1], ids[-1, :1] = 0, PAD
    pixels = rng.normal(size=(b, 1, 42, 28, 3)).astype(np.float32)
    pmask = np.ones((b, 1, 42, 28), np.int32)
    pmask[0, 0, 28:], pmask[0, 0, :, 14:] = 0, 0
    pixels[pmask == 0] = 0.0
    return pixels, np.ones((b, 1), bool), ids, mask, pmask


# ---------------------------------------------------------------------------
# the serving and merged functions against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["plain", "icv", "navit_icv"])
def test_serving_prefill_and_decode_step_match_jax(case):
    """The prefill into a fresh cache (last logits, cache, media, next
    positions), then two cached steps of the decode step."""
    navit = case.startswith("navit")
    jcfg, jparams, pcfg, pparams = tiny_pair(image_size=NAVIT_SIZE if navit else 28)
    rng = np.random.default_rng(5)
    pixels, valid, ids, mask, pmask = navit_group(rng, 2, 12, pcfg.image_seq_len)
    if not navit:
        pixels, pmask = pixels[:, :, :28], None
    icv = icv_rows(pcfg, 5) if "icv" in case else None
    cache_len = 15
    jpre, jstep, jaxes = jx.make_idefics2_serving_fns(jcfg, EOS)
    ppre, pstep, paxes = I2.make_idefics2_serving_fns(pcfg, EOS)
    assert paxes == jaxes == {}
    jkw = {} if pmask is None else {"pixel_attention_mask": jnp.asarray(pmask)}
    pkw = {} if pmask is None else {"pixel_attention_mask": t(pmask)}
    jicv = None if icv is None else jnp.asarray(icv)
    picv = None if icv is None else t(icv)
    jout = jpre(jparams, *map(jnp.asarray, (pixels, valid, ids, mask)), jicv, cache_len, **jkw)
    with torch.inference_mode():
        pout = ppre(pparams, *map(t, (pixels, valid, ids, mask)), picv, cache_len, **pkw)
        close(pout[0], jout[0], "prefill last logits")
        assert pout[0].dtype == torch.float32 and pout[2] == {} and jout[2] == {}
        for key in ("k", "v", "pos", "valid"):
            close(pout[1][key], jout[1][key], f"prefill cache[{key}]")
        np.testing.assert_array_equal(pout[3].numpy(), np.asarray(jout[3]))
        jcache, pcache, pos = jout[1], pout[1], np.asarray(jout[3])[:, None]
        for step in range(2):
            tok = np.asarray([[7 + step], [9]], np.int32)
            one = np.ones_like(tok)
            jl, jcache = jstep(jparams, jnp.asarray(tok), jnp.asarray(one), jnp.asarray(pos),
                               jcache, jicv, {})
            pl, pcache = pstep(pparams, t(tok), t(one), t(pos), pcache, picv, {})
            close(pl, jl, f"decode step {step} logits")
            pos = pos + 1
        for key in ("k", "v"):
            close(pcache[key], jcache[key], f"decode cache[{key}]")


@pytest.mark.parametrize("case", ["plain", "icv", "navit_icv"])
def test_merged_admit_fn_matches_jax(case):
    """One merged forward: a pool of 3 rows prefilled by the serving
    prefill at their own write index (one row not advancing), and an
    admission group of 2 prompts with their images.  Both lanes' outputs
    against JAX's."""
    navit = case.startswith("navit")
    jcfg, jparams, pcfg, pparams = tiny_pair(image_size=NAVIT_SIZE if navit else 28)
    rng = np.random.default_rng(9)
    n_lat = pcfg.image_seq_len
    pool = navit_group(rng, 3, 10, n_lat)[:4]
    pool = (pool[0][:, :, :28],) + pool[1:]
    adm_px, adm_pv, adm_ids, adm_mask, adm_pm = navit_group(rng, 2, 12, n_lat)
    if not navit:
        adm_px, adm_pm = adm_px[:, :, :28], None
    adm = (adm_px, adm_pv, adm_ids, adm_mask)
    icv = icv_rows(pcfg, 9) if "icv" in case else None
    cache_len = 16
    tok = np.asarray([[5], [7], [9]], np.int32)
    adv = np.asarray([[1], [0], [1]], np.int32)
    index = np.asarray([10, 11, 10])
    jicv = None if icv is None else jnp.asarray(icv)
    picv = None if icv is None else t(icv)

    jpre = jx.make_idefics2_serving_fns(jcfg, EOS)[0]
    _, jcache, jmedia, jpos = jpre(jparams, *map(jnp.asarray, pool), jicv, cache_len)
    jcache = dict(jcache, index=jnp.asarray(index, jnp.int32))
    jkw = {} if adm_pm is None else {"pixel_attention_mask": jnp.asarray(adm_pm)}
    jout = jx.make_idefics2_merged_admit_fn(jcfg, EOS)(
        jparams, jnp.asarray(tok), jnp.asarray(adv), jpos[:, None], jcache, jmedia, jicv,
        *map(jnp.asarray, adm), cache_len, **jkw)

    ppre = I2.make_idefics2_serving_fns(pcfg, EOS)[0]
    pkw = {} if adm_pm is None else {"pixel_attention_mask": t(adm_pm)}
    with torch.inference_mode():
        _, pcache, pmedia, ppos = ppre(pparams, *map(t, pool), picv, cache_len)
        pcache["index"] = t(index).long()
        pout = I2.make_idefics2_merged_admit_fn(pcfg, EOS)(
            pparams, t(tok), t(adv), ppos[:, None], pcache, pmedia, picv, *map(t, adm),
            cache_len, **pkw)
    names = ("dec_logits", "cache", "pre_last_logits", "pre_cache", "pre_media", "pre_next_pos")
    for name, got, want in zip(names, pout, jout):
        if name in ("cache", "pre_cache"):
            for key in ("k", "v", "pos", "valid"):
                close(got[key], want[key], f"{name}[{key}]")
            close(got["index"], want["index"], f"{name}[index]")
        elif name == "pre_media":
            assert got == {} and want == {}
        else:
            close(got, want, name)
    assert pout[0].shape == (3, 1, pcfg.text.vocab_size) and pout[2].dtype == torch.float32


# ---------------------------------------------------------------------------
# the engines against the port's bs=1 decodes
# ---------------------------------------------------------------------------


def requests(cfg, seed, n, min_new=0):
    return [S.Request(**dataclasses.asdict(r))
            for r in _make_requests(cfg, np.random.default_rng(seed), n, min_new=min_new)]


def reference(cfg, params, req, icv=None, beams=1):
    """The port's bs=1 unpadded decode of one request through
    ``bind_images`` (with its NaViT mask, where it has one), trimmed at EOS
    (inclusive): the engine's output contract."""
    _, bind = I2.make_idefics2_forward_fns(cfg, EOS)
    ids = t(np.asarray(req.input_ids, np.int32)[None])
    px = t(np.asarray(req.pixel_values)[None])
    pv = (torch.ones((1, px.shape[1]), dtype=torch.bool) if req.pixel_valid is None
          else t(np.asarray(req.pixel_valid, bool)[None]))
    kw = dict(max_new_tokens=req.max_new, eos_token_id=EOS, pad_token_id=PAD,
              min_new_tokens=req.min_new)
    pam = {} if req.pixel_attention_mask is None else {
        "pixel_attention_mask": t(np.asarray(req.pixel_attention_mask)[None])}
    with torch.inference_mode():
        fwd = bind(params, px, pv, ids, icv, ids.shape[1] + req.max_new + 1, **pam)
        mask = torch.ones_like(ids)
        if beams > 1:
            out = beam_generate(fwd, ids, mask, num_beams=beams, length_penalty=0.0, **kw)
        else:
            out = greedy_generate(fwd, ids, mask, **kw)
    gen = out[0, ids.shape[1]:].numpy()
    hits = np.nonzero(gen == EOS)[0]
    return gen[: hits[0] + 1] if len(hits) else gen


def engine(cfg, params, beams=1, merged=False, **kw):
    prefill, decode, axes = I2.make_idefics2_serving_fns(cfg, EOS)
    if merged:
        kw["merged_admit_fn"] = I2.make_idefics2_merged_admit_fn(cfg, EOS)
    cls = S.ServingEngine
    if beams > 1:
        cls, kw["num_beams"] = S.BeamServingEngine, beams
    return cls(prefill, decode, axes, cfg.text, params, eos_token_id=EOS, pad_token_id=PAD,
               supports_pixel_attention_mask=True, **kw)


def serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    return eng.run()


def assert_matches(got, cfg, params, reqs, icv=None, beams=1):
    assert set(got) == {r.uid for r in reqs}
    for r in reqs:
        np.testing.assert_array_equal(got[r.uid], reference(cfg, params, r, icv, beams),
                                      err_msg=str(r.uid))


ENGINE_CASES = {
    # 6 mixed requests through 3 slots: slot reuse, buckets 8 and 16, groups
    # of 2 and 1, the ICV and min_new; then with merged admission
    "greedy_icv_min_new": (1, False, 6, 1, dict(n_slots=3, admit_sizes=(2, 1))),
    "greedy_merged_icv_min_new": (1, True, 6, 1, dict(n_slots=3, admit_sizes=(2, 1))),
    # 5 requests through 2 groups of 3 beams (tests/test_serving.py:128)
    "beam3_icv": (3, False, 5, 0, dict(n_slots=2, admit_sizes=(2, 1))),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engines_match_the_bs1_decodes(tiny, case):
    cfg, params, _, _ = tiny
    beams, merged, n, min_new, kw = ENGINE_CASES[case]
    reqs = requests(cfg, 17, n, min_new=min_new)
    icv = t(icv_rows(cfg, 17))
    eng = engine(cfg, params, beams, merged, icv_scaled=icv, out_cap=8, prompt_buckets=(8, 16),
                 sync_steps=2, **kw)
    got = serve(eng, reqs)
    assert_matches(got, cfg, params, reqs, icv, beams)
    if merged:
        assert eng.merged_admits > 0, "no admission rode a merged forward"
        plain = serve(engine(cfg, params, icv_scaled=icv, out_cap=8, prompt_buckets=(8, 16),
                             sync_steps=2, **kw), reqs)
        for uid in got:
            np.testing.assert_array_equal(got[uid], plain[uid], err_msg=str(uid))


# ---------------------------------------------------------------------------
# NaViT admission groups through a bundle's engines
# ---------------------------------------------------------------------------

# (height, width): four real shapes, padded to the processor's 112-pixel
# buckets as (112, 112), (112, 112), (224, 112) and (112, 224)
NAVIT_SHAPES = ((56, 28), (28, 56), (168, 112), (112, 168))


@pytest.fixture(scope="module")
def navit_bundle():
    """A port ``ModelBundle`` of tiny Idefics2 (a 4x4 position table) with a
    variable-resolution processor, and six requests whose images cycle
    ``NAVIT_SHAPES``."""
    from licv_vqa_tpu_torch.data.processor import (
        SIGLIP_MEAN,
        SIGLIP_STD,
        ImageTransform,
        PromptProcessor,
    )
    from licv_vqa_tpu_torch.data.tokenizer import WhitespaceTokenizer
    from licv_vqa_tpu_torch.models.registry import ModelBundle

    _, _, cfg, params = tiny_pair(image_size=NAVIT_SIZE)
    tok = WhitespaceTokenizer()
    proc = PromptProcessor(
        tok, ImageTransform(NAVIT_SIZE, SIGLIP_MEAN, SIGLIP_STD, variable_resolution=True,
                            min_edge=28, max_edge=224),
        family="idefics2", image_seq_len=cfg.image_seq_len,
    )
    cfg = dataclasses.replace(cfg, image_token_id=proc.image_token_id)
    train_fwd, bind = I2.make_idefics2_forward_fns(cfg, tok.eos_token_id)
    bundle = ModelBundle(
        name="tiny-idefics2-navit", model_cfg=cfg, params=params, tokenizer=tok, processor=proc,
        train_forward=train_fwd, bind_decode=bind, hidden_size=cfg.text.d_model,
        n_layers=cfg.text.n_layers, device=torch.device("cpu"), pixel_mean=SIGLIP_MEAN,
        pixel_std=SIGLIP_STD,
    )
    rng = np.random.default_rng(2)
    reqs = []
    for i in range(6):
        img = rng.integers(0, 255, size=NAVIT_SHAPES[i % 4] + (3,)).astype(np.uint8)
        enc = proc.prepare_input([[img, f"query {i}"]], padding=True, padding_side="left")
        m = np.asarray(enc["attention_mask"][0], bool)
        reqs.append(S.Request(
            uid=i, input_ids=np.asarray(enc["input_ids"][0])[m],
            pixel_values=np.asarray(enc["pixel_values"][0]),
            pixel_valid=np.asarray(enc["pixel_valid"][0], bool), max_new=4,
            pixel_attention_mask=np.asarray(enc["pixel_attention_mask"][0])))
    return bundle, reqs


@pytest.mark.parametrize("beams", [1, 3], ids=["greedy_merged", "beam3"])
def test_navit_requests_give_the_static_bind_paths_tokens(navit_bundle, beams):
    bundle, reqs = navit_bundle
    assert {r.pixel_attention_mask.shape for r in reqs} == {
        (1, 112, 112), (1, 224, 112), (1, 112, 224)}
    cls = S.BeamServingEngine if beams > 1 else S.ServingEngine
    kw = dict(num_beams=beams) if beams > 1 else {}
    eng = cls.from_bundle(bundle, n_slots=2, out_cap=4, prompt_buckets=(32,), sync_steps=2,
                          **kw)
    assert eng.supports_pixel_attention_mask
    got = serve(eng, reqs)
    # the two 112x112-padded requests of each real shape share groups; the
    # other shapes admit apart
    assert len(eng.admissions) >= 3 and sum(a for a, _ in eng.admissions) == len(reqs)
    if beams == 1:
        assert eng.merged_admits > 0, "no NaViT group rode a merged forward"
    for r in reqs:
        # the bundle's bind normalises the processor's uint8 pixels
        want = reference(bundle.model_cfg, bundle.params, dataclasses.replace(
            r, pixel_values=bundle.model_pixels(t(r.pixel_values)).numpy()), beams=beams)
        np.testing.assert_array_equal(got[r.uid], want, err_msg=str(r.uid))


def test_the_idefics_engine_still_refuses_a_mask():
    """Idefics-9B's family takes no ``pixel_attention_mask``
    (JAX ``supports_pixel_attention_mask``, serving.py:402-408)."""
    from licv_vqa_tpu_torch.models import idefics as I

    cfg = I.IdeficsConfig.tiny()
    params = I.init_idefics_params(torch.Generator().manual_seed(0), cfg, "cpu")
    prefill, decode, axes = I.make_idefics_serving_fns(cfg, EOS)
    eng = S.ServingEngine(prefill, decode, axes, cfg.text, params, eos_token_id=EOS,
                          pad_token_id=PAD, n_slots=2, out_cap=4, prompt_buckets=(16,))
    isz = cfg.vision.image_size
    with pytest.raises(ValueError, match="pixel_attention_mask"):
        eng.submit(S.Request(uid=0, input_ids=np.asarray([3, cfg.image_token_id, 4], np.int32),
                             pixel_values=np.zeros((1, isz, isz, 3), np.float32), max_new=2,
                             pixel_attention_mask=np.ones((1, isz, isz), np.int32)))


# ---------------------------------------------------------------------------
# the pooled chain
# ---------------------------------------------------------------------------


def questions(cfg, n, seed, s=12):
    """(ids, mask, pixels, valid) of n one-image questions, (N, 1, ...), a
    run of image tokens each; question 1 left-padded."""
    rng = np.random.default_rng(seed)
    isz = cfg.vision.image_size
    ids = rng.integers(3, cfg.text.vocab_size - 2, size=(n, 1, s)).astype(np.int32)
    ids[:, :, 3:3 + cfg.image_seq_len] = cfg.image_token_id
    mask = np.ones_like(ids)
    mask[1, :, :2] = 0
    ids[1, :, :2] = PAD
    pixels = rng.normal(size=(n, 1, 1, isz, isz, 3)).astype(np.float32)
    return ids, mask, pixels, np.ones((n, 1, 1), bool)


def test_pooled_chain_matches_beam_generate_and_jax(tiny):
    """5 questions, P = 3 groups (max_new 4: the drain wraps around), the
    ICV and a left-padded question: per question the port's bs=1
    ``beam_generate`` through ``bind_images``, and JAX's chain on the same
    arrays."""
    pcfg, pparams, jcfg, jparams = tiny
    n, max_new = 5, 4
    qs = questions(pcfg, n, 29)
    icv = icv_rows(pcfg, 29)
    chain = C.make_idefics2_pooled_eval_chain(pcfg, EOS, num_beams=3, max_new_tokens=max_new,
                                              pad_token_id=PAD)
    got = chain(pparams, *map(t, qs), t(icv))
    assert got.shape == (n, 1, max_new)
    _, bind = I2.make_idefics2_forward_fns(pcfg, EOS)
    ids, mask, pixels, valid = qs
    s = ids.shape[-1]
    with torch.inference_mode():
        for i in range(n):
            fwd = bind(pparams, t(pixels[i]), t(valid[i]), t(ids[i]), t(icv), s + max_new + 1)
            want = beam_generate(fwd, t(ids[i]), t(mask[i]), max_new_tokens=max_new,
                                 eos_token_id=EOS, pad_token_id=PAD, num_beams=3)[:, s:]
            np.testing.assert_array_equal(got[i].numpy(), want.numpy(), err_msg=f"question {i}")
    jchain = jax.jit(jx_chain.make_idefics2_pooled_eval_chain(jcfg, EOS, num_beams=3,
                                                              max_new_tokens=max_new))
    want = jchain(jparams, *map(jnp.asarray, qs), jnp.asarray(icv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
