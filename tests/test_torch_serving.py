"""Port vs JAX: the continuous-batching engines on tiny Idefics (CPU, f32).

Every request's tokens from the port's ``ServingEngine`` and
``BeamServingEngine`` must equal, token for token, the port's own bs=1
``greedy_generate``/``beam_generate`` through ``bind_images`` (held to
JAX's in ``tests/test_torch_decode.py``), trimmed at EOS: mixed buckets and
slot reuse, an admission group size that does not divide the request count,
a short bucket reusing a long one's slot, the ICV with ``min_new``, the int8
cache and weights, mixed image counts, both harvest lags, a streaming
callback with follow-up submissions, ``run_online`` fed from a thread and a
``release_pool`` round trip.  One test runs the same arrays through JAX's
own engines.  The requests come from ``tests/serving_common.py``'s
``_make_requests``; the params from ``tests/test_torch_idefics.tiny_pair``
(JAX's init with the cross-attention gates opened, so the media count).
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from licv_vqa_tpu.infer import serving as jx_serving
from licv_vqa_tpu.models import idefics as jx_idefics
from licv_vqa_tpu_torch.infer import serving as S
from licv_vqa_tpu_torch.infer.decode import beam_generate, greedy_generate
from licv_vqa_tpu_torch.models import idefics as I
from licv_vqa_tpu_torch.ops.quantize import quantize_layer_stack
from tests.serving_common import EOS, PAD, _make_requests
from tests.test_torch_idefics import tiny_pair


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny tensors gain nothing from intra-op threads; beside the suite's
    other workers they only spin.  Restored for the worker's next file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """(port cfg, port params, jax cfg, jax params)."""
    jcfg, jparams, pcfg, pparams = tiny_pair()
    return pcfg, pparams, jcfg, jparams


@pytest.fixture(scope="module")
def tiny_int8(tiny):
    """The int8 KV cache and int8 layer weights (the port's quantizer, held
    bit-equal to JAX's in ``tests/test_torch_quantize.py``)."""
    pcfg, pparams, _, _ = tiny
    pparams = dict(pparams, layers=quantize_layer_stack(pparams["layers"]))
    pcfg = dataclasses.replace(pcfg, text=dataclasses.replace(pcfg.text, kv_cache_dtype="int8"))
    return pcfg, pparams


def requests(cfg, seed, n, min_new=0, prefix="r"):
    rng = np.random.default_rng(seed)
    out = []
    for r in _make_requests(cfg, rng, n, min_new=min_new):
        out.append(S.Request(**dict(dataclasses.asdict(r), uid=f"{prefix}{r.uid[1:]}")))
    return out


def mixed_image_requests(cfg, seed, n):
    """1, 2 and 3 images a request (tests/test_serving.py:428)."""
    rng = np.random.default_rng(seed)
    isz, vocab = cfg.vision.image_size, cfg.text.vocab_size
    reqs = []
    for i in range(n):
        n_img = 1 + (i % 3)
        ids = rng.integers(3, vocab, size=(int(rng.integers(6, 13)),)).astype(np.int32)
        for j in range(n_img):
            ids[1 + 2 * j] = cfg.image_token_id
        reqs.append(S.Request(
            uid=f"m{i}", input_ids=ids,
            pixel_values=rng.normal(size=(n_img, isz, isz, 3)).astype(np.float32),
            max_new=int(rng.integers(2, 6)),
        ))
    return reqs


def reference(cfg, params, req, icv=None, beams=1, lp=0.0):
    """The port's bs=1 unpadded decode of one request, trimmed at EOS
    (inclusive): the engine's output contract."""
    _, bind = I.make_idefics_forward_fns(cfg, EOS)
    ids = torch.from_numpy(np.asarray(req.input_ids, np.int32)[None])
    px = torch.from_numpy(np.asarray(req.pixel_values)[None])
    pv = torch.ones((1, px.shape[1]), dtype=torch.bool)
    kw = dict(max_new_tokens=req.max_new, eos_token_id=EOS, pad_token_id=PAD,
              min_new_tokens=req.min_new)
    with torch.inference_mode():
        fwd = bind(params, px, pv, ids, icv, ids.shape[1] + req.max_new + 1)
        mask = torch.ones_like(ids)
        if beams > 1:
            out = beam_generate(fwd, ids, mask, num_beams=beams, length_penalty=lp, **kw)
        else:
            out = greedy_generate(fwd, ids, mask, **kw)
    gen = out[0, ids.shape[1]:].numpy()
    hits = np.nonzero(gen == EOS)[0]
    return gen[: hits[0] + 1] if len(hits) else gen


def engine(cfg, params, beams=1, **kw):
    prefill, decode, axes = I.make_idefics_serving_fns(cfg, EOS)
    if beams > 1:
        kw["num_beams"] = beams
        return S.BeamServingEngine(prefill, decode, axes, cfg.text, params,
                                   eos_token_id=EOS, pad_token_id=PAD, **kw)
    return S.ServingEngine(prefill, decode, axes, cfg.text, params,
                           eos_token_id=EOS, pad_token_id=PAD, **kw)


def serve(eng, reqs, **run_kw):
    for r in reqs:
        eng.submit(r)
    return eng.run(**run_kw)


def assert_matches(got, cfg, params, reqs, icv=None, beams=1, lp=0.0):
    assert set(got) == {r.uid for r in reqs}
    for r in reqs:
        want = reference(cfg, params, r, icv, beams, lp)
        np.testing.assert_array_equal(got[r.uid], want, err_msg=str(r.uid))


def icv_rows(cfg, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (rng.normal(size=(cfg.text.n_layers, cfg.text.d_model)) * 0.1).astype(np.float32))


# (requests, engine options, harvest lag) as tests/test_serving.py:15 and :428
GREEDY_CASES = {
    # 6 mixed requests through 3 slots: slot reuse, buckets 8 and 16, groups
    "mixed": (lambda c: requests(c, 7, 6),
              dict(n_slots=3, out_cap=8, prompt_buckets=(8, 16), sync_steps=2,
                   admit_sizes=(2, 1))),
    # 5 requests of one bucket through groups of 2: the last group is short
    "group_size_does_not_divide": (lambda c: requests(c, 5, 5),
                                   dict(n_slots=4, out_cap=8, prompt_buckets=(16,),
                                        sync_steps=2, admit_sizes=(2,))),
    "harvest_lag_0": (lambda c: requests(c, 7, 6),
                      dict(n_slots=3, out_cap=8, prompt_buckets=(8, 16), sync_steps=1,
                           admit_sizes=(2, 1), harvest_lag=0)),
    # max_new = out_cap in the largest bucket: a finished row's write index
    # stands at cache_len, and its masked writes must stay inside the cache
    "max_new_fills_the_cache": (lambda c: [dataclasses.replace(r, max_new=6)
                                           for r in requests(c, 13, 3)],
                                dict(n_slots=2, out_cap=6, prompt_buckets=(16,),
                                     sync_steps=2)),
    "mixed_image_counts": (lambda c: mixed_image_requests(c, 11, 5),
                           dict(n_slots=3, out_cap=8, prompt_buckets=(16,), sync_steps=2,
                                admit_sizes=(2, 1), max_images=3)),
}


@pytest.mark.parametrize("case", list(GREEDY_CASES))
def test_greedy_engine_matches_greedy_generate(tiny, case):
    cfg, params, _, _ = tiny
    make, kw = GREEDY_CASES[case]
    reqs = make(cfg)
    eng = engine(cfg, params, **kw)
    assert_matches(serve(eng, reqs), cfg, params, reqs)
    if case == "group_size_does_not_divide":
        assert [a for a, _ in eng.admissions] == [2, 2, 1]


def test_greedy_engine_with_icv_and_min_new(tiny):
    """tests/test_serving.py:40: the ICV and min_new EOS suppression."""
    cfg, params, _, _ = tiny
    reqs = requests(cfg, 3, 4, min_new=2)
    icv = icv_rows(cfg, 3)
    eng = engine(cfg, params, n_slots=2, out_cap=8, prompt_buckets=(16,), sync_steps=3,
                 admit_sizes=(2, 1), icv_scaled=icv)
    assert_matches(serve(eng, reqs), cfg, params, reqs, icv)


@pytest.mark.parametrize("beams", [1, 3], ids=["greedy", "beam3"])
def test_engines_int8_cache_and_weights(tiny_int8, beams):
    """tests/test_serving.py:65 and :190: int8 weights and the int8 KV cache
    (the beam tail permute moves the ``{"q", "s"}`` planes)."""
    cfg, params = tiny_int8
    reqs = requests(cfg, 11 if beams == 1 else 29, 3)
    eng = engine(cfg, params, beams, n_slots=2 if beams == 1 else 1, out_cap=8,
                 prompt_buckets=(16,), sync_steps=2)
    assert_matches(serve(eng, reqs), cfg, params, reqs, beams=beams)


def test_short_bucket_reuses_a_long_requests_slot(tiny):
    """One slot: a 16-bucket request, then an 8-bucket one.  The second
    admission writes columns [0, 8) only; the first occupant's later
    columns stay valid in the pool and only the per-row ``written`` mask
    hides them."""
    cfg, params, _, _ = tiny
    rng = np.random.default_rng(4)
    isz = cfg.vision.image_size

    def req(uid, s, max_new):
        ids = rng.integers(3, cfg.text.vocab_size, size=(s,)).astype(np.int32)
        ids[1] = cfg.image_token_id
        return S.Request(uid=uid, input_ids=ids, max_new=max_new,
                         pixel_values=rng.normal(size=(1, isz, isz, 3)).astype(np.float32))

    reqs = [req("long", 14, 6), req("short", 5, 2)]
    eng = engine(cfg, params, n_slots=1, out_cap=8, prompt_buckets=(8, 16), sync_steps=2)
    got = serve(eng, reqs)
    assert_matches(got, cfg, params, reqs)
    assert eng.admissions == [(1, 16), (1, 8)]
    # the short request wrote columns up to 8 + its token count (its last
    # column by the masked steps after it finished); the long request's
    # columns past those are still marked valid
    short_end = 8 + len(got["short"])
    assert bool(eng._cache["valid"][0, short_end + 1:16].all())


@pytest.mark.parametrize("lp", [0.0, -0.5, 1.0])
def test_beam_engine_with_icv_min_new_and_length_penalty(tiny, lp):
    """tests/test_serving.py:156: lp <= 0 releases groups early, lp > 0 runs
    every step."""
    cfg, params, _, _ = tiny
    reqs = requests(cfg, 23, 4, min_new=2)
    icv = icv_rows(cfg, 23)
    eng = engine(cfg, params, 2, length_penalty=lp, n_slots=2, out_cap=8,
                 prompt_buckets=(16,), sync_steps=3, icv_scaled=icv)
    assert_matches(serve(eng, reqs), cfg, params, reqs, icv, beams=2, lp=lp)


def test_beam_engine_mixed_buckets_and_group_reuse(tiny):
    """tests/test_serving.py:128: 5 requests through 2 groups of 3 beams."""
    cfg, params, _, _ = tiny
    reqs = requests(cfg, 17, 5)
    eng = engine(cfg, params, 3, n_slots=2, out_cap=8, prompt_buckets=(8, 16),
                 sync_steps=2, admit_sizes=(2, 1))
    assert_matches(serve(eng, reqs), cfg, params, reqs, beams=3)


def test_beam_engine_guards(tiny):
    """tests/test_serving.py:222."""
    cfg, params, _, _ = tiny
    prefill, decode, axes = I.make_idefics_serving_fns(cfg, EOS)
    with pytest.raises(ValueError, match="num_beams"):
        S.BeamServingEngine(prefill, decode, axes, cfg.text, params, num_beams=1,
                            eos_token_id=EOS, pad_token_id=PAD)
    eng = engine(cfg, params, 2, n_slots=1, prompt_buckets=(8,), out_cap=4)
    with pytest.raises(NotImplementedError, match="greedy-only"):
        eng.run_fused()
    with pytest.raises(NotImplementedError, match="greedy-only"):
        engine(cfg, params, 2, merged_admit_fn=lambda *a: None)


@pytest.mark.parametrize("what,item", [("mesh", "item 16b"), ("run_fused", "item 19")])
def test_what_is_not_ported_raises_with_its_roadmap_item(tiny, what, item):
    cfg, params, _, _ = tiny
    with pytest.raises(NotImplementedError, match=item):
        if what == "mesh":
            engine(cfg, params, mesh=object())
        else:
            engine(cfg, params, prompt_buckets=(8,)).run_fused()


def test_submit_guards(tiny):
    """A NaViT mask (tests/test_serving.py:544), and a request wider than
    the media buffers (:428)."""
    cfg, params, _, _ = tiny
    eng = engine(cfg, params, n_slots=2, out_cap=4, prompt_buckets=(16,), max_images=2)
    isz = cfg.vision.image_size
    ids = np.asarray([3, cfg.image_token_id, 4], np.int32)
    with pytest.raises(ValueError, match="pixel_attention_mask"):
        eng.submit(S.Request(uid=0, input_ids=ids, max_new=2,
                             pixel_values=np.zeros((1, isz, isz, 3), np.float32),
                             pixel_attention_mask=np.ones((1, isz, isz), np.int32)))
    with pytest.raises(ValueError, match="max_images"):
        eng.submit(S.Request(uid=1, input_ids=ids, max_new=2,
                             pixel_values=np.zeros((3, isz, isz, 3), np.float32)))
    with pytest.raises(ValueError, match="out_cap"):
        eng.submit(S.Request(uid=2, input_ids=ids, max_new=5,
                             pixel_values=np.zeros((1, isz, isz, 3), np.float32)))


def test_streaming_callback_and_followup_submission(tiny):
    """tests/test_serving.py:264: results stream as slots finish; the
    callback submits follow-ups, which enter freed slots."""
    cfg, params, _, _ = tiny
    first = requests(cfg, 21, 3)
    followups = {r.uid: f for r, f in zip(first, requests(cfg, 22, 3, prefix="f"))}
    eng = engine(cfg, params, n_slots=2, out_cap=8, prompt_buckets=(16,), sync_steps=2)
    streamed = {}

    def on_complete(uid, toks):
        streamed[uid] = toks
        if uid in followups:
            eng.submit(followups[uid])

    got = serve(eng, first, on_complete=on_complete)
    assert streamed.keys() == got.keys()
    assert_matches(got, cfg, params, first + list(followups.values()))


def test_run_online_serves_a_feeding_thread(tiny):
    """``run_online`` serves requests submitted from another thread and
    returns after ``stop`` once everything submitted is done."""
    cfg, params, _, _ = tiny
    reqs = requests(cfg, 41, 4)
    eng = engine(cfg, params, n_slots=2, out_cap=8, prompt_buckets=(16,), sync_steps=2)
    done = threading.Event()

    def feed():
        while eng._clock_t0 is None:  # submit once the loop's clock runs
            time.sleep(0.001)
        for r in reqs:
            eng.submit(r)
        done.set()

    def on_complete(uid, toks):
        if done.is_set() and len(eng.completion_s) == len(reqs):
            eng.stop()

    feeder = threading.Thread(target=feed)
    feeder.start()
    got = eng.run_online(on_complete=on_complete)
    feeder.join(timeout=30)
    assert not feeder.is_alive()
    assert_matches(got, cfg, params, reqs)
    assert set(eng.arrival_s) == set(eng.admission_s) == set(eng.first_token_s) == set(got)


def test_release_pool_round_trip(tiny):
    """tests/test_serving.py:573."""
    cfg, params, _, _ = tiny
    reqs = requests(cfg, 31, 3)
    eng = engine(cfg, params, n_slots=2, out_cap=8, prompt_buckets=(16,))
    assert set(serve(eng, reqs[:2])) == {r.uid for r in reqs[:2]}
    eng.release_pool()
    assert eng._cache is None and eng._state is None and eng._media is None
    for r in reqs:
        eng.submit(r)
    with pytest.raises(RuntimeError, match="queued"):
        eng.release_pool()
    assert_matches(eng.run(), cfg, params, reqs)


@pytest.mark.parametrize("beams", [1, 3], ids=["greedy", "beam3"])
def test_engines_equal_jax_engines(tiny, beams):
    """The same arrays through JAX's ``ServingEngine``/``BeamServingEngine``
    and the port's: every request's tokens equal."""
    pcfg, pparams, jcfg, jparams = tiny
    reqs = requests(pcfg, 51, 4)
    kw = dict(n_slots=2, out_cap=8, prompt_buckets=(16,), sync_steps=2, admit_sizes=(2, 1))
    prefill, decode, axes = jx_idefics.make_idefics_serving_fns(jcfg, eos_token_id=EOS)
    jcls = jx_serving.BeamServingEngine if beams > 1 else jx_serving.ServingEngine
    jkw = dict(kw, num_beams=beams) if beams > 1 else kw
    jeng = jcls(prefill, decode, axes, jcfg.text, jparams, eos_token_id=EOS,
                pad_token_id=PAD, **jkw)
    for r in reqs:
        jeng.submit(jx_serving.Request(**dataclasses.asdict(r)))
    want = jeng.run()
    got = serve(engine(pcfg, pparams, beams, **kw), reqs)
    assert set(got) == set(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], np.asarray(want[uid]), err_msg=str(uid))


def test_serving_media_axes_match_jax():
    """The port's media axes name JAX's batch axes (and the image axes the
    port sizes its buffers by)."""
    assert {k: ax for k, (ax, _) in I.SERVING_MEDIA_AXES.items()} == jx_idefics.SERVING_MEDIA_AXES
