"""Merged admission in the port's greedy engine (CPU, f32, tiny Idefics).

Given a ``merged_admit_fn``, the engine's admissions into an occupied pool
ride one forward of a pool decode step and the group's prefill (``models/idefics.py::make_idefics_merged_admit_fn``).  Every
request's tokens equal plain admission's and the port's bs=1
``greedy_generate`` (``tests/test_torch_serving.py::reference``): with the
ICV and ``min_new`` and slot reuse forcing admissions mid-flight (JAX
``tests/test_serving_merged.py:12``), with int8 weights and the int8 KV
cache (``:91``), with mixed image counts, and against JAX's engine with
JAX's merged function.  ``from_bundle`` gives the greedy engine the merged
function, unless the bundle's prefills take w8a8, and the beam engine none.
"""

import dataclasses

import numpy as np
import pytest

from licv_vqa_tpu.infer import serving as jx_serving
from licv_vqa_tpu.models import idefics as jx_idefics
from licv_vqa_tpu_torch.infer import serving as S
from licv_vqa_tpu_torch.models import idefics as I
from tests.serving_common import EOS, PAD
from tests.test_torch_serving import (  # noqa: F401  (fixtures)
    _one_thread,
    assert_matches,
    engine,
    icv_rows,
    mixed_image_requests,
    requests,
    serve,
    tiny,
    tiny_int8,
)


def merged_engine(cfg, params, **kw):
    return engine(cfg, params, merged_admit_fn=I.make_idefics_merged_admit_fn(cfg, EOS), **kw)


CASES = {
    # 7 requests through 3 slots, buckets 8 and 16, groups of 2 and 1, the
    # ICV and min_new (tests/test_serving_merged.py:12)
    "icv_min_new": (lambda c: requests(c, 17, 7, min_new=1),
                    dict(n_slots=3, out_cap=8, prompt_buckets=(8, 16), sync_steps=2,
                         admit_sizes=(2, 1)), True),
    "harvest_lag_0": (lambda c: requests(c, 19, 5),
                      dict(n_slots=2, out_cap=8, prompt_buckets=(16,), sync_steps=1,
                           admit_sizes=(1,), harvest_lag=0), False),
    "mixed_image_counts": (lambda c: mixed_image_requests(c, 11, 5),
                           dict(n_slots=2, out_cap=8, prompt_buckets=(16,), sync_steps=2,
                                admit_sizes=(1,), max_images=3), False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_merged_admission_matches_plain_admission_and_greedy(tiny, case):
    cfg, params, _, _ = tiny
    make, kw, with_icv = CASES[case]
    reqs = make(cfg)
    icv = icv_rows(cfg, 17) if with_icv else None
    eng = merged_engine(cfg, params, icv_scaled=icv, **kw)
    got = serve(eng, reqs)
    assert eng.merged_admits > 0, "no admission rode a merged forward"
    assert_matches(got, cfg, params, reqs, icv)
    plain = serve(engine(cfg, params, icv_scaled=icv, **kw), reqs)
    assert set(plain) == set(got)
    for uid in got:
        np.testing.assert_array_equal(got[uid], plain[uid], err_msg=str(uid))


def test_merged_admission_int8_weights_and_cache(tiny_int8):
    """tests/test_serving_merged.py:91: the packed projections' int8 routes
    and the int8 cache's round trip through the merged forward."""
    cfg, params = tiny_int8
    reqs = requests(cfg, 29, 5)
    eng = merged_engine(cfg, params, n_slots=2, out_cap=8, prompt_buckets=(16,), sync_steps=2,
                        admit_sizes=(2, 1))
    got = serve(eng, reqs)
    assert eng.merged_admits > 0
    assert_matches(got, cfg, params, reqs)


def test_merged_admission_equals_jax_engine(tiny):
    """The same requests through JAX's engine with its merged function."""
    pcfg, pparams, jcfg, jparams = tiny
    reqs = requests(pcfg, 53, 5)
    kw = dict(n_slots=2, out_cap=8, prompt_buckets=(16,), sync_steps=2, admit_sizes=(1,))
    prefill, decode, axes = jx_idefics.make_idefics_serving_fns(jcfg, eos_token_id=EOS)
    jeng = jx_serving.ServingEngine(
        prefill, decode, axes, jcfg.text, jparams, eos_token_id=EOS, pad_token_id=PAD,
        merged_admit_fn=jx_idefics.make_idefics_merged_admit_fn(jcfg, EOS),
        merged_admit_in_run=True, **kw)
    for r in reqs:
        jeng.submit(jx_serving.Request(**dataclasses.asdict(r)))
    want = jeng.run()
    eng = merged_engine(pcfg, pparams, **kw)
    got = serve(eng, reqs)
    assert jeng.merged_admits == eng.merged_admits > 0
    assert set(got) == set(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], np.asarray(want[uid]), err_msg=str(uid))


def test_run_keeps_plain_admission_unless_asked(tiny):
    """Without a ``merged_admit_fn`` every admission is plain; with one, an
    admission into an empty pool still is (one slot: every admission finds
    the pool empty)."""
    cfg, params, _, _ = tiny
    reqs = requests(cfg, 61, 3)
    kw = dict(n_slots=1, out_cap=8, prompt_buckets=(16,), sync_steps=2)
    eng = engine(cfg, params, **kw)
    assert_matches(serve(eng, reqs), cfg, params, reqs)
    assert eng.merged_admits == 0
    one = merged_engine(cfg, params, **kw)
    assert_matches(serve(one, reqs), cfg, params, reqs)
    assert one.merged_admits == 0


def test_from_bundle_gives_merged_admission_to_the_greedy_engine_only(monkeypatch):
    """The bundle's engines: the greedy one carries the merged function
    (with the bundle's pixel normalisation) and uses it, the beam one
    none; a bundle whose prefills take w8a8 keeps plain admission (the
    merged forward is weight-only)."""
    from licv_vqa_tpu_torch.models.registry import build_model
    from licv_vqa_tpu_torch.utils import compose
    from tests.test_torch_cli import MODEL, REPO

    monkeypatch.chdir(REPO)

    def bundle_of(*extra):
        cfg = compose("config", "inference", [f"lmm={MODEL}", "device=cpu", *extra])
        return build_model(cfg, device="cpu")

    bundle = bundle_of()
    greedy = S.ServingEngine.from_bundle(bundle, n_slots=2, out_cap=8, prompt_buckets=(16,),
                                         sync_steps=2, admit_sizes=(1,))
    beam = S.BeamServingEngine.from_bundle(bundle, n_slots=1, prompt_buckets=(64,))
    assert greedy._merged_admit is not None and beam._merged_admit is None
    reqs = [dataclasses.replace(r, pixel_values=np.zeros(r.pixel_values.shape, np.uint8))
            for r in requests(bundle.model_cfg, 67, 3)]
    serve(greedy, reqs)
    assert greedy.merged_admits > 0  # the second request joins the first's pool
    w8a8 = bundle_of("lmm.quantize=int8", "lmm.w8a8_prefill=true")
    assert S.ServingEngine.from_bundle(w8a8, n_slots=2)._merged_admit is None
