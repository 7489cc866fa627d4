"""Port vs JAX: the serving engines and the pooled chain over spawned gloo
ranks (CPU, f32).

The engines' slot pool is sharded over dp (each rank its contiguous slots,
a beam engine's whole groups) and the frozen weights over tp, one process
a rank (``tests/torch_dist_common.py::serving_suite``: every case of one
world size in one spawn, two ranks for dp = 2 or tp = 2, four for
dp = 2 x tp = 2).  Every rank's tokens must equal, exactly:

- the port's one-process engine on the same requests (its plain admission
  where the ranks admit plainly), with the same ``admissions`` and
  ``steps_run``;
- JAX's engine on a dp (and tp) mesh of the suite's virtual devices (JAX
  ``tests/test_serving.py:299``, ``:329``), run here while the ranks run:
  the greedy and beam Idefics cases, and greedy Idefics2 and OpenFlamingo.

The cases: greedy at dp 2 and dp 2 x tp 2 (merged admission given, dropped
under dp > 1), merged admission at tp 2 (its merged admissions as one
process's), beam-3 at dp 2, tp 2 and dp 2 x tp 2 (JAX's layouts), Idefics2
NaViT groups (three pixel shapes) greedy and beam at dp 2, OpenFlamingo
over 1-3 images greedy and beam at dp 2, int8 weights and the int8 KV cache
at dp 2 and beam at dp 2 x tp 2, and the pooled chain
(``runner.pooled_tokens``) at dp 2 and tp 2 against one process's chunks.
The raises (``n_slots`` not a dp multiple, ``run_online`` across ranks,
ROADMAP item 30) need no ranks: they come before any collective.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from licv_vqa_tpu.infer import serving as jx_serving
from licv_vqa_tpu.models import idefics as jx_idefics
from licv_vqa_tpu.models import idefics2 as jx_idefics2
from licv_vqa_tpu.models import openflamingo as jx_flamingo
from licv_vqa_tpu.parallel.sharding import param_specs as jx_param_specs
from licv_vqa_tpu_torch.core.mesh import Mesh as PortMesh
from licv_vqa_tpu_torch.infer import serving as S
from licv_vqa_tpu_torch.models import idefics as I
from tests import test_torch_idefics as T1
from tests import test_torch_idefics2 as T2
from tests import test_torch_openflamingo as T3
from tests.serving_common import EOS, PAD, _make_requests
from tests.torch_dist_common import Ranks, serve_case, serving_suite

NAVIT_SIZE = 56
# (height, width) of the Idefics2 requests' padded pixels, and their real
# region: three admission-group keys
NAVIT_SHAPES = (((42, 28), (28, 28)), ((28, 42), (28, 14)), ((56, 56), (42, 56)))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _requests(cfg, seed, n, min_new=0):
    return [dataclasses.asdict(r) for r in _make_requests(cfg, np.random.default_rng(seed), n,
                                                          min_new=min_new)]


def _navit_requests(cfg, seed, n):
    """Idefics2 requests whose pixels (one image) cycle ``NAVIT_SHAPES``,
    the padding zero and masked as the processor leaves it."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        (h, w), (rh, rw) = NAVIT_SHAPES[i % len(NAVIT_SHAPES)]
        ids = rng.integers(3, 110, size=(int(rng.integers(8, 14)),)).astype(np.int32)
        ids[1:1 + cfg.image_seq_len] = cfg.image_token_id
        pmask = np.zeros((1, h, w), np.int32)
        pmask[0, :rh, :rw] = 1
        pixels = rng.normal(size=(1, h, w, 3)).astype(np.float32) * pmask[..., None]
        out.append(dict(uid=f"n{i}", input_ids=ids, pixel_values=pixels,
                        max_new=int(rng.integers(2, 6)), pixel_attention_mask=pmask))
    return out


def _image_requests(cfg, seed, n):
    """OpenFlamingo requests of 1, 2 and 3 images."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        n_img = 1 + i % 3
        ids = rng.integers(3, cfg.text.vocab_size, size=(int(rng.integers(6, 13)),)).astype(
            np.int32)
        ids[[1 + 2 * j for j in range(n_img)]] = cfg.image_token_id
        isz = cfg.vision.image_size
        out.append(dict(uid=f"m{i}", input_ids=ids, max_new=int(rng.integers(2, 6)),
                        pixel_values=rng.normal(size=(n_img, isz, isz, 3)).astype(np.float32)))
    return out


def _questions(cfg, n, seed):
    """The pooled chain's ``(ids, pixels, valid)`` of ``n`` questions of one
    or two images: two image-count buckets of 64 columns."""
    rng = np.random.default_rng(seed)
    isz = cfg.vision.image_size
    out = []
    for i in range(n):
        n_img = 1 + (i % 3 == 2)
        ids = rng.integers(3, cfg.text.vocab_size - 2, size=(int(rng.integers(9, 15)),))
        ids = ids.astype(np.int32)
        ids[[2 + 4 * j for j in range(n_img)]] = cfg.image_token_id
        out.append((ids, rng.normal(size=(n_img, isz, isz, 3)).astype(np.float32),
                    np.ones((n_img,), bool)))
    return out


ENGINE = dict(out_cap=8, sync_steps=2, admit_sizes=(2, 1))


def _cases():
    """``{name: case}`` (``serve_case``'s dicts, with ``dp``/``tp``) and the
    JAX setups ``{family: (jax cfg, jax params)}``."""
    rng = np.random.default_rng(40)
    j1, jp1, p1, _ = T1.tiny_pair()
    j2, jp2, p2, _ = T2.tiny_pair(image_size=NAVIT_SIZE)
    j3, jp3, p3, _ = T3.tiny_pair()
    fam = {"idefics": (p1, _np_tree(jp1), T1.EOS), "idefics2": (p2, _np_tree(jp2), T2.EOS),
           "openflamingo": (p3, _np_tree(jp3), T3.EOS)}

    def case(family, dp, tp, **kw):
        cfg, params, eos = fam[family]
        return dict(dict(kind="engine", family=family, cfg=cfg, params=params, eos=eos, pad=PAD,
                         dp=dp, tp=tp, beams=1), **kw)

    greedy = dict(requests=_requests(p1, 9, 6), engine_kw=dict(ENGINE, n_slots=4,
                                                               prompt_buckets=(16,)))
    beam = dict(requests=_requests(p1, 31, 6), beams=3,
                engine_kw=dict(ENGINE, n_slots=2, prompt_buckets=(8, 16)))
    navit = dict(requests=_navit_requests(p2, 5, 6), icv=(rng.normal(size=(4, 64)) * 0.1).astype(
        np.float32), engine_kw=dict(ENGINE, n_slots=4, prompt_buckets=(32,)))
    images = dict(requests=_image_requests(p3, 23, 6),
                  engine_kw=dict(ENGINE, n_slots=4, prompt_buckets=(8, 16), max_images=3))
    images_beam = dict(images, engine_kw=dict(images["engine_kw"], n_slots=2))
    kv8 = dataclasses.replace(p3, text=dataclasses.replace(p3.text, kv_cache_dtype="int8"))
    pooled = dict(kind="pooled", encs=_questions(p1, 7, 60), pool=2, max_new=4,
                  icv=(rng.normal(size=(4, 64)) * 0.1).astype(np.float32))
    two = {
        "greedy_dp2": case("idefics", 2, 1, **greedy),
        "merged_tp2": case("idefics", 1, 2, merged=True, **greedy),
        "beam_dp2": case("idefics", 2, 1, **beam),
        "beam_tp2": case("idefics", 1, 2, **beam),
        "idefics2_navit_dp2": case("idefics2", 2, 1, merged=True, **navit),
        "idefics2_navit_beam_dp2": case("idefics2", 2, 1, **dict(navit, beams=3, engine_kw=dict(
            navit["engine_kw"], n_slots=2))),
        "openflamingo_dp2": case("openflamingo", 2, 1, merged=True, **images),
        "openflamingo_beam_dp2": case("openflamingo", 2, 1, beams=3, **images_beam),
        "openflamingo_int8_kv8_dp2": case("openflamingo", 2, 1, **dict(
            images, cfg=kv8, int8=True)),
        "pooled_dp2": case("idefics", 2, 1, **pooled),
        "pooled_tp2": case("idefics", 1, 2, **pooled),
    }
    four = {
        "greedy_dp2tp2": case("idefics", 2, 2, merged=True, **greedy),
        "beam_dp2tp2": case("idefics", 2, 2, **beam),
        "openflamingo_beam_dp2tp2": case("openflamingo", 2, 2, beams=3, **images_beam),
    }
    return two, four, {"idefics": (j1, jp1), "idefics2": (j2, jp2), "openflamingo": (j3, jp3)}


JAX_FNS = {"idefics": jx_idefics.make_idefics_serving_fns,
           "idefics2": jx_idefics2.make_idefics2_serving_fns,
           "openflamingo": jx_flamingo.make_openflamingo_serving_fns}


def _jax_serve(c, jcfg, jparams):
    """JAX's engine on the case's requests, the pool over a dp (x tp) mesh
    of the virtual devices, the weights laid out by ``param_specs``."""
    dp, tp = c["dp"], c["tp"]
    mesh = Mesh(np.asarray(jax.devices()[:dp * tp]).reshape(dp, tp), ("dp", "tp"))
    specs = jx_param_specs(jparams)
    params = jax.device_put(jparams, jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                                                  is_leaf=lambda x: isinstance(x, P)))
    prefill, decode, axes = JAX_FNS[c["family"]](jcfg, c["eos"])
    kw = dict(c["engine_kw"], eos_token_id=c["eos"], pad_token_id=PAD, mesh=mesh,
              icv_scaled=None if c.get("icv") is None else jnp.asarray(c["icv"]),
              supports_pixel_attention_mask=c["family"] == "idefics2")
    if c["beams"] > 1:
        eng = jx_serving.BeamServingEngine(prefill, decode, axes, jcfg.text, params,
                                           num_beams=c["beams"], **kw)
    else:
        eng = jx_serving.ServingEngine(prefill, decode, axes, jcfg.text, params, **kw)
    for r in c["requests"]:
        eng.submit(jx_serving.Request(**r))
    return {uid: np.asarray(t) for uid, t in eng.run().items()}


# the JAX mesh engine each case is held to: one run a request set, at the
# case's layout where JAX's tests run that layout
JAX_RUNS = {"greedy_dp2": "greedy_dp2", "merged_tp2": "greedy_dp2",
            "greedy_dp2tp2": "greedy_dp2", "beam_dp2": "beam_dp2tp2",
            "beam_tp2": "beam_dp2tp2", "beam_dp2tp2": "beam_dp2tp2",
            "idefics2_navit_dp2": "idefics2_navit_dp2", "openflamingo_dp2": "openflamingo_dp2"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{case: (the ranks' outputs, one process's, JAX's or None)}``: two
    and four ranks run at once while JAX's mesh engines and the port's
    one-process engines run here."""
    two, four, jax_setups = _cases()
    tmp = tmp_path_factory.mktemp("serving_dist")
    spawns = [(Ranks(serving_suite, 2, tmp, two, timeout=300), two),
              (Ranks(serving_suite, 4, tmp, four, timeout=300), four)]
    cases = {**two, **four}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jax_out = {name: _jax_serve(cases[name], *jax_setups[cases[name]["family"]])
                   for name in sorted(set(JAX_RUNS.values()))}
        # one process: plain admission wherever the ranks' dp drops merged
        one = {name: serve_case(dict(c, merged=c.get("merged", False) and c["dp"] == 1))
               for name, c in cases.items()}
    finally:
        torch.set_num_threads(n)
    out = {}
    for ranks, group in spawns:
        results = ranks.wait()
        for name, c in group.items():
            want_jax = jax_out[JAX_RUNS[name]] if name in JAX_RUNS else None
            out[name] = (c, [r[name] for r in results], one[name], want_jax)
    return out


CASES = ["greedy_dp2", "merged_tp2", "beam_dp2", "beam_tp2", "idefics2_navit_dp2",
         "idefics2_navit_beam_dp2", "openflamingo_dp2", "openflamingo_beam_dp2",
         "openflamingo_int8_kv8_dp2", "greedy_dp2tp2", "beam_dp2tp2",
         "openflamingo_beam_dp2tp2"]


def _assert_tokens(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for uid in want:
        np.testing.assert_array_equal(np.asarray(got[uid]), np.asarray(want[uid]),
                                      err_msg=f"{what}: {uid}")


@pytest.mark.parametrize("name", CASES)
def test_every_rank_gives_the_one_process_engines_tokens(runs, name):
    c, ranks, one, _ = runs[name]
    assert len(ranks) == c["dp"] * c["tp"]
    assert set(one["tokens"]) == {r["uid"] for r in c["requests"]}
    for rank, got in enumerate(ranks):  # every rank returns every request
        _assert_tokens(got["tokens"], one["tokens"], f"{name} rank {rank}")


@pytest.mark.parametrize("name", CASES)
def test_the_schedule_is_the_one_process_engines(runs, name):
    """The same admissions and decode steps on every rank; each rank holds
    its 1/dp of the rows; merged admission at dp = 1 only."""
    c, ranks, one, _ = runs[name]
    for got in ranks:
        assert got["admissions"] == one["admissions"]
        assert got["steps_run"] == one["steps_run"]
        assert got["merged_admits"] == one["merged_admits"]
        assert got["n_rows"] * c["dp"] == one["n_rows"]
    if c.get("merged") and c["dp"] == 1:
        assert one["merged_admits"] > 0, "no admission rode a merged forward"
    else:
        assert one["merged_admits"] == 0


@pytest.mark.parametrize("name", list(JAX_RUNS))
def test_the_ranks_give_jax_mesh_engines_tokens(runs, name):
    _, ranks, _, want = runs[name]
    for rank, got in enumerate(ranks):
        _assert_tokens(got["tokens"], want, f"{name} rank {rank} vs JAX")


@pytest.mark.parametrize("name", ["pooled_dp2", "pooled_tp2"])
def test_pooled_chain_over_ranks_gives_one_process_chunks_tokens(runs, name):
    c, ranks, one, _ = runs[name]
    want = one["tokens"]
    assert want.shape == (len(c["encs"]), c["max_new"]) and (want != PAD).any()
    for got in ranks:
        np.testing.assert_array_equal(got["tokens"], want)


def _engine(mesh, **kw):
    cfg, params = I.IdeficsConfig.tiny(dtype=torch.float32), T1.tiny_pair()[3]
    prefill, decode, axes = I.make_idefics_serving_fns(cfg, EOS)
    return S.ServingEngine(prefill, decode, axes, cfg.text, params, eos_token_id=EOS,
                           pad_token_id=PAD, mesh=mesh, prompt_buckets=(8,), **kw)


def test_slots_that_do_not_divide_over_dp_raise():
    """JAX serving.py:177-181 (and a beam engine's groups, :1240)."""
    mesh = PortMesh(dp=2, tp=1, rank=0, dp_index=0, tp_index=0)
    with pytest.raises(ValueError, match="must divide over dp=2"):
        _engine(mesh, n_slots=3)
    cfg, params = I.IdeficsConfig.tiny(dtype=torch.float32), T1.tiny_pair()[3]
    prefill, decode, axes = I.make_idefics_serving_fns(cfg, EOS)
    with pytest.raises(ValueError, match="must divide over dp=2"):
        S.BeamServingEngine(prefill, decode, axes, cfg.text, params, num_beams=3, n_slots=3,
                            eos_token_id=EOS, pad_token_id=PAD, mesh=mesh)


def test_run_online_across_ranks_raises_with_its_roadmap_item():
    eng = _engine(PortMesh(dp=2, tp=1, rank=1, dp_index=1, tp_index=0), n_slots=4)
    assert eng.n_rows == 2
    with pytest.raises(NotImplementedError, match="item 30"):
        eng.run_online()
