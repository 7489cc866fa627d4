"""Port vs JAX: the tp-sharded forward of the three families (CPU, f32).

JAX runs its tiny models with the params laid out by its own
``param_specs`` on a tp mesh of its virtual CPU devices (as
``tests/test_parallel.py`` does) for the base Idefics-9B case, and on one
device for the others: GSPMD changes no result
(``tests/test_parallel.py`` holds its sharded decodes to the one-device
ones), and its sharded eager dispatch costs CPU the suite shares.  The port
runs the same numpy params in spawned gloo ranks
(``tests/torch_dist_common.py``), each holding its ``shard_params`` shard:
two ranks for the tp = 2 cases, four for the tp = 4 one.  Prefill logits
must agree within 1e-5 and the greedy and beam-3 tokens exactly, for tiny
Idefics-9B, Idefics2 and OpenFlamingo with the ICV on, int8 (head, tower,
int8 cache, w8a8) and int4 Idefics-9B, and a tp = 4 Idefics-9B (greedy)
whose vocab (110) 4 does not divide.
Idefics2's tiny perceiver has one KV head, which two ranks cannot split by
heads: its cases give the perceiver two (the real model's 16/4 split at
tp = 2 and 4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from licv_vqa_tpu.infer.decode import beam_generate as jx_beam
from licv_vqa_tpu.infer.decode import greedy_generate as jx_greedy
from licv_vqa_tpu.models import idefics as jx_idefics
from licv_vqa_tpu.models import idefics2 as jx_idefics2
from licv_vqa_tpu.models import openflamingo as jx_flamingo
from licv_vqa_tpu.parallel.sharding import param_specs as jx_param_specs
from licv_vqa_tpu_torch.models import idefics2 as pt_idefics2
from tests import test_torch_idefics as T1
from tests import test_torch_idefics2 as T2
from tests import test_torch_openflamingo as T3
from tests.test_torch_quantize import CONFIGS as QUANT_CONFIGS
from tests.torch_dist_common import Ranks, tp_suite

ATOL = 1e-5
MAX_NEW = 3


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _heads(cfg, **kw):
    """``cfg`` with its tower's and perceiver's head counts replaced."""
    out = cfg
    for part, n in kw.items():
        out = dataclasses.replace(out, **{part: dataclasses.replace(getattr(out, part), n_heads=n)})
    return out


def _quantized(jcfg, jparams, pcfg, name):
    """``tests/test_torch_quantize.py``'s quantized tiny-idefics, quantized
    by the port (planes and scales bit-equal to JAX's, as that file holds)
    and carried back to JAX."""
    from types import SimpleNamespace

    from licv_vqa_tpu_torch.models import registry as pt_registry
    from licv_vqa_tpu_torch.models.weights import params_from_jax

    mode, head, vision, kv8, a8 = QUANT_CONFIGS[name]
    lmm = {"quantize": mode, "quantize_head": head, "quantize_vision": vision}
    ns = SimpleNamespace(lmm=SimpleNamespace(get=lambda k, d=None: lmm.get(k, d)))
    bundle = SimpleNamespace(params=params_from_jax(_np_tree(jparams)), model_cfg=pcfg)
    tree = jax.tree.map(lambda t: t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy(),
                        pt_registry._maybe_quantize(ns, bundle).params)
    tree = _bf16_scales(tree)
    kw = dict(kv_cache_dtype="int8" if kv8 else "bf16", w8a8_prefill=a8)
    jcfg = dataclasses.replace(jcfg, text=dataclasses.replace(jcfg.text, **kw))
    pcfg = dataclasses.replace(pcfg, text=dataclasses.replace(pcfg.text, **kw))
    return jcfg, jax.tree.map(jnp.asarray, tree), pcfg


def _bf16_scales(tree):
    """int4 scales back in JAX's bf16 storage dtype."""
    if isinstance(tree, dict):
        if set(tree) == {"q4", "s"}:
            return {"q4": tree["q4"], "s": tree["s"].astype(jnp.bfloat16)}
        return {k: _bf16_scales(v) for k, v in tree.items()}
    return tree


def _idefics_cases():
    rng = np.random.default_rng(3)
    ids, mask, pixels, valid = T1.tiny_inputs(rng, s=20)
    icv = (rng.normal(size=(4, 64)) * 0.5).astype(np.float32)
    jcfg, jparams, pcfg, _ = T1.tiny_pair()
    out = {"idefics": (jcfg, jparams, pcfg, 2, (ids, mask, pixels, valid), icv)}
    for name in ("int8_all", "int4"):
        jq, jqp, pq = _quantized(jcfg, jparams, pcfg, name)
        out[f"idefics_{name}"] = (jq, jqp, pq, 2, (ids, mask, pixels, valid), icv)
    # tp = 4: every head count a multiple of 4; vocab 110 is padded to 112
    j4 = _heads(jcfg, vision=4, perceiver=4)
    p4 = _heads(pcfg, vision=4, perceiver=4)
    j4params = jx_idefics.init_idefics_params(jax.random.PRNGKey(4), j4)
    j4params = _np_tree(j4params)
    for key in ("alpha_xattn", "alpha_dense"):
        j4params["xattn"][key] = np.full_like(j4params["xattn"][key], 0.7)
    out["idefics_tp4"] = (j4, jax.tree.map(jnp.asarray, j4params), p4, 4,
                          (ids, mask, pixels, valid), icv)
    return out


def _idefics2_case():
    rng = np.random.default_rng(5)
    ids, mask, pixels, valid, _ = T2.tiny_inputs(rng)
    icv = (rng.normal(size=(4, 64)) * 0.5).astype(np.float32)
    jcfg = jx_idefics2.Idefics2Config.tiny(dtype=jnp.float32)
    jcfg = dataclasses.replace(jcfg, perceiver=dataclasses.replace(jcfg.perceiver, n_kv_heads=2))
    pcfg = pt_idefics2.Idefics2Config.tiny(dtype=torch.float32)
    pcfg = dataclasses.replace(pcfg, perceiver=dataclasses.replace(pcfg.perceiver, n_kv_heads=2))
    tree = T2._perturb(_np_tree(jx_idefics2.init_idefics2_params(jax.random.PRNGKey(0), jcfg)),
                       np.random.default_rng(100))
    return jcfg, jax.tree.map(jnp.asarray, tree), pcfg, 2, (ids, mask, pixels, valid), icv


def _flamingo_case():
    rng = np.random.default_rng(6)
    ids, mask, pixels, valid = T3.tiny_inputs(rng)
    icv = (rng.normal(size=(4, 64)) * 0.5).astype(np.float32)
    jcfg, jparams, pcfg, _ = T3.tiny_pair()
    return jcfg, jparams, pcfg, 2, (ids, mask, pixels, valid), icv


FAMILY = {"idefics": (jx_idefics.make_idefics_forward_fns, T1),
          "idefics2": (jx_idefics2.make_idefics2_forward_fns, T2),
          "openflamingo": (jx_flamingo.make_openflamingo_forward_fns, T3)}


def _family(name: str) -> str:
    return "idefics2" if name.startswith("idefics2") else (
        "openflamingo" if name.startswith("openflamingo") else "idefics")


def _jax_run(name, jcfg, jparams, tp, inputs, icv):
    """JAX's prefill logits and decodes with its params tp-sharded by
    ``param_specs`` on ``tp`` of the virtual devices.  ``device_put`` takes
    no uneven shard: the tiny int4 leaves' single group of scales stays
    replicated on JAX's side (the port re-packs it per rank)."""
    make, mod = FAMILY[_family(name)]
    mesh = Mesh(np.asarray(jax.devices()[:tp]).reshape(1, tp, 1), ("dp", "tp", "sp"))

    def layout(spec, x):
        even = all(ax is None or x.shape[i] % tp == 0 for i, ax in enumerate(spec))
        return NamedSharding(mesh, spec if even else P())

    specs = jx_param_specs(jparams)
    sharded = jax.device_put(jparams, jax.tree.map(
        layout, specs, jparams, is_leaf=lambda x: isinstance(x, P)))
    ids, mask, pixels, valid = (jnp.asarray(x) for x in inputs)
    bind = make(jcfg, mod.EOS)[1]
    max_len = ids.shape[1] + MAX_NEW + 1
    jicv = jnp.asarray(icv)
    fwd = bind(sharded, pixels, valid, ids, jicv, max_len)
    first = []

    def recording(*args):  # the greedy decode's first call is the prefill
        res = fwd(*args)
        if not first:
            first.append(np.asarray(res[0]))
        return res

    kw = dict(max_new_tokens=MAX_NEW, eos_token_id=mod.EOS, pad_token_id=0)
    out = {"greedy": np.asarray(jx_greedy(recording, ids, mask, **kw))}
    out["logits"] = first[0]
    if name in BEAM_CASES:
        out["beam"] = np.asarray(jx_beam(bind(sharded, pixels, valid, ids, jicv, max_len), ids,
                                         mask, num_beams=3, length_penalty=0.0, **kw))
    return out


def _w8a8_inputs():
    """Rows whose absmax lies in the other rank's columns at tp = 2, and an
    int8 leaf (JAX's quantization)."""
    from licv_vqa_tpu.ops.quantize import quantize_array

    rng = np.random.default_rng(9)
    m, k, n = 24, 64, 40
    x = rng.normal(size=(m, k)).astype(np.float32)
    x[: m // 2, k // 2:] *= 8.0  # absmax in rank 1's columns
    x[m // 2:, : k // 2] *= 8.0  # absmax in rank 0's columns
    return x, _np_tree(quantize_array(jnp.asarray(rng.normal(size=(k, n)).astype(np.float32))))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{case: (jax outputs, [port outputs of each rank])}`` and the w8a8
    ranks' outputs: two ranks run the tp = 2 cases and the w8a8 product
    while JAX runs every case here, then four ranks the tp = 4 case."""
    cases = dict(_idefics_cases())
    cases["idefics2"] = _idefics2_case()
    cases["openflamingo"] = _flamingo_case()
    port_cases = {
        name: {"family": _family(name), "cfg": pcfg, "params": _np_tree(jparams), "tp": tp,
               "inputs": inputs, "icv": icv, "eos": FAMILY[_family(name)][1].EOS,
               "max_new": MAX_NEW, "beam": name in BEAM_CASES}
        for name, (_, jparams, pcfg, tp, inputs, icv) in cases.items()
    }
    by_world = {w: {n: c for n, c in port_cases.items() if c["tp"] == w} for w in (2, 4)}
    tmp = tmp_path_factory.mktemp("tp")
    two = Ranks(tp_suite, 2, tmp, by_world[2], _w8a8_inputs())
    jax_out = {name: _jax_run(name, jcfg, jparams, tp if name in JAX_SHARDED else 1, inputs,
                              icv)
               for name, (jcfg, jparams, _, tp, inputs, icv) in cases.items()}
    ranks = two.wait()
    four = Ranks(tp_suite, 4, tmp, by_world[4]).wait()
    out = {name: (jax_out[name], [r["cases"][name] for r in ranks]) for name in by_world[2]}
    out.update({name: (jax_out[name], [r["cases"][name] for r in four]) for name in by_world[4]})
    out["w8a8"] = [r["w8a8"] for r in ranks]
    return out


CASES = ["idefics", "idefics_int8_all", "idefics_int4", "idefics_tp4", "idefics2", "openflamingo"]
# beam-3 on every family and both quantized modes; the tp = 4 case greedy
BEAM_CASES = ["idefics", "idefics_int8_all", "idefics_int4", "idefics2", "openflamingo"]
JAX_SHARDED = ["idefics"]


@pytest.mark.parametrize("name", CASES)
def test_tp_prefill_logits_match_jax(runs, name):
    want, ranks = runs[name]
    for got in ranks:  # every rank holds the gathered logits
        assert got["logits"].shape == want["logits"].shape
        np.testing.assert_allclose(got["logits"], want["logits"], atol=ATOL, rtol=0)


@pytest.mark.parametrize("name,kind", [(n, "greedy") for n in CASES]
                         + [(n, "beam") for n in BEAM_CASES])
def test_tp_decodes_token_exact(runs, name, kind):
    want, ranks = runs[name]
    for got in ranks:
        np.testing.assert_array_equal(got[kind], want[kind])


def test_w8a8_row_split_takes_the_whole_rows_absmax(runs):
    """``qdot_row`` under w8a8 at tp = 2, with rows whose absmax lies in the
    other rank's columns, equals JAX's w8a8 ``qdot`` on the whole rows; the
    same product quantized with each rank's local absmax does not."""
    from licv_vqa_tpu.ops.int8_matmul import qdot as jx_qdot

    x, leaf = _w8a8_inputs()
    k = x.shape[1]
    want = np.asarray(jax.jit(lambda a, w: jx_qdot(a, w, a8=True))(
        jnp.asarray(x), jax.tree.map(jnp.asarray, leaf)), np.float32)
    for r in runs["w8a8"]:
        assert r["k_local"] == k // 2
        np.testing.assert_allclose(r["got"], want, atol=1e-4 * np.abs(want).max(), rtol=0)
        assert np.abs(r["local_absmax"] - want).max() > 1e-3 * np.abs(want).max()
