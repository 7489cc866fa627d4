"""Port vs JAX: self-speculative greedy decoding on tiny-idefics (CPU, f32).

The draft is the model's first two layers and one cross-attention group
(``build_draft_decode`` on each side), the target the whole model, both on
one numpy param tree carried across from JAX's init.  The port's tokens
must equal its own ``greedy_generate``'s (held to JAX's in
``tests/test_torch_decode.py``) in every case, per row and in lockstep, at
bs 1 and 3, γ 2 and 4, and JAX's ``speculative_greedy_generate``'s where
it runs (a few cases: each call compiles its loop).  Also: the cache sized exactly as the runner sizes it
(prompt + max_new + γ + 1) over a long decode, rows that finish on EOS
mid-block, the runner's fallbacks for beam search and ``min_new_tokens``,
subset-layer intervention through the registry, int8 weights, the other
two families' drafts, and the per-row ``decode_cache_view`` against
JAX's.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from licv_vqa_tpu.infer.speculative import speculative_greedy_generate as jx_spec
from licv_vqa_tpu.models import decoder as jx_decoder
from licv_vqa_tpu.models import idefics as jx_idefics
from licv_vqa_tpu.models.registry import build_draft_decode as jx_draft
from licv_vqa_tpu_torch.infer.decode import greedy_generate as pt_greedy
from licv_vqa_tpu_torch.infer.speculative import speculative_greedy_generate as pt_spec
from licv_vqa_tpu_torch.models import decoder as pt_decoder
from licv_vqa_tpu_torch.models import idefics as pt_idefics
from licv_vqa_tpu_torch.models.registry import build_draft_decode as pt_draft
from tests.test_torch_idefics import EOS, icv_pair, tiny_inputs, tiny_pair

PAD = 0
DRAFT = 2


def _inputs(bs: int, seed: int):
    rng = np.random.default_rng(seed)
    ids, mask, pixels, valid = tiny_inputs(rng, bs=max(bs, 2))
    jicv, picv = icv_pair(rng)
    return ids[:bs], mask[:bs], pixels[:bs], valid[:bs], jicv, picv


def _binds(ids, pixels, valid, jicv, picv, max_len, eos=EOS, with_jax=True):
    """(port target, port draft, jax target, jax draft) forwards."""
    jcfg, jparams, pcfg, pparams = tiny_pair()
    pb = SimpleNamespace(name="tiny-idefics", model_cfg=pcfg, params=pparams, eos_token_id=eos)
    dparams, dbind = pt_draft(pb, DRAFT)
    px, pv, pid = torch.from_numpy(pixels), torch.from_numpy(valid), torch.from_numpy(ids)
    pf = pt_idefics.make_idefics_forward_fns(pcfg, eos)[1](pparams, px, pv, pid, picv, max_len)
    pdf = dbind(dparams, px, pv, pid, picv[:DRAFT], max_len)
    if not with_jax:
        return pf, pdf, None, None
    jb = SimpleNamespace(name="tiny-idefics", model_cfg=jcfg, params=jparams, eos_token_id=eos)
    jdparams, jdbind = jx_draft(jb, DRAFT)
    jx = (jnp.asarray(pixels), jnp.asarray(valid), jnp.asarray(ids))
    jf = jx_idefics.make_idefics_forward_fns(jcfg, eos)[1](jparams, *jx, jicv, max_len)
    jdf = jdbind(jdparams, *jx, jicv[:DRAFT], max_len)
    return pf, pdf, jf, jdf


@pytest.mark.parametrize("lockstep", [False, True], ids=["per_row", "lockstep"])
@pytest.mark.parametrize("bs,gamma,with_jax", [
    (1, 4, False), (3, 4, True), (1, 2, False), (3, 2, False),
])
def test_speculative_equals_greedy_and_jax(bs, gamma, with_jax, lockstep):
    max_new = 6
    ids, mask, pixels, valid, jicv, picv = _inputs(bs, seed=10 * bs + gamma)
    pf, pdf, jf, jdf = _binds(ids, pixels, valid, jicv, picv,
                              ids.shape[1] + max_new + gamma + 1, with_jax=with_jax)
    kw = dict(max_new_tokens=max_new, eos_token_id=EOS, pad_token_id=PAD)
    pid, pmask = torch.from_numpy(ids), torch.from_numpy(mask)
    greedy = pt_greedy(pf, pid, pmask, **kw).numpy()
    got = pt_spec(pf, pdf, pid, pmask, gamma=gamma, lockstep=lockstep, **kw).numpy()
    np.testing.assert_array_equal(got, greedy)
    if with_jax:
        want = jx_spec(jf, jdf, jnp.asarray(ids), jnp.asarray(mask), gamma=gamma,
                       lockstep=lockstep, **kw)
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("lockstep", [False, True], ids=["per_row", "lockstep"])
def test_speculative_tight_cache_equals_greedy(lockstep):
    """The cache sized exactly as the runner sizes it, prompt + max_new + γ
    + 1, over a decode long enough that the last rounds' verify writes
    reach the margin: every write lands inside, and the tokens equal
    greedy's."""
    gamma, max_new = 4, 12
    ids, mask, pixels, valid, jicv, picv = _inputs(3, seed=5)
    pf, pdf, _, _ = _binds(ids, pixels, valid, jicv, picv, ids.shape[1] + max_new + gamma + 1,
                           with_jax=False)
    kw = dict(max_new_tokens=max_new, eos_token_id=EOS, pad_token_id=PAD)
    pid, pmask = torch.from_numpy(ids), torch.from_numpy(mask)
    want = pt_greedy(pf, pid, pmask, **kw).numpy()
    got = pt_spec(pf, pdf, pid, pmask, gamma=gamma, lockstep=lockstep, **kw).numpy()
    np.testing.assert_array_equal(got, want)


def test_speculative_rows_finish_on_eos_mid_block():
    """EOS := the token greedy emits second on row 0, so that row finishes
    inside a verify block while the others go on; the pad tail matches."""
    gamma, max_new = 4, 8
    ids, mask, pixels, valid, jicv, picv = _inputs(3, seed=7)
    pid, pmask = torch.from_numpy(ids), torch.from_numpy(mask)
    max_len = ids.shape[1] + max_new + gamma + 1
    pf, _, _, _ = _binds(ids, pixels, valid, jicv, picv, max_len, with_jax=False)
    first = pt_greedy(pf, pid, pmask, max_new_tokens=max_new, eos_token_id=EOS,
                      pad_token_id=PAD).numpy()
    eos = int(first[0, ids.shape[1] + 1])
    pf, pdf, _, _ = _binds(ids, pixels, valid, jicv, picv, max_len, eos=eos, with_jax=False)
    kw = dict(max_new_tokens=max_new, eos_token_id=eos, pad_token_id=PAD)
    want = pt_greedy(pf, pid, pmask, **kw).numpy()
    assert (want[0, ids.shape[1] + 2:] == PAD).all()
    for lockstep in (False, True):
        got = pt_spec(pf, pdf, pid, pmask, gamma=gamma, lockstep=lockstep, **kw).numpy()
        np.testing.assert_array_equal(got, want)


def test_runner_falls_back_for_beams_and_min_new_tokens(monkeypatch):
    """``min_new_tokens > 0`` or ``num_beams > 1`` with a draft asked for
    take the plain decode with JAX's warning, and never build the draft (a
    stub bundle that ``build_draft_decode`` rejects survives); with neither
    the draft is built (and the stub rejected)."""
    from licv_vqa_tpu_torch.infer import runner
    from licv_vqa_tpu_torch.infer.runner import make_generate_fn

    said = []
    monkeypatch.setattr(runner.logger, "warning", lambda msg, *a: said.append(msg % a))
    stub = SimpleNamespace(name="stub", eos_token_id=2, pad_token_id=0, bind_decode=None,
                           intervention_layers=None, model_cfg=SimpleNamespace(text=None))
    make_generate_fn(stub, {"speculative_draft_layers": 2, "min_new_tokens": 1})
    make_generate_fn(stub, {"speculative_draft_layers": 2, "num_beams": 3})
    text = " ".join(said)
    assert "does not implement min_new_tokens" in text and "falling back to plain beam" in text
    with pytest.raises(Exception):
        make_generate_fn(stub, {"speculative_draft_layers": 2})


def _tiny_bundle(extra: list):
    from licv_vqa_tpu_torch.models.registry import build_model
    from licv_vqa_tpu_torch.utils import compose
    from tests.test_cli_e2e import REPO

    cfg = compose(str(REPO / "config"), "inference", ["lmm=tiny-idefics", *extra])
    return build_model(cfg, device="cpu")


@pytest.mark.parametrize("extra,icv_rows", [
    (["lmm.intervention_layer=[1,3]"], 2),
    (["lmm.quantize=int8"], 4),
], ids=["subset_layers", "int8"])
def test_runner_speculative_equals_greedy(extra, icv_rows):
    """Through ``make_generate_fn``: subset-layer intervention (the draft's
    ICV expanded to per-layer rows, then cut to its depth: layer 1 on,
    layer 0 off) and int8 weights (the draft slices the quantized leaves,
    views of the target's)."""
    from licv_vqa_tpu_torch.infer.runner import _draft_icv, make_generate_fn
    from licv_vqa_tpu_torch.models.registry import build_draft_decode

    bundle = _tiny_bundle(extra)
    rng = np.random.default_rng(11)
    ids, mask, pixels, valid = tiny_inputs(rng, bs=3)
    icv = torch.from_numpy((rng.normal(size=(icv_rows, 64)) * 0.5).astype(np.float32))
    args = (bundle.params, *(torch.from_numpy(x) for x in (ids, mask, pixels, valid)), icv)
    greedy = make_generate_fn(bundle, {"max_new_tokens": 6})(*args)
    spec = make_generate_fn(bundle, {"max_new_tokens": 6, "speculative_draft_layers": 2,
                                     "speculative_gamma": 3})(*args)
    np.testing.assert_array_equal(spec.numpy(), greedy.numpy())
    draft_params, _ = build_draft_decode(bundle, 2)
    for name in ("layers", "xattn"):
        for leaf, full in zip(_leaves(draft_params[name]), _leaves(bundle.params[name])):
            assert leaf.data_ptr() == full.data_ptr() and leaf.shape[1:] == full.shape[1:]
    if bundle.intervention_layers is not None:
        rows, flags = _draft_icv(bundle, icv, 2)
        assert flags == [False, True] and torch.equal(rows[1], icv[0])
        assert not rows[0].any()
    else:
        assert draft_params["layers"]["attn"]["wq"]["q"].dtype == torch.int8


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_build_draft_decode_rejects_depths_off_the_cross_attention_grid():
    bundle = _tiny_bundle([])
    from licv_vqa_tpu_torch.models.registry import build_draft_decode

    with pytest.raises(ValueError, match="multiple of cross_layer_interval"):
        build_draft_decode(bundle, 3)


@pytest.mark.parametrize("family", ["idefics2", "flamingo"])
def test_other_families_speculative_equals_greedy_and_jax(family):
    """One JAX speculative call a family: tiny-idefics2 (no cross-attention
    groups) and tiny-flamingo (groups of ``cross_attn_every_n_layers``,
    ALiBi over the per-row cache columns)."""
    if family == "idefics2":
        from licv_vqa_tpu.models import idefics2 as jm
        from licv_vqa_tpu_torch.models import idefics2 as pm
        from tests import test_torch_idefics2 as t

        rng = np.random.default_rng(12)
        ids, mask, pixels, valid, _ = t.tiny_inputs(rng)
        make_j, make_p, name = jm.make_idefics2_forward_fns, pm.make_idefics2_forward_fns, \
            "tiny-idefics2"
    else:
        from licv_vqa_tpu.models import openflamingo as jm
        from licv_vqa_tpu_torch.models import openflamingo as pm
        from tests import test_torch_openflamingo as t

        rng = np.random.default_rng(13)
        ids, mask, pixels, valid = t.tiny_inputs(rng)
        make_j, make_p, name = (jm.make_openflamingo_forward_fns,
                                pm.make_openflamingo_forward_fns, "tiny-flamingo")
    jicv, picv = t.icv_pair(rng)
    jcfg, jparams, pcfg, pparams = t.tiny_pair()
    gamma, max_new = 3, 6
    max_len = ids.shape[1] + max_new + gamma + 1
    jx_in = (jnp.asarray(pixels), jnp.asarray(valid), jnp.asarray(ids))
    pt_in = (torch.from_numpy(pixels), torch.from_numpy(valid), torch.from_numpy(ids))
    jf = make_j(jcfg, t.EOS)[1](jparams, *jx_in, jicv, max_len)
    pf = make_p(pcfg, t.EOS)[1](pparams, *pt_in, picv, max_len)
    jdp, jdb = jx_draft(SimpleNamespace(name=name, model_cfg=jcfg, params=jparams,
                                        eos_token_id=t.EOS), DRAFT)
    pdp, pdb = pt_draft(SimpleNamespace(name=name, model_cfg=pcfg, params=pparams,
                                        eos_token_id=t.EOS), DRAFT)
    jdf = jdb(jdp, *jx_in, jicv[:DRAFT], max_len)
    pdf = pdb(pdp, *pt_in, picv[:DRAFT], max_len)
    kw = dict(max_new_tokens=max_new, eos_token_id=t.EOS, pad_token_id=t.PAD, gamma=gamma)
    pid, pmask = torch.from_numpy(ids), torch.from_numpy(mask)
    got = pt_spec(pf, pdf, pid, pmask, **kw).numpy()
    kw.pop("gamma")
    np.testing.assert_array_equal(got, pt_greedy(pf, pid, pmask, **kw).numpy())
    want = jx_spec(jf, jdf, jnp.asarray(ids), jnp.asarray(mask), gamma=gamma, **kw)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_per_row_cache_view_and_writes_match_jax(kv):
    """``decode_cache_view`` and ``apply_kv_rows`` with a (B,) index (rows
    at columns 3, 6 and 4) against JAX's vector-index branch: the mask,
    positions and validity, and the written K/V leaves."""
    from licv_vqa_tpu.models.config import DecoderConfig as JCfg
    from licv_vqa_tpu_torch.models.config import DecoderConfig as PCfg

    b, s, max_len = 3, 2, 10
    kw = dict(vocab_size=16, d_model=8, n_layers=1, n_heads=2, n_kv_heads=2, d_ff=16,
              kv_cache_dtype=kv)
    jc = jx_decoder.init_kv_cache(JCfg(dtype=jnp.float32, **kw), b, max_len)
    pc = pt_decoder.init_kv_cache(PCfg(dtype=torch.float32, **kw), b, max_len, "cpu")
    rng = np.random.default_rng(14)
    pos0 = rng.integers(0, 5, size=(b, max_len)).astype(np.int32)
    valid0 = rng.random((b, max_len)) > 0.3
    jc = dict(jc, pos=jnp.asarray(pos0), valid=jnp.asarray(valid0),
              index=jnp.asarray([3, 6, 4], jnp.int32))
    pc["pos"][:] = torch.from_numpy(pos0)
    pc["valid"][:] = torch.from_numpy(valid0)
    pc["index"] = torch.tensor([3, 6, 4])
    positions = rng.integers(2, 9, size=(b, s)).astype(np.int32)
    amask = np.array([[1, 1], [0, 1], [1, 0]], np.int32)
    jm, jpos, jvalid = jx_decoder.decode_cache_view(jc, jnp.asarray(positions),
                                                    jnp.asarray(amask), s)
    pm, ppos, pvalid = pt_decoder.decode_cache_view(pc, torch.from_numpy(positions),
                                                    torch.from_numpy(amask), s)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ppos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(pvalid.numpy(), np.asarray(jvalid))

    k = rng.normal(size=(1, b, s, 2, 4)).astype(np.float32)
    v = rng.normal(size=(1, b, s, 2, 4)).astype(np.float32)
    if kv == "int8":
        rows = [{"q": rng.integers(-127, 128, size=x.shape).astype(np.int8),
                 "s": np.abs(x[..., :1])} for x in (k, v)]
        j_rows = [{n: jnp.asarray(r[n]) for n in r} for r in rows]
        p_rows = [{n: torch.from_numpy(r[n][0]) for n in r} for r in rows]
    else:
        j_rows = [jnp.asarray(x) for x in (k, v)]
        p_rows = [torch.from_numpy(x[0]) for x in (k, v)]
    jout = jx_decoder.apply_kv_rows(jc, *j_rows)
    pt_decoder.apply_kv_rows(pt_decoder.L.layer_slice(pc["k"], 0),
                             pt_decoder.L.layer_slice(pc["v"], 0), *p_rows, pc["index"])
    for name in ("k", "v"):
        got, want = pc[name], jout[name]
        for leaf in (("q", "s") if kv == "int8" else (None,)):
            g = got if leaf is None else got[leaf]
            w = want if leaf is None else want[leaf]
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
