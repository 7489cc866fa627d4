"""Port vs JAX: quantized OpenFlamingo on tiny-flamingo (CPU, f32).

The params are ``tests/test_torch_openflamingo.tiny_pair``'s numpy tree
(JAX's init, its constant leaves perturbed so the gates are open),
quantized by JAX's registry step and carried across with
``params_from_jax``; the same numpy inputs go through both packages.
Tolerances:
- the int8 KV cache's attention under an ALiBi bias against JAX's
  ``_cached_attention``, at a host index and at a per-row index: 1e-5;
- the registry's quantization of the flamingo tree (decoder and
  cross-attention stacks, tower, perceiver blocks): bit-equal, the
  cross-attention norm dicts left alone (JAX ``tests/test_quantize.py:42``);
- prefill and cached-step logits, int8 with the int8 KV cache and w8a8
  and int4, through ``bind_images``: 1e-4; greedy and beam-3 decodes
  token-exact;
- the w8a8 forward of JAX ``tests/test_openflamingo.py:612``: 1e-4 of
  JAX's, engaged against the weight-only forward, and bit-identical to it
  below the token gate.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from licv_vqa_tpu.infer.decode import beam_generate as jx_beam
from licv_vqa_tpu.infer.decode import greedy_generate as jx_greedy
from licv_vqa_tpu.models import openflamingo as jx
from licv_vqa_tpu.models import registry as jx_registry
from licv_vqa_tpu.models.decoder import _cached_attention as jx_cached_attention
from licv_vqa_tpu.ops import quantize as JQ
from licv_vqa_tpu_torch.infer.decode import beam_generate as pt_beam
from licv_vqa_tpu_torch.infer.decode import greedy_generate as pt_greedy
from licv_vqa_tpu_torch.models import decoder as PD
from licv_vqa_tpu_torch.models import openflamingo as pt
from licv_vqa_tpu_torch.models import registry as pt_registry
from licv_vqa_tpu_torch.models.decoder import W8A8_MIN_TOKENS
from licv_vqa_tpu_torch.models.idefics import image_attention_onehot
from licv_vqa_tpu_torch.models.weights import params_from_jax
from licv_vqa_tpu_torch.ops import quantize as PQ
from tests.test_torch_openflamingo import EOS, IMG, PAD, _jax_tree, icv_pair
from tests.test_torch_quantize import _assert_tree_equal

ATOL = 1e-4


def t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------------
# the int8 KV cache's attention under ALiBi
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("per_row", [False, True], ids=["host_index", "per_row_index"])
def test_int8_cache_attention_with_alibi_bias_matches_jax(per_row, s):
    """``decoder._int8_cached_attention`` with a (B, H, s, S) bias against
    JAX's split softmax: the bias on the cache part's columns as it is and
    on the local part sliced at the host index, or gathered at each row's
    own columns.  Row 1 of the per-row case sits two columns further on."""
    b, h, dh, S = 2, 4, 16, 12
    index = np.asarray([5, 7]) if per_row else np.asarray([5, 5])
    rng = np.random.default_rng(21)
    q = rng.normal(size=(b, s, h, dh)).astype(np.float32)
    kq, ks, vq, vs = (np.array(a) for _ in "kv" for a in JQ.quantize_kv_rows(
        jnp.asarray(rng.normal(size=(b, S, h, dh)), jnp.float32)))
    k_loc, v_loc = (rng.normal(size=(b, s, h, dh)).astype(np.float32) for _ in "kv")
    bias = rng.normal(size=(b, h, s, S)).astype(np.float32)
    mask = np.zeros((b, 1, s, S), bool)
    for i in range(b):
        for qi in range(s):
            mask[i, 0, qi, i : index[i]] = True  # earlier rows, some left padding
            mask[i, 0, qi, index[i] : index[i] + qi + 1] = True  # causal local block
    jlocal = [JQ.dequantize_kv(*JQ.quantize_kv_rows(jnp.asarray(a)), jnp.float32)
              for a in (k_loc, v_loc)]
    jindex = jnp.asarray(index if per_row else index[0], jnp.int32)
    want = jx_cached_attention(
        jnp.asarray(q), {"q": jnp.asarray(kq), "s": jnp.asarray(ks)},
        {"q": jnp.asarray(vq), "s": jnp.asarray(vs)}, *jlocal, jnp.asarray(mask),
        jnp.asarray(bias), jindex,
    )
    plocal = [PQ.dequantize_kv(*PQ.quantize_kv_rows(t(a)), torch.float32) for a in (k_loc, v_loc)]
    pindex = t(index).long() if per_row else int(index[0])
    got = PD._int8_cached_attention(
        t(q), {"q": t(kq), "s": t(ks)}, {"q": t(vq), "s": t(vs)}, *plocal, t(mask), pindex,
        None, t(bias),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    unbiased = PD._int8_cached_attention(
        t(q), {"q": t(kq), "s": t(ks)}, {"q": t(vq), "s": t(vs)}, *plocal, t(mask), pindex)
    assert np.abs(unbiased.numpy() - np.asarray(want)).max() > 1e-2  # the bias counts


# ---------------------------------------------------------------------------
# the registry's quantization of the flamingo tree
# ---------------------------------------------------------------------------


def test_quantize_layer_stack_skips_xattn_layernorm_dicts():
    """The gated cross-attention's norms are ``{"w", "b"}`` dicts: the bare
    ``w`` key is not a projection (JAX ``tests/test_quantize.py:42``)."""
    cfg = pt.OpenFlamingoConfig.tiny()
    xp = pt.init_flamingo_xattn_params(torch.Generator().manual_seed(0), cfg, 2, "cpu")
    for mode in ("int8", "int4"):
        q = PQ.quantize_layer_stack(xp, mode=mode)
        for norm in ("ln_attn", "ln_ff"):
            assert not PQ.is_any_quantized_leaf(q[norm]["w"])
            assert q[norm]["w"] is xp[norm]["w"] and q[norm]["b"] is xp[norm]["b"]
        for key in ("wq", "wkv", "wo", "ff_up", "ff_down"):
            assert PQ.is_any_quantized_leaf(q[key]), (mode, key)
        assert q["attn_gate"] is xp["attn_gate"] and q["ff_gate"] is xp["ff_gate"]


def _lmm(**opts):
    return SimpleNamespace(lmm=SimpleNamespace(get=lambda k, d=None: opts.get(k, d)))


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_maybe_quantize_equals_jax_on_tiny_flamingo(mode):
    """The registry step on the flamingo tree, the head and vision options
    on: the same leaves quantized bit for bit (the tied head stays the
    embedding table, with a warning)."""
    jcfg, tree = _jax_tree(0)
    ns = _lmm(quantize=mode, quantize_head=True, quantize_vision=True)
    jb = SimpleNamespace(params=jax.tree.map(np.array, tree), model_cfg=jcfg)
    pb = SimpleNamespace(params=params_from_jax(tree), model_cfg=pt.OpenFlamingoConfig.tiny())
    want = jax.tree.map(np.asarray, jx_registry._maybe_quantize(ns, jb).params)
    got = pt_registry._maybe_quantize(ns, pb).params
    _assert_tree_equal(want, got)
    assert PQ.is_any_quantized_leaf(got["xattn"]["wkv"])
    assert PQ.is_quantized_leaf(got["perceiver"]["blocks"]["wq"])
    assert not PQ.is_any_quantized_leaf(got["embed"]) and "lm_head" not in got


# ---------------------------------------------------------------------------
# quantized tiny-flamingo against JAX
# ---------------------------------------------------------------------------

# (quantize mode, kv8, w8a8): JAX's composition with the int8 KV cache
# under ALiBi, and int4
CONFIGS = {"int8_kv8_w8a8": ("int8", True, True), "int4": ("int4", False, False)}


def quantized_pair(name):
    """(jax cfg, jax params, port cfg, port params) of tiny-flamingo under
    ``CONFIGS[name]``: the tower and perceiver int8 too."""
    mode, kv8, a8 = CONFIGS[name]
    jcfg, tree = _jax_tree(0)
    ns = _lmm(quantize=mode, quantize_vision=True)
    jq = jax.tree.map(np.asarray, jx_registry._maybe_quantize(
        ns, SimpleNamespace(params=jax.tree.map(np.array, tree), model_cfg=jcfg)).params)
    kw = dict(kv_cache_dtype="int8" if kv8 else "bf16", w8a8_prefill=a8)
    pcfg = pt.OpenFlamingoConfig.tiny(dtype=torch.float32)
    jcfg = dataclasses.replace(jcfg, text=dataclasses.replace(jcfg.text, **kw))
    pcfg = dataclasses.replace(pcfg, text=dataclasses.replace(pcfg.text, **kw))
    return jcfg, jax.tree.map(jnp.asarray, jq), pcfg, params_from_jax(jq)


def many_image_inputs(rng, bs=2, s=24, n_img=4):
    """Left-padded prompts with ``n_img`` ``<image>`` tokens each: 16 media
    latents a row, so the media K/V projection passes the w8a8 token gate;
    row 1's last image slot padded."""
    ids = rng.integers(3, 120, size=(bs, s)).astype(np.int32)
    mask = np.ones((bs, s), np.int32)
    mask[1, :3], ids[1, :3] = 0, PAD
    for j in range(n_img):
        ids[:, 4 + 4 * j] = IMG
    pixels = rng.normal(size=(bs, n_img, 28, 28, 3)).astype(np.float32)
    valid = np.ones((bs, n_img), bool)
    valid[1, -1] = False
    return ids, mask, pixels, valid


def _bind_both(name, ids, pixels, valid, jicv, picv, max_len):
    jcfg, jparams, pcfg, pparams = quantized_pair(name)
    jf = jx.make_openflamingo_forward_fns(jcfg, EOS)[1](
        jparams, jnp.asarray(pixels), jnp.asarray(valid), jnp.asarray(ids), jicv, max_len)
    pf = pt.make_openflamingo_forward_fns(pcfg, EOS)[1](
        pparams, t(pixels), t(valid), t(ids), picv, max_len)
    return jf, pf


@pytest.mark.parametrize("name", list(CONFIGS))
def test_quantized_prefill_and_cached_steps_match_jax(name):
    rng = np.random.default_rng(12)
    ids, mask, pixels, valid = many_image_inputs(rng)
    jicv, picv = icv_pair(rng)
    jf, pf = _bind_both(name, ids, pixels, valid, jicv, picv, ids.shape[1] + 3)
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
    with torch.inference_mode():
        jl, jc = jf(jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(pos), None)
        pl, pc = pf(t(ids), t(mask), t(pos), None)
        assert isinstance(pc["k"], dict) == (name == "int8_kv8_w8a8")
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
        nxt = pos[:, -1:] + 1
        for _ in range(2):
            tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
            one = np.ones_like(tok)
            jl, jc = jf(jnp.asarray(tok), jnp.asarray(one), jnp.asarray(nxt), jc)
            pl, pc = pf(t(tok), t(one), t(nxt), pc)
            np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
            nxt = nxt + 1


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("kind", ["greedy", "beam"])
def test_quantized_decodes_token_exact(name, kind):
    rng = np.random.default_rng(13)
    ids, mask, pixels, valid = many_image_inputs(rng)
    jicv, picv = icv_pair(rng)
    max_new = 5
    jf, pf = _bind_both(name, ids, pixels, valid, jicv, picv, ids.shape[1] + max_new + 1)
    kw = dict(max_new_tokens=max_new, eos_token_id=EOS, pad_token_id=PAD)
    if kind == "beam":
        kw.update(num_beams=3, length_penalty=0.0)
    jgen, pgen = (jx_beam, pt_beam) if kind == "beam" else (jx_greedy, pt_greedy)
    want = jgen(jf, jnp.asarray(ids), jnp.asarray(mask), **kw)
    with torch.inference_mode():
        got = pgen(pf, t(ids), t(mask), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_w8a8_prefill_matches_jax_and_below_the_gate_is_bit_identical(monkeypatch):
    """JAX ``tests/test_openflamingo.py:612``'s setting: int8 decoder,
    cross-attention, tower and perceiver, the w8a8 forward of 20 tokens
    (the media K/V weight-only at 4 latents) against JAX's, engaged (it
    differs from the weight-only forward) and, 14 tokens long, below the
    gate, bit-identical to it.

    Against JAX: within 1e-4 at every position before the first activation
    row whose int8 rounding sits on an exact tie (some element's x / scale
    is k + 1/2: XLA's fused row quantization computes that quotient an ulp
    apart from a division, so the two round it to neighbouring steps);
    from there on in its sequence, within the JAX test's own w8a8 fidelity
    bound (5% of max|logits|)."""
    from licv_vqa_tpu_torch.ops import int8_matmul as PI8

    jcfg, jparams, pcfg, pparams = quantized_pair("int8_kv8_w8a8")
    off = dataclasses.replace(pcfg, text=dataclasses.replace(pcfg.text, w8a8_prefill=False))
    rng = np.random.default_rng(9)
    b, s = 2, W8A8_MIN_TOKENS + 4
    ids = rng.integers(3, 120, size=(b, s)).astype(np.int32)
    ids[:, 1] = IMG
    mask = np.ones_like(ids)
    pixels = rng.normal(size=(b, 1, 28, 28, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, i, m, px: jx.openflamingo_forward(
        jcfg, p, i, m, jx.encode_media(jcfg, p, px),
        jx.image_attention_onehot(i, IMG, EOS, 1))[0])(
        jparams, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(pixels)))

    ties = set()  # (row, position) of the text block's activation rows on a tie
    quantize = PI8.quantize_act_rows

    def spied(x):
        xq, xs = quantize(x)
        if x.shape[0] == b * s:
            r = x.float() / xs
            for row in torch.nonzero(((r - torch.floor(r)) == 0.5).any(-1)).flatten():
                ties.add(divmod(int(row), s))
        return xq, xs

    monkeypatch.setattr(PI8, "quantize_act_rows", spied)

    def forward(cfg, n):
        with torch.inference_mode():
            lat = pt.encode_media(cfg, pparams, t(pixels))
            onehot = image_attention_onehot(t(ids[:, :n]), IMG, EOS, 1)
            return pt.openflamingo_forward(cfg, pparams, t(ids[:, :n]), t(mask[:, :n]), lat,
                                           onehot)[0]

    a8 = forward(pcfg, s).numpy()
    err = np.abs(a8 - want).max(-1)  # (B, S)
    for row in range(b):
        first = min([pos for r, pos in ties if r == row], default=s)
        np.testing.assert_allclose(a8[row, :first], want[row, :first], atol=ATOL, rtol=0)
    assert err.max() < 0.05 * np.abs(want).max(), (err.max(), sorted(ties))
    assert np.abs(a8 - forward(off, s).numpy()).max() > 1e-4  # w8a8 engaged
    short = W8A8_MIN_TOKENS - 2
    torch.testing.assert_close(forward(pcfg, short), forward(off, short), rtol=0, atol=0)
