"""Port vs JAX: weight quantization, ``qdot`` and the quantized tiny-idefics
(CPU, f32).

The same numpy inputs go through the JAX package and the port.  Tolerances:
- quantized planes, scales and int8 KV rows: bit-equal;
- the plain routes of ``qdot``: within 1e-5 (f32; summation order);
- the kernels' plain versions against the TPU kernels run in interpret
  mode, as ``tests/test_quantize.py`` runs them: within 2e-2 of max|ref|
  (the TPU kernels multiply in bf16);
- activation gradients through ``qdot`` against ``jax.grad``: 2e-2 of
  max|ref| (f32 on both sides, so they read about 1e-7);
- tiny-idefics logits, prefill and a cached step: within 1e-4 (f32);
  greedy and beam-3 decodes token-exact.
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
from licv_vqa_tpu.models import idefics as jx_idefics
from licv_vqa_tpu.models import registry as jx_registry
from licv_vqa_tpu.ops import int4_matmul as JI4
from licv_vqa_tpu.ops import int8_matmul as JI8
from licv_vqa_tpu.ops import quantize as JQ
from licv_vqa_tpu_torch.infer.decode import beam_generate as pt_beam
from licv_vqa_tpu_torch.infer.decode import greedy_generate as pt_greedy
from licv_vqa_tpu_torch.models import decoder as PD
from licv_vqa_tpu_torch.models import idefics as pt_idefics
from licv_vqa_tpu_torch.models import layers as PL
from licv_vqa_tpu_torch.models import registry as pt_registry
from licv_vqa_tpu_torch.models.weights import params_from_jax
from licv_vqa_tpu_torch.ops import int4_matmul as PI4
from licv_vqa_tpu_torch.ops import int8_matmul as PI8
from licv_vqa_tpu_torch.ops import quantize as PQ
from tests.test_torch_idefics import EOS, icv_pair, tiny_inputs, tiny_pair

ATOL = 1e-4
QDOT_ATOL = 1e-5
KERNEL_REL = 2e-2


def _assert_tree_equal(want, got, path=""):
    """A JAX tree (numpy leaves) and a port tree: same keys, leaves
    bit-equal with the same dtype (bf16 compared through f32, exact)."""
    if isinstance(want, dict):
        assert set(want) == set(got), path
        for k in want:
            _assert_tree_equal(want[k], got[k], f"{path}/{k}")
        return
    w = np.asarray(want)
    wname = "bfloat16" if w.dtype.name == "bfloat16" else w.dtype.name
    assert str(got.dtype).replace("torch.", "") == wname, (path, got.dtype, w.dtype)
    g = got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
    np.testing.assert_array_equal(g, w.astype(np.float32) if wname == "bfloat16" else w,
                                  err_msg=path)


# ---------------------------------------------------------------------------
# ops/quantize.py: bit-equal planes and scales
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(4, 256, 384), (512, 384), (88, 40)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_planes_and_scales_equal_jax(mode, dtype, shape):
    w = (np.random.default_rng(0).normal(size=shape) * 0.02).astype(np.float32)
    jw = jnp.asarray(w, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    pw = torch.from_numpy(w).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    if mode == "int8":
        want, got = JQ.quantize_array(jw), PQ.quantize_array(pw)
    else:
        want, got = JQ.quantize_array_int4(jw), PQ.quantize_array_int4(pw)
    _assert_tree_equal(jax.tree.map(np.asarray, want), got)
    if mode == "int4":  # and the dequantized weight
        np.testing.assert_array_equal(
            PQ.dequantize_int4(got, torch.float32).numpy(),
            np.asarray(JQ.dequantize_int4(want, jnp.float32)),
        )


def test_int4_group_fallback_and_odd_in_features():
    assert PQ._int4_group(4096) == JQ._int4_group(4096) == 64
    assert PQ._int4_group(88) == JQ._int4_group(88) == 88  # one group per column
    assert PQ._int4_group(96) == JQ._int4_group(96) == 32
    leaf = PQ.quantize_array_int4(torch.zeros((88, 40)))
    assert leaf["s"].shape == (1, 1, 40) and leaf["q4"].shape == (44, 40)
    with pytest.raises(ValueError, match="even"):
        PQ.quantize_array_int4(torch.zeros((87, 40)))


def test_quantize_kv_rows_equal_jax():
    x = np.random.default_rng(1).normal(size=(2, 7, 3, 16)).astype(np.float32)
    x[0, 0] = 0.0  # all-zero rows take the floor scale
    jq, js = JQ.quantize_kv_rows(jnp.asarray(x))
    pq, ps = PQ.quantize_kv_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        PQ.dequantize_kv(pq, ps, torch.float32).numpy(),
        np.asarray(JQ.dequantize_kv(jq, js, jnp.float32)),
    )


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_maybe_quantize_equals_jax_on_tiny_idefics(mode):
    """The registry step, head and vision rules included: the same leaves
    are quantized, bit for bit; norms, biases, gates and latents stay."""
    _, jparams, pcfg, _ = tiny_pair()
    lmm = {"quantize": mode, "quantize_head": True, "quantize_vision": True}
    ns = SimpleNamespace(lmm=SimpleNamespace(get=lambda k, d=None: lmm.get(k, d)))
    jb = SimpleNamespace(params=jax.tree.map(np.asarray, jparams),
                         model_cfg=jx_idefics.IdeficsConfig.tiny())
    pb = SimpleNamespace(params=params_from_jax(jb.params), model_cfg=pcfg)
    want = jax.tree.map(np.asarray, jx_registry._maybe_quantize(ns, jb).params)
    got = pt_registry._maybe_quantize(ns, pb).params
    _assert_tree_equal(want, got)
    assert PQ.is_quantized_leaf(got["lm_head"]) and PQ.is_quantized_leaf(
        got["vision"]["layers"]["mlp"]["w1"])
    assert not PQ.is_any_quantized_leaf(got["layers"]["ln1"])


def test_params_from_jax_keeps_quantized_dtypes():
    """Quantized leaves keep JAX's dtypes whatever ``dtype`` is asked for:
    int8 scales stay f32 (bit-equal), int4 scales bf16."""
    rng = np.random.default_rng(2)
    w = jnp.asarray(rng.normal(size=(2, 64, 48)) * 0.02, jnp.float32)
    tree = jax.tree.map(np.asarray, {
        "a": JQ.quantize_array(w), "b": JQ.quantize_array_int4(w), "c": w,
    })
    got = params_from_jax(tree, torch.bfloat16)
    assert got["a"]["q"].dtype == torch.int8 and got["a"]["s"].dtype == torch.float32
    np.testing.assert_array_equal(got["a"]["s"].numpy(), tree["a"]["s"])
    assert got["b"]["q4"].dtype == torch.uint8 and got["b"]["s"].dtype == torch.bfloat16
    _assert_tree_equal(tree["b"], got["b"])
    assert got["c"].dtype == torch.bfloat16  # a plain leaf still takes dtype


# ---------------------------------------------------------------------------
# ops/int8_matmul.py: qdot's routes, the kernels' plain versions, gradients
# ---------------------------------------------------------------------------


def _leaf_pair(mode, k, n, seed):
    w = (np.random.default_rng(seed).normal(size=(k, n)) * 0.02).astype(np.float32)
    jl = (JQ.quantize_array if mode == "int8" else JQ.quantize_array_int4)(jnp.asarray(w))
    return w, jl, params_from_jax(jax.tree.map(np.asarray, jl))


@pytest.mark.parametrize("route,mode,m,a8", [
    ("plain", None, 10, False),
    ("scale_on_output", "int8", 70, False),
    ("int8_kernel_shaped", "int8", 10, False),
    ("w8a8", "int8", 24, True),
    ("int4_dequantize", "int4", 70, False),
    ("int4_kernel_shaped", "int4", 10, False),
])
@pytest.mark.parametrize("pet", [None, "f32"])
def test_qdot_routes_match_jax(route, mode, m, a8, pet):
    x = np.random.default_rng(3).normal(size=(2, m // 2, 256)).astype(np.float32)
    w, jl, pl = _leaf_pair(mode or "int8", 256, 96, 4)
    if mode is None:
        jl, pl = jnp.asarray(w), torch.from_numpy(w)
    want = JI8.qdot(jnp.asarray(x), jl, preferred_element_type=jnp.float32 if pet else None,
                    a8=a8)
    got = PI8.qdot(torch.from_numpy(x), pl, preferred_element_type=torch.float32 if pet else None,
                   a8=a8)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=QDOT_ATOL, rtol=0)


def test_qdot_kernel_shaped_routes_call_the_kernel_wrappers(monkeypatch):
    """Decode-shaped quantized calls go through the kernels' wrappers (which
    take the plain version for CPU tensors); larger ones do not."""
    seen = []
    for mod, name in ((PI8, "int8_matmul"), (PI4, "int4_matmul")):
        real = getattr(mod, name)
        monkeypatch.setattr(
            mod, name, lambda *a, _r=real, _n=name, **k: seen.append(_n) or _r(*a, **k))
    x = torch.randn((64, 256))
    for mode in ("int8", "int4"):
        _, _, leaf = _leaf_pair(mode, 256, 96, 5)
        PI8.qdot(x, leaf)
        PI8.qdot(torch.randn((65, 256)), leaf)
        PI8.qdot(x, leaf, a8=True)  # w8a8 for int8; int4 ignores a8
    assert seen == ["int8_matmul", "int4_matmul", "int4_matmul"]


@pytest.mark.parametrize("m,k,n", [(8, 96, 128), (3, 256, 384)])
def test_int8_plain_version_matches_pallas_interpret(m, k, n):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w, jl, pl = _leaf_pair("int8", k, n, 7)
    ref = np.asarray(JI8.int8_matmul_pallas(
        jnp.asarray(x, jnp.bfloat16), jl["q"], jl["s"], out_dtype=jnp.float32, interpret=True))
    got = PI8.int8_matmul_reference(
        torch.from_numpy(x).to(torch.bfloat16), pl["q"], pl["s"], torch.float32).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < KERNEL_REL


@pytest.mark.parametrize("m,k,n,g", [(8, 256, 256, 64), (3, 512, 384, 64)])
def test_int4_plain_version_matches_pallas_interpret(m, k, n, g):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * 0.02).astype(np.float32)
    jl = JQ.quantize_array_int4(jnp.asarray(w), group=g)
    pl = params_from_jax(jax.tree.map(np.asarray, jl))
    ref = np.asarray(JI4.int4_matmul_pallas(
        jnp.asarray(x), jl["q4"], jl["s"].reshape(k // g, n), g, out_dtype=jnp.float32,
        interpret=True))
    got = PI4.int4_matmul_reference(
        torch.from_numpy(x), pl["q4"], pl["s"].reshape(k // g, n), g, torch.float32).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < KERNEL_REL


def test_int4_usable_keeps_only_the_functions_shape_rules():
    assert PI4.int4_matmul_usable(3, 4096, 11008, 64)  # no m % 8, no tiles
    assert PI4.int4_matmul_usable(64, 11008, 4096, 64)
    assert not PI4.int4_matmul_usable(65, 4096, 4096, 64)
    assert not PI4.int4_matmul_usable(3, 4097, 4096, 64)  # odd K
    assert not PI4.int4_matmul_usable(3, 96, 40, 64)  # K/2 % G != 0


@pytest.mark.parametrize("mode,a8,m", [("int8", False, 12), ("int8", True, 24),
                                       ("int4", False, 12), ("int8", False, 80)])
def test_activation_backward_matches_jax_grad(mode, a8, m):
    x = np.random.default_rng(9).normal(size=(m, 256)).astype(np.float32)
    gy = np.random.default_rng(10).normal(size=(m, 96)).astype(np.float32)
    _, jl, pl = _leaf_pair(mode, 256, 96, 11)
    want = np.asarray(jax.grad(lambda xv: jnp.sum(JI8.qdot(xv, jl, a8=a8) * gy))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    (got,) = torch.autograd.grad((PI8.qdot(xt, pl, a8=a8) * torch.from_numpy(gy)).sum(), xt)
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() < KERNEL_REL


def test_launch_plan_covers_every_row_once():
    """The split-K plan: about two blocks per SM at decode shapes (unless a
    column tile's cluster is full or the stages run out),
    whole 64-row stages per split, every weight row in exactly one split;
    blocks of 128 columns and up to 64 activation rows; TMA where both row
    pitches are multiples of 16 bytes, else the plain loads."""
    for m, rows, n in [(3, 4096, 4096), (3, 11008, 4096), (64, 4096, 4096), (3, 4096, 32002),
                       (3, 2048, 11008), (1, 40, 33), (64, 2048, 4096), (17, 1280, 1536)]:
        splits, per = PI8.launch_plan(m, rows, n, 132)
        assert per % 64 == 0 and (splits - 1) * per < rows <= splits * per
        blocks = -(-n // 128) * -(-m // 64) * splits
        stages = -(-rows // 64)
        # a full cluster: INT8_MAX_SPLITS splits' worth of stages each
        # (fewer splits where whole stages leave the last ones empty)
        full = -(-stages // PI8.INT8_MAX_SPLITS) * 64
        assert blocks >= 132 or per == full or splits == stages, (m, rows, n)
    assert PI8.tma_path(4096, 4096) and PI8.tma_path(4096, 11008)
    assert not PI8.tma_path(4096, 32002) and not PI8.tma_path(40, 33)


# ---------------------------------------------------------------------------
# The quantized tiny-idefics against JAX
# ---------------------------------------------------------------------------

# (quantize mode, head, vision, kv8, w8a8): the JAX end-to-end test's
# composition (tests/test_quantize.py:110-129), and int4
CONFIGS = {
    "int8_all": ("int8", True, True, True, True),
    "int4": ("int4", False, False, False, False),
}


def quantized_pair(name):
    mode, head, vision, kv8, a8 = CONFIGS[name]
    jcfg, jparams, pcfg, _ = tiny_pair()
    lmm = {"quantize": mode, "quantize_head": head, "quantize_vision": vision}
    ns = SimpleNamespace(lmm=SimpleNamespace(get=lambda k, d=None: lmm.get(k, d)))
    jb = SimpleNamespace(params=jax.tree.map(np.asarray, jparams), model_cfg=jcfg)
    jq = jx_registry._maybe_quantize(ns, jb).params
    kw = dict(kv_cache_dtype="int8" if kv8 else "bf16", w8a8_prefill=a8)
    jcfg = dataclasses.replace(jcfg, text=dataclasses.replace(jcfg.text, **kw))
    pcfg = dataclasses.replace(pcfg, text=dataclasses.replace(pcfg.text, **kw))
    return jcfg, jax.tree.map(jnp.asarray, jq), pcfg, params_from_jax(jax.tree.map(np.asarray, jq))


def _bind_both(name, ids, pixels, valid, jicv, picv, max_len, eos=EOS):
    jcfg, jparams, pcfg, pparams = quantized_pair(name)
    jf = jx_idefics.make_idefics_forward_fns(jcfg, eos)[1](
        jparams, jnp.asarray(pixels), jnp.asarray(valid), jnp.asarray(ids), jicv, max_len)
    pf = pt_idefics.make_idefics_forward_fns(pcfg, eos)[1](
        pparams, torch.from_numpy(pixels), torch.from_numpy(valid), torch.from_numpy(ids), picv,
        max_len)
    return jf, pf


@pytest.mark.parametrize("name", list(CONFIGS))
def test_quantized_prefill_and_cached_steps_match_jax(name):
    rng = np.random.default_rng(12)
    # 20 tokens: past W8A8_MIN_TOKENS, so the prefill runs w8a8 under int8_all
    ids, mask, pixels, valid = tiny_inputs(rng, s=20)
    jicv, picv = icv_pair(rng)
    jf, pf = _bind_both(name, ids, pixels, valid, jicv, picv, ids.shape[1] + 3)
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
    jl, jc = jf(jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(pos), None)
    pl, pc = pf(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(pos), None)
    assert isinstance(pc["k"], dict) == (name == "int8_all")
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    nxt = pos[:, -1:] + 1
    for _ in range(2):
        tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
        one = np.ones_like(tok)
        jl, jc = jf(jnp.asarray(tok), jnp.asarray(one), jnp.asarray(nxt), jc)
        pl, pc = pf(torch.from_numpy(tok), torch.from_numpy(one), torch.from_numpy(nxt), pc)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
        nxt = nxt + 1


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("kind", ["greedy", "beam"])
def test_quantized_decodes_token_exact(name, kind):
    rng = np.random.default_rng(13)
    ids, mask, pixels, valid = tiny_inputs(rng, s=20)
    jicv, picv = icv_pair(rng)
    max_new = 5
    jf, pf = _bind_both(name, ids, pixels, valid, jicv, picv, ids.shape[1] + max_new + 1)
    kw = dict(max_new_tokens=max_new, eos_token_id=EOS, pad_token_id=0)
    if kind == "greedy":
        want = jx_greedy(jf, jnp.asarray(ids), jnp.asarray(mask), **kw)
        got = pt_greedy(pf, torch.from_numpy(ids), torch.from_numpy(mask), **kw)
    else:
        kw.update(num_beams=3, length_penalty=0.0)
        want = jx_beam(jf, jnp.asarray(ids), jnp.asarray(mask), **kw)
        got = pt_beam(pf, torch.from_numpy(ids), torch.from_numpy(mask), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_kv8_flash_prefill_attends_the_int8_round_trip(monkeypatch):
    """With an int8 cache and the flash branch forced, the prefill attends
    the int8 round trip of its own K/V, what later steps read back
    (JAX ``tests/test_quantize.py:496``); the raw keys are not a fixed point."""
    cfg = pt_idefics.IdeficsConfig.tiny().text
    cfg = dataclasses.replace(cfg, n_layers=1, kv_cache_dtype="int8", attention_impl="flash")
    p = PL.layer_slice(PD.init_layer_params(torch.Generator().manual_seed(0), cfg, 1, "cpu"), 0)
    captured = []

    def fake_flash(q, k, v, valid, scale=None):
        captured.append(k.clone())
        return torch.zeros_like(q)

    monkeypatch.setattr(PL, "flash_attention_usable", lambda *a: True)
    monkeypatch.setattr(PL, "flash_attention", fake_flash)
    b, s = 2, 8
    h = torch.randn((b, s, cfg.d_model), generator=torch.Generator().manual_seed(1))
    mask = torch.ones((b, s), dtype=torch.int32)
    pos = torch.cumsum(mask, -1) - 1
    cache = PD.init_kv_cache(cfg, b, 16, "cpu")
    assert isinstance(cache["k"], dict)
    view, _, _ = PD.decode_cache_view(cache, pos, mask, s)
    cos, sin = PL.rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)
    kv = (PL.layer_slice(cache["k"], 0), PL.layer_slice(cache["v"], 0), 0)
    PD.decoder_layer(cfg, p, h, cos, sin, view, None, kv_write=kv, flash_valid=mask)
    assert captured, "flash stub never called"
    k = captured[0]
    kq, ks = PQ.quantize_kv_rows(k)
    torch.testing.assert_close(k, PQ.dequantize_kv(kq, ks, torch.float32), rtol=0, atol=1e-6)
    # the cache holds exactly those rows
    np.testing.assert_array_equal(cache["k"]["q"][0, :, :s].numpy(), kq.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,softcap", [(1, None), (3, None), (1, 30.0)])
def test_int8_cache_attention_matches_jax(dtype, s, softcap):
    """The int8 cache's attention against JAX ``_cached_attention``: earlier
    rows as int8 planes with their per-(token, head) scales on the f32
    scores and the probabilities, this step's rows as their round trip in
    the compute dtype; GQA (4 query heads on 2 KV heads).  f32: 1e-5; bf16
    outputs: 2e-3 of max|ref| (they read 0; attending the prefix
    dequantized to bf16 instead reads 4e-3 to 6e-3)."""
    from licv_vqa_tpu.models.decoder import _cached_attention as jx_cached_attention

    b, h, kv, dh, S, index = 2, 4, 2, 16, 12, 5
    rng = np.random.default_rng(12)
    q = rng.normal(size=(b, s, h, dh)).astype(np.float32)
    kq, ks, vq, vs = (np.array(a) for key in "kv" for a in JQ.quantize_kv_rows(
        jnp.asarray(rng.normal(size=(b, S, kv, dh)), jnp.float32)))
    k_loc, v_loc = (rng.normal(size=(b, s, kv, dh)).astype(np.float32) for _ in "kv")
    mask = np.zeros((b, 1, s, S), bool)
    for i in range(b):
        for qi in range(s):
            mask[i, 0, qi, i : index] = True  # earlier rows, some left padding
            mask[i, 0, qi, index : index + qi + 1] = True  # causal local block
    jdt = jnp.dtype(dtype)
    jlocal = [JQ.dequantize_kv(*JQ.quantize_kv_rows(jnp.asarray(a)), jdt) for a in (k_loc, v_loc)]
    want = jx_cached_attention(
        jnp.asarray(q, jdt), {"q": jnp.asarray(kq), "s": jnp.asarray(ks)},
        {"q": jnp.asarray(vq), "s": jnp.asarray(vs)},
        *(jnp.repeat(a, h // kv, axis=2) for a in jlocal),
        jnp.asarray(mask), None, jnp.asarray(index, jnp.int32), logit_softcap=softcap,
    )
    tdt = getattr(torch, dtype)
    plocal = [PQ.dequantize_kv(*PQ.quantize_kv_rows(torch.from_numpy(a)), tdt)
              for a in (k_loc, v_loc)]
    got = PD._int8_cached_attention(
        torch.from_numpy(q).to(tdt), {"q": torch.from_numpy(kq), "s": torch.from_numpy(ks)},
        {"q": torch.from_numpy(vq), "s": torch.from_numpy(vs)}, *plocal,
        torch.from_numpy(mask), index, softcap,
    )
    assert got.dtype == tdt and got.shape == (b, s, h, dh)
    w = np.asarray(want.astype(jnp.float32))
    err = np.abs(got.float().numpy() - w).max()
    assert err <= (1e-5 if dtype == "float32" else 2e-3 * np.abs(w).max()), err
