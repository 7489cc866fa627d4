"""Port vs JAX: the tiny OpenFlamingo stack and its two kernels' plain
versions (CPU, f32).

The same numpy params (built by the JAX package's init, with its constant
norms, biases, latents and gates perturbed so that every term counts, and
carried across with ``params_from_jax``) and the same numpy inputs go
through both packages.  Tolerances: the kernels' plain versions against the
interpreted Pallas kernels within 1e-5 (f32; on the rows the function
defines, see ``visible_rows``), activations and logits within atol=1e-4
(f32; summation order only), ALiBi slopes to 1e-6 relative, decodes and
converted params exact, the loss to 1e-5 relative and the (icv, alpha)
gradients to 1e-4 relative (max-abs error over max-abs value).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from licv_vqa_tpu.icv import encoder as jx_encoder
from licv_vqa_tpu.icv import module as jx_module
from licv_vqa_tpu.infer.decode import beam_generate as jx_beam
from licv_vqa_tpu.infer.decode import greedy_generate as jx_greedy
from licv_vqa_tpu.models import convert as jx_convert
from licv_vqa_tpu.models import decoder as jx_decoder
from licv_vqa_tpu.models import layers as jx_layers
from licv_vqa_tpu.models import openflamingo as jx
from licv_vqa_tpu.ops import flash_alibi as jx_fa
from licv_vqa_tpu.ops import vit_attention as jx_vit
from licv_vqa_tpu_torch.icv import module as pt_module
from licv_vqa_tpu_torch.icv.encoder import GlobalICVEncoder
from licv_vqa_tpu_torch.infer.decode import beam_generate as pt_beam
from licv_vqa_tpu_torch.infer.decode import greedy_generate as pt_greedy
from licv_vqa_tpu_torch.models import convert as pt_convert
from licv_vqa_tpu_torch.models import decoder as pt_decoder
from licv_vqa_tpu_torch.models import layers as pt_layers
from licv_vqa_tpu_torch.models import openflamingo as pt
from licv_vqa_tpu_torch.models import vision as pt_vision
from licv_vqa_tpu_torch.models.idefics import image_attention_onehot
from licv_vqa_tpu_torch.models.weights import params_from_jax
from licv_vqa_tpu_torch.ops import flash_alibi as pt_fa

ATOL = 1e-4
KERNEL_ATOL = 1e-5
EOS, PAD, IMG = 2, 0, 125  # the tiny config's <image>
VOCAB = 130


def _perturb(tree, rng):
    """Constant leaves (unit norms, zero biases and gates, latents) get
    noise, so a dropped bias or a closed gate shows."""
    if isinstance(tree, dict):
        return {k: _perturb(v, rng) for k, v in tree.items()}
    x = np.asarray(tree)
    if x.dtype.kind == "f" and np.all(x == x.flat[0]):
        x = x + (rng.normal(size=x.shape) * 0.3).astype(x.dtype)
    return x


@functools.cache
def _jax_tree(seed: int, n_layers: int = 4, every: int = 2):
    jcfg = jx.OpenFlamingoConfig.tiny(dtype=jnp.float32)
    jcfg = dataclasses.replace(jcfg, text=dataclasses.replace(jcfg.text, n_layers=n_layers),
                               cross_attn_every_n_layers=every)
    tree = jax.tree.map(np.asarray, jx.init_openflamingo_params(jax.random.PRNGKey(seed), jcfg))
    return jcfg, _perturb(tree, np.random.default_rng(seed + 100))


def tiny_pair(seed: int = 0, n_layers: int = 4, every: int = 2):
    """(jax cfg, jax params, port cfg, port params) of one numpy tree."""
    jcfg, tree = _jax_tree(seed, n_layers, every)
    pcfg = pt.OpenFlamingoConfig.tiny(dtype=torch.float32)
    pcfg = dataclasses.replace(pcfg, text=dataclasses.replace(pcfg.text, n_layers=n_layers),
                               cross_attn_every_n_layers=every)
    return jcfg, jax.tree.map(jnp.asarray, tree), pcfg, params_from_jax(tree, torch.float32)


def tiny_inputs(rng, bs=2, s=16, n_img=2):
    """Left-padded prompts, each image one ``<image>`` token (flamingo's
    media token), row 1's second image slot padded."""
    ids = rng.integers(3, 120, size=(bs, s)).astype(np.int32)
    mask = np.ones((bs, s), np.int32)
    mask[1, :3], ids[1, :3] = 0, PAD
    for start in (3, 9)[:n_img]:
        ids[:, start] = IMG
    pixels = rng.normal(size=(bs, n_img, 28, 28, 3)).astype(np.float32)
    valid = np.ones((bs, n_img), bool)
    valid[1, -1] = False
    return ids, mask, pixels, valid


def icv_pair(rng, flags=None):
    rows = (rng.normal(size=(4, 64)) * 0.5).astype(np.float32)
    if flags is None:
        return jnp.asarray(rows), torch.from_numpy(rows)
    return ((jnp.asarray(rows), jnp.asarray(np.asarray(flags))),
            (torch.from_numpy(rows), list(flags)))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# ALiBi and the two kernels' plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_heads", [4, 6, 8, 12, 32])
def test_alibi_slopes_and_bias_match_jax(n_heads):
    """Including the non-power-of-two branch (6, 12)."""
    np.testing.assert_allclose(pt_layers.alibi_slopes(n_heads).numpy(),
                               np.asarray(jx_layers.alibi_slopes(n_heads)), rtol=1e-6, atol=0)
    rng = np.random.default_rng(n_heads)
    q_pos = rng.integers(0, 20, size=(2, 5)).astype(np.int32)
    k_pos = rng.integers(0, 20, size=(2, 7)).astype(np.int32)
    want = jx_layers.alibi_bias(n_heads, jnp.asarray(q_pos), jnp.asarray(k_pos))
    got = pt_layers.alibi_bias(n_heads, torch.from_numpy(q_pos), torch.from_numpy(k_pos))
    assert got.dtype == torch.float32 and got.shape == (2, n_heads, 5, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def visible_rows(valid: np.ndarray) -> np.ndarray:
    """(B, S) rows that see at least one key under the ALiBi flash rule
    (k <= q and valid[k]): every real row, and the right-pad rows, which
    attend the real keys before them.  A left-pad row sees none: the kernel
    writes 0 there and the plain version a uniform average (garbage by
    contract)."""
    return np.cumsum(valid, axis=1) > 0


@pytest.mark.parametrize("padding", ["right", "left"])
def test_flash_alibi_reference_matches_interpreted_pallas(padding):
    rng = np.random.default_rng(1)
    b, s, h, dh = 2, 128, 4, 32
    q, k, v = (rng.normal(size=(b, s, h, dh)).astype(np.float32) for _ in range(3))
    valid = np.ones((b, s), np.int32)
    if padding == "right":
        valid[1, 90:] = 0
    else:
        valid[1, :37] = 0
    slopes = np.array(jx_layers.alibi_slopes(h))
    scale = dh ** -0.5
    want = np.asarray(jx_fa._flash_alibi_fwd_impl(
        *(jnp.asarray(x) for x in (q, k, v, valid, slopes)), scale=scale, interpret=True))
    t = torch.from_numpy
    got = pt_fa.flash_alibi_attention(t(q), t(k), t(v), t(valid), t(slopes), scale).numpy()
    rows = visible_rows(valid)
    assert rows.sum() == (2 * s if padding == "right" else 2 * s - 37)
    np.testing.assert_allclose(got[rows], want[rows], atol=KERNEL_ATOL, rtol=0)
    assert pt_fa.flash_alibi_attention.launches == 0  # CPU tensors launch no kernel


def test_flash_alibi_backward_is_the_dense_recompute():
    """The autograd Function's gradient equals the plain version's (JAX
    ``_bwd`` recomputes through ``_dense_reference``)."""
    rng = np.random.default_rng(2)
    b, s, h, dh = 1, 12, 2, 8
    q, k, v = (torch.from_numpy(rng.normal(size=(b, s, h, dh)).astype(np.float32))
               .requires_grad_(True) for _ in range(3))
    valid = torch.ones((b, s), dtype=torch.int32)
    slopes = pt_layers.alibi_slopes(h)
    g = torch.from_numpy(rng.normal(size=(b, s, h, dh)).astype(np.float32))
    got = torch.autograd.grad(pt_fa.flash_alibi_attention(q, k, v, valid, slopes, 0.3), (q, k, v), g)
    want = torch.autograd.grad(pt_fa.flash_alibi_reference(q, k, v, valid, slopes, 0.3),
                               (q, k, v), g)
    for a, w in zip(got, want, strict=True):
        torch.testing.assert_close(a, w, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dh", [64, 80])
@pytest.mark.parametrize("masked", [False, True])
def test_vit_attention_reference_matches_interpreted_pallas(dh, masked):
    """Every row, the fully masked one included (its uniform softmax)."""
    rng = np.random.default_rng(dh + masked)
    b, s, h = 2, 9, 2
    q, k, v = (rng.normal(size=(b, s, h, dh)).astype(np.float32) for _ in range(3))
    valid = None
    if masked:
        valid = rng.random((b, s)) > 0.3
        valid[1] = False
    want = np.asarray(jx_vit.vit_attention_tpu(
        *(jnp.asarray(x) for x in (q, k, v)),
        valid=None if valid is None else jnp.asarray(valid), interpret=True))
    t = torch.from_numpy
    got = pt_layers.vit_attention(t(q), t(k), t(v), None if valid is None else t(valid))
    np.testing.assert_allclose(got.numpy(), want, atol=KERNEL_ATOL, rtol=0)
    assert pt_layers.vit_attention.launches == 0


def _calls(monkeypatch, name):
    calls = []
    fn = getattr(pt_layers, name)
    monkeypatch.setattr(pt_layers, name, lambda *a, **k: calls.append(1) or fn(*a, **k))
    return calls


def test_vit_layer_sends_the_fused_route_key_masks_only(monkeypatch):
    """With the fused gate forced on: a causal ``mask`` and no ``valid`` (the
    CLIP text encoder's layer) takes the plain causal path; a key mask with
    its ``valid``, and no mask at all, take ``vit_attention``."""
    _, _, pcfg, pparams = tiny_pair()
    vc = pcfg.vision
    p = pt_layers.layer_slice(pparams["vision"]["layers"], 0)
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.normal(size=(2, 6, vc.d_model)).astype(np.float32))
    causal = torch.tril(torch.ones((6, 6), dtype=torch.bool))[None, None].expand(2, 1, 6, 6)
    valid = torch.from_numpy(rng.random((2, 6)) > 0.3)
    want = {key: pt_vision._vit_layer(vc, p, h, mask=m, valid=vv)
            for key, m, vv in (("causal", causal, None), ("key", valid[:, None, None, :], valid),
                               ("none", None, None))}
    monkeypatch.setattr(pt_layers, "vit_attention_usable", lambda s, dh, device: True)
    calls = _calls(monkeypatch, "vit_attention")
    got = pt_vision._vit_layer(vc, p, h, mask=causal)
    assert calls == []
    torch.testing.assert_close(got, want["causal"], rtol=0, atol=0)
    bidir = pt_vision._vit_layer(vc, p, h, mask=None)
    assert not torch.allclose(got, bidir, atol=1e-4)  # the mask mattered
    got = pt_vision._vit_layer(vc, p, h, mask=valid[:, None, None, :], valid=valid)
    assert len(calls) == 2
    torch.testing.assert_close(got, want["key"], rtol=0, atol=1e-6)
    torch.testing.assert_close(bidir, want["none"], rtol=0, atol=1e-6)


def test_vit_attention_gate(monkeypatch):
    """A CUDA device, s <= 1024, a built head dim, and the env switch; on by
    default (ROADMAP Queue 3), where JAX keeps it opt-in."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    monkeypatch.delenv("LICV_VIT_FUSED_ATTN", raising=False)
    assert pt_layers.vit_attention_usable(257, 64, cuda)
    assert pt_layers.vit_attention_usable(257, 80, cuda)
    assert not pt_layers.vit_attention_usable(257, 64, cpu)
    assert not pt_layers.vit_attention_usable(1025, 64, cuda)
    assert not pt_layers.vit_attention_usable(257, 96, cuda)
    monkeypatch.setenv("LICV_VIT_FUSED_ATTN", "0")
    assert not pt_layers.vit_attention_usable(257, 64, cuda)


def test_flash_alibi_gate():
    cfg = pt.OpenFlamingoConfig.openflamingo_9b().text
    cuda = torch.device("cuda")
    assert pt_fa.flash_alibi_usable(cfg, 128, 128, cuda)
    assert pt_fa.flash_alibi_usable(cfg, 473, 128, cuda)  # no 128-multiple rule
    assert not pt_fa.flash_alibi_usable(cfg, 127, 128, cuda)
    assert not pt_fa.flash_alibi_usable(cfg, 512, 64, cuda)
    assert not pt_fa.flash_alibi_usable(cfg, 512, 128, torch.device("cpu"))
    xla = dataclasses.replace(cfg, attention_impl="xla")
    assert not pt_fa.flash_alibi_usable(xla, 512, 128, cuda)


# ---------------------------------------------------------------------------
# Converters (open_flamingo / open_clip / HF MPT naming, built locally)
# ---------------------------------------------------------------------------


def flamingo_state_dict(cfg, rng) -> dict:
    """A full-model open_flamingo dump at ``cfg``'s widths: the MPT base
    (``lang_encoder.transformer.*``), the gated cross-attention layers, the
    perceiver and the open_clip tower (``vision_encoder.visual.*``), random
    f32 torch tensors, ``module.``-prefixed as a DDP save leaves them."""
    t, vc, pc = cfg.text, cfg.vision, cfg.perceiver
    d, de, dv = t.d_model, pc.d_model, vc.d_model
    inner, xin = pc.n_heads * pc.head_dim, cfg.xattn_heads * cfg.xattn_head_dim

    def r(*shape, scale=0.1):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))

    sd = {}

    def ln(prefix, n, bias=True):
        sd[prefix + "weight"] = 1.0 + r(n)
        if bias:
            sd[prefix + "bias"] = r(n)

    lp = "lang_encoder.transformer."
    sd[lp + "wte.weight"] = r(t.vocab_size, d, scale=0.5)
    ln(lp + "norm_f.", d, bias=False)
    for i in range(t.n_layers):
        bp = f"{lp}blocks.{i}."
        sd[bp + "attn.Wqkv.weight"] = r(3 * d, d)
        sd[bp + "attn.out_proj.weight"] = r(d, d)
        sd[bp + "ffn.up_proj.weight"] = r(t.d_ff, d)
        sd[bp + "ffn.down_proj.weight"] = r(d, t.d_ff)
        ln(bp + "norm_1.", d, bias=False)
        ln(bp + "norm_2.", d, bias=False)
    for i in range(t.n_layers // cfg.cross_attn_every_n_layers):
        xp = f"lang_encoder.gated_cross_attn_layers.{i}."
        ln(xp + "attn.norm.", d)
        sd[xp + "attn.to_q.weight"] = r(xin, d)
        sd[xp + "attn.to_kv.weight"] = r(2 * xin, de)
        sd[xp + "attn.to_out.weight"] = r(d, xin)
        sd[xp + "attn_gate"] = r(1, scale=1.0)
        ln(xp + "ff.0.", d)
        sd[xp + "ff.1.weight"] = r(cfg.xattn_ff_mult * d, d)
        sd[xp + "ff.3.weight"] = r(d, cfg.xattn_ff_mult * d)
        sd[xp + "ff_gate"] = r(1, scale=1.0)
    sd["perceiver.latents"] = r(pc.n_latents, de, scale=1.0)
    ln("perceiver.norm.", de)
    for i in range(pc.n_layers):
        ap, fp = f"perceiver.layers.{i}.0.", f"perceiver.layers.{i}.1."
        ln(ap + "norm_media.", de)
        ln(ap + "norm_latents.", de)
        sd[ap + "to_q.weight"] = r(inner, de)
        sd[ap + "to_kv.weight"] = r(2 * inner, de)
        sd[ap + "to_out.weight"] = r(de, inner)
        ln(fp + "0.", de)
        sd[fp + "1.weight"] = r(pc.d_ff, de)
        sd[fp + "3.weight"] = r(de, pc.d_ff)
    vp = "vision_encoder.visual."
    sd[vp + "conv1.weight"] = r(dv, 3, vc.patch_size, vc.patch_size)
    sd[vp + "class_embedding"] = r(dv, scale=1.0)
    sd[vp + "positional_embedding"] = r(vc.n_patches, dv, scale=1.0)
    ln(vp + "ln_pre.", dv)
    ln(vp + "ln_post.", dv)
    for i in range(vc.n_layers):
        rp = f"{vp}transformer.resblocks.{i}."
        ln(rp + "ln_1.", dv)
        ln(rp + "ln_2.", dv)
        sd[rp + "attn.in_proj_weight"] = r(3 * dv, dv)
        sd[rp + "attn.in_proj_bias"] = r(3 * dv)
        sd[rp + "attn.out_proj.weight"] = r(dv, dv)
        sd[rp + "attn.out_proj.bias"] = r(dv)
        sd[rp + "mlp.c_fc.weight"] = r(vc.d_ff, dv)
        sd[rp + "mlp.c_fc.bias"] = r(vc.d_ff)
        sd[rp + "mlp.c_proj.weight"] = r(dv, vc.d_ff)
        sd[rp + "mlp.c_proj.bias"] = r(dv)
    return {"module." + k: v for k, v in sd.items()}


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        return
    w = np.asarray(want, np.float32)
    g = got.float().numpy()
    assert g.shape == w.shape, path
    np.testing.assert_array_equal(g, w, err_msg=path)


@pytest.mark.parametrize("name", ["mpt", "openclip_vision", "flamingo_perceiver",
                                  "flamingo_xattn", "openflamingo_checkpoint"])
def test_converters_equal_jax(name):
    """Each converter gives JAX's arrays, bit for bit (f32)."""
    jcfg, jparams, pcfg, pparams = tiny_pair()
    sd = flamingo_state_dict(pcfg, np.random.default_rng(4))
    bare = {k[len("module."):]: v for k, v in sd.items()}
    f32 = torch.float32
    if name == "mpt":
        want = jx_convert.convert_mpt(bare, jcfg.text, prefix="lang_encoder.transformer.",
                                      dtype=jnp.float32)
        got = pt_convert.convert_mpt(bare, pcfg.text, prefix="lang_encoder.transformer.")
    elif name == "openclip_vision":
        want = jx_convert.convert_openclip_vision(bare, jcfg.vision, "vision_encoder.visual.")
        got = pt_convert.convert_openclip_vision(bare, pcfg.vision, "vision_encoder.visual.")
    elif name == "flamingo_perceiver":
        want = jx_convert.convert_flamingo_perceiver(bare, 2)
        got = pt_convert.convert_flamingo_perceiver(bare, 2)
    elif name == "flamingo_xattn":
        want = jx_convert.convert_flamingo_xattn(bare, 2)
        got = pt_convert.convert_flamingo_xattn(bare, 2)
    else:
        want, w_upd = jx_convert.convert_openflamingo_checkpoint(sd, jcfg, jparams,
                                                                  dtype=jnp.float32)
        got, g_upd = pt_convert.convert_openflamingo_checkpoint(sd, pcfg, pparams, dtype=f32)
        assert g_upd == w_upd == ["perceiver", "xattn", "embed", "layers", "vision"]
    _assert_trees_equal(got, want)


# ---------------------------------------------------------------------------
# The model: tower, forwards, decodes, invariants, training
# ---------------------------------------------------------------------------


def test_encode_media_matches_jax():
    """ViT-L layout (class token dropped after the post-norm), perceiver
    with GELU and no q/k norms."""
    jcfg, jparams, pcfg, pparams = tiny_pair()
    _, _, pixels, _ = tiny_inputs(np.random.default_rng(5))
    want = jx.encode_media(jcfg, jparams, jnp.asarray(pixels))
    got = pt.encode_media(pcfg, pparams, torch.from_numpy(pixels))
    assert got.shape == (2, 2 * 4, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def _binds(ids, pixels, valid, jicv, picv, max_len, eos=EOS, seed=0, every=2, n_layers=4):
    jcfg, jparams, pcfg, pparams = tiny_pair(seed, n_layers, every)
    jf = jx.make_openflamingo_forward_fns(jcfg, eos)[1](
        jparams, jnp.asarray(pixels), jnp.asarray(valid), jnp.asarray(ids), jicv, max_len)
    pf = pt.make_openflamingo_forward_fns(pcfg, eos)[1](
        pparams, torch.from_numpy(pixels), torch.from_numpy(valid), torch.from_numpy(ids),
        picv, max_len)
    return jf, pf


@pytest.mark.parametrize("case", ["plain", "icv", "icv_subset", "every3"])
def test_bind_prefill_and_cached_steps_match_jax(case):
    """Prefill logits and two cached greedy steps (the ALiBi bias over the
    cache's columns), with the ICV at every block output, on a subset of
    layers, and with the cross-attention every 3 of 6 layers."""
    rng = np.random.default_rng(6)
    ids, mask, pixels, valid = tiny_inputs(rng)
    jicv = picv = None
    if "icv" in case:
        jicv, picv = icv_pair(rng, flags=[True, False, True, True] if "subset" in case else None)
    kw = dict(every=3, n_layers=6) if case == "every3" else {}
    jf, pf = _binds(ids, pixels, valid, jicv, picv, ids.shape[1] + 3, **kw)
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
    jl, jc = jf(jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(pos), None)
    pl_, pc = pf(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(pos), None)
    assert pl_.shape == (2, 1, VOCAB)
    np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    nxt = pos[:, -1:] + 1
    for _ in range(2):
        tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
        one = np.ones_like(tok)
        jl, jc = jf(jnp.asarray(tok), jnp.asarray(one), jnp.asarray(nxt), jc)
        pl_, pc = pf(torch.from_numpy(tok), torch.from_numpy(one), torch.from_numpy(nxt), pc)
        np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
        nxt = nxt + 1


def _decode(kind, eos):
    rng = np.random.default_rng(7)
    ids, mask, pixels, valid = tiny_inputs(rng)
    jicv, picv = icv_pair(rng)
    jf, pf = _binds(ids, pixels, valid, jicv, picv, ids.shape[1] + 6, eos=eos)
    kw = dict(max_new_tokens=5, eos_token_id=eos, pad_token_id=PAD)
    if kind == "beam":
        kw.update(num_beams=3, length_penalty=0.0)
        want = jx_beam(jf, jnp.asarray(ids), jnp.asarray(mask), **kw)
        got = pt_beam(pf, torch.from_numpy(ids), torch.from_numpy(mask), **kw)
    else:
        want = jx_greedy(jf, jnp.asarray(ids), jnp.asarray(mask), **kw)
        got = pt_greedy(pf, torch.from_numpy(ids), torch.from_numpy(mask), **kw)
    return np.asarray(want), got.numpy(), ids.shape[1]


@pytest.mark.parametrize("kind", ["greedy", "beam"])
def test_decode_token_exact_with_left_padding_and_eos(kind):
    want, got, s = _decode(kind, EOS)
    np.testing.assert_array_equal(got, want)
    eos = int(want[0, s + 1])  # a token JAX emits: row 0 finishes
    want, got, s = _decode(kind, eos)
    np.testing.assert_array_equal(got, want)
    assert (want[:, s:] == eos).any()


def _forward(pcfg, pparams, ids, mask, pixels):
    t = torch.from_numpy
    latents = pt.encode_media(pcfg, pparams, t(pixels))
    onehot = image_attention_onehot(t(ids), IMG, EOS, pixels.shape[1])
    logits, _ = pt.openflamingo_forward(pcfg, pparams, t(ids), t(mask), latents, onehot)
    return logits.numpy()


def test_train_forward_logits_match_jax():
    """The grouped no-cache forward (right padding, the plain ALiBi bias)."""
    jcfg, jparams, pcfg, pparams = tiny_pair()
    rng = np.random.default_rng(8)
    ids, _, pixels, _ = tiny_inputs(rng)
    mask = np.ones_like(ids)
    mask[1, 12:] = 0
    latents = jx.encode_media(jcfg, jparams, jnp.asarray(pixels))
    onehot = jx.image_attention_onehot(jnp.asarray(ids), IMG, EOS, 2)
    want, _ = jx.openflamingo_forward(jcfg, jparams, jnp.asarray(ids), jnp.asarray(mask),
                                      latents, onehot)
    np.testing.assert_allclose(_forward(pcfg, pparams, ids, mask, pixels), np.asarray(want),
                               atol=ATOL, rtol=0)


def test_left_padding_offset_invariance():
    """ALiBi's relative bias and the masks make the forward invariant to
    left padding at the real positions (gates open), as
    ``tests/test_openflamingo.py:457`` holds JAX's."""
    _, _, pcfg, pparams = tiny_pair()
    rng = np.random.default_rng(9)
    ids, _, pixels, _ = tiny_inputs(rng, s=9, n_img=1)
    ids[1, :3] = rng.integers(3, 120, size=3)
    mask = np.ones_like(ids)
    base = _forward(pcfg, pparams, ids, mask, pixels)
    pad = 3
    ids_p = np.concatenate([np.zeros((2, pad), np.int32), ids], axis=1)
    mask_p = np.concatenate([np.zeros((2, pad), np.int32), mask], axis=1)
    np.testing.assert_allclose(_forward(pcfg, pparams, ids_p, mask_p, pixels)[:, pad:], base,
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("n_layers,every", [(2, 2), (4, 2), (6, 3)])
def test_gate_zero_equals_the_plain_mpt_at_every_depth(n_layers, every):
    """Closed gates: the flamingo forward equals the port's plain MPT
    (``decoder.causal_lm_forward``) on the real rows, at every depth and
    phase, as ``tests/test_openflamingo.py:532`` holds JAX's."""
    _, _, pcfg, pparams = tiny_pair(2, n_layers, every)
    pparams = dict(pparams, xattn=dict(pparams["xattn"],
                                       attn_gate=torch.zeros_like(pparams["xattn"]["attn_gate"]),
                                       ff_gate=torch.zeros_like(pparams["xattn"]["ff_gate"])))
    rng = np.random.default_rng(10)
    ids, mask, pixels, _ = tiny_inputs(rng, s=7, n_img=1)
    mask[1, :2] = 0
    got = _forward(pcfg, pparams, ids, mask, pixels)
    text = {k: pparams[k] for k in ("embed", "layers", "final_norm", "final_norm_b")}
    want, _ = pt_decoder.causal_lm_forward(pcfg.text, text, torch.from_numpy(ids),
                                           torch.from_numpy(mask))
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], want.numpy()[valid], atol=1e-5, rtol=0)


def test_no_media_positions_get_zero_cross_attention():
    """With no ``<image>`` token an open attention gate changes nothing
    (the FF gate closed), as ``tests/test_openflamingo.py:575`` holds."""
    _, _, pcfg, pparams = tiny_pair(3)
    x = pparams["xattn"]
    closed = dict(pparams, xattn=dict(x, ff_gate=torch.zeros_like(x["ff_gate"]),
                                      attn_gate=torch.zeros_like(x["attn_gate"])))
    opened = dict(closed, xattn=dict(closed["xattn"],
                                     attn_gate=torch.full_like(x["attn_gate"], 2.0)))
    rng = np.random.default_rng(11)
    ids, mask, pixels, _ = tiny_inputs(rng, s=8, n_img=1)
    ids[ids == IMG] = 5
    np.testing.assert_allclose(_forward(pcfg, opened, ids, mask, pixels),
                               _forward(pcfg, closed, ids, mask, pixels), atol=1e-6, rtol=0)
    ids[:, 0] = IMG
    assert not np.allclose(_forward(pcfg, opened, ids, mask, pixels),
                           _forward(pcfg, closed, ids, mask, pixels), atol=1e-4)


def _train_batch(rng):
    """Right-padded student and teacher views (one and two images a row),
    the last row a batch filler."""
    bs, s_stu, s_tea = 3, 10, 20
    stu = np.full((bs, s_stu), PAD, np.int32)
    tea = np.full((bs, s_tea), PAD, np.int32)
    qx, icl = np.zeros(bs, np.int32), np.zeros(bs, np.int32)
    for b in range(bs - 1):
        shot = [IMG] + list(rng.integers(3, 100, size=rng.integers(3, 6)))
        query = [IMG] + list(rng.integers(3, 100, size=rng.integers(2, 4)))
        ans = list(rng.integers(3, 100, size=rng.integers(1, 3))) + [EOS]
        stu[b, : len(query) + len(ans)] = query + ans
        tea[b, : len(shot) + len(query) + len(ans)] = shot + query + ans
        qx[b], icl[b] = len(query), len(shot) + len(query)

    def view(ids, n_img):
        return {"input_ids": ids, "attention_mask": (ids != PAD).astype(np.int32),
                "pixel_values": rng.normal(size=(bs, n_img, 28, 28, 3)).astype(np.float32),
                "pixel_valid": np.ones((bs, n_img), bool)}

    return {"query_inputs": view(stu, 1), "inputs": view(tea, 2),
            "query_x_length": qx, "in_context_length": icl}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def test_train_forward_loss_and_grads_match_icv_loss_fn():
    """``icv_loss_fn`` through the train forward (the group, layer and
    cross-attention recompute; the gather-before-head teacher): the masked
    KL plus hard CE and the (icv, alpha) gradients."""
    jcfg, jparams, pcfg, pparams = tiny_pair()
    rng = np.random.default_rng(12)
    batch = _train_batch(rng)
    icv = {"icv": (rng.normal(size=(4, 64)) * 0.5).astype(np.float32),
           "alpha": np.full((4,), 0.3, np.float32)}
    jfwd = jx.make_openflamingo_forward_fns(jcfg, EOS)[0]
    enc = jx_encoder.GlobalICVEncoder(64, 4, alpha_init_value=0.3)
    mcfg = jx_module.ICVModuleConfig(hard_loss_weight=0.5, init_temperature=1.5)

    def loss(enc_params):
        trainable = {"encoder": enc_params, "temperature": jnp.float32(1.5)}
        return jx_module.icv_loss_fn(
            trainable, jparams, jax.tree.map(jnp.asarray, batch), jfwd, enc, mcfg, PAD,
            lambda p, h: jx_decoder.logits_from_hidden(jcfg.text, p, h),
        )

    (want, _), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, icv))
    penc = GlobalICVEncoder(64, 4, alpha_init_value=0.3)
    penc.load_params(icv)
    got, _ = pt_module.icv_loss_fn(
        penc, torch.tensor(1.5), pparams, _to_torch(batch),
        pt.make_openflamingo_forward_fns(pcfg, EOS)[0],
        pt_module.ICVModuleConfig(hard_loss_weight=0.5, init_temperature=1.5), PAD,
        lambda p, h: pt_decoder.logits_from_hidden(pcfg.text, p, h),
    )
    d_icv, d_alpha = torch.autograd.grad(got, (penc.icv, penc.alpha))
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    assert _rel(d_icv.numpy(), grads["icv"]) <= 1e-4
    assert _rel(d_alpha.numpy(), grads["alpha"]) <= 1e-4


def test_alibi_layer_off_the_flash_branch_needs_its_bias():
    _, _, pcfg, pparams = tiny_pair()
    t = pcfg.text
    h = torch.zeros((1, 3, t.d_model))
    mask = torch.ones((1, 1, 3, 3), dtype=torch.bool)
    with pytest.raises(ValueError, match="needs its bias"):
        pt_decoder.decoder_layer(t, pt_layers.layer_slice(pparams["layers"], 0), h, None,
                                 None, mask, None)


def test_decoder_config_refuses_an_unknown_positional():
    from licv_vqa_tpu_torch.models.config import DecoderConfig

    with pytest.raises(ValueError, match="positional must be"):
        DecoderConfig(positional="xpos")
