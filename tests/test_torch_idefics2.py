"""Port vs JAX: the tiny Idefics2 stack (CPU, f32).

The same numpy params (built by the JAX package's init, with its constant
norms, biases and latents perturbed so that every term counts, and carried
across with ``params_from_jax``) and the same numpy inputs go through both
packages.  Tolerances: activations and logits within atol=1e-4 (f32; the
two differ only in summation order), NaViT position ids and decodes exact,
the loss to 1e-5 relative and the (icv, alpha) gradients to 1e-4 relative
(max-abs error over max-abs value), converted params bit-equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from licv_vqa_tpu.infer.decode import beam_generate as jx_beam
from licv_vqa_tpu.infer.decode import greedy_generate as jx_greedy
from licv_vqa_tpu.icv import encoder as jx_encoder
from licv_vqa_tpu.icv import module as jx_module
from licv_vqa_tpu.models import decoder as jx_decoder
from licv_vqa_tpu.models import idefics2 as jx
from licv_vqa_tpu.models import layers as jx_layers
from licv_vqa_tpu.models import vision as jx_vision
from licv_vqa_tpu_torch.icv import module as pt_module
from licv_vqa_tpu_torch.icv.encoder import GlobalICVEncoder
from licv_vqa_tpu_torch.infer.decode import beam_generate as pt_beam
from licv_vqa_tpu_torch.infer.decode import greedy_generate as pt_greedy
from licv_vqa_tpu_torch.models import decoder as pt_decoder
from licv_vqa_tpu_torch.models import idefics2 as pt
from licv_vqa_tpu_torch.models import layers as pt_layers
from licv_vqa_tpu_torch.models import vision as pt_vision
from licv_vqa_tpu_torch.models.weights import params_from_jax

ATOL = 1e-4
EOS, PAD, IMG = 2, 0, 118
N_LAT = 4  # tiny image_seq_len


def _perturb(tree, rng):
    """Constant leaves (unit norms and latents, zero biases) get noise."""
    if isinstance(tree, dict):
        return {k: _perturb(v, rng) for k, v in tree.items()}
    x = np.asarray(tree)
    if x.dtype.kind == "f" and np.all(x == x.flat[0]):
        x = x + (rng.normal(size=x.shape) * 0.1).astype(x.dtype)
    return x


@functools.cache
def _jax_params(seed: int, image_size: int):
    jcfg = jx.Idefics2Config.tiny(dtype=jnp.float32)
    jcfg = dataclasses.replace(jcfg, vision=dataclasses.replace(jcfg.vision, image_size=image_size))
    tree = jax.tree.map(np.asarray, jx.init_idefics2_params(jax.random.PRNGKey(seed), jcfg))
    return jcfg, _perturb(tree, np.random.default_rng(seed + 100))


def tiny_pair(seed: int = 0, image_size: int = 28):
    """(jax cfg, jax params, port cfg, port params) of one numpy tree.
    ``image_size`` 56 gives a 4x4 position table, so NaViT grids smaller
    than it bucketize non-trivially."""
    jcfg, tree = _jax_params(seed, image_size)
    pcfg = pt.Idefics2Config.tiny(dtype=torch.float32)
    pcfg = dataclasses.replace(pcfg, vision=dataclasses.replace(pcfg.vision, image_size=image_size))
    return jcfg, jax.tree.map(jnp.asarray, tree), pcfg, params_from_jax(tree, torch.float32)


def tiny_inputs(rng, bs=2, s=20, n_img=2, navit=False):
    """Left-padded prompts with one run of 4 ``<image>`` tokens per image;
    ``navit``: 42x28 batch-padded pixels with a pixel mask (row 1's images
    are 28x14 and 42x14, the padding zeroed as the HF processor leaves it)."""
    ids = rng.integers(3, 110, size=(bs, s)).astype(np.int32)
    mask = np.ones((bs, s), np.int32)
    mask[1, :3], ids[1, :3] = 0, PAD
    for start in (3, 11)[:n_img]:
        ids[:, start : start + N_LAT] = IMG
    hw = (42, 28) if navit else (28, 28)
    pixels = rng.normal(size=(bs, n_img) + hw + (3,)).astype(np.float32)
    valid = np.ones((bs, n_img), bool)
    pmask = None
    if navit:
        pmask = np.ones((bs, n_img) + hw, np.int32)
        pmask[1, 0, 28:, :] = 0
        pmask[1, 0, :, 14:] = 0
        pmask[1, 1, :, 14:] = 0
        pixels[pmask == 0] = 0.0
    else:
        valid[1, 1] = False  # a padded image slot: its latents are zeroed
    return ids, mask, pixels, valid, pmask


@pytest.mark.parametrize("with_mask", [False, True])
def test_siglip_tower_matches_jax(with_mask):
    """NaViT position ids, no class token, patch bias, post-LN; with the
    patch mask the padded patches are masked out as keys."""
    jcfg, jparams, pcfg, pparams = tiny_pair(image_size=56)
    rng = np.random.default_rng(0)
    pixels = rng.normal(size=(3, 42, 28, 3)).astype(np.float32)
    patch_mask = None
    if with_mask:
        patch_mask = np.ones((3, 3, 2), bool)
        patch_mask[1, 2:, :] = False
        patch_mask[2, :, 1:] = False
    want = jx_vision.vision_forward(
        jcfg.vision, jparams["vision"], jnp.asarray(pixels),
        patch_mask=None if patch_mask is None else jnp.asarray(patch_mask),
    )
    got = pt_vision.vision_forward(
        pcfg.vision, pparams["vision"], torch.from_numpy(pixels),
        patch_mask=None if patch_mask is None else torch.from_numpy(patch_mask),
    )
    assert "class_embed" not in pparams["vision"] and got.shape == (3, 6, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_navit_position_ids_match_jax_at_bucket_boundaries():
    side = 70
    for nb_h, nb_w in [(70, 70), (35, 70), (45, 27), (7, 10), (64, 69), (28, 50), (34, 45)]:
        mask = np.zeros((1, 70, 70), bool)
        mask[0, :nb_h, :nb_w] = True
        want = np.asarray(jx_vision.navit_position_ids(70, 70, side, jnp.asarray(mask)))
        got = pt_vision.navit_position_ids(70, 70, side, torch.from_numpy(mask)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"nb=({nb_h},{nb_w})")


@pytest.mark.parametrize("navit", [False, True])
def test_encode_images2_matches_jax(navit):
    jcfg, jparams, pcfg, pparams = tiny_pair(image_size=56 if navit else 28)
    _, _, pixels, _, pmask = tiny_inputs(np.random.default_rng(1), navit=navit)
    want = jx.encode_images2(
        jcfg, jparams, jnp.asarray(pixels),
        pixel_attention_mask=None if pmask is None else jnp.asarray(pmask),
    )
    got = pt.encode_images2(
        pcfg, pparams, torch.from_numpy(pixels),
        pixel_attention_mask=None if pmask is None else torch.from_numpy(pmask),
    )
    assert got.shape == (2, 2, N_LAT, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_patch_mask_and_merge_image_embeds_match_jax():
    rng = np.random.default_rng(2)
    ids, _, _, _, pmask = tiny_inputs(rng, navit=True)
    pm = pmask.reshape((-1,) + pmask.shape[2:])
    np.testing.assert_array_equal(
        pt.patch_mask_from_pixel_mask(torch.from_numpy(pm), 14).numpy(),
        np.asarray(jx.patch_mask_from_pixel_mask(jnp.asarray(pm), 14)),
    )
    embeds = rng.normal(size=(2, 20, 64)).astype(np.float32)
    latents = rng.normal(size=(2, 2, N_LAT, 64)).astype(np.float32)
    want = jx.merge_image_embeds(jnp.asarray(ids), jnp.asarray(embeds), jnp.asarray(latents), IMG)
    got = pt.merge_image_embeds(
        torch.from_numpy(ids), torch.from_numpy(embeds), torch.from_numpy(latents), IMG
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def icv_pair(rng, flags=None):
    rows = (rng.normal(size=(4, 64)) * 0.5).astype(np.float32)
    if flags is None:
        return jnp.asarray(rows), torch.from_numpy(rows)
    return (
        (jnp.asarray(rows), jnp.asarray(np.asarray(flags))),
        (torch.from_numpy(rows), list(flags)),
    )


def _binds(ids, pixels, valid, pmask, jicv, picv, max_len, image_size=28, eos=EOS):
    jcfg, jparams, pcfg, pparams = tiny_pair(image_size=image_size)
    jkw = {} if pmask is None else {"pixel_attention_mask": jnp.asarray(pmask)}
    pkw = {} if pmask is None else {"pixel_attention_mask": torch.from_numpy(pmask)}
    jf = jx.make_idefics2_forward_fns(jcfg, eos)[1](
        jparams, jnp.asarray(pixels), jnp.asarray(valid), jnp.asarray(ids), jicv, max_len, **jkw
    )
    pf = pt.make_idefics2_forward_fns(pcfg, eos)[1](
        pparams, torch.from_numpy(pixels), torch.from_numpy(valid), torch.from_numpy(ids),
        picv, max_len, **pkw,
    )
    return jf, pf


@pytest.mark.parametrize("case", ["plain", "icv", "icv_subset", "navit_icv"])
def test_bind_images_prefill_and_steps_match_jax(case):
    """Prefill logits and two cached greedy steps, with the ICV at every
    layer's MLP output, on a subset of layers, and with NaViT masks."""
    rng = np.random.default_rng(3)
    navit = case.startswith("navit")
    ids, mask, pixels, valid, pmask = tiny_inputs(rng, navit=navit)
    jicv = picv = None
    if "icv" in case:
        jicv, picv = icv_pair(rng, flags=[True, False, True, True] if "subset" in case else None)
    jf, pf = _binds(ids, pixels, valid, pmask, jicv, picv, ids.shape[1] + 3,
                    image_size=56 if navit else 28)
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
    jl, jc = jf(jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(pos), None)
    pl, pc = pf(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(pos), None)
    assert pl.shape == (2, 1, 120)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    nxt = pos[:, -1:] + 1
    for _ in range(2):
        tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
        one = np.ones_like(tok)
        jl, jc = jf(jnp.asarray(tok), jnp.asarray(one), jnp.asarray(nxt), jc)
        pl, pc = pf(torch.from_numpy(tok), torch.from_numpy(one), torch.from_numpy(nxt), pc)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
        nxt = nxt + 1


def _decode(kind, eos):
    rng = np.random.default_rng(4)
    ids, mask, pixels, valid, _ = tiny_inputs(rng)
    jicv, picv = icv_pair(rng)
    jf, pf = _binds(ids, pixels, valid, None, jicv, picv, ids.shape[1] + 6, eos=eos)
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


def _train_batch(rng, navit):
    """Right-padded student and teacher views (one and two images a row),
    the last row a batch filler; ``navit`` adds 42x28 pixel masks."""
    bs, s_stu, s_tea = 3, 14, 28
    stu = np.full((bs, s_stu), PAD, np.int32)
    tea = np.full((bs, s_tea), PAD, np.int32)
    qx, icl = np.zeros(bs, np.int32), np.zeros(bs, np.int32)
    for b in range(bs - 1):
        shot = [IMG] * N_LAT + list(rng.integers(3, 100, size=rng.integers(3, 6)))
        query = [IMG] * N_LAT + list(rng.integers(3, 100, size=rng.integers(2, 4)))
        ans = list(rng.integers(3, 100, size=rng.integers(1, 3))) + [EOS]
        stu[b, : len(query) + len(ans)] = query + ans
        tea[b, : len(shot) + len(query) + len(ans)] = shot + query + ans
        qx[b], icl[b] = len(query), len(shot) + len(query)
    hw = (42, 28) if navit else (28, 28)

    def view(ids, n_img):
        out = {
            "input_ids": ids,
            "attention_mask": (ids != PAD).astype(np.int32),
            "pixel_values": rng.normal(size=(bs, n_img) + hw + (3,)).astype(np.float32),
            "pixel_valid": np.ones((bs, n_img), bool),
        }
        if navit:
            pm = np.ones((bs, n_img) + hw, np.int32)
            pm[0, 0, 28:, :] = 0
            pm[1, -1, :, 14:] = 0
            out["pixel_attention_mask"] = pm
        return out

    return {"query_inputs": view(stu, 1), "inputs": view(tea, 2),
            "query_x_length": qx, "in_context_length": icl}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("navit", [False, True])
def test_train_forward_loss_and_grads_match_icv_loss_fn(navit):
    """``icv_loss_fn`` through the train forward (per-layer recompute,
    gather-before-head teacher); with ``navit`` the batch carries an
    explicit ``pixel_attention_mask``, which reaches both towers."""
    size = 56 if navit else 28
    jcfg, jparams, pcfg, pparams = tiny_pair(image_size=size)
    rng = np.random.default_rng(5)
    batch = _train_batch(rng, navit)
    icv = {"icv": (rng.normal(size=(4, 64)) * 0.5).astype(np.float32),
           "alpha": np.full((4,), 0.3, np.float32)}
    jfwd = jx.make_idefics2_forward_fns(jcfg, EOS)[0]
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
    pfwd = pt.make_idefics2_forward_fns(pcfg, EOS)[0]
    got, _ = pt_module.icv_loss_fn(
        penc, torch.tensor(1.5), pparams, _to_torch(batch), pfwd,
        pt_module.ICVModuleConfig(hard_loss_weight=0.5, init_temperature=1.5), PAD,
        lambda p, h: pt_decoder.logits_from_hidden(pcfg.text, p, h),
    )
    d_icv, d_alpha = torch.autograd.grad(got, (penc.icv, penc.alpha))
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    assert _rel(d_icv.numpy(), grads["icv"]) <= 1e-4
    assert _rel(d_alpha.numpy(), grads["alpha"]) <= 1e-4
    if navit:  # the mask changes the teacher, so it was not dropped
        plain = {k: {kk: vv for kk, vv in v.items() if kk != "pixel_attention_mask"}
                 if isinstance(v, dict) else v for k, v in batch.items()}
        with torch.no_grad():
            other, _ = pt_module.icv_loss_fn(
                penc, torch.tensor(1.5), pparams, _to_torch(plain), pfwd,
                pt_module.ICVModuleConfig(hard_loss_weight=0.5, init_temperature=1.5), PAD,
            )
        assert abs(float(other) - float(got.detach())) > 1e-4


def test_collator_hands_the_pixel_mask_to_the_train_forward():
    """With NaViT variable resolution the port's collator emits
    ``pixel_attention_mask`` for the student and teacher views, which
    ``batch_to_device`` carries to the train forward's ``inputs``."""
    from licv_vqa_tpu_torch.data.collator import collate_icv_batch
    from licv_vqa_tpu_torch.data.processor import ImageTransform, PromptProcessor
    from licv_vqa_tpu_torch.data.tokenizer import WhitespaceTokenizer
    from licv_vqa_tpu_torch.train.trainer import batch_to_device

    proc = PromptProcessor(
        WhitespaceTokenizer(), ImageTransform(56, variable_resolution=True, min_edge=28,
                                              max_edge=56),
        family="idefics2", image_seq_len=N_LAT,
    )
    rng = np.random.default_rng(6)
    img = lambda h, w: rng.integers(0, 255, size=(h, w, 3)).astype(np.uint8)  # noqa: E731
    rows = [{"query_prompt": [img(56, 28), "Question:a? Short answer:b"],
             "query_x": [img(56, 28), "Question:a? Short answer:"],
             "ice_prompt": [img(28, 56), "Question:c? Short answer:d."]},
            {"query_prompt": [img(28, 56), "Question:e? Short answer:f"],
             "query_x": [img(28, 56), "Question:e? Short answer:"],
             "ice_prompt": [img(56, 28), "Question:g? Short answer:h."]}]
    batch = batch_to_device(collate_icv_batch(rows, proc), "cpu")
    for view in ("query_inputs", "inputs"):
        pm = batch[view]["pixel_attention_mask"]
        assert pm.shape == batch[view]["pixel_values"].shape[:-1]
        assert 0 < int(pm.sum()) < pm.numel()  # padded: a tall and a wide image


@pytest.mark.parametrize("remat", [False, True])
def test_causal_lm_forward_matches_jax(remat):
    """The plain stacked decoder (Mistral GQA, MLP-site ICV): the no-cache
    forward with per-layer recompute, and a cached prefill plus one step."""
    cfg = jx.Idefics2Config.tiny(dtype=jnp.float32).text
    tree = _perturb(jax.tree.map(np.asarray, jx_decoder.init_decoder_params(
        jax.random.PRNGKey(7), cfg)), np.random.default_rng(7))
    pcfg = pt.Idefics2Config.tiny(dtype=torch.float32).text
    pparams = params_from_jax(tree, torch.float32)
    rng = np.random.default_rng(8)
    ids = rng.integers(3, 110, size=(2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.int32)
    mask[1, :4] = 0
    rows = (rng.normal(size=(4, 64)) * 0.5).astype(np.float32)
    want, _ = jx_decoder.causal_lm_forward(
        cfg, jax.tree.map(jnp.asarray, tree), jnp.asarray(ids), jnp.asarray(mask),
        icv_scaled=jnp.asarray(rows), remat=remat,
    )
    icv = torch.from_numpy(rows).requires_grad_(remat)
    got, cache = pt_decoder.causal_lm_forward(
        pcfg, pparams, torch.from_numpy(ids), torch.from_numpy(mask), icv_scaled=icv,
        remat=remat,
    )
    assert cache is None
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)
    if remat:
        got.sum().backward()
        assert icv.grad is not None and torch.isfinite(icv.grad).all()
        return
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
    jc = jx_decoder.init_kv_cache(cfg, 2, 14)
    pc = pt_decoder.init_kv_cache(pcfg, 2, 14, "cpu")
    jl, jc = jx_decoder.causal_lm_forward(
        cfg, jax.tree.map(jnp.asarray, tree), jnp.asarray(ids), jnp.asarray(mask),
        icv_scaled=jnp.asarray(rows), cache=jc, positions=jnp.asarray(pos),
        prefill_flash=jnp.asarray(mask))
    pl, pc = pt_decoder.causal_lm_forward(
        pcfg, pparams, torch.from_numpy(ids), torch.from_numpy(mask),
        icv_scaled=torch.from_numpy(rows), cache=pc, positions=torch.from_numpy(pos),
        prefill_flash=torch.from_numpy(mask))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
    one, nxt = np.ones_like(tok), pos[:, -1:] + 1
    jl, _ = jx_decoder.causal_lm_forward(
        cfg, jax.tree.map(jnp.asarray, tree), jnp.asarray(tok), jnp.asarray(one),
        icv_scaled=jnp.asarray(rows), cache=jc, positions=jnp.asarray(nxt))
    pl, _ = pt_decoder.causal_lm_forward(
        pcfg, pparams, torch.from_numpy(tok), torch.from_numpy(one),
        icv_scaled=torch.from_numpy(rows), cache=pc, positions=torch.from_numpy(nxt))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)


def test_convert_idefics2_equals_jax_converter():
    from licv_vqa_tpu.models.convert import convert_idefics2 as jx_convert
    from licv_vqa_tpu.models.convert import hf_state_dict
    from licv_vqa_tpu_torch.models.convert import convert_idefics2 as pt_convert
    from tests.test_idefics2_parity import _tiny_hf_idefics2

    sd = hf_state_dict(_tiny_hf_idefics2())
    want = jx_convert(sd, jx.Idefics2Config.tiny(), dtype=jnp.float32)
    got = pt_convert({k: torch.from_numpy(v) for k, v in sd.items()},
                     pt.Idefics2Config.tiny(), dtype=torch.float32)

    def compare(w, g, path=""):
        if isinstance(w, dict):
            assert set(w) == set(g), path
            for k in w:
                compare(w[k], g[k], f"{path}/{k}")
            return
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, path
        np.testing.assert_array_equal(g.numpy(), w, err_msg=path)

    compare(want, got)

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return tuple(tree.shape)

    # the converted tree has the structure and shapes the port's init builds
    init = pt.init_idefics2_params(torch.Generator().manual_seed(0), pt.Idefics2Config.tiny(),
                                   "cpu")
    assert shapes(init) == shapes(got)


def _bidir_inputs(rng, b=2, s=150, h=2, dh=72):
    q, k, v = (rng.normal(size=(b, s, h, dh)).astype(np.float32) for _ in range(3))
    valid = np.ones((b, s), bool)
    valid[0, 97:] = False  # a batch-padded image: its tail patches invalid
    valid[-1, ::7] = False
    return q, k, v, valid


@pytest.mark.parametrize("masked", [False, True])
def test_flash_bidir_reference_is_the_segment_rule(masked):
    """The plain version against JAX's statement of the rule,
    ``dot_product_attention`` with the ``valid[q] == valid[k]`` mask, on
    every row; the CPU wrapper takes the plain version."""
    q, k, v, valid = _bidir_inputs(np.random.default_rng(9))
    jmask = (valid[:, None, :] == valid[:, :, None])[:, None] if masked else None
    want = jx_layers.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=None if jmask is None else jnp.asarray(jmask))
    args = [torch.from_numpy(x) for x in (q, k, v)] + [
        torch.from_numpy(valid) if masked else None]
    got = pt_layers.flash_attention_bidir_reference(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    before = pt_layers.flash_attention_bidir.launches
    np.testing.assert_array_equal(pt_layers.flash_attention_bidir(*args).numpy(), got.numpy())
    assert pt_layers.flash_attention_bidir.launches == before  # no kernel on the CPU


def test_flash_bidir_reference_matches_interpreted_pallas_kernel(monkeypatch):
    """JAX's own kernel (``flash_attention_bidir_tpu``) under the Pallas
    interpreter: equal on every real row.  Invalid rows differ by
    convention: JAX pads S to a multiple of 128 with keys of the invalid
    segment, which those rows then attend (ROADMAP Queue 3)."""
    from jax.experimental.pallas.ops.tpu import flash_attention as upstream

    monkeypatch.setattr(upstream.pl, "pallas_call",
                        functools.partial(upstream.pl.pallas_call, interpret=True))
    q, k, v, valid = _bidir_inputs(np.random.default_rng(10), s=140)
    want = np.asarray(jx_layers.flash_attention_bidir_tpu(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), valid=jnp.asarray(valid)))
    got = pt_layers.flash_attention_bidir_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-5, rtol=0)
    assert np.abs(got[~valid] - want[~valid]).max() > 1e-3  # the convention shows


def test_flash_bidir_gate(monkeypatch):
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    monkeypatch.delenv("LICV_VIT_FLASH", raising=False)
    assert pt_layers.flash_bidir_usable(1024, cuda) and not pt_layers.flash_bidir_usable(1023, cuda)
    assert not pt_layers.flash_bidir_usable(4900, cpu)
    monkeypatch.setenv("LICV_VIT_FLASH", "0")
    assert not pt_layers.flash_bidir_usable(4900, cuda)
