"""Port vs JAX: the CLIP dual encoder (``models/clip.py``) on the CPU, f32.

Params come from JAX's ``init_clip_params`` (``ClipConfig.tiny``) carried
across with ``params_from_jax``; both sides take the same numpy pixels and
right-padded id rows.  Features agree within atol 1e-5 (f32 on both sides:
they differ by summation order).  Also: ``convert_hf_clip`` on a
tiny-random transformers ``CLIPModel`` equal to JAX's converter, the f32
plain ``vit_attention_reference`` at RICE's head dim against JAX's Pallas
``vit_attention_tpu`` run in interpret mode, and the text tower's causal
mask keeping it off the fused ViT route even where that route is forced
on.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from licv_vqa_tpu.models import clip as jx_clip
from licv_vqa_tpu_torch.models import clip as pt_clip
from licv_vqa_tpu_torch.models import layers as PL
from licv_vqa_tpu_torch.models.weights import params_from_jax

ATOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    jcfg = jx_clip.ClipConfig.tiny()
    jparams = jax.tree.map(np.asarray, jx_clip.init_clip_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    # non-trivial norms and biases, so a dropped or swapped one shows
    for tower in ("vision", "text"):
        layers = jparams[tower]["layers"]
        for ln in ("ln1", "ln2"):
            layers[ln]["w"] = (1 + 0.1 * rng.normal(size=layers[ln]["w"].shape)).astype(np.float32)
            layers[ln]["b"] = (0.1 * rng.normal(size=layers[ln]["b"].shape)).astype(np.float32)
        for key in ("bq", "bk", "bv", "bo"):
            layers["attn"][key] = (0.1 * rng.normal(size=layers["attn"][key].shape)).astype(np.float32)
    pcfg = pt_clip.ClipConfig.tiny()
    return jcfg, jax.tree.map(jnp.asarray, jparams), pcfg, params_from_jax(jparams)


def _text_rows(rng, b=5, s=12, v=128, lengths=(12, 9, 5, 12, 1)):
    ids = rng.integers(1, v - 1, size=(b, s)).astype(np.int32)
    lengths = np.asarray(lengths)
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    ids[np.arange(b), lengths - 1] = v - 1  # EOT = the highest id (HF pools argmax)
    ids[mask == 0] = 0
    return ids, mask


def test_configs_match_jax():
    for name in ("vit_b32", "tiny"):
        j, p = getattr(jx_clip.ClipConfig, name)(), getattr(pt_clip.ClipConfig, name)()
        assert j.projection_dim == p.projection_dim
        for jj, pp in ((j.vision, p.vision), (j.text, p.text)):
            jd = {k: v for k, v in dataclasses.asdict(jj).items() if k != "dtype"}
            pd = {k: v for k, v in dataclasses.asdict(pp).items() if k != "dtype"}
            assert jd == pd, name
        assert p.vision.dtype == p.text.dtype == torch.float32


def test_image_features_match_jax(pair):
    jcfg, jparams, pcfg, pparams = pair
    px = np.random.default_rng(1).normal(size=(3, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jx_clip.clip_image_features(jcfg, jparams, jnp.asarray(px)))
    got = pt_clip.clip_image_features(pcfg, pparams, torch.from_numpy(px))
    assert got.shape == (3, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("eos", [2, 127], ids=["argmax_pool", "first_eos_pool"])
def test_text_features_match_jax_with_padded_rows(pair, eos):
    """Right-padded rows of lengths 12, 9, 5, 12 and 1; pooled at the
    highest id (eos_token_id 2, the OpenAI legacy) or at the first
    ``eos_token_id``."""
    jcfg, jparams, pcfg, pparams = pair
    jcfg = dataclasses.replace(jcfg, text=dataclasses.replace(jcfg.text, eos_token_id=eos))
    pcfg = dataclasses.replace(pcfg, text=dataclasses.replace(pcfg.text, eos_token_id=eos))
    ids, mask = _text_rows(np.random.default_rng(2))
    want = np.asarray(jx_clip.clip_text_features(jcfg, jparams, jnp.asarray(ids),
                                                 jnp.asarray(mask)))
    got = pt_clip.clip_text_features(pcfg, pparams, torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_params_from_jax_carries_the_clip_tree(pair):
    _, jparams, _, pparams = pair
    assert set(pparams) == {"vision", "text", "visual_projection", "text_projection"}
    for key in ("visual_projection", "text_projection"):
        np.testing.assert_array_equal(pparams[key].numpy(), np.asarray(jparams[key]))
    assert pparams["text"]["layers"]["attn"]["wq"].shape == (2, 24, 24)


def test_convert_hf_clip_equals_jax_converter():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.CLIPConfig(
        text_config=dict(vocab_size=128, hidden_size=24, intermediate_size=48,
                         num_hidden_layers=2, num_attention_heads=4,
                         max_position_embeddings=16, eos_token_id=2),
        vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                           num_attention_heads=4, image_size=32, patch_size=8),
        projection_dim=16,
    )
    torch.manual_seed(0)
    hf = transformers.CLIPModel(hf_cfg).eval()
    sd = hf.state_dict()
    want = jax.tree.map(np.asarray, jx_clip.convert_hf_clip(sd, jx_clip.ClipConfig.tiny()))
    got = pt_clip.convert_hf_clip(sd, pt_clip.ClipConfig.tiny())

    def walk(g, w, path=""):
        if isinstance(w, dict):
            assert set(g) == set(w), path
            for k in w:
                walk(g[k], w[k], f"{path}/{k}")
        else:
            assert g.dtype == torch.float32, path
            np.testing.assert_array_equal(g.numpy(), w, err_msg=path)

    walk(got, want)
    px = np.random.default_rng(3).normal(size=(2, 3, 32, 32)).astype(np.float32)
    with torch.no_grad():
        ref = hf.get_image_features(pixel_values=torch.from_numpy(px)).numpy()
    feats = pt_clip.clip_image_features(pt_clip.ClipConfig.tiny(), got,
                                        torch.from_numpy(px.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(feats.numpy(), ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("masked", [False, True], ids=["all_valid", "key_mask"])
def test_vit_attention_f32_reference_matches_interpreted_pallas(monkeypatch, masked):
    """The f32 entry's plain version at (2, 50, 4, 64) against JAX's Pallas
    kernel in interpret mode (``LICV_VIT_ATTN_INTERPRET=1``), whose output
    dtype follows q: f32 in, f32 out, no rounding of P."""
    from licv_vqa_tpu.ops.vit_attention import vit_attention_tpu

    monkeypatch.setenv("LICV_VIT_ATTN_INTERPRET", "1")
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(2, 50, 4, 64)).astype(np.float32) for _ in range(3))
    valid = None
    if masked:
        valid = rng.random((2, 50)) > 0.3
        valid[1, :] = False  # no valid key: the uniform softmax
    want = vit_attention_tpu(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             None if valid is None else jnp.asarray(valid))
    assert want.dtype == jnp.float32
    got = PL.vit_attention_reference(*(torch.from_numpy(x) for x in (q, k, v)),
                                     None if valid is None else torch.from_numpy(valid))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_text_tower_never_takes_the_fused_route(pair, monkeypatch):
    """With the fused ViT route forced on (its gate true on the CPU, its
    wrapper a spy), the image tower takes it at every layer and the text
    tower at none: its causal mask is not a key mask.  The text features
    still equal the plain causal path's."""
    _, _, pcfg, pparams = pair
    ids, mask = _text_rows(np.random.default_rng(5))
    ids_t, mask_t = torch.from_numpy(ids), torch.from_numpy(mask)
    plain = pt_clip.clip_text_features(pcfg, pparams, ids_t, mask_t)
    calls = []

    def spy(q, k, v, valid=None, scale=None):
        calls.append(q.shape)
        return PL.vit_attention_reference(q, k, v, valid, scale)

    monkeypatch.setattr(PL, "vit_attention_usable", lambda s, dh, device: True)
    monkeypatch.setattr(PL, "vit_attention", spy)
    forced = pt_clip.clip_text_features(pcfg, pparams, ids_t, mask_t)
    assert calls == []
    torch.testing.assert_close(forced, plain, rtol=0, atol=0)
    px = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 32, 32, 3)).astype(np.float32))
    pt_clip.clip_image_features(pcfg, pparams, px)
    assert len(calls) == pcfg.vision.n_layers and calls[0] == (2, 17, 4, 8)


def test_init_clip_params_has_jax_layout():
    jtree = jx_clip.init_clip_params(jax.random.PRNGKey(0), jx_clip.ClipConfig.tiny())
    ptree = pt_clip.init_clip_params(torch.Generator().manual_seed(0),
                                     pt_clip.ClipConfig.tiny(), "cpu")

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        return tuple(t.shape)

    assert shapes(ptree) == shapes(jtree)
