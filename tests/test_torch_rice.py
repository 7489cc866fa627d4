"""Port vs JAX: RICE retrieval (``retrieval/rice.py``) on the CPU.

The port's ``MMTopkRetriever`` must return exactly JAX's indices, ties
included, over ``HashEncoder`` (its features equal JAX's bit for bit) and
over the tiny CLIP encoder (each side's towers on one param tree), with
every index image in several rows so that scores tie exactly, as VQAv2's
~5 questions an image make them.  Also: the top-k cache across shot counts
and ``reversed_order`` (as ``tests/test_clip_retrieval.py:88-160`` holds
JAX's), the cache file in both directions, the text modes, and how the
default encoder is picked.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from licv_vqa_tpu.models import clip as jx_clip
from licv_vqa_tpu.retrieval import rice as jx_rice
from licv_vqa_tpu_torch.models import clip as pt_clip
from licv_vqa_tpu_torch.models.weights import params_from_jax
from licv_vqa_tpu_torch.retrieval import rice as pt_rice

MODES = ("i2i", "i2t", "t2i", "t2t")


def _rows(n_images: int, copies: int, seed: int, pil: bool = False):
    """Index rows: each of ``n_images`` images in ``copies`` rows,
    interleaved (row i holds image i % n_images), each with its own text;
    PIL images where ``pil`` (``HashEncoder`` converts and resizes them)."""
    rng = np.random.default_rng(seed)
    imgs = [rng.normal(size=(32, 32, 3)).astype(np.float32) for _ in range(n_images)]
    if pil:
        imgs = [Image.fromarray(rng.integers(0, 255, size=(32, 32, 3), dtype=np.uint8))
                for _ in range(n_images)]
    words = ["red", "blue", "cat", "two", "dog"]
    return [{"image": imgs[i % n_images], "question": f"what {words[i % 5]} {i // 3}?"}
            for i in range(n_images * copies)]


@pytest.fixture(scope="module")
def clip_pair():
    jcfg = jx_clip.ClipConfig.tiny()
    jparams = jax.tree.map(np.asarray, jx_clip.init_clip_params(jax.random.PRNGKey(1), jcfg))
    return jcfg, jax.tree.map(jnp.asarray, jparams), pt_clip.ClipConfig.tiny(), params_from_jax(jparams)


def _tokenize(texts, s=10, v=128):
    """Deterministic right-padded ids: the text's bytes, then EOT (the
    highest id) and padding."""
    ids = np.zeros((len(texts), s), np.int64)
    mask = np.zeros((len(texts), s), np.int64)
    for r, t in enumerate(texts):
        body = [3 + b % (v - 4) for b in t.encode()][: s - 1] + [v - 1]
        ids[r, : len(body)], mask[r, : len(body)] = body, 1
    return ids, mask


class _JaxClip:
    """JAX's towers on injected inputs (its own encoder needs a
    ``CLIPProcessor``)."""

    def __init__(self, cfg, params):
        self.cfg, self.params = cfg, params

    def encode_images(self, images):
        px = np.stack([np.asarray(im, np.float32) for im in images])
        return np.asarray(jx_clip.clip_image_features(self.cfg, self.params, jnp.asarray(px)))

    def encode_texts(self, texts):
        ids, mask = _tokenize(texts)
        return np.asarray(jx_clip.clip_text_features(
            self.cfg, self.params, jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32)))


def _port_clip(cfg, params, batch_size=3):
    return pt_rice.ClipTowerEncoder(
        cfg, params, preprocess=lambda ims: np.stack([np.asarray(im, np.float32) for im in ims]),
        tokenize=_tokenize, batch_size=batch_size, device="cpu",
    )


def _assert_ties_lower_first(retriever, rows):
    """Within each row, index rows of equal features (which score equal)
    appear in increasing index order; returns how many such pairs."""
    feats, pairs = retriever.index_feats, 0
    for row in rows:
        for a, b in zip(row, row[1:]):
            if np.array_equal(feats[a], feats[b]):
                assert a < b, row
                pairs += 1
    return pairs


def test_hash_encoder_equals_jax_bit_for_bit():
    rows = _rows(4, 2, seed=0, pil=True) + _rows(3, 1, seed=1)
    texts = [r["question"] for r in rows]
    images = [r["image"] for r in rows]
    np.testing.assert_array_equal(pt_rice.HashEncoder().encode_images(images),
                                  jx_rice.HashEncoder().encode_images(images))
    np.testing.assert_array_equal(pt_rice.HashEncoder().encode_texts(texts),
                                  jx_rice.HashEncoder().encode_texts(texts))


@pytest.mark.parametrize("mode", MODES)
def test_indices_equal_jax_over_hash_encoder_with_ties(mode):
    index_ds = _rows(8, 5, seed=2, pil=True)  # 40 rows, each image 5 times
    test_ds = _rows(8, 1, seed=2, pil=True)[:6]
    kw = dict(mode=mode, index_field="image" if mode[-1] == "i" else "question",
              test_field="image" if mode[0] == "i" else "question")
    got = pt_rice.MMTopkRetriever(index_ds, test_ds, encoder=pt_rice.HashEncoder(),
                                  device="cpu", **kw)
    want = jx_rice.MMTopkRetriever(index_ds, test_ds, encoder=jx_rice.HashEncoder(), **kw)
    for k in (1, 5, 32):
        rows = got.retrieve(k)
        assert rows == want.retrieve(k), (mode, k)
        ties = _assert_ties_lower_first(got, rows)
    assert mode[-1] == "t" or ties > 0
    if mode == "i2i":
        # the test image's five copies lead its row, lowest index first
        assert got.retrieve(5)[0] == [0, 8, 16, 24, 32]


@pytest.mark.parametrize("mode", MODES)
def test_indices_equal_jax_over_the_tiny_clip_encoder(clip_pair, mode):
    jcfg, jparams, pcfg, pparams = clip_pair
    index_ds = _rows(6, 4, seed=3)
    test_ds = _rows(6, 1, seed=3)[:4] + _rows(2, 1, seed=4)
    kw = dict(mode=mode, index_field="image" if mode[-1] == "i" else "question",
              test_field="image" if mode[0] == "i" else "question")
    got = pt_rice.MMTopkRetriever(index_ds, test_ds, encoder=_port_clip(pcfg, pparams),
                                  device="cpu", **kw)
    want = jx_rice.MMTopkRetriever(index_ds, test_ds, encoder=_JaxClip(jcfg, jparams), **kw)
    np.testing.assert_allclose(got.index_feats, want.index_feats, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.test_feats, want.test_feats, atol=1e-5, rtol=0)
    # identical features where JAX's are fed in: the ranking alone decides
    same = pt_rice.MMTopkRetriever(index_ds, test_ds, device="cpu", encoder=_JaxClip(jcfg, jparams), **kw)
    for k in (1, 4, 24):
        assert same.retrieve(k) == want.retrieve(k), (mode, k)
        _assert_ties_lower_first(same, same.retrieve(k))
    assert got.retrieve(4) == want.retrieve(4), mode


def test_topk_cache_across_shot_counts_and_reversed_order(clip_pair):
    """One ranking (at the largest k, at least 32 where the index holds 32
    rows) serves every shot count, equal to fresh per-k rankings; and
    ``reversed_order`` flips each row most-similar-last."""
    _, _, pcfg, pparams = clip_pair
    index_ds = _rows(12, 3, seed=5)
    test_ds = [{"image": index_ds[1]["image"]}, {"image": index_ds[6]["image"]}]
    enc = _port_clip(pcfg, pparams)
    r = pt_rice.MMTopkRetriever(index_ds, test_ds, encoder=enc, device="cpu")
    for k in (1, 4, 8):
        fresh = pt_rice.MMTopkRetriever(index_ds, test_ds, encoder=enc, device="cpu")
        assert r.retrieve(k) == fresh.retrieve(k)
    assert r._topk_cache.shape[1] == 32
    assert r.retrieve(3)[0] == [1, 13, 25] and r.retrieve(3)[1] == [6, 18, 30]
    assert r.retrieve(40)[0][:3] == [1, 13, 25] and r._topk_cache.shape[1] == 36
    rev = pt_rice.MMTopkRetriever(index_ds, test_ds, encoder=enc, device="cpu",
                                  reversed_order=True)
    for k in (1, 3, 6):
        assert rev.retrieve(k) == [list(reversed(row)) for row in r.retrieve(k)]
    assert rev.retrieve(3)[0][-1] == 1


def test_small_index_and_chunked_scores(monkeypatch):
    """An index under 32 rows ranks exactly k; test rows in chunks of one
    (``SCORE_CHUNK_BYTES`` tiny) give the same rows."""
    index_ds = _rows(5, 2, seed=6, pil=True)
    test_ds = _rows(5, 1, seed=6, pil=True)
    r = pt_rice.MMTopkRetriever(index_ds, test_ds, encoder=pt_rice.HashEncoder(), device="cpu")
    want = r.retrieve(3)
    assert r._topk_cache.shape[1] == 3
    monkeypatch.setattr(pt_rice, "SCORE_CHUNK_BYTES", 1)
    r2 = pt_rice.MMTopkRetriever(index_ds, test_ds, encoder=pt_rice.HashEncoder(), device="cpu")
    assert r2.retrieve(3) == want == jx_rice.MMTopkRetriever(
        index_ds, test_ds, encoder=jx_rice.HashEncoder()).retrieve(3)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_file_read_across_packages(tmp_path, writer):
    """``{"index", "test", "mode"}`` written by one package loads in the
    other with no encoding (the reader's encoder would raise), and a cache
    of another mode is ignored."""
    index_ds, test_ds = _rows(6, 3, seed=7, pil=True), _rows(6, 1, seed=8, pil=True)
    cache = tmp_path / "cache" / "vqav2_4_rice_imgemb.pkl"
    if writer == "jax":
        first = jx_rice.MMTopkRetriever(index_ds, test_ds, encoder=jx_rice.HashEncoder(),
                                        cache_file=str(cache))
    else:
        first = pt_rice.MMTopkRetriever(index_ds, test_ds, encoder=pt_rice.HashEncoder(),
                                        cache_file=str(cache), device="cpu")
    saved = torch.load(cache, weights_only=False)
    assert set(saved) == {"index", "test", "mode"} and saved["mode"] == "i2i"

    class NoEncode:
        def encode_images(self, images):
            raise AssertionError("a cache hit encodes nothing")

        encode_texts = encode_images

    if writer == "jax":
        second = pt_rice.MMTopkRetriever(index_ds, test_ds, encoder=NoEncode(),
                                         cache_file=str(cache), device="cpu")
    else:
        second = jx_rice.MMTopkRetriever(index_ds, test_ds, encoder=NoEncode(),
                                         cache_file=str(cache))
    assert second.retrieve(4) == first.retrieve(4)
    with pytest.raises(AssertionError, match="encodes nothing"):
        pt_rice.MMTopkRetriever(index_ds, test_ds, mode="t2i", encoder=NoEncode(),
                                cache_file=str(cache), device="cpu", test_field="question")


def test_default_encoder_choice(tmp_path, monkeypatch):
    """No ``$CLIP_CPK_DIR``: ``HashEncoder``.  With one: the CLIP towers,
    the host encoder where a file or package is missing or
    ``RICE_ENCODER=torch``; any other failure of the towers raises."""
    made = []

    class HostStub:
        def __init__(self, path, batch_size):
            made.append(("host", path, batch_size))

    monkeypatch.setattr(pt_rice, "ClipEncoder", HostStub)
    monkeypatch.delenv("CLIP_CPK_DIR", raising=False)
    monkeypatch.delenv("RICE_ENCODER", raising=False)
    assert isinstance(pt_rice._default_encoder(8, "cpu"), pt_rice.HashEncoder)
    monkeypatch.setenv("CLIP_CPK_DIR", str(tmp_path / "missing"))
    assert isinstance(pt_rice._default_encoder(8, "cpu"), pt_rice.HashEncoder)

    monkeypatch.setenv("CLIP_CPK_DIR", str(tmp_path))
    tower = object()
    monkeypatch.setattr(pt_rice.ClipTowerEncoder, "from_pretrained",
                        classmethod(lambda cls, path, bs, dev: tower))
    assert pt_rice._default_encoder(8, "cpu") is tower
    for err in (FileNotFoundError("no weights"), ImportError("no transformers"), OSError("x")):
        def fail(cls, path, bs, dev, err=err):
            raise err

        monkeypatch.setattr(pt_rice.ClipTowerEncoder, "from_pretrained", classmethod(fail))
        assert isinstance(pt_rice._default_encoder(4, "cpu"), HostStub)
    assert made[-1] == ("host", str(tmp_path), 4)

    def broken(cls, path, bs, dev):
        raise RuntimeError("a fault of the towers")

    monkeypatch.setattr(pt_rice.ClipTowerEncoder, "from_pretrained", classmethod(broken))
    with pytest.raises(RuntimeError, match="towers"):
        pt_rice._default_encoder(4, "cpu")
    monkeypatch.setenv("RICE_ENCODER", "torch")
    assert isinstance(pt_rice._default_encoder(4, "cpu"), HostStub)


def test_tower_encoder_batches_equal_one_batch(clip_pair):
    """Features do not depend on the encoder's batch size (7 rows in
    batches of 3, 2, 7)."""
    _, _, pcfg, pparams = clip_pair
    rows = _rows(7, 1, seed=9)
    images, texts = [r["image"] for r in rows], [r["question"] for r in rows]
    ref_i = _port_clip(pcfg, pparams, 7).encode_images(images)
    ref_t = _port_clip(pcfg, pparams, 7).encode_texts(texts)
    for bs in (2, 3):
        np.testing.assert_allclose(_port_clip(pcfg, pparams, bs).encode_images(images), ref_i,
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(_port_clip(pcfg, pparams, bs).encode_texts(texts), ref_t,
                                   atol=1e-6, rtol=0)
