"""RICE shot retrieval: a CLIP dual encoder and an exact top-k
(counterpart of ``licv_vqa_tpu/retrieval/rice.py``).

Replaces the reference's faiss ``IndexFlatIP`` path (reference:
icv_src/utils/mm_topk_retriver.py): exact inner-product search is one f32
product and a sort on the device.  The feature-cache contract is kept: a
``torch.save`` pickle ``{"index", "test", "mode"}`` of the encoded
features, so a cache the JAX package wrote loads here and the reverse.

Encoders are pluggable: with a LOCAL CLIP checkpoint directory
(``$CLIP_CPK_DIR``) the default is ``ClipTowerEncoder`` (``models/clip.py``,
both towers on the device in f32; the image tower's attention is the f32
fused ViT kernel on the card); ``RICE_ENCODER=torch`` selects transformers'
CLIP on the host (``ClipEncoder``); with no checkpoint, a deterministic
hash encoder (tests, offline runs).

Two numerical rules, each needed for indices equal to JAX's:

- ties go to the LOWER index, as ``jax.lax.top_k`` breaks them (the index
  holds a row per question, about 5 a VQAv2 image, and equal images score
  equal): a stable descending sort, where ``torch.topk`` on the card
  promises no order among ties, over scores that give equal index rows
  equal bits (``topk_lower_index_first``);
- the product is true f32: nothing here turns TF32 on.

The score matrix is formed in chunks of test rows of at most
``SCORE_CHUNK_BYTES`` (the top-k of a row does not depend on the others),
so a full VQAv2 split (214k x 443k, 380 GB of f32 scores) runs too.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..utils.log import get_logger

logger = get_logger("retrieval")

# the scores, the sorted scores and their int64 indices of one chunk of
# test rows stay under this many bytes
SCORE_CHUNK_BYTES = 1 << 30


class HashEncoder:
    """Deterministic, dependency-free featurizer (offline fallback); the
    JAX package's, bit for bit."""

    dim = 64

    def encode_images(self, images: Sequence) -> np.ndarray:
        feats = []
        for img in images:
            arr = np.asarray(
                img.convert("L").resize((8, 8)) if hasattr(img, "convert") else img
            )
            arr = np.resize(np.asarray(arr, np.float32), (self.dim,))
            feats.append(arr)
        return np.stack(feats)

    def encode_texts(self, texts: Sequence[str]) -> np.ndarray:
        feats = []
        for t in texts:
            h = np.zeros(self.dim, np.float32)
            for i, ch in enumerate(t.encode()):
                h[(ch * 31 + i) % self.dim] += 1.0
            feats.append(h)
        return np.stack(feats)


class ClipEncoder:
    """transformers CLIP from a local checkpoint directory, on the host
    (``RICE_ENCODER=torch``)."""

    def __init__(self, model_path: str, batch_size: int = 8):
        from transformers import CLIPModel, CLIPProcessor

        self.model = CLIPModel.from_pretrained(model_path).eval()
        self.processor = CLIPProcessor.from_pretrained(model_path)
        self.batch_size = batch_size

    def encode_images(self, images) -> np.ndarray:
        out = []
        for i in range(0, len(images), self.batch_size):
            batch = self.processor(
                images=list(images[i : i + self.batch_size]), return_tensors="pt"
            )
            with torch.no_grad():
                out.append(self.model.get_image_features(**batch).numpy())
        return np.concatenate(out)

    def encode_texts(self, texts) -> np.ndarray:
        out = []
        for i in range(0, len(texts), self.batch_size):
            batch = self.processor(
                text=list(texts[i : i + self.batch_size]),
                return_tensors="pt",
                padding=True,
                truncation=True,
            )
            with torch.no_grad():
                out.append(self.model.get_text_features(**batch).numpy())
        return np.concatenate(out)


class ClipTowerEncoder:
    """The CLIP dual encoder of ``models/clip.py`` on ``device`` (the
    counterpart of JAX's ``JaxClipEncoder``).

    ``preprocess(images) -> (B, H, W, 3)`` normalized pixels and
    ``tokenize(texts) -> (input_ids, attention_mask)`` are injected host
    callables (numpy or tensors); ``from_pretrained`` builds them from a
    checkpoint's ``CLIPProcessor``.  Features of all batches stay on the
    device until the last, then come back to the host once."""

    def __init__(self, cfg, params: dict, preprocess: Callable, tokenize: Optional[Callable] = None,
                 batch_size: int = 8, device="cuda"):
        self.cfg = cfg
        self.params = params
        self.preprocess = preprocess
        self.tokenize = tokenize
        self.batch_size = batch_size
        self.device = torch.device(device)

    @classmethod
    def from_pretrained(cls, model_path: str, batch_size: int = 8, device="cuda"):
        """Config and processor from transformers' ``CLIPConfig`` /
        ``CLIPProcessor``, weights through the port's loader and
        ``convert_hf_clip``.  A missing file raises ``FileNotFoundError``
        (or ``OSError`` from transformers), a missing package
        ``ImportError``."""
        from transformers import CLIPConfig, CLIPProcessor

        from ..models.clip import ClipConfig, ClipTextConfig, convert_hf_clip
        from ..models.config import VisionConfig
        from ..models.registry import _load_hf_weights

        hf = CLIPConfig.from_pretrained(model_path)
        hv, ht = hf.vision_config, hf.text_config
        cfg = ClipConfig(
            vision=VisionConfig(
                image_size=hv.image_size, patch_size=hv.patch_size, d_model=hv.hidden_size,
                n_layers=hv.num_hidden_layers, n_heads=hv.num_attention_heads,
                d_ff=hv.intermediate_size, activation="quick_gelu", dtype=torch.float32,
            ),
            text=ClipTextConfig(
                vocab_size=ht.vocab_size, max_positions=ht.max_position_embeddings,
                d_model=ht.hidden_size, n_layers=ht.num_hidden_layers,
                n_heads=ht.num_attention_heads, d_ff=ht.intermediate_size,
                eos_token_id=ht.eos_token_id,
            ),
            projection_dim=hf.projection_dim,
        )
        sd = _load_hf_weights(Path(model_path))
        if sd is None:
            raise FileNotFoundError(f"no CLIP weights under {model_path}")
        params = convert_hf_clip(sd, cfg, device=device)
        processor = CLIPProcessor.from_pretrained(model_path)

        def preprocess(images):
            px = processor(images=list(images), return_tensors="np")["pixel_values"]
            return np.transpose(px, (0, 2, 3, 1))  # NCHW → NHWC

        def tokenize(texts):
            enc = processor(text=list(texts), return_tensors="np", padding=True,
                            truncation=True)
            return enc["input_ids"], enc["attention_mask"]

        return cls(cfg, params, preprocess, tokenize, batch_size, device)

    def _tensor(self, x, dtype) -> torch.Tensor:
        x = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
        return x.to(device=self.device, dtype=dtype)

    @torch.inference_mode()
    def encode_images(self, images) -> np.ndarray:
        from ..models.clip import clip_image_features

        out = [
            clip_image_features(self.cfg, self.params, self._tensor(
                self.preprocess(images[i : i + self.batch_size]), torch.float32))
            for i in range(0, len(images), self.batch_size)
        ]
        return torch.cat(out).cpu().numpy()

    @torch.inference_mode()
    def encode_texts(self, texts) -> np.ndarray:
        from ..models.clip import clip_text_features

        if self.tokenize is None:
            raise ValueError("ClipTowerEncoder: text modes need a tokenize callable")
        out = []
        for i in range(0, len(texts), self.batch_size):
            ids, mask = self.tokenize(texts[i : i + self.batch_size])
            out.append(clip_text_features(self.cfg, self.params, self._tensor(ids, torch.long),
                                          self._tensor(mask, torch.long)))
        return torch.cat(out).cpu().numpy()


def _default_encoder(batch_size: int, device="cuda"):
    """Under ``$CLIP_CPK_DIR`` the CLIP encoder (the device towers unless
    ``RICE_ENCODER=torch``); with no checkpoint ``HashEncoder``.  Only a
    missing file or package at construction falls back to the host
    encoder: the towers run later, and a failure there raises."""
    path = os.environ.get("CLIP_CPK_DIR")
    if path and Path(path).exists():
        if os.environ.get("RICE_ENCODER", "device") != "torch":
            try:
                enc = ClipTowerEncoder.from_pretrained(path, batch_size, device)
                logger.info("RICE using the CLIP towers on %s from %s", device, path)
                return enc
            except (ImportError, OSError) as e:  # missing weights/processor files
                logger.warning("RICE: CLIP towers unavailable (%s) — torch fallback", e)
        logger.info("RICE using torch CLIP encoder from %s", path)
        return ClipEncoder(path, batch_size)
    logger.warning("RICE: no local CLIP checkpoint — using HashEncoder fallback")
    return HashEncoder()


def _l2_normalize(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-8)


def topk_lower_index_first(test: torch.Tensor, index: torch.Tensor, k: int) -> torch.Tensor:
    """(T, k) int64 indices of the ``k`` largest ``test @ index.T`` scores of
    each test row, ties broken by the lower index (``lax.top_k``'s order),
    in test-row chunks of at most ``SCORE_CHUNK_BYTES``.

    Equal index rows must score EQUAL for the tie rule to see them, and a
    blocked f32 product need not give two equal columns equal bits (the
    CPU's edge columns take another summation order than its full
    blocks).  So the product runs over the distinct index rows once, and
    each row's score is gathered from its distinct row's: equal features,
    one column, equal scores.  VQAv2's ~5 questions an image make that
    about 5x less product work too."""
    distinct, column = torch.unique(index, dim=0, return_inverse=True)
    per_row = distinct.shape[0] * 4 + index.shape[0] * (4 + 4 + 8)  # products, scores, sort
    rows = max(1, SCORE_CHUNK_BYTES // per_row)
    out = []
    for i in range(0, test.shape[0], rows):
        scores = (test[i : i + rows] @ distinct.T)[:, column]
        out.append(torch.sort(scores, dim=-1, descending=True, stable=True)[1][:, :k])
    return torch.cat(out)


class MMTopkRetriever:
    """mode ∈ {i2i, i2t, t2i, t2t}: test-side query → index-side keys.
    ``device``: where the similarity product and the sort run (and the
    default encoder's towers), the CUDA device unless given."""

    def __init__(
        self,
        index_ds,
        test_ds,
        mode: str = "i2i",
        index_field: str = "image",
        test_field: Optional[str] = None,
        batch_size: int = 8,
        num_workers: int = 0,
        cache_file: Optional[str] = None,
        encoder=None,
        device=None,
        reversed_order: bool = False,
    ):
        del num_workers  # no host loader threads
        self.device = torch.device(device if device is not None else "cuda")
        self.mode = mode
        self.reversed_order = reversed_order
        self.index_ds = index_ds
        self.test_ds = test_ds
        self.index_field = index_field
        self.test_field = test_field or index_field
        self.encoder = encoder or _default_encoder(batch_size, self.device)

        feats = self._load_cache(cache_file)
        if feats is None:
            q_kind, k_kind = mode.split("2")[0], mode.split("2")[1]
            index_feats = self._encode(index_ds, self.index_field, k_kind)
            test_feats = self._encode(test_ds, self.test_field, q_kind)
            feats = {"index": index_feats, "test": test_feats, "mode": mode}
            self._save_cache(cache_file, feats)
        self.index_feats = _l2_normalize(np.asarray(feats["index"], np.float32))
        self.test_feats = _l2_normalize(np.asarray(feats["test"], np.float32))

    def _encode(self, ds, field: str, kind: str) -> np.ndarray:
        values = [ds[i][field] for i in range(len(ds))]
        if kind == "i":
            return self.encoder.encode_images(values)
        return self.encoder.encode_texts([str(v) for v in values])

    def _load_cache(self, cache_file):
        if cache_file and Path(cache_file).exists():
            logger.info("RICE cache hit: %s", cache_file)
            cached = torch.load(cache_file, weights_only=False)
            if cached.get("mode") == self.mode:
                return cached
        return None

    def _save_cache(self, cache_file, feats):
        if cache_file:
            Path(cache_file).parent.mkdir(parents=True, exist_ok=True)
            torch.save(feats, cache_file)

    def retrieve(self, ice_num: int) -> list[list[int]]:
        """Exact top-``ice_num`` inner-product search on the device.

        The eval loop calls this once per ``few_shot_list`` entry (reference:
        inference.py:193-216); the ranking is cached at the largest k seen
        so far (at least 32 where the index has 32 rows) and smaller
        requests slice it (the same result: top-k of a fixed scoring is
        prefix monotone).  ``reversed_order`` flips each row most-similar-
        last (reference: icv_src/utils/mm_topk_retriver.py:224-226)."""
        cached = getattr(self, "_topk_cache", None)
        if cached is None or cached.shape[1] < ice_num:
            k = max(ice_num, 32 if self.index_feats.shape[0] >= 32 else ice_num)
            k = min(k, self.index_feats.shape[0])
            test = torch.from_numpy(self.test_feats).to(self.device)
            index = torch.from_numpy(self.index_feats).to(self.device)
            self._topk_cache = topk_lower_index_first(test, index, k).cpu().numpy()
            cached = self._topk_cache
        rows = cached[:, :ice_num].tolist()
        if self.reversed_order:
            rows = [list(reversed(r)) for r in rows]
        return rows
