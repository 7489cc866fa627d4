"""Multimodal prompt processor: interleaved [image|text] → model tensors.

Replaces ``lmm_icl_interface.LMMPromptProcessor.prepare_input`` (reference
call sites: icv_src/icv_datamodule.py:80-103, inference.py:277).  Produces
STATIC-SHAPE numpy batches: sequence length padded to a bucket multiple and
image count padded to the batch max, so every (batch, bucket) pair compiles
exactly once on TPU.

Image-token layouts per model family:

- ``idefics``    — ``<fake_token_around_image><image><fake_token_around_image>``
  per image (adjacent images share the fake token); 1 text token per image,
  vision features enter via gated cross-attention.
- ``idefics2``   — ``<fake_token_around_image>`` + ``<image>``×64 +
  ``<fake_token_around_image>``; vision features are spliced inline.
- ``flamingo``   — ``<image>`` followed by the shot text and
  ``<|endofchunk|>`` handled by the prompt templates.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np

FAKE_IMAGE_TOKEN = "<fake_token_around_image>"
IMAGE_TOKEN = "<image>"

# CLIP normalization (OpenCLIP ViT-H for idefics); SigLIP uses 0.5s.
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)


class ImageRef:
    """Lazy image handle: a path that decodes on demand.

    Datasets/tables hand these to the processor instead of eagerly-decoded
    PIL objects, so each image is JPEG-decoded + resized exactly once (LRU in
    ``ImageTransform``) no matter how many prompt views reference it — the
    32-shot collator touches each image in up to 4 views, and few-shot
    sampling re-draws the same shots across samples."""

    __slots__ = ("path",)

    def __init__(self, path: str):
        self.path = str(path)

    @property
    def pil(self):
        from PIL import Image as PILImage

        return PILImage.open(self.path)

    @property
    def size(self):
        return self.pil.size  # PIL reads only the header

    def convert(self, mode: str):
        return self.pil.convert(mode)

    def __repr__(self):
        return f"ImageRef({self.path!r})"


@dataclasses.dataclass
class ImageTransform:
    """Resize (bicubic) + rescale + normalize → (H, W, 3) float32.

    ``ImageRef`` inputs go through an LRU decode+resize cache (uint8, so a
    4096-entry cache of 224² images is ~600MB).

    ``variable_resolution`` (Idefics2/NaViT): instead of a fixed square,
    aspect-preserving resize with the HF Idefics2ImageProcessor rule —
    downscale so the longest edge ≤ ``max_edge``, then clamp both dims to
    ≥ ``min_edge``; the batch is padded (+ pixel_attention_mask) in
    ``PromptProcessor.prepare_input``."""

    image_size: int = 224
    mean: tuple = CLIP_MEAN
    std: tuple = CLIP_STD
    cache_entries: int = 4096
    variable_resolution: bool = False
    min_edge: int = 378
    max_edge: int = 980

    def target_size(self, width: int, height: int) -> tuple[int, int]:
        """(W, H) after the HF idefics2 resize rule (image_processing_idefics2
        get_resize_output_image_size semantics)."""
        aspect = width / height
        if width >= height and width > self.max_edge:
            width = self.max_edge
            height = int(width / aspect)
        elif height > width and height > self.max_edge:
            height = self.max_edge
            width = int(height * aspect)
        return max(width, self.min_edge), max(height, self.min_edge)

    def __post_init__(self):
        self._mean32 = np.asarray(self.mean, np.float32)
        self._std_inv32 = (1.0 / np.asarray(self.std)).astype(np.float32)
        import threading
        from collections import OrderedDict

        self._cache: "OrderedDict[str, np.ndarray]" = OrderedDict()
        # the DataLoader decodes from worker THREADS; OrderedDict get +
        # move_to_end + popitem interleavings are not safe without a lock
        self._lock = threading.Lock()

    # Grain's mp_prefetch pickles the whole pipeline (including this
    # transform, closed over by the batch collator) into worker processes;
    # the lock and cache are per-process state, not data — drop on pickle,
    # recreate fresh on unpickle.
    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_cache", None)
        state.pop("_lock", None)
        return state

    def __setstate__(self, state):
        import threading
        from collections import OrderedDict

        self.__dict__.update(state)
        self._cache = OrderedDict()
        self._lock = threading.Lock()

    def __call__(self, image: Any) -> np.ndarray:
        """Decode+resize → uint8 (H, W, 3).  Normalization happens ONCE per
        batch in ``normalize`` — per-view normalization was the host
        pipeline's hottest loop (each image appears in up to 4 collator
        views)."""
        return self._to_array(image)

    def normalize(self, batch: np.ndarray) -> np.ndarray:
        """Vectorized rescale+normalize of a whole (..., H, W, 3) batch."""
        return (
            batch.astype(np.float32) * np.float32(1.0 / 255.0) - self._mean32
        ) * self._std_inv32

    def _resize_pil(self, img) -> np.ndarray:
        from PIL import Image as PILImage

        img = img.convert("RGB")
        if self.variable_resolution:
            img = img.resize(self.target_size(*img.size), PILImage.BICUBIC)
        else:
            img = img.resize((self.image_size, self.image_size), PILImage.BICUBIC)
        return np.asarray(img, np.uint8)

    def _decode_resized(self, path: str) -> np.ndarray:
        with self._lock:
            hit = self._cache.get(path)
            if hit is not None:
                self._cache.move_to_end(path)
                return hit
        from PIL import Image as PILImage

        # decode OUTSIDE the lock (PIL releases the GIL for the heavy parts)
        arr = self._resize_pil(PILImage.open(path))
        with self._lock:
            self._cache[path] = arr
            if len(self._cache) > self.cache_entries:
                self._cache.popitem(last=False)
        return arr

    def _to_array(self, image: Any) -> np.ndarray:
        if isinstance(image, ImageRef):
            return self._decode_resized(image.path)
        if isinstance(image, str):
            return self._decode_resized(image)
        if isinstance(image, np.ndarray):
            a = image
            if self.variable_resolution:
                w, h = a.shape[1], a.shape[0]
                if (w, h) != self.target_size(w, h):
                    a = self._resize_np(a)
            elif a.shape[:2] != (self.image_size, self.image_size):
                a = self._resize_np(a)
            return a.astype(np.uint8, copy=False)
        try:  # PIL image
            from PIL import Image as PILImage

            if isinstance(image, PILImage.Image):
                return self._resize_pil(image)
        except ImportError:
            pass
        raise TypeError(f"unsupported image type: {type(image)}")

    def _resize_np(self, a: np.ndarray) -> np.ndarray:
        from PIL import Image as PILImage

        return self._resize_pil(PILImage.fromarray(a.astype(np.uint8)))


def _is_image(x: Any) -> bool:
    if isinstance(x, str):
        return False
    if isinstance(x, (np.ndarray, ImageRef)):
        return True
    try:
        from PIL import Image as PILImage

        return isinstance(x, PILImage.Image)
    except ImportError:
        return False


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def bucket_length(n: int, base: int = 64) -> int:
    """Geometric-ish bucketing: fine granularity for short prompts, coarser
    for long ICL prompts, so each (batch, bucket) shape — and its XLA
    compilation — is reused across the whole eval.

    ≤512 → multiples of ``base``; ≤2048 → multiples of 256; above → 512.
    """
    if n <= 512:
        return _round_up(n, base)
    if n <= 2048:
        return _round_up(n, 256)
    return _round_up(n, 512)


class PromptProcessor:
    def __init__(
        self,
        tokenizer,
        image_transform: Optional[ImageTransform] = None,
        family: str = "idefics",
        image_seq_len: int = 64,  # idefics2 inline tokens per image
        padding_side: str = "right",
        pad_to_multiple: int = 64,
        max_length: int = 2048,
        add_bos: bool = True,
    ):
        self.tokenizer = tokenizer
        self.image_transform = image_transform or ImageTransform()
        self.family = family
        self.image_seq_len = image_seq_len
        self.padding_side = padding_side
        self.pad_to_multiple = pad_to_multiple
        self.max_length = max_length
        self.add_bos = add_bos
        self.input_ids_field = "input_ids"
        self.image_token_id = tokenizer.token_id(IMAGE_TOKEN)
        self.fake_token_id = tokenizer.token_id(FAKE_IMAGE_TOKEN)

    def _image_markup(self) -> str:
        if self.family == "idefics":
            return FAKE_IMAGE_TOKEN + IMAGE_TOKEN + FAKE_IMAGE_TOKEN
        if self.family == "idefics2":
            return (
                FAKE_IMAGE_TOKEN
                + IMAGE_TOKEN * self.image_seq_len
                + FAKE_IMAGE_TOKEN
            )
        return IMAGE_TOKEN  # flamingo

    def _encode_prompt_textual(
        self, prompt: Sequence[Any], add_eos_token: bool, with_pixels: bool = True
    ):
        """HF-tokenizer path: build ONE string with literal image-token markup
        and tokenize once — segment-wise tokenization differs at SentencePiece
        boundaries, and HF's Idefics processors tokenize the joined string
        (adjacent images share a fake token, like HF)."""
        parts: list[str] = []
        images: list[np.ndarray] = []
        for part in prompt:
            if _is_image(part):
                if with_pixels:
                    images.append(self.image_transform(part))
                parts.append(self._image_markup())
            else:
                parts.append(str(part))
        text = "".join(parts).replace(
            FAKE_IMAGE_TOKEN + FAKE_IMAGE_TOKEN, FAKE_IMAGE_TOKEN
        )
        ids = ([self.tokenizer.bos_token_id] if self.add_bos else []) + list(
            self.tokenizer.encode(text)
        )
        if add_eos_token:
            ids.append(self.tokenizer.eos_token_id)
        return ids, images  # truncation (+ warning) happens in prepare_input

    # -- single prompt → (ids, images) ------------------------------------
    def _encode_prompt(
        self, prompt: Sequence[Any], add_eos_token: bool, with_pixels: bool = True
    ):
        if hasattr(self.tokenizer, "tok"):  # HF-backed tokenizer
            return self._encode_prompt_textual(prompt, add_eos_token, with_pixels)
        ids: list[int] = []
        if self.add_bos:
            ids.append(self.tokenizer.bos_token_id)
        images: list[np.ndarray] = []
        last_was_image = False
        for part in prompt:
            if _is_image(part):
                if with_pixels:
                    images.append(self.image_transform(part))
                if self.family == "idefics":
                    if last_was_image:
                        ids.pop()  # adjacent images share one fake token
                    ids += [self.fake_token_id, self.image_token_id, self.fake_token_id]
                elif self.family == "idefics2":
                    if last_was_image:
                        ids.pop()
                    ids += (
                        [self.fake_token_id]
                        + [self.image_token_id] * self.image_seq_len
                        + [self.fake_token_id]
                    )
                else:  # flamingo
                    ids.append(self.image_token_id)
                last_was_image = True
            else:
                ids += self.tokenizer.encode(str(part))
                last_was_image = False
        if add_eos_token:
            ids.append(self.tokenizer.eos_token_id)
        return ids, images  # truncation (+ warning) happens in prepare_input

    def _truncate(self, ids: list, images: list) -> tuple:
        """Clip to ``max_length``, dropping images whose tokens were cut so
        pixel count stays consistent with the surviving image tokens, and
        warn LOUDLY — a truncated teacher view silently destroys the KL
        target (the answer region falls off the end), so this must never
        pass unnoticed.  Raise ``max_length`` via ``lmm.max_length``."""
        if len(ids) <= self.max_length:
            return ids, images
        kept = ids[: self.max_length]
        n_img_kept = sum(1 for t in kept if t == self.image_token_id)
        if self.family == "idefics2":
            n_img_kept = -(-n_img_kept // max(1, self.image_seq_len))
        if not hasattr(self, "_warned_truncation"):
            self._warned_truncation = True
            from ..utils.log import get_logger

            get_logger("processor").warning(
                "prompt of %d tokens TRUNCATED to max_length=%d (family=%s); "
                "if this is the teacher ICL view the answer region is cut off "
                "and the KL objective is corrupted — raise lmm.max_length or "
                "lower few_shot_num",
                len(ids),
                self.max_length,
                self.family,
            )
        return kept, images[:n_img_kept]

    # -- batch API ----------------------------------------------------------
    def prepare_input(
        self,
        prompts: Sequence[Sequence[Any]],
        padding: bool = True,
        truncation: bool = True,
        add_eos_token: bool = False,
        return_tensors: str = "np",
        padding_side: Optional[str] = None,
        with_pixels: bool = True,
    ) -> dict:
        """``with_pixels=False`` skips image decode/normalize entirely (image
        tokens still land in input_ids) — for views consumed only for their
        token lengths, e.g. the collator's ice/query_x views."""
        del truncation, return_tensors  # always truncates at max_length; numpy out
        side = padding_side or self.padding_side
        encoded = [
            self._truncate(*self._encode_prompt(p, add_eos_token, with_pixels=with_pixels))
            for p in prompts
        ]
        b = len(encoded)
        pad_id = self.tokenizer.pad_token_id
        max_len = max(len(ids) for ids, _ in encoded) if padding else self.max_length
        max_len = min(bucket_length(max_len, self.pad_to_multiple), self.max_length)
        n_img = max((len(imgs) for _, imgs in encoded), default=0)
        n_img = max(n_img, 1)

        input_ids = np.full((b, max_len), pad_id, np.int32)
        attn = np.zeros((b, max_len), np.int32)
        for i, (ids, _) in enumerate(encoded):
            ids = ids[:max_len]
            if side == "right":
                input_ids[i, : len(ids)] = ids
                attn[i, : len(ids)] = 1
            else:
                input_ids[i, max_len - len(ids) :] = ids
                attn[i, max_len - len(ids) :] = 1

        out = {"input_ids": input_ids, "attention_mask": attn}
        variable = self.image_transform.variable_resolution
        if variable:
            # NaViT: pad to the batch max H/W, ROUNDED UP to a coarse bucket
            # (8-patch multiples) so a whole eval reuses a handful of XLA
            # compilations; pixel_attention_mask marks real pixels.
            bucket = 8 * 14
            max_h = max(
                (im.shape[0] for _, imgs in encoded for im in imgs), default=bucket
            )
            max_w = max(
                (im.shape[1] for _, imgs in encoded for im in imgs), default=bucket
            )
            hh, ww = _round_up(max_h, bucket), _round_up(max_w, bucket)
        else:
            hh = ww = self.image_transform.image_size
        pixels_u8 = np.zeros((b, n_img, hh, ww, 3), np.uint8)
        img_valid = np.zeros((b, n_img), bool)
        # padding images keep an all-ones mask: an all-masked ViT row would
        # attend uniformly to garbage; their latents are gated by pixel_valid
        pmask = np.ones((b, n_img, hh, ww), np.uint8) if variable else None
        for i, (_, imgs) in enumerate(encoded):
            for j, img in enumerate(imgs):
                if variable:
                    ih, iw = img.shape[:2]
                    pixels_u8[i, j, :ih, :iw] = img
                    pmask[i, j] = 0
                    pmask[i, j, :ih, :iw] = 1
                else:
                    pixels_u8[i, j] = img
                img_valid[i, j] = True
        # RAW uint8: normalization runs ON DEVICE in the model bundles
        # (XLA fuses it into the patch-embed matmul; host normalize was
        # the pipeline's hottest op and quadrupled transfer bytes)
        out["pixel_values"] = pixels_u8
        out["pixel_valid"] = img_valid
        if variable:
            out["pixel_attention_mask"] = pmask
        return out
