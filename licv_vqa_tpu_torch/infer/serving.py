"""Continuous-batching serving engines, greedy and beam (counterpart of
``licv_vqa_tpu/infer/serving.py``, host-driven ``run``/``run_online``).

Static batches make every batch wait for its slowest member (reference
inference.py:246-321).  Here a fixed pool of ``n_slots`` sequences decodes
in lockstep, and a request enters a free slot the moment one frees:

- the pool's KV cache keeps a per-row write index (``cache["index"]`` a
  ``(n_rows,)`` int tensor on the device, ``models/decoder.py::
  decode_cache_view``) and per-row positions, so every slot sits at its own
  offset and masks from its own ``pos``/``valid`` columns;
- an admission prefills a group of requests of one prompt bucket into a
  fresh bucket-length cache (the flash kernel from 256 tokens, w8a8 where
  enabled: the batch runners' code path) and writes its K/V rows, media
  (image latents, cross-attention K/V, step one-hot) and decode state into
  the pool's tensors in place (``index_copy_`` and indexed writes, where
  JAX donates buffers);
- merged admission (the greedy engine given a ``merged_admit_fn``, as
  ``from_bundle`` gives it): an admission into an occupied pool runs ONE
  forward of a pool decode step and the group's prefill, the decoder
  projections packed over both token streams (the family's
  ``make_*_merged_admit_fn``), so the pool keeps decoding while a group is
  admitted; each admitted request's tokens are those of plain admission;
- NaViT variable resolution (Idefics2): a request's
  ``pixel_attention_mask`` marks its real pixels; requests admit together
  only where their pixels and masks have one shape, and the group's
  stacked masks go to its prefill, plain or merged;
- every ``sync_steps`` decode steps (a chunk, no host read inside) the
  finished flags, counts and token buffer are copied with
  ``non_blocking=True`` into pinned host tensors and a CUDA event is
  recorded; with ``harvest_lag=1`` the host waits on chunk k's event only
  after it has dispatched chunk k+1, so the readback overlaps the device.

Decode semantics per slot are ``infer.decode.greedy_generate``'s (argmax,
EOS, ``min_new_tokens`` EOS suppression) and, in ``BeamServingEngine``,
``beam_generate``'s HF beam search, token for token.  Across batch shapes a
row's bf16 logits may differ (cuBLAS and the kernels pick tiles by M), so
argmax near-ties can flip between the engine and a static batch, as between
two static batch sizes (JAX serving.py:31-37); in f32 the tokens are equal.

Not in this port yet, each raising ``NotImplementedError`` that names its
ROADMAP item: ``run_fused`` (the whole scheduler on the device, item 19's
CUDA-graph capture) and the serving mesh (``mesh``: a slot pool sharded
over dp, item 16b; the static runner takes ``infer_dp``/``infer_tp``).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..models.decoder import init_kv_cache
from ..utils.log import get_logger
from .decode import NEG_INF, _kv_leaves, _take_rows, _topk, _topk_2k_two_stage

logger = get_logger("serving")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to licv_vqa_tpu_torch yet (ROADMAP.md Queue 1 {item})"
    )


@dataclasses.dataclass
class Request:
    """One generation request (unpadded host arrays)."""

    uid: Any
    input_ids: np.ndarray  # (S,) int, no padding
    pixel_values: np.ndarray  # (N_img, H, W, 3)
    max_new: int
    min_new: int = 0
    pixel_valid: Optional[np.ndarray] = None  # (N_img,) bool; default all on
    # (N_img, H, W) real pixels (NaViT variable resolution): only an engine
    # whose family takes it (Idefics2) accepts it
    pixel_attention_mask: Optional[np.ndarray] = None


@dataclasses.dataclass
class _Slot:
    request: Request
    prompt_len: int
    # chunk count at admission: a snapshot taken after chunk k (id k) shows
    # this slot only if admitted_at < k; the lagged harvest reads older
    # snapshots, where a freed and refilled slot still shows its previous
    # occupant's flags
    admitted_at: int = 0


@dataclasses.dataclass
class _Snapshot:
    """Host copies of one chunk's ``(finished, tok_count, out)``, and the
    event after which they are complete (None on the CPU)."""

    host: tuple
    event: Optional[torch.cuda.Event]
    gen: int


def _map(fn, x):
    """``fn`` over the tensors of a tensor, tuple or dict tree."""
    if isinstance(x, dict):
        return {k: _map(fn, v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_map(fn, v) for v in x)
    return fn(x)


def _leaves(x) -> list:
    if isinstance(x, dict):
        return [leaf for v in x.values() for leaf in _leaves(v)]
    if isinstance(x, (tuple, list)):
        return [leaf for v in x for leaf in _leaves(v)]
    return [x]


def _rep(x: torch.Tensor, k: int) -> torch.Tensor:
    """Each element of a 1-D tensor ``k`` times in a row (``jnp.repeat``)."""
    return x[:, None].expand(x.shape[0], k).reshape(-1)


class ServingEngine:
    """Continuous-batching greedy pool over one model family.

    ``prefill_fn``/``decode_fn``/``media_axes`` come from the family's
    ``make_*_serving_fns`` (``models/idefics.py``, ``models/idefics2.py``,
    ``models/openflamingo.py``) or via :meth:`from_bundle`; ``media_axes``
    maps each media key to its (batch axis, image axis).
    ``supports_pixel_attention_mask``: the family's prefill (and merged
    function) take ``pixel_attention_mask``.
    """

    def __init__(
        self,
        prefill_fn: Callable,
        decode_fn: Callable,
        media_axes: dict,
        text_cfg,
        params,
        *,
        eos_token_id: int,
        pad_token_id: int,
        n_slots: int = 8,
        out_cap: int = 32,
        prompt_buckets: tuple = (64, 128),
        sync_steps: int = 4,
        admit_sizes: tuple = (4, 2, 1),
        icv_scaled=None,
        mesh=None,
        max_images: Optional[int] = None,
        supports_pixel_attention_mask: bool = False,
        merged_admit_fn: Optional[Callable] = None,
        harvest_lag: int = 1,
        device=None,
    ):
        if mesh is not None:
            raise _not_ported("the serving mesh (a slot pool sharded over dp)", "item 16b")
        if harvest_lag not in (0, 1):
            raise ValueError(f"harvest_lag must be 0 or 1, got {harvest_lag}")
        self._prefill = prefill_fn
        self._decode = decode_fn
        # merged admission (chunked prefill) wherever a merged function is
        # given: on the H100 it saves the pool the forward an admission
        # would take (JAX's run() leaves it off by default: it lost on the
        # TPU, serving.py:145-159); an admission into an empty pool is
        # always plain (no decode lane to carry it)
        self._merged_admit = merged_admit_fn
        self._media_axes = dict(media_axes)
        self._text_cfg = text_cfg
        self.params = params
        self.device = torch.device(device) if device is not None else _leaves(params)[0].device
        self.eos_token_id = int(eos_token_id)
        self.pad_token_id = int(pad_token_id)
        self.n_slots = int(n_slots)
        self.out_cap = int(out_cap)
        self.prompt_buckets = tuple(sorted(int(b) for b in prompt_buckets))
        self.sync_steps = int(sync_steps)
        self.admit_sizes = tuple(sorted({int(a) for a in admit_sizes} | {1}, reverse=True))
        self.cache_len = self.prompt_buckets[-1] + self.out_cap
        self._icv = icv_scaled
        # mixed image counts (ICL sweeps: k+1 images a request): the media
        # buffers are ``max_images`` wide; an admission runs the tower at
        # its group's true image count and its scatter zero-pads up to the
        # buffer (never attended: the one-hots derive from pixel_valid)
        self.max_images = None if max_images is None else int(max_images)
        self.supports_pixel_attention_mask = bool(supports_pixel_attention_mask)
        # harvest_lag=1: wait on chunk k's flags only after dispatching
        # chunk k+1 (the readback overlaps the device; a finished slot idles
        # up to 2·sync_steps steps); 0: wait on every chunk's own flags
        self.harvest_lag = int(harvest_lag)

        self._cache = None
        self._media: Optional[dict] = None  # allocated at the first admission
        self._media_n_img: Optional[int] = None  # the buffers' image count
        self._state = None
        self._host = None  # pinned snapshot buffers, one per outstanding chunk
        self._snapshots = 0  # snapshots taken (the ring's cursor)
        self._ensure_pool()
        self._queue: deque[Request] = deque()
        self._slots: list[Optional[_Slot]] = [None] * self.n_slots
        self.steps_run = 0  # decode steps dispatched
        self.admissions: list[tuple[int, int]] = []  # (group size, bucket) each
        self.merged_admits = 0  # admissions that rode a merged forward
        self._chunk_count = 0  # chunks dispatched (the harvest's generation id)
        # clocks relative to the serve start: completion (run and
        # run_online); arrival, admission and first token observed at a
        # harvest (run_online; an upper-bound TTFT, late by at most a chunk)
        self.completion_s: dict = {}
        self.arrival_s: dict = {}
        self.admission_s: dict = {}
        self.first_token_s: dict = {}
        self._clock_t0: Optional[float] = None
        self._stop_requested = False

    # -- device state ---------------------------------------------------------

    @property
    def n_rows(self) -> int:
        return self.n_slots

    @torch.inference_mode()
    def _ensure_pool(self) -> None:
        """(Re-)allocate the pool's device tensors if released."""
        if self._cache is None:
            self._cache = self._init_cache()
            self._state = self._init_state()
            watched = (self._state["finished"], self._state["tok_count"], self._state["out"])
            pin = self.device.type == "cuda"
            self._host = [tuple(torch.empty(x.shape, dtype=x.dtype, pin_memory=pin)
                                for x in watched) for _ in range(self.harvest_lag + 1)]

    def release_pool(self) -> None:
        """Drop the pool's device tensors (KV cache, media, slot state); they
        are allocated again at the next run."""
        if any(s is not None for s in self._slots) or self._queue:
            raise RuntimeError("release_pool with active slots or queued requests")
        self._cache = None
        self._media = None
        self._media_n_img = None
        self._state = None
        self._host = None

    def _init_cache(self) -> dict:
        cache = init_kv_cache(self._text_cfg, self.n_rows, self.cache_len, self.device)
        # each row's own next column
        cache["index"] = torch.zeros((self.n_rows,), dtype=torch.long, device=self.device)
        return cache

    def _init_state(self) -> dict:
        b, v, dev = self.n_rows, self._text_cfg.vocab_size, self.device

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return {
            "active": zeros(b, dtype=torch.bool),
            "finished": zeros(b, dtype=torch.bool),
            "tok_count": zeros(b),
            "next_pos": zeros(b),
            "max_new": torch.ones((b,), dtype=torch.int32, device=dev),
            "min_new": zeros(b),
            "last_logits": zeros(b, v, dtype=torch.float32),
            "out": zeros(b, self.out_cap),
        }

    # -- construction -----------------------------------------------------------

    @classmethod
    def from_bundle(cls, bundle, **kw) -> "ServingEngine":
        """The engine of a ``ModelBundle``: the family's serving functions
        (and, for the greedy engine, its merged admission function) on the
        bundle's pixel normalisation (raw uint8 pixels normalised on the
        device) and ICV layout (``ModelBundle.model_pixels``/``model_icv``).
        The merged forward's matmuls are weight-only, so a bundle whose
        prefills take w8a8 (``lmm.w8a8_prefill``) keeps plain admission.
        Idefics2's engines take NaViT ``pixel_attention_mask``s."""
        from ..models import idefics as I
        from ..models import idefics2 as I2
        from ..models import openflamingo as OF

        cfg = bundle.model_cfg
        serving, merged_fn, pam_ok = {
            I.IdeficsConfig: (I.make_idefics_serving_fns, I.make_idefics_merged_admit_fn, False),
            I2.Idefics2Config: (I2.make_idefics2_serving_fns, I2.make_idefics2_merged_admit_fn,
                                True),
            OF.OpenFlamingoConfig: (OF.make_openflamingo_serving_fns,
                                    OF.make_openflamingo_merged_admit_fn, False),
        }[type(cfg)]
        prefill, decode, axes = serving(cfg, bundle.eos_token_id)

        def norm_prefill(params, pixels, *a, **k):
            return prefill(params, bundle.model_pixels(pixels), *a, **k)

        # merged admission for the greedy engine; beam groups keep the
        # plain admission (their step is the beam transition)
        if not issubclass(cls, BeamServingEngine) and not cfg.text.w8a8_prefill:
            raw_merged = merged_fn(cfg, bundle.eos_token_id)

            def merged(params, tok, adv, pos, cache, media, icv, pixels, *a, **k):
                return raw_merged(params, tok, adv, pos, cache, media, icv,
                                  bundle.model_pixels(pixels), *a, **k)

            kw.setdefault("merged_admit_fn", merged)

        return cls(norm_prefill, decode, axes, cfg.text, bundle.params,
                   eos_token_id=bundle.eos_token_id, pad_token_id=bundle.pad_token_id,
                   icv_scaled=bundle.model_icv(kw.pop("icv_scaled", None)),
                   supports_pixel_attention_mask=pam_ok, device=bundle.device, **kw)

    # -- public API --------------------------------------------------------------

    def submit(self, request: Request) -> None:
        if request.max_new > self.out_cap:
            raise ValueError(f"max_new={request.max_new} exceeds out_cap={self.out_cap}")
        if len(request.input_ids) > self.prompt_buckets[-1]:
            raise ValueError(f"prompt length {len(request.input_ids)} exceeds the largest "
                             f"bucket {self.prompt_buckets[-1]}")
        if request.pixel_attention_mask is not None and not self.supports_pixel_attention_mask:
            raise ValueError("this engine's model family does not take a "
                             "pixel_attention_mask (NaViT variable resolution is an "
                             "Idefics2 feature)")
        n_img = np.asarray(request.pixel_values).shape[0]
        if self.max_images is not None and n_img > self.max_images:
            raise ValueError(f"request has {n_img} images > engine max_images="
                             f"{self.max_images}")
        if self._media_n_img is not None and n_img > self._media_n_img:
            raise ValueError(f"request has {n_img} images but media buffers are sized for "
                             f"{self._media_n_img}; construct the engine with "
                             f"max_images={n_img}")
        if self._clock_t0 is not None:  # online arrival clock
            self.arrival_s[request.uid] = time.perf_counter() - self._clock_t0
        self._queue.append(request)

    def run(self, on_complete: Optional[Callable] = None) -> dict:
        """Drain the queue; returns ``{uid: np.ndarray of generated ids}`` (up
        to and including EOS).  ``on_complete(uid, tokens)`` fires as each
        request finishes and may ``submit`` follow-ups, which enter freed
        slots without draining the pool."""
        return self._serve(online=False, on_complete=on_complete)

    def run_online(self, on_complete: Optional[Callable] = None,
                   idle_sleep_s: float = 0.002) -> dict:
        """Serve until :meth:`stop`, sleeping briefly when idle.  ``submit``
        may be called from other threads meanwhile (deque appends are
        atomic; the loop reads the queue every iteration).  ``stop()``
        finishes everything submitted, then returns."""
        return self._serve(online=True, on_complete=on_complete, idle_sleep_s=idle_sleep_s)

    def stop(self) -> None:
        """Ask a running :meth:`run_online` to return once idle."""
        self._stop_requested = True

    def run_fused(self) -> dict:
        raise _not_ported("run_fused (the whole scheduler on the device, a replayed CUDA "
                          "graph)", "item 19")

    @torch.inference_mode()
    def _serve(self, online: bool, on_complete, idle_sleep_s: float = 0.002) -> dict:
        self._ensure_pool()
        results: dict = {}
        t0 = time.perf_counter()
        self._clock_t0 = t0 if online else None
        self._stop_requested = False

        def now_rel():
            return time.perf_counter() - t0

        def emit(done):
            now = now_rel()
            for uid, toks in done.items():
                self.completion_s[uid] = now
                if on_complete is not None:
                    on_complete(uid, toks)
            results.update(done)

        prev = None  # the snapshot of the chunk before the last one dispatched
        while True:
            if not (self._queue or any(s is not None for s in self._slots)):
                if prev is not None:
                    emit(self._harvest(prev, now=now_rel()))
                    prev = None
                if not online or self._stop_requested:
                    break
                time.sleep(idle_sleep_s)
                continue
            self._admit_pending()
            if any(s is not None for s in self._slots):
                self._chunk()
                self.steps_run += self.sync_steps
                self._chunk_count += 1
                snap = self._snapshot()
                if self.harvest_lag == 0:
                    emit(self._harvest(snap, now=now_rel()))
                else:
                    if prev is not None:
                        emit(self._harvest(prev, now=now_rel()))
                    prev = snap
        self._clock_t0 = None
        return results

    # -- admission -------------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self.prompt_buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds buckets")

    def _group_key(self, r: Request):
        """Requests admitted together share a prompt bucket, a pixel shape
        and a pixel mask shape (their pixels and masks stack; JAX
        serving.py:539-549)."""
        pam = r.pixel_attention_mask
        return (self._bucket_for(len(r.input_ids)), tuple(np.asarray(r.pixel_values).shape),
                None if pam is None else tuple(np.asarray(pam).shape))

    def _admit_pending(self) -> None:
        free = [i for i, s in enumerate(self._slots) if s is None]
        while free and self._queue:
            key = self._group_key(self._queue[0])
            group: list[Request] = []
            limit = min(self.admit_sizes[0], len(free))
            for r in list(self._queue):  # same-key requests in queue order
                if self._group_key(r) == key:
                    group.append(r)
                    if len(group) == limit:
                        break
            adm = next(a for a in self.admit_sizes if a <= max(len(group), 1))
            group = group[:adm]
            for r in group:
                self._queue.remove(r)
            slots = [free.pop() for _ in group]
            self._admit_group(group, slots, key[0])

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":  # staged in pinned memory: no host wait
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _admit_group(self, group: list, slots: list, bucket: int) -> None:
        adm = len(group)
        ids = np.full((adm, bucket), self.pad_token_id, np.int32)
        mask = np.zeros((adm, bucket), np.int32)
        for i, r in enumerate(group):  # LEFT padding (the decode convention)
            n = len(r.input_ids)
            ids[i, bucket - n:] = np.asarray(r.input_ids, np.int32)
            mask[i, bucket - n:] = 1
        pixels = np.stack([np.asarray(r.pixel_values) for r in group])
        pv = np.stack([np.ones(pixels.shape[1], bool) if r.pixel_valid is None
                       else np.asarray(r.pixel_valid, bool) for r in group])
        max_new = np.asarray([r.max_new for r in group], np.int32)
        min_new = np.asarray([r.min_new for r in group], np.int32)
        admitted_at = self._chunk_count
        mask_t = self._to_device(mask)
        inputs = (self._to_device(pixels), self._to_device(pv), self._to_device(ids), mask_t)
        pam = {}  # the group's NaViT masks (one shape: the group key)
        if group[0].pixel_attention_mask is not None:
            pam["pixel_attention_mask"] = self._to_device(
                np.stack([np.asarray(r.pixel_attention_mask) for r in group]))
        merged = self._merged_admit is not None and any(s is not None for s in self._slots)
        if merged:
            last, small, media, next_pos = self._merged_step(inputs, bucket, pam)
        else:
            last, small, media, next_pos = self._prefill(self.params, *inputs, self._icv,
                                                         bucket, **pam)
        if self._media is None:
            self._alloc_media(media, pixels.shape[1])
        rows = self._rows(self._to_device(np.asarray(slots, np.int64)))
        self._scatter_admit(rows, bucket, last, small, media, next_pos,
                            self._to_device(max_new), self._to_device(min_new))
        self._admit_state(rows, mask_t)
        self.admissions.append((adm, bucket))
        if self._clock_t0 is not None:  # online admission clock
            adm_now = time.perf_counter() - self._clock_t0
            for r in group:
                self.admission_s[r.uid] = adm_now
        for r, s in zip(group, slots):
            self._slots[s] = _Slot(r, len(r.input_ids), admitted_at)

    def _rows(self, slots: torch.Tensor) -> torch.Tensor:
        """(adm, rows a slot) pool rows of the admitted slots."""
        return slots[:, None]

    def _admit_state(self, rows: torch.Tensor, mask: torch.Tensor) -> None:
        """Engine-specific state of the admitted rows (the beam pools')."""

    def _alloc_media(self, media: dict, n_img: int) -> None:
        """Per-slot media buffers shaped as the first admission's media, the
        batch axis ``n_rows`` wide and the image axis ``max_images`` (else
        this group's image count) images wide; none for a family whose
        decode steps take no media (Idefics2's ``{}``)."""
        width = n_img if self.max_images is None else self.max_images

        def alloc(ax, img_ax):
            def f(x):
                shape = list(x.shape)
                shape[ax] = self.n_rows
                shape[img_ax] = x.shape[img_ax] // n_img * width
                return torch.zeros(shape, dtype=x.dtype, device=self.device)
            return f

        self._media = {k: _map(alloc(*self._media_axes[k]), media[k]) for k in self._media_axes}
        self._media_n_img = width

    def _scatter_admit(self, rows, bucket, last, small, media, next_pos, max_new, min_new):
        """Write one prefilled group into the pool in place: columns
        ``[0, bucket)`` of its rows' K/V, positions and validity (a reused
        slot keeps its previous occupant's later columns, which the per-row
        ``written`` mask of ``decode_cache_view`` hides), their write index,
        media and decode state.  ``rows`` is (adm, k): request i's prefill
        goes to each of its k rows."""
        cache, st = self._cache, self._state
        for j in range(rows.shape[1]):
            r = rows[:, j].contiguous()
            for key in ("k", "v"):  # (L, B, S, KV, Dh|1)
                for big, sm in zip(_kv_leaves(cache[key]), _kv_leaves(small[key])):
                    big[:, r, :bucket] = sm
            for key in ("pos", "valid"):
                cache[key][r, :bucket] = small[key]
            cache["index"].index_fill_(0, r, small["index"])
            for key, (ax, img_ax) in self._media_axes.items():
                for big, sm in zip(_leaves(self._media[key]), _leaves(media[key])):
                    if sm.shape[img_ax] < big.shape[img_ax]:  # zero-pad the images
                        shape = list(big.shape)
                        shape[ax] = sm.shape[ax]
                        padded = sm.new_zeros(shape)
                        padded.narrow(img_ax, 0, sm.shape[img_ax]).copy_(sm)
                        sm = padded
                    big.index_copy_(ax, r, sm.to(big.dtype))
            st["active"].index_fill_(0, r, True)
            st["finished"].index_fill_(0, r, False)
            st["tok_count"].index_fill_(0, r, 0)
            st["out"].index_fill_(0, r, 0)
            st["next_pos"].index_copy_(0, r, next_pos.to(torch.int32))
            st["max_new"].index_copy_(0, r, max_new)
            st["min_new"].index_copy_(0, r, min_new)
            st["last_logits"].index_copy_(0, r, last)

    # -- decode ------------------------------------------------------------------

    def _chunk(self) -> None:
        """``sync_steps`` lockstep decode steps; nothing is read back."""
        for _ in range(self.sync_steps):
            self._step()

    def _pool_forward(self, adv, fn):
        """``fn(cache)``, a forward of the whole pool: rows with ``adv`` 0
        write a masked column and keep their write index (a finished row's
        index may stand at ``cache_len``, so the forward sees it clamped to
        the last column, which the row never reads again; JAX drops such
        writes)."""
        cache = self._cache
        index = cache["index"]
        cache["index"] = torch.clamp(index, max=self.cache_len - 1)
        out = fn(cache)
        cache["index"] = index + adv
        return out

    def _forward(self, tok, adv, positions) -> torch.Tensor:
        """One decode forward of the whole pool; returns the last
        position's f32 logits."""
        logits, _ = self._pool_forward(adv, lambda cache: self._decode(
            self.params, tok[:, None], adv[:, None], positions[:, None], cache, self._icv,
            self._media))
        return logits[:, -1, :].float()

    def _emit(self) -> tuple:
        """Each active unfinished slot's pending token (argmax, EOS
        suppressed while under ``min_new``): ``(emit, tok, adv, out,
        finished)``, the state not yet updated."""
        st = self._state
        eos, pad = self.eos_token_id, self.pad_token_id
        emit = st["active"] & ~st["finished"]
        lg = st["last_logits"].clone()
        lg[:, eos] = torch.where(st["tok_count"] < st["min_new"], NEG_INF, lg[:, eos])
        tok = torch.where(emit, torch.argmax(lg, dim=-1).to(torch.int32), pad)
        cols = torch.arange(self.out_cap, device=tok.device)
        write = emit[:, None] & (cols[None, :] == st["tok_count"][:, None])
        out = torch.where(write, tok[:, None], st["out"])
        finished = st["finished"] | (
            emit & ((tok == eos) | (st["tok_count"] + 1 >= st["max_new"])))
        return emit, tok, emit.to(torch.int32), out, finished

    def _update(self, logits, emit, adv, out, finished) -> None:
        """The state after a step whose forward gave ``logits``."""
        st = self._state
        st.update(
            last_logits=torch.where(emit[:, None], logits, st["last_logits"]),
            tok_count=st["tok_count"] + adv,
            next_pos=st["next_pos"] + adv,
            finished=finished,
            out=out,
        )

    def _step(self) -> None:
        """Emit each slot's pending token, forward it, advance its row."""
        emit, tok, adv, out, finished = self._emit()
        logits = self._forward(tok, adv, self._state["next_pos"])
        self._update(logits, emit, adv, out, finished)

    def _merged_step(self, inputs: tuple, bucket: int, pam: dict) -> tuple:
        """A pool decode step whose forward also prefills the admission
        group ``inputs`` = (pixels, pv, ids, mask) (and its NaViT masks,
        ``pam``) into a fresh cache of ``bucket`` columns; returns the
        prefill's ``(last_logits, cache, media, next_pos)`` for
        ``_scatter_admit``.  Counts as a step and as a chunk that takes no
        snapshot."""
        emit, tok, adv, out, finished = self._emit()
        positions = self._state["next_pos"]
        logits, _, *pre = self._pool_forward(adv, lambda cache: self._merged_admit(
            self.params, tok[:, None], adv[:, None], positions[:, None], cache, self._media,
            self._icv, *inputs, bucket, **pam))
        self._update(logits[:, -1, :].float(), emit, adv, out, finished)
        self.steps_run += 1
        self._chunk_count += 1
        self.merged_admits += 1
        return tuple(pre)

    # -- harvest -----------------------------------------------------------------

    def _snapshot(self) -> _Snapshot:
        """Queue the copy of this chunk's flags, counts and tokens to the host."""
        st = self._state
        # by the snapshots' own count: a merged step advances the chunk
        # count without a snapshot
        host = self._host[self._snapshots % len(self._host)]
        self._snapshots += 1
        for h, x in zip(host, (st["finished"], st["tok_count"], st["out"])):
            h.copy_(x, non_blocking=True)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return _Snapshot(host, event, self._chunk_count)

    def _harvest_row(self, i: int) -> int:
        """Pool row that carries slot ``i``'s result."""
        return i

    def _harvest(self, snap: _Snapshot, now: Optional[float] = None) -> dict:
        """Free the finished slots that ``snap`` shows; slots admitted at or
        after its chunk still show their previous occupant there and are
        skipped.  With ``now`` (online), record each live slot's first
        observed token."""
        live = [i for i, s in enumerate(self._slots)
                if s is not None and s.admitted_at < snap.gen]
        if not live:
            return {}
        if snap.event is not None:
            snap.event.synchronize()
        finished, counts, out = (x.numpy() for x in snap.host)
        results = {}
        for i in live:
            r = self._harvest_row(i)
            uid = self._slots[i].request.uid
            if now is not None and counts[r] > 0 and uid not in self.first_token_s:
                self.first_token_s[uid] = now
            if finished[r]:
                results[uid] = out[r, : counts[r]].copy()
                self._slots[i] = None
        return results


class BeamServingEngine(ServingEngine):
    """Continuous batching for beam search, the reference's eval decode
    (``num_beams=3``, reference config/inference.yaml:26-30).

    Each request takes a contiguous group of ``num_beams`` pool rows
    (``n_slots`` counts requests).  Its prefill runs once and is written to
    each row of its group (``beam_generate``'s repeat after the shared
    prefill).  Each lockstep step runs one HF beam transition per live
    group (top-2K candidates, EOS candidates into a K-slot finished pool,
    the live beams chosen), permutes only the decoded tail of the group's
    cache rows by beam parent, and forwards the K chosen tokens.  The
    result is the HF-finalised best hypothesis, ``beam_generate``'s.

    Early release at ``length_penalty <= 0`` (the reference's 0.0): once a
    group's finished pool holds K hypotheses whose worst score is at least
    its best live score, no continuation can enter the pool or win (step
    log-probs are <= 0, and ``len**lp`` in (0, 1] only lowers a penalised
    score), so the group frees at once.  At ``length_penalty > 0`` groups
    run all ``max_new`` steps.

    Length-penalty caveat: hypothesis scores divide by the TRUE prompt
    length plus the generated length; the static batch path divides by the
    PADDED batch length (HF semantics, batching-dependent).  The two agree
    at the reference's ``length_penalty=0.0``; at another value the engine
    matches an unpadded bs=1 run.
    """

    def __init__(self, prefill_fn, decode_fn, media_axes, text_cfg, params, *,
                 num_beams: int = 3, length_penalty: float = 0.0, n_slots: int = 4, **kw):
        if num_beams < 2:
            raise ValueError("BeamServingEngine needs num_beams >= 2; use ServingEngine "
                             "for greedy")
        if kw.get("merged_admit_fn") is not None:
            raise NotImplementedError(
                "merged admission is greedy-only: the beam pool's step is the beam "
                "transition, not the greedy emission the merged program embeds")
        self.num_beams = int(num_beams)
        self.length_penalty = float(length_penalty)
        self.n_groups = int(n_slots)
        super().__init__(prefill_fn, decode_fn, media_axes, text_cfg, params,
                         n_slots=self.n_groups, **kw)

    @property
    def n_rows(self) -> int:
        return self.n_groups * self.num_beams

    def run_fused(self) -> dict:
        raise NotImplementedError(
            "run_fused is greedy-only; beam groups use the host-driven run()")

    # -- state ---------------------------------------------------------------

    def _init_state(self) -> dict:
        st = super()._init_state()
        g, k, dev = self.n_groups, self.num_beams, self.device
        st.update(
            plen=torch.zeros((self.n_rows,), dtype=torch.int32, device=dev),  # lp divisor
            beam_live=torch.full((g, k), NEG_INF, dtype=torch.float32, device=dev),
            beam_fin=torch.full((g, k), NEG_INF, dtype=torch.float32, device=dev),
            beam_fin_tok=torch.full((g, k, self.out_cap), self.pad_token_id,
                                    dtype=torch.int32, device=dev),
        )
        return st

    # -- admission -----------------------------------------------------------

    def _rows(self, slots: torch.Tensor) -> torch.Tensor:
        k = self.num_beams
        return slots[:, None] * k + torch.arange(k, device=slots.device)[None, :]

    def _admit_state(self, rows: torch.Tensor, mask: torch.Tensor) -> None:
        """Beam 0 starts at score 0 and the others at -inf, so the first
        transition expands the shared prefill's distribution once."""
        st, k = self._state, self.num_beams
        groups = rows[:, 0] // k
        adm = groups.shape[0]
        st["plen"].index_copy_(0, rows.reshape(-1),
                               _rep(mask.sum(dim=1).to(torch.int32), k))
        live0 = torch.full((adm, k), NEG_INF, dtype=torch.float32, device=rows.device)
        live0[:, 0] = 0.0
        st["beam_live"].index_copy_(0, groups, live0)
        st["beam_fin"].index_fill_(0, groups, NEG_INF)
        st["beam_fin_tok"].index_fill_(0, groups, self.pad_token_id)

    # -- decode ----------------------------------------------------------------

    def _tail_permute(self, sel_rows: torch.Tensor) -> None:
        """Reorder the decoded tail of the K/V planes by ``sel_rows`` (each
        row's parent row).  Columns below the smallest prompt bucket are
        prefill-written and equal across a group's beams, and ``pos``,
        ``valid`` and ``index`` advance in lockstep within a group, so only
        the K/V tails can differ (``decode._beam_gather_cache``).  The
        gathered rows are a copy before they are written back."""
        start = self.prompt_buckets[0]
        for key in ("k", "v"):
            for x in _kv_leaves(self._cache[key]):
                x[:, :, start:] = x[:, sel_rows, start:]

    def _step(self) -> None:
        st = self._state
        eos, pad = self.eos_token_id, self.pad_token_id
        k, cap, lp = self.num_beams, self.out_cap, self.length_penalty
        g, rows = self.n_groups, self.n_rows
        dev = st["out"].device
        emit = st["active"][::k] & ~st["finished"][::k]  # (G,) live groups
        t = st["tok_count"][::k]
        min_new_g, plen_g = st["min_new"][::k], st["plen"][::k]

        # ---- the beam transition (decode.beam_transition, per group) ----
        logp = torch.log_softmax(st["last_logits"].reshape(g, k, -1), dim=-1)
        vocab = logp.shape[-1]
        logp[:, :, eos] = torch.where((t < min_new_g)[:, None], NEG_INF, logp[:, :, eos])
        cand = st["beam_live"][:, :, None] + logp
        top_scores, src_beam, token = _topk_2k_two_stage(cand, g, k, vocab)
        is_eos = token == eos
        cols = torch.arange(cap, device=dev)
        parent_hist = _take_rows(st["out"].reshape(g, k, cap), src_beam)
        cand_hist = torch.where(cols[None, None, :] == t[:, None, None], token[:, :, None],
                                parent_hist)

        # the finished pool: EOS candidates ranked < K compete for K slots,
        # divided by (prompt + generated) length ** lp
        lp_div = (plen_g + t + 1).float()[:, None] ** lp
        rank_ok = torch.arange(2 * k, device=dev)[None, :] < k
        eos_scores = torch.where(is_eos & rank_ok, top_scores / lp_div, NEG_INF)
        new_fin, best_i = _topk(torch.cat([st["beam_fin"], eos_scores], dim=1), k)
        new_fin_tok = _take_rows(torch.cat([st["beam_fin_tok"], cand_hist], dim=1), best_i)

        new_live, sel = _topk(torch.where(is_eos, NEG_INF, top_scores), k)
        new_beam = torch.gather(src_beam, 1, sel)
        new_tok = torch.gather(token, 1, sel)
        new_out = _take_rows(cand_hist, sel)

        # ---- a group finishes at its last transition, or released early ----
        last_t = t + 1 >= st["max_new"][::k]
        if lp <= 0.0:  # see the class docstring
            early = ((new_fin > NEG_INF / 2).all(dim=1)
                     & (new_fin.min(dim=1).values >= new_live.max(dim=1).values))
            fin_now = emit & (last_t | early)
        else:
            fin_now = emit & last_t
        cont = emit & ~fin_now

        # finishing groups: merge the live beams into the pool (HF finalize)
        all_s = torch.cat([new_fin, new_live / lp_div], dim=1)
        all_t = torch.cat([new_fin_tok, new_out], dim=1)
        best_tok = _take_rows(all_t, torch.argmax(all_s, dim=1)[:, None])[:, 0]
        hit = best_tok == eos
        best_len = torch.where(hit.any(dim=1), torch.argmax(hit.to(torch.int32), dim=1) + 1,
                               t + 1).to(torch.int32)

        # ---- per-row state ----
        cont_r = _rep(cont, k)
        out = torch.where(cont_r[:, None], new_out.reshape(rows, cap), st["out"])
        out[::k] = torch.where(fin_now[:, None], best_tok, out[::k])
        adv = cont_r.to(torch.int32)
        tok_count = st["tok_count"] + adv
        tok_count[::k] = torch.where(fin_now, best_len, tok_count[::k])
        positions = st["next_pos"]
        st.update(
            beam_live=torch.where(emit[:, None], new_live, st["beam_live"]),
            beam_fin=torch.where(emit[:, None], new_fin, st["beam_fin"]),
            beam_fin_tok=torch.where(emit[:, None, None], new_fin_tok, st["beam_fin_tok"]),
            finished=st["finished"] | _rep(fin_now, k),
            out=out,
            tok_count=tok_count,
            next_pos=positions + adv,
        )

        # ---- the cache tail by beam parent, then one forward ----
        par_rows = (torch.arange(g, device=dev)[:, None] * k + new_beam).reshape(rows)
        self._tail_permute(torch.where(cont_r, par_rows, torch.arange(rows, device=dev)))
        tok = torch.where(cont_r, new_tok.reshape(rows), pad)
        logits = self._forward(tok, adv, positions)
        st["last_logits"] = torch.where(cont_r[:, None], logits, st["last_logits"])

    def _harvest_row(self, i: int) -> int:
        return i * self.num_beams
