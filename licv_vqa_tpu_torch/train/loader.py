"""Host-side data loading: shuffled batching + threaded prefetch (a copy of
``licv_vqa_tpu/train/loader.py``).

Image decode + tokenization run in a pool of worker threads (PIL/np release
the GIL for the heavy parts) while the device consumes the previous batch; a
bounded queue applies backpressure.  Batches are numpy dicts; the trainer
moves them to the device.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        collate_fn: Callable,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 4,
        prefetch: int = 4,
        drop_last: bool = True,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _index_batches(self) -> list[list[int]]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        batches = [
            idx[i : i + self.batch_size].tolist()
            for i in range(0, len(idx), self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __iter__(self) -> Iterator[dict]:
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self.epoch)  # fresh per-epoch shot draws
        batches = self._index_batches()
        self.epoch += 1
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def make(batch_idx: list[int]) -> dict:
            items = [self.dataset[i] for i in batch_idx]
            return self.collate_fn(items)

        def put(item) -> bool:
            # never block forever: the consumer may have gone away mid-epoch
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            # Submission runs in a BOUNDED window: at most num_workers +
            # prefetch futures outstanding, the next submitted only after a
            # result is consumed.  Submitting the whole epoch upfront lets
            # completed-but-unconsumed collated batches (each ~40MB+ with
            # 33-image teacher views) pile up without bound whenever the device
            # step is slower than the decode threads — host OOM.
            from collections import deque
            from concurrent.futures import ThreadPoolExecutor

            window = self.num_workers + max(self.prefetch, 1)
            pool = ThreadPoolExecutor(self.num_workers)
            pending: "deque" = deque()
            try:
                it = iter(batches)
                for b in it:
                    pending.append(pool.submit(make, b))
                    if len(pending) < window:
                        continue
                    if not put(pending.popleft().result()):
                        return
                while pending:
                    if not put(pending.popleft().result()):
                        return
            except Exception as e:  # surface worker errors to the consumer
                put(e)
            finally:
                # early exit (limit_train_batches, preemption, error): drop
                # everything not yet running instead of decoding the epoch out
                for f in pending:
                    f.cancel()
                pool.shutdown(wait=False, cancel_futures=True)
                put(None)  # stop-aware: returns once delivered or consumer left

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            # unblock a producer stuck in put() and let it run its cleanup
            while not out_q.empty():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break
