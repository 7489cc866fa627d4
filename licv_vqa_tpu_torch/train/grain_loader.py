"""Optional Grain-backed input pipeline (counterpart of
``licv_vqa_tpu/train/grain_loader.py``, the same pipeline on the same
seeds).

Over the threaded ``DataLoader`` it brings:

- true multi-PROCESS workers (``mp_prefetch`` for ``num_workers > 1``:
  PIL decode and tokenization off the GIL);
- a deterministic, checkpointable iterator: ``get_state`` pickles
  ``(epoch, iterator state)`` mid-epoch, and ``set_state`` on a fresh
  loader of the same configuration replays the exact remaining order;
- ``shard_index``/``shard_count``: disjoint slices of each epoch's order,
  truncated to a common length.

Same interface as ``train.loader.DataLoader`` (``__len__`` + ``__iter__``
yielding collated batches), so the Trainer takes either.  Select with
``data_cfg.loader=grain``.  The port's ranks each build the one
seed-ordered global batch and take their rows of it (``train/trainer.py``),
so the train CLI reads grain unsharded (``shard_count=1``) on any number of
ranks: every rank sees JAX's single-process order.  ``grain`` is imported
when a loader is made; where it is missing that raises.
"""

from __future__ import annotations

from typing import Callable

from ..utils.log import get_logger

logger = get_logger("grain")


class _BatchOfDicts:
    """Batch transform: list of sample dicts → collated arrays."""

    def __init__(self, collate_fn: Callable):
        self.collate_fn = collate_fn

    def __call__(self, items: list) -> dict:
        return self.collate_fn(items)


class GrainDataLoader:
    def __init__(
        self,
        dataset,  # len + __getitem__ (a RandomAccessDataSource)
        batch_size: int,
        collate_fn: Callable,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 4,
        num_epochs: int | None = None,
        drop_last: bool = True,
        shard_index: int = 0,
        shard_count: int = 1,
    ):
        import grain.python as gp

        self._gp = gp
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.num_epochs = num_epochs
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        # a disjoint 1/shard_count slice of the (per-epoch reshuffled) order
        self.shard_index = shard_index
        self.shard_count = max(1, shard_count)
        self.collate_fn = collate_fn
        self.epoch = 0
        self._cur_epoch = 0  # epoch whose seed built the CURRENT pipeline
        self._iter_ds = self._build(seed)
        self._it = None
        self._restored_it = None

    def _build(self, seed: int):
        gp = self._gp
        ds = gp.MapDataset.source(self.dataset).seed(seed)
        if self.shuffle:
            ds = ds.shuffle()
        if self.shard_count > 1:
            # truncate to the common length: uneven shards would desync the
            # readers' loops (one finishing early stalls the collectives)
            ds = ds[self.shard_index :: self.shard_count]
            ds = ds[: len(self.dataset) // self.shard_count]
        if self.num_epochs is not None:
            ds = ds.repeat(self.num_epochs)
        batched = ds.batch(
            self.batch_size,
            drop_remainder=self.drop_last,
            batch_fn=_BatchOfDicts(self.collate_fn),
        )
        iter_ds = batched.to_iter_dataset()
        if self.num_workers and self.num_workers > 1:
            iter_ds = iter_ds.mp_prefetch(
                gp.MultiprocessingOptions(num_workers=self.num_workers)
            )
        return iter_ds

    def __len__(self) -> int:
        n = len(self.dataset) // self.shard_count
        per_epoch = n // self.batch_size if self.drop_last else -(-n // self.batch_size)
        return per_epoch * (self.num_epochs or 1)

    def __iter__(self):
        if self._restored_it is not None:
            # resume: hand out the mid-epoch iterator restored by set_state
            # exactly once, then fall back to per-epoch rebuilds
            it, self._restored_it = self._restored_it, None
            self._it = it
            return it
        # fresh shuffle order per epoch (matches the threaded loader)
        self._cur_epoch = self.epoch
        if hasattr(self.dataset, "set_epoch"):
            # before _build: mp_prefetch pickles the dataset (with the epoch
            # baked in) into the worker processes at iterator creation
            self.dataset.set_epoch(self.epoch)
        self._iter_ds = self._build(self.seed + self.epoch)
        self.epoch += 1
        self._it = iter(self._iter_ds)
        return self._it

    # -- checkpointable iteration ------------------------------------------
    def iterator(self):
        """A persistent iterator whose state can be saved/restored."""
        if self._it is None:
            self._it = iter(self._iter_ds)
        return self._it

    def get_state(self) -> bytes | None:
        """Serialized (epoch, grain iterator state) captured mid-epoch, or
        None when nothing is in flight.  Feed to ``set_state`` on a fresh
        loader with the same config to replay the exact remaining order."""
        it = self._it
        if it is None or not hasattr(it, "get_state"):
            return None
        import pickle

        return pickle.dumps({"epoch": self._cur_epoch, "it": it.get_state()})

    def set_state(self, state: bytes) -> None:
        import pickle

        d = pickle.loads(state)
        self._cur_epoch = int(d["epoch"])
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self._cur_epoch)
        self._iter_ds = self._build(self.seed + self._cur_epoch)
        it = iter(self._iter_ds)
        it.set_state(d["it"])
        self.epoch = self._cur_epoch + 1
        self._restored_it = it
        self._it = it
