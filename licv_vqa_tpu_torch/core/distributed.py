"""Multi-process start-up, rank-zero gating and preemption handling
(counterpart of ``licv_vqa_tpu/core/distributed.py``).

- ``maybe_initialize_distributed()``: reads the launcher's environment
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``,
  as ``python -m torch.distributed.run`` sets them) and initialises the
  default process group: ``nccl`` for a CUDA device, ``gloo`` for the CPU,
  or the backend the caller names.  Without a launcher it does nothing (one
  process).
- ``is_main_process()``: the rank-zero gate for the final artifacts.
- ``PreemptionGuard``: SIGTERM/SIGINT turn into a flag the train loop polls,
  so a preempted job checkpoints and exits cleanly instead of dying
  mid-step; ``sync_should_stop`` makes it the global OR over the ranks, so
  every rank stops at the same micro-step.
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Optional

from ..utils.log import get_logger

logger = get_logger("distributed")


def launcher_env() -> Optional[tuple[int, int, int]]:
    """``(rank, world_size, local_rank)`` from the launcher's environment,
    or None where no launcher set ``WORLD_SIZE``."""
    if "WORLD_SIZE" not in os.environ:
        return None
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ.get("RANK", "0"))
    local = int(os.environ.get("LOCAL_RANK", str(rank)))
    return rank, world, local


def maybe_initialize_distributed(device_type: str = "cuda", backend: Optional[str] = None):
    """Initialise the default process group from the launcher's
    environment; returns the device this rank computes on, or None where no
    launcher is there (one process: the caller keeps its own device).

    The device is ``cuda:LOCAL_RANK`` (raises where that device does not
    exist; two ranks that share a card both set ``LOCAL_RANK=0``) or the
    CPU.  The backend is ``nccl`` on CUDA and ``gloo`` on the CPU unless
    ``backend`` names another; an initialisation that fails raises."""
    import torch
    import torch.distributed as dist

    env = launcher_env()
    if env is None:
        return None
    rank, world, local = env
    if device_type == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local >= n:
            raise RuntimeError(f"rank {rank}: LOCAL_RANK={local} but {n} CUDA device(s)")
        torch.cuda.set_device(local)
        device = torch.device("cuda", local)
    elif device_type == "cpu":
        device = torch.device("cpu")
    else:
        raise ValueError(f"device_type must be cuda or cpu, got {device_type!r}")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available in this build")
    if dist.is_initialized():
        if dist.get_world_size() != world or dist.get_rank() != rank:
            raise RuntimeError(
                f"default group is rank {dist.get_rank()}/{dist.get_world_size()}, the "
                f"launcher says {rank}/{world}")
        return device
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend=backend, rank=rank, world_size=world, **kw)
    logger.info("torch.distributed initialised: rank %d/%d (%s, %s)", rank, world,
                backend, device)
    return device


def shutdown_distributed() -> None:
    """Leave the default group (a barrier first, so no rank leaves while
    another still reduces) and drop the current mesh."""
    import torch.distributed as dist

    from .mesh import set_current_mesh

    set_current_mesh(None)
    if dist.is_available() and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def is_main_process() -> bool:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def sync_should_stop(local: bool) -> bool:
    """Global OR of the per-rank preemption flag, an ``all_reduce(MAX)``
    over the world (JAX ``_sync_should_stop``, train/trainer.py:61-73).
    A signal lands on ranks at different times; acting on the local flag
    would let ranks leave the loop at different micro-steps and hang the
    next collective.  One process: the flag itself."""
    import torch
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return bool(local)
    dev = torch.device("cuda", torch.cuda.current_device()) if (
        dist.get_backend() == "nccl") else torch.device("cpu")
    flag = torch.tensor([1 if local else 0], dtype=torch.int32, device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())


class PreemptionGuard:
    """Installs SIGTERM/SIGINT handlers that request a graceful stop;
    ``close()`` puts the previous handlers back."""

    def __init__(self, enabled: bool = True):
        self._stop = threading.Event()
        self._prev = {}
        if not enabled:
            return
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except ValueError:  # not the main thread
                pass

    def _handler(self, signum, frame):
        logger.warning("signal %s received — will checkpoint and stop", signum)
        self._stop.set()
        prev = self._prev.get(signum)
        if signum == signal.SIGINT and callable(prev):
            # a second Ctrl-C falls through to the previous handler
            signal.signal(signal.SIGINT, prev)

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()

    def close(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev = {}
