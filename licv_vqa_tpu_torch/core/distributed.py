"""Rank-zero gating and preemption handling, single process (counterpart of
``licv_vqa_tpu/core/distributed.py``).

- ``is_main_process()``: the rank-zero gate for the final artifact.  The
  port trains on one device in one process; under an initialised
  ``torch.distributed`` group it is rank 0.
- ``PreemptionGuard``: SIGTERM/SIGINT turn into a flag the train loop polls,
  so a preempted job checkpoints and exits cleanly instead of dying
  mid-step.

Multi-process initialisation (JAX ``maybe_initialize_distributed``) is not
ported: ROADMAP.md Queue 1 item 16.
"""

from __future__ import annotations

import signal
import threading

from ..utils.log import get_logger

logger = get_logger("distributed")


def is_main_process() -> bool:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


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
