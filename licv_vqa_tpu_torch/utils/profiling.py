"""Tracing and step timing (counterpart of ``licv_vqa_tpu/utils/profiling.py``).

- ``trace(log_dir)``: a ``torch.profiler`` context (host and CUDA
  activities) that writes a Chrome trace, ``trace.json``, under ``log_dir``;
- ``StepTimer``: per-step wall-clock stats fed to the metrics sink.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Iterator, Optional

import numpy as np


@contextlib.contextmanager
def trace(log_dir: str | Path) -> Iterator[None]:
    import torch
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / "trace.json"))


class StepTimer:
    def __init__(self, window: int = 50):
        self.window = window
        self._times: list[float] = []
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self._times.append(dt)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now
        return dt

    @property
    def stats(self) -> dict:
        if not self._times:
            return {}
        arr = np.asarray(self._times)
        return {
            "step_time_mean_s": float(arr.mean()),
            "step_time_p50_s": float(np.percentile(arr, 50)),
            "step_time_p95_s": float(np.percentile(arr, 95)),
            "steps_per_sec": float(1.0 / max(arr.mean(), 1e-9)),
        }
