"""Tracing / profiling utilities -- the port of
``nbest_asr_tpu/utils/profiling.py`` (``trace`` :24, ``annotate`` :35,
``StepTimer`` :41).

- ``trace(logdir)``: context manager around ``torch.profiler.profile``
  that writes a Chrome trace (``trace_<pid>_<ms>.json``) under
  ``logdir``.  It always records CPU activity and records CUDA activity
  when the run's device is CUDA; a profiler that fails to start or to
  write raises.
- ``StepTimer``: lightweight per-step wall-time stats; the caller fences
  (``torch.cuda.synchronize()`` on the card), as JAX's callers
  ``block_until_ready``.
- ``annotate(name)``: ``torch.profiler.record_function``, so host-side
  phases (pack, decode, dumps) show up in the same timeline.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str, device: Optional[torch.device] = None):
    """Profile the body and write its Chrome trace under ``logdir``.
    ``device`` is the run's device (None: CUDA when it is available)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available() if device is None \
        else torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(logdir, f"trace_{os.getpid()}_"
                        f"{time.time_ns() // 1_000_000}.json")
    prof.export_chrome_trace(path)
    if not os.path.getsize(path):
        raise RuntimeError(f"the profiler wrote an empty trace at {path}")


def annotate(name: str):
    return torch.profiler.record_function(name)


@dataclass
class StepTimer:
    """Collects fenced per-step wall times.

    >>> timer = StepTimer()
    >>> with timer.step():
    ...     state, stats = train_step(...)
    ...     torch.cuda.synchronize()
    >>> timer.summary()
    """

    times: List[float] = field(default_factory=list)
    warmup: int = 2

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)

    def summary(self) -> dict:
        import numpy as np

        t = np.asarray(self.times[self.warmup:] or self.times)
        return {
            "steps": len(t),
            "mean_s": float(t.mean()) if t.size else 0.0,
            "p50_s": float(np.percentile(t, 50)) if t.size else 0.0,
            "p95_s": float(np.percentile(t, 95)) if t.size else 0.0,
            "total_s": float(t.sum()),
        }
