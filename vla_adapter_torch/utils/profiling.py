"""Profiling hooks (counterpart of vla_adapter_tpu/utils/profiling.py).

* :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace (``trace.json``, viewable in Perfetto or chrome://tracing)
  under ``logdir`` for a window of steps; the card's kernels too when
  CUDA is available.
* :class:`StepTimer`: wall-clock timing with warm-up discard and a
  percentile summary. PyTorch returns before the card finishes, so a
  timed step must end in a synchronisation (``torch.cuda.synchronize()``
  or reading a result on the host), as the JAX one must block on an
  output.
* :func:`annotate`: ``torch.profiler.record_function``, so that named
  regions show up in the trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np


@contextlib.contextmanager
def trace(logdir: str, enabled: bool = True):
    """Profile the block into ``logdir/trace.json``; yields the profiler
    (None when not ``enabled``)."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """A named region of the trace: ``with annotate("step"): ...``."""
    import torch

    return torch.profiler.record_function(name)


class StepTimer:
    """``with timer: step()`` per step; the first ``warmup`` steps are not
    kept. :meth:`summary` gives the JAX package's keys."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times: List[float] = []
        self._t0: Optional[float] = None
        self._count = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self._times.append(dt)

    def times(self) -> List[float]:
        """The kept times, in seconds, in order."""
        return list(self._times)

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {}
        a = np.asarray(self._times)
        return {
            "mean_s": float(a.mean()),
            "median_s": float(np.median(a)),
            "p90_s": float(np.percentile(a, 90)),
            "min_s": float(a.min()),
            "steps": len(a),
        }
