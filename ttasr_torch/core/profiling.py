"""Profiling/tracing hooks (port of ``ttasr/core/profiling.py``).

- ``trace(dir)``: context manager around ``torch.profiler`` (CPU
  activity, and CUDA activity when a card is present), writing a Chrome
  trace (``chrome://tracing``, Perfetto) into ``dir``,
- ``annotate(name)``: a named region in that trace
  (``torch.profiler.record_function``),
- ``StageTimer``: per-stage wall-clock accounting for the serving loop
  (mel / encode / decode / postprocess), exported as a dict for the
  health endpoints.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a torch profiler trace into ``log_dir``
    (``trace_<pid>_<ns>.json``)."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """Named region visible in profiler traces."""
    import torch

    return torch.profiler.record_function(name)


class StageTimer:
    """Accumulates wall-clock per named stage; thread-safe enough for the
    single-writer serving loop."""

    def __init__(self) -> None:
        self._total: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._total[name] += time.perf_counter() - t0
            self._count[name] += 1

    def snapshot(self) -> Dict[str, dict]:
        return {
            name: {
                "total_s": round(self._total[name], 4),
                "count": self._count[name],
                "mean_ms": round(1000 * self._total[name] / self._count[name], 2)
                if self._count[name] else 0.0,
            }
            for name in self._total
        }

    def reset(self) -> None:
        self._total.clear()
        self._count.clear()
