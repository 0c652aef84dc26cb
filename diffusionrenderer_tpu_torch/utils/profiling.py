"""Tracing, phase timing and the metrics registry (counterpart of
diffusionrenderer_tpu/utils/profiling.py).

* `trace(dir)` - torch.profiler over the CPU and, with a card, CUDA; writes
  a Chrome trace into dir (open it in Perfetto or chrome://tracing);
* `annotate(name)` - a named range in that trace (record_function), and an
  NVTX range when a card is present;
* `Timer` / `phase_timer` - wall-clock phase timers recording into the
  process-wide `metrics` registry;
* `device_get_scalar` - fetch one element, which waits for the work that
  produced it.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List

import numpy as np
import torch

logger = logging.getLogger("diffusionrenderer_tpu_torch")


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed work (host, and the card's kernels when CUDA is
    available) and write it as a Chrome trace, log_dir/trace.json."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Label a region in a trace (and, with a card, an NVTX range)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def device_get_scalar(x: torch.Tensor) -> float:
    """Fetch the last element to the host: waits for the work behind x."""
    return float(x.reshape(-1)[-1].item())


class MetricsRegistry:
    """Process-wide phase timing aggregation (thread-safe: the serving
    worker records beside its callers)."""

    def __init__(self):
        self._times: Dict[str, List[float]] = defaultdict(list)
        self._lock = threading.Lock()

    def record(self, name: str, seconds: float) -> None:
        with self._lock:
            self._times[name].append(seconds)
        logger.debug("phase %s: %.3fs", name, seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            snapshot = {name: list(vals) for name, vals in self._times.items()}
        out = {}
        for name, vals in snapshot.items():
            arr = np.asarray(vals)
            out[name] = {
                "count": int(arr.size),
                "total_s": float(arr.sum()),
                "mean_s": float(arr.mean()),
                "min_s": float(arr.min()),
                "max_s": float(arr.max()),
            }
        return out

    def reset(self) -> None:
        with self._lock:
            self._times.clear()


metrics = MetricsRegistry()


@contextlib.contextmanager
def phase_timer(name: str, registry: MetricsRegistry = metrics) -> Iterator[None]:
    t0 = time.perf_counter()
    try:
        yield
    finally:
        registry.record(name, time.perf_counter() - t0)


class Timer:
    """Reusable named timer: `with Timer('decode') as t: ...; t.seconds`."""

    def __init__(self, name: str = "timer"):
        self.name = name
        self.seconds = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        metrics.record(self.name, self.seconds)
        return False
