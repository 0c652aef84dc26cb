"""Serving runtime: a batching executor in front of the pipeline
(counterpart of diffusionrenderer_tpu/serving.py).

* callers submit requests (`submit` returns a Future);
* a worker thread groups compatible requests (same model_type, shape,
  steps, guidance, normal flag and condition keys) into one batch of up to
  `max_batch` rows, so the per-dispatch cost is paid once for all of them;
* that worker is the only thread that launches work on the pipeline's
  device: it selects the device once, and each batch is one `generate`
  with a seed per row, so a batched row gets the noise of a solo run.

The executor is host-side Python around the pipeline: control plane only.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .pipeline import DiffusionRendererPipeline, PixelInput
from .utils.profiling import logger, phase_timer


@dataclasses.dataclass
class Request:
    data_batch: Dict[str, Any]
    seed: int
    normalize_normal: bool
    future: Future
    bucket: Tuple


class ServingExecutor:
    """Batching front-end over one DiffusionRendererPipeline."""

    def __init__(
        self,
        pipeline: DiffusionRendererPipeline,
        max_batch: int = 4,
        max_wait_ms: float = 5.0,
    ):
        self.pipeline = pipeline
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self._queue: "queue.Queue[Optional[Request]]" = queue.Queue()
        self._worker = threading.Thread(target=self._run, daemon=True)
        # _state_lock orders submits against shutdown: a request is either
        # enqueued strictly before the shutdown sentinel (FIFO guarantees the
        # worker sees it) or the submit raises, so no future can be accepted
        # and then never resolve.
        self._state_lock = threading.Lock()
        self._accepting = True
        self._abort = False
        self._backlog: "deque[Request]" = deque()  # worker-local only
        self._worker.start()

    # -- public API ---------------------------------------------------------

    def submit(
        self,
        data_batch: Dict[str, Any],
        seed: int = 42,
        normalize_normal: bool = False,
    ) -> Future:
        """Enqueue one generation; the returned Future resolves to the uint8
        (B, T, H, W, C) result.  Batch dim of each request must be 1."""
        shape_key = next(iter(data_batch))
        for k in ("rgb", "image", "depth", "basecolor"):
            if k in data_batch:
                shape_key = k
                break
        shape = tuple(np.shape(data_batch[shape_key]))
        bucket = (
            self.pipeline.model_type,
            shape,
            self.pipeline.num_steps,
            float(self.pipeline.guidance),
            normalize_normal,
            tuple(sorted(data_batch)),
        )
        fut: Future = Future()
        with self._state_lock:
            if not self._accepting:
                raise RuntimeError("ServingExecutor is shut down")
            self._queue.put(
                Request(data_batch, seed, normalize_normal, fut, bucket)
            )
        return fut

    def shutdown(self, drain: bool = True, join_timeout: float = 30.0) -> None:
        """Stop the executor.  Every future ever returned by `submit` is
        guaranteed to complete: with drain=True (default) accepted requests
        are dispatched before the worker exits; with drain=False pending
        requests fail fast with RuntimeError (a batch already dispatched
        still finishes: queued device work is not aborted).  Subsequent
        `submit` calls raise.  Idempotent."""
        with self._state_lock:
            self._accepting = False
            if not drain:
                self._abort = True
            self._queue.put(None)
        self._worker.join(timeout=join_timeout)
        # Safety net (idempotent re-shutdown, worker join timeout): fail
        # anything still queued rather than leaving futures forever-pending.
        while True:
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                break
            if r is not None and not r.future.done():
                r.future.set_exception(
                    RuntimeError("ServingExecutor shut down before dispatch")
                )

    # -- worker -------------------------------------------------------------

    def _collect_batch(self) -> List[Request]:
        # The worker-local backlog holds requests deferred by bucketing; it
        # is always drained before the shared queue so a deferred request
        # can never land BEHIND the shutdown sentinel (which would turn a
        # graceful drain into a dropped request).
        if self._backlog:
            first: Optional[Request] = self._backlog.popleft()
        else:
            first = self._queue.get()
        if first is None:
            return []
        batch = [first]
        # One ABSOLUTE deadline for the whole batch: a per-get timeout would
        # reset on every arrival, letting a steady trickle hold the batch
        # open for up to max_batch x max_wait while request 0 waits.
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            if self._backlog:
                if self._backlog[0].bucket == first.bucket:
                    batch.append(self._backlog.popleft())
                    continue
                break  # head-of-line different bucket: it dispatches next
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                self._queue.put(None)  # re-signal shutdown
                break
            if nxt.bucket != first.bucket:
                # Different bucket: defer to its own dispatch.
                self._backlog.append(nxt)
                break
            batch.append(nxt)
        return batch

    def _run(self) -> None:
        if self.pipeline.device.type == "cuda":
            torch.cuda.set_device(self.pipeline.device)
        while True:
            batch = self._collect_batch()
            if not batch:
                # Sentinel reached.  FIFO + the submit/shutdown lock mean
                # every accepted request was already collected: exit.
                return
            if self._abort:
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(
                            RuntimeError("ServingExecutor aborted")
                        )
                continue
            try:
                self._dispatch(batch)
            except Exception as e:  # the callers read it from their futures
                logger.exception("serving: dispatch of %d failed", len(batch))
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)

    def _dispatch(self, batch: List[Request]) -> None:
        n = len(batch)
        logger.info("serving: dispatching batch of %d (%s)", n,
                    batch[0].bucket[:2])
        # Merge on the host, then one upload per condition key.
        keys = batch[0].data_batch.keys()

        def _merge(k):
            rows = [_host(r.data_batch[k]) for r in batch]
            if any(r.dtype == np.uint8 for r in rows) and not all(
                r.dtype == np.uint8 for r in rows
            ):
                # Mixed uint8/[-1,1]-float rows: a raw concat would keep the
                # uint8 rows at [0,255] scale.  Unify to signed-range float
                # (uint8-only batches stay uint8: the raw-upload path).
                rows = [
                    r.astype(np.float32) * (2.0 / 255.0) - 1.0
                    if r.dtype == np.uint8 else r
                    for r in rows
                ]
            return np.concatenate(rows, axis=0)

        merged = {k: _merge(k) for k in keys if k != "context_index"}
        if "context_index" in keys:
            merged["context_index"] = np.concatenate(
                [_host(r.data_batch["context_index"]).reshape(-1) for r in batch]
            )
        # One seed per batched row: row i's noise is the noise of request i
        # dispatched alone with its own seed.
        seeds = [r.seed for r in batch]
        normal_mask = np.asarray(
            [float(r.normalize_normal) for r in batch], np.float32
        )
        with phase_timer("serving/dispatch"):
            out = self.pipeline.generate(
                merged, normalize_normal=normal_mask, seed=seeds
            )
        for i, r in enumerate(batch):
            r.future.set_result(out[i : i + 1])


def _host(x) -> np.ndarray:
    """A request's array on the host (numpy, or a CPU tensor's view)."""
    if isinstance(x, PixelInput):
        raise TypeError("submit host arrays or tensors, not a PixelInput: the "
                        "executor merges requests on the host")
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
