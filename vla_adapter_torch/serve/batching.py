"""Dynamic micro-batching for the /act server (counterpart of
vla_adapter_tpu/serve/batching.py).

The reference server is serial batch-1: each request pays a full forward.
A batched forward costs far less per row than batch 1 does, so coalescing
concurrent requests raises what one card serves. This module is the
standard dynamic-batching layer:

  * requests queue up; a worker drains up to ``max_batch`` of them, waiting
    at most ``max_wait_ms`` after the first arrival (the latency bound);
  * the batch is grouped by (unnorm_key, proprio present, image count):
    rows in one forward share normalization statistics and input shapes;
  * each group is padded by repeating its last row up to the next bucket
    (1/2/4/8/16), so the Predictor captures one CUDA graph per bucket, not
    per request count.

Preprocessing (``Predictor.preprocess``) runs on the request's own thread;
the worker only stacks rows and runs the forward. Pure stdlib threading.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class _Request:
    images: Sequence[np.ndarray]
    instruction: str
    proprio: Optional[np.ndarray]
    unnorm_key: Optional[str]
    # preprocessed row (Predictor.preprocess), computed on the request's
    # thread so that the host image pipeline runs in parallel across
    # clients; the worker thread only stacks rows and runs the forward
    row: Optional[dict] = None
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    error: Optional[BaseException] = None


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class DynamicBatcher:
    """Coalesces concurrent predict requests into batched forwards.

    Thread-safe: call :meth:`predict` from any number of request threads.
    ``stats()`` exposes the realized batch sizes (observability + tests).
    """

    def __init__(
        self,
        predictor,
        max_batch: int = 16,
        max_wait_ms: float = 4.0,
        buckets: Sequence[int] = (1, 2, 4, 8, 16),
    ):
        # extend the bucket ladder (powers of two) up to max_batch so any
        # max_batch works with the default buckets
        buckets = list(buckets)
        while max(buckets) < max_batch:
            buckets.append(max(buckets) * 2)
        self.predictor = predictor
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.buckets = tuple(sorted(buckets))
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._closed = False
        self._batch_sizes: List[int] = []
        self._lock = threading.Lock()
        # serializes the closed-flag check against enqueue: without it a
        # request thread could pass the check, then enqueue after close()'s
        # final drain — stranding its caller in done.wait() forever
        self._shutdown_lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- client side --------------------------------------------------------

    def predict(
        self,
        images: Sequence[np.ndarray],
        instruction: str,
        proprio: Optional[np.ndarray] = None,
        unnorm_key: Optional[str] = None,
    ) -> np.ndarray:
        if self._closed:
            raise RuntimeError("DynamicBatcher is closed")
        req = _Request(images, instruction, proprio, unnorm_key)
        if hasattr(self.predictor, "preprocess"):
            # the host work runs here, on the caller's thread: concurrent
            # requests preprocess in parallel instead of serializing inside
            # the one batching worker
            req.row = self.predictor.preprocess(
                images, instruction, proprio, unnorm_key)
        with self._shutdown_lock:
            # atomic check+enqueue: once close() flips the flag (under this
            # lock), every request is either already in the queue — ahead of
            # the sentinel, so the worker or close()'s drain settles it — or
            # rejected here
            if self._closed:
                raise RuntimeError("DynamicBatcher is closed")
            self._q.put(req)
        req.done.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def close(self, join_timeout_s: float = 120.0) -> None:
        with self._shutdown_lock:
            self._closed = True
            self._q.put(None)
        deadline = time.monotonic() + join_timeout_s
        while True:
            self._worker.join(timeout=5)
            if not self._worker.is_alive():
                break
            # The in-flight forward outlasted the wait (a first capture of
            # a new bucket's graph may). Fail the stranded requests now so
            # their callers unblock, but re-enqueue a sentinel — draining
            # may have consumed the one above, and without it the worker
            # would block on q.get() forever once its forward finishes.
            self._fail_pending(RuntimeError("DynamicBatcher closed"))
            self._q.put(None)
            if time.monotonic() > deadline:
                # A wedged device forward can outlive any wait: give up on
                # the join (the worker is a daemon thread and a sentinel is
                # queued for it), unblock remaining callers, and return so
                # the server process itself can still shut down.
                break
        self._fail_pending(RuntimeError("DynamicBatcher closed"))

    def _fail_pending(self, err: BaseException) -> None:
        """Error out requests stranded behind the shutdown sentinel —
        without this their caller threads would block in done.wait()
        forever."""
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is not None:
                item.error = err
                item.done.set()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            sizes = list(self._batch_sizes)
        return {
            "num_forwards": len(sizes),
            "num_requests": int(sum(sizes)),
            "batch_sizes": sizes,
        }

    # -- worker side ---------------------------------------------------------

    def _drain(self, first: _Request) -> List[_Request]:
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:  # shutdown sentinel — requeue for _run
                self._q.put(None)
                break
            batch.append(item)
        return batch

    def _run(self) -> None:
        while True:
            first = self._q.get()
            if first is None:
                return
            batch = self._drain(first)
            for key, group in self._group(batch).items():
                self._execute(key, group)

    def _group(self, batch: List[_Request]) -> Dict[tuple, List[_Request]]:
        # image count is part of the key: wrist_image is optional at the
        # server, so 1- and 2-image requests can coexist — stacking them in
        # one forward would fail EVERY request in the group
        groups: Dict[tuple, List[_Request]] = {}
        for r in batch:
            key = (r.unnorm_key, r.proprio is not None, len(r.images))
            groups.setdefault(key, []).append(r)
        return groups

    def _execute(self, key, group: List[_Request]) -> None:
        unnorm_key, has_proprio, _num_images = key
        try:
            n = len(group)
            padded = _bucket(n, self.buckets)
            reqs = group + [group[-1]] * (padded - n)
            if all(r.row is not None for r in reqs):
                actions = self.predictor.predict_action_rows(
                    [r.row for r in reqs], unnorm_key)
            else:
                actions = self.predictor.predict_action_batch(
                    [r.images for r in reqs],
                    [r.instruction for r in reqs],
                    [r.proprio for r in reqs] if has_proprio else None,
                    unnorm_key,
                )
            with self._lock:
                self._batch_sizes.append(n)
            for r, a in zip(group, actions[:n]):
                r.result = np.asarray(a)
                r.done.set()
        except BaseException as e:  # noqa: BLE001 — propagate to callers
            for r in group:
                r.error = e
                r.done.set()
