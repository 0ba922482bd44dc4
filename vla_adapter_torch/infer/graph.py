"""The serving forward captured once and replayed as a CUDA graph (the
port's counterpart of the JAX Predictor's ``jax.jit(forward)``).

An eager forward is some 3,700-4,300 host launches per request, and the
card waits on the host for most of it. :class:`GraphedForward` captures the
forward once per key (w8a8 backend, batch size, proprio present or not),
at the key's first request, as the JIT compiles once per shape, and then
replays it: one launch of the whole graph per request.

Per key it holds static device buffers for the inputs (ids, prompt
length, text valid, pixels and, if present, proprio) and pinned host
buffers that each request is copied through. The pixels' buffer takes the
dtype of the first request's pixels: uint8 (normalized inside the graph)
or fp32 (normalized on the host, ``device_normalize=False``); a replay
with pixels of another dtype raises. Everything from the pixels on (their
normalization included) is inside the graph, computed by the same code as
the eager path, so the two agree bit for bit.

At a key's first request the forward runs once eagerly on a side stream:
that builds the kernels, sets their shared-memory limits, creates the
per-device scratches and fills the plans' caches, none of which may happen
during a capture. Then it is captured. All graphs of one instance share
one memory pool. Captures, replays and the copy of an output to the host
happen under :data:`CARD_LOCK`, one lock for the process: no replay sees
another graph's reuse of its output buffer, and no thread touches the card
while another captures (a capture in the global mode fails if one does).
A capture that fails raises, naming the key; nothing falls back to the
eager path.

Launch counts (``ops/cuda_lib.py``): the warm-up and the capture each
count into their own ``Counter`` (the two must agree), and every replay
adds the capture's to ``cuda_lib.LAUNCHES``, so a replayed request counts
what an eager one counts.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Hashable, Optional, Tuple

import numpy as np
import torch

from vla_adapter_torch.ops import cuda_lib

# the static buffer's dtype of each input (proprio only where present);
# pixels: uint8, or fp32 where they were normalized on the host
INPUT_DTYPES = {"ids": torch.long, "plen": torch.long, "valid": torch.int32,
                "proprio": torch.float32}
PIXEL_DTYPES = {np.dtype(np.uint8): torch.uint8,
                np.dtype(np.float32): torch.float32}

# Every capture, replay and eager card forward of the process takes turns
# under this lock (module docstring).
CARD_LOCK = threading.RLock()


def input_dtype(name: str, arr: np.ndarray) -> torch.dtype:
    """The static buffer's dtype for input ``name`` given as ``arr``."""
    if name != "pixels":
        return INPUT_DTYPES[name]
    if arr.dtype not in PIXEL_DTYPES:
        raise ValueError(f"pixels of dtype {arr.dtype}: expected uint8 or "
                         "float32")
    return PIXEL_DTYPES[arr.dtype]


@dataclass
class Capture:
    """One key's graph, its static buffers and what its capture cost."""

    graph: torch.cuda.CUDAGraph
    static: Dict[str, torch.Tensor]
    pinned: Dict[str, torch.Tensor]
    out: torch.Tensor
    out_host: torch.Tensor
    launches: Dict[str, int]
    warmup_s: float
    capture_s: float
    replays: int = 0


class GraphedForward:
    """``forward(ids, plen, valid, pixels, proprio) -> device tensor``, run
    through one CUDA graph per key on ``device``. Call with the key and the
    host arrays; returns the output as a host fp32 array."""

    def __init__(self, forward: Callable[..., torch.Tensor],
                 device: torch.device):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {device}")
        self.forward = forward
        self.device = (device if device.index is not None else
                       torch.device("cuda", torch.cuda.current_device()))
        self.pool = torch.cuda.graph_pool_handle()
        self.captures: Dict[Hashable, Capture] = {}

    def __call__(self, key: Hashable, ids: np.ndarray, plen: np.ndarray,
                 valid: np.ndarray, pixels: np.ndarray,
                 proprio: Optional[np.ndarray]) -> np.ndarray:
        arrays = {"ids": ids, "plen": plen, "valid": valid, "pixels": pixels}
        if proprio is not None:
            arrays["proprio"] = proprio
        with CARD_LOCK:
            cap = self.captures.get(key)
            if cap is None:
                cap = self.captures[key] = self._capture(key, arrays)
            for name, arr in arrays.items():
                pinned = cap.pinned[name]
                if (tuple(arr.shape) != tuple(pinned.shape)
                        or input_dtype(name, arr) != pinned.dtype):
                    raise ValueError(
                        f"graph {key}: {name} {arr.dtype} {arr.shape}, the "
                        f"capture took {pinned.dtype} {tuple(pinned.shape)}")
                pinned.numpy()[...] = arr
                cap.static[name].copy_(pinned, non_blocking=True)
            cap.graph.replay()
            cuda_lib.add_launches(cap.launches)
            cap.replays += 1
            cap.out_host.copy_(cap.out, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            return cap.out_host.numpy().copy()

    def _run(self, static: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.forward(static["ids"], static["plen"], static["valid"],
                            static["pixels"], static.get("proprio"))

    def _capture(self, key: Hashable, arrays: Dict[str, np.ndarray]
                 ) -> Capture:
        static, pinned = {}, {}
        for name, arr in arrays.items():
            dtype = input_dtype(name, arr)
            static[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(
                self.device, dtype)
            pinned[name] = torch.empty(arr.shape, dtype=dtype,
                                       pin_memory=True)
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            t0 = time.perf_counter()
            with torch.cuda.stream(side), cuda_lib.recording() as warm:
                self._run(static)
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            try:
                with cuda_lib.recording() as captured, \
                        torch.cuda.graph(graph, pool=self.pool):
                    out = self._run(static)
            except RuntimeError as err:
                raise RuntimeError(f"CUDA graph capture failed for key "
                                   f"{key}: {err}") from err
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        if captured != warm:
            raise RuntimeError(f"graph {key}: the capture launched "
                               f"{dict(captured)}, the warm-up {dict(warm)}")
        return Capture(graph=graph, static=static, pinned=pinned, out=out,
                       out_host=torch.empty(out.shape, dtype=out.dtype,
                                            pin_memory=True),
                       launches=dict(captured), warmup_s=t1 - t0,
                       capture_s=t2 - t1)

    def stats(self) -> Dict[str, object]:
        """Per key: warm-up and capture seconds, kernel launches per replay,
        replays so far; and the bytes the shared pool holds on the card."""
        return {"keys": {str(k): {"warmup_s": c.warmup_s,
                                  "capture_s": c.capture_s,
                                  "launches": c.launches,
                                  "replays": c.replays}
                         for k, c in self.captures.items()},
                "pool_bytes": pool_bytes(self.pool, self.device)}


def pool_bytes(pool: Tuple[int, int], device: torch.device) -> int:
    """Bytes of the card's memory that segments of ``pool`` hold (the
    caching allocator's snapshot)."""
    want = tuple(pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if seg["device"] == device.index
               and tuple(seg.get("segment_pool_id", ())) == want)
