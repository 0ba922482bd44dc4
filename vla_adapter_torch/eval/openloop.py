"""Open-loop execution controllers (counterpart of
vla_adapter_tpu/eval/openloop.py).

Two ways of turning chunked predictions into per-step actions:

* :class:`ActionQueueController`, the LIBERO protocol (the reference's
  run_libero_eval.py:307-352): query when the queue is empty and execute
  the first ``num_open_loop_steps`` actions of the chunk open loop.
* :class:`TemporalEnsembleController`, CALVIN's "hi3" protocol (the
  reference's evaluate_calvin.py:392-508): three staggered queries per
  10-step cycle (at cycle steps 0, 1 and 2), each executed action the mean
  of the overlapping predictions. The reference's schedule is kept exactly,
  quirks included: the (a2, b1, c0) combination is used twice (cycle steps
  2 and 3), a7, b6 and c5 are never used, and the cycle ends on (b7, c6)
  and a bare c7.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, List, Optional

import numpy as np

Policy = Callable[..., np.ndarray]  # (*obs_args) -> (chunk, action_dim)


class ActionQueueController:
    def __init__(self, policy: Policy, num_open_loop_steps: int = 8):
        self.policy = policy
        self.num_open_loop_steps = num_open_loop_steps
        self.queue: deque = deque()

    def reset(self) -> None:
        self.queue.clear()

    def step(self, *obs_args, **obs_kwargs) -> np.ndarray:
        if len(self.queue) == 0:
            chunk = np.asarray(self.policy(*obs_args, **obs_kwargs))
            # the chunk's FIRST num_open_loop_steps actions, in order (a
            # maxlen deque would evict the head and run the tail instead)
            self.queue.extend(list(chunk)[: self.num_open_loop_steps])
        return self.queue.popleft()


# The reference schedule as (query_now, [(buffer, chunk index), ...]) per
# cycle position; buffers 0, 1 and 2 hold the queries of cycle steps 0-2.
_HI3_SCHEDULE = [
    (0, [(0, 0)]),
    (1, [(0, 1), (1, 0)]),
    (2, [(0, 2), (1, 1), (2, 0)]),
    (None, [(0, 2), (1, 1), (2, 0)]),  # the reference repeats t = 2
    (None, [(0, 3), (1, 2), (2, 1)]),
    (None, [(0, 4), (1, 3), (2, 2)]),
    (None, [(0, 5), (1, 4), (2, 3)]),
    (None, [(0, 6), (1, 5), (2, 4)]),
    (None, [(1, 7), (2, 6)]),
    (None, [(2, 7)]),
]

HI3_CYCLE_LEN = len(_HI3_SCHEDULE)


class TemporalEnsembleController:
    def __init__(self, policy: Policy):
        self.policy = policy
        self._pos = 0
        self._buffers: List[Optional[np.ndarray]] = [None, None, None]

    def reset(self) -> None:
        self._pos = 0
        self._buffers = [None, None, None]

    def step(self, *obs_args, **obs_kwargs) -> np.ndarray:
        query, combo = _HI3_SCHEDULE[self._pos]
        if query is not None:
            self._buffers[query] = np.asarray(
                self.policy(*obs_args, **obs_kwargs))
        parts = [self._buffers[b][c] for b, c in combo]
        self._pos = (self._pos + 1) % HI3_CYCLE_LEN
        return np.mean(parts, axis=0)
