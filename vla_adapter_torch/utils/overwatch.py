"""Process-aware logging ("overwatch"; counterpart of
vla_adapter_tpu/utils/overwatch.py).

INFO on process 0, ERROR elsewhere. The process index and count are the
``torch.distributed`` rank and world size once a process group is
initialized (``parallel/sharding.py:initialize_distributed``), else 0 of
1. ``local_zero_first`` runs process 0 through a block before the rest
(a cache one process fills and the others read).
"""

from __future__ import annotations

import contextlib
import logging
import sys
from typing import Optional

import torch.distributed as dist

_FORMAT = "%(asctime)s | %(levelname)-7s | %(name)s :: %(message)s"


def group_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if group_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if group_initialized() else 1


def is_main_process() -> bool:
    return process_index() == 0


def initialize_overwatch(name: str, level: Optional[int] = None
                         ) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        logger.addHandler(handler)
        logger.propagate = False
    if level is None:
        level = logging.INFO if is_main_process() else logging.ERROR
    logger.setLevel(level)
    return logger


@contextlib.contextmanager
def local_zero_first():
    """Process 0 runs the body first, the others after it has left the
    block (a barrier over the process group, the JAX package's
    ``sync_global_devices``); without a process group the body runs at
    once."""
    if process_count() == 1:
        yield
        return
    if is_main_process():
        yield
        dist.barrier()
    else:
        dist.barrier()
        yield
