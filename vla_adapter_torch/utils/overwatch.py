"""Process-aware logging ("overwatch"; counterpart of
vla_adapter_tpu/utils/overwatch.py).

INFO on process 0, ERROR elsewhere. The port runs one process on one card
until multi-GPU serving and training are ported, so the process index is
0 of 1.
"""

from __future__ import annotations

import logging
import sys
from typing import Optional

_FORMAT = "%(asctime)s | %(levelname)-7s | %(name)s :: %(message)s"


def process_index() -> int:
    return 0


def process_count() -> int:
    return 1


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
