"""Batch collation (copy of vla_adapter_tpu/data/collator.py): the
examples are already fixed-shape, so a batch is a stack, optionally folded
into (accum, micro, ...) for gradient accumulation."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

_ARRAY_KEYS = (
    "input_ids", "prompt_len", "text_valid", "labels", "pixel_values",
    "actions", "proprio",
)


def collate(examples: Sequence[Dict], accum_steps: Optional[int] = None
            ) -> Dict[str, np.ndarray]:
    batch = {}
    for k in _ARRAY_KEYS:
        n = sum(k in e for e in examples)
        if n == 0:
            continue
        if n != len(examples):
            raise ValueError(
                f"key {k!r} present in {n}/{len(examples)} examples: every "
                "dataset in a mixture must emit the same keys")
        batch[k] = np.stack([np.asarray(e[k]) for e in examples])
    if "dataset_name" in examples[0]:
        batch["dataset_name"] = [e["dataset_name"] for e in examples]
    if accum_steps and accum_steps > 1:
        b = len(examples)
        if b % accum_steps:
            raise ValueError(f"batch {b} is not a multiple of "
                             f"{accum_steps} micro-batches")
        micro = b // accum_steps
        for k, v in batch.items():
            if isinstance(v, np.ndarray):
                batch[k] = v.reshape((accum_steps, micro) + v.shape[1:])
            else:
                batch[k] = [list(v[i * micro:(i + 1) * micro])
                            for i in range(accum_steps)]
    return batch
