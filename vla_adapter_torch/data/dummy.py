"""Data-free training batches (copy of vla_adapter_tpu/data/dummy.py).

Random images, proprio and action chunks with the real batch schema, in
the model's fixed-shape input format (``models/vla.py``), so the finetune
path runs without RLDS data. The draws are the JAX package's, from a numpy
``Generator``: both packages see the same batches from the same seed.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from vla_adapter_torch.core.config import VLAConfig


def make_dummy_batch(
    cfg: VLAConfig,
    batch_size: int,
    rng: np.random.Generator,
    accum_steps: Optional[int] = None,
    inference_layout: bool = False,
) -> Dict[str, np.ndarray]:
    """One batch; with ``accum_steps``, a leading micro-batch axis of that
    many micro-batches of ``batch_size // accum_steps`` rows."""
    if accum_steps:
        micro = [
            make_dummy_batch(cfg, batch_size // accum_steps, rng,
                             inference_layout=inference_layout)
            for _ in range(accum_steps)
        ]
        return {k: np.stack([m[k] for m in micro]) for k in micro[0]}

    consts = cfg.constants
    v = cfg.vision
    num_q = consts.num_action_query_tokens
    t = cfg.max_text_tokens
    tail = 1 if inference_layout else 0  # STOP token at inference

    prompt_len = rng.integers(8, t - num_q - tail,
                              size=batch_size).astype(np.int32)
    input_ids = np.zeros((batch_size, t), np.int32)
    valid = np.zeros((batch_size, t), np.int32)
    for i in range(batch_size):
        p = prompt_len[i]
        input_ids[i, :p] = rng.integers(3, min(cfg.llm.vocab_size, 10_000),
                                        size=p)
        input_ids[i, p:p + num_q] = 1
        if inference_layout:
            input_ids[i, p + num_q] = 2  # STOP_INDEX
        valid[i, :p + num_q + tail] = 1

    batch = {
        "input_ids": input_ids,
        "prompt_len": prompt_len,
        "text_valid": valid,
        "pixel_values": rng.normal(
            size=(batch_size, v.num_images, v.primary.image_size,
                  v.primary.image_size, v.channels_per_image)
        ).astype(np.float32),
        "actions": rng.uniform(
            -1, 1,
            size=(batch_size, consts.num_actions_chunk, consts.action_dim)
        ).astype(np.float32),
    }
    if cfg.use_proprio:
        batch["proprio"] = rng.normal(
            size=(batch_size, consts.proprio_dim)).astype(np.float32)
    return batch


class DummyDataset:
    """Infinite iterator of dummy batches."""

    def __init__(self, cfg: VLAConfig, batch_size: int, seed: int = 0,
                 accum_steps: Optional[int] = None):
        self.cfg = cfg
        self.batch_size = batch_size
        self.accum_steps = accum_steps
        self._rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield make_dummy_batch(self.cfg, self.batch_size, self._rng,
                                   self.accum_steps)
