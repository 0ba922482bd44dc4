"""Modality/length-grouped batching (copy of
vla_adapter_tpu/data/batching.py, the reference's util/batching_utils.py
SplitModalitySampler: the LLaVA-style sampler for VLM pretraining).

Groups examples so each batch is single-modality (multimodal vs text-only
— mixed batches would need ragged vision inputs) and length-sorted within
groups to minimize padding, while staying globally shuffled across epochs.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np


class SplitModalitySampler:
    def __init__(
        self,
        is_multimodal: Sequence[bool],
        lengths: Sequence[int],
        batch_size: int,
        seed: int = 0,
    ):
        self.is_multimodal = np.asarray(is_multimodal, bool)
        self.lengths = np.asarray(lengths)
        self.batch_size = batch_size
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _grouped_indices(self, rng: np.random.Generator) -> List[np.ndarray]:
        batches = []
        for modality in (True, False):
            idx = np.nonzero(self.is_multimodal == modality)[0]
            if len(idx) == 0:
                continue
            rng.shuffle(idx)
            # length-sort within megabatches of 8*batch_size, then split
            mega = 8 * self.batch_size
            for start in range(0, len(idx), mega):
                chunk = idx[start : start + mega]
                chunk = chunk[np.argsort(self.lengths[chunk])[::-1]]
                for b in range(0, len(chunk), self.batch_size):
                    batch = chunk[b : b + self.batch_size]
                    if len(batch) == self.batch_size:
                        batches.append(batch)
        rng.shuffle(batches)
        return batches

    def __iter__(self) -> Iterator[np.ndarray]:
        rng = np.random.default_rng(self.seed + self.epoch)
        yield from self._grouped_indices(rng)

    def __len__(self) -> int:
        n_mm = int(self.is_multimodal.sum())
        n_txt = len(self.is_multimodal) - n_mm
        return n_mm // self.batch_size + n_txt // self.batch_size
