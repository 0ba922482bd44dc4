"""RLDS -> model batches as PyTorch ``IterableDataset``s (counterpart of
vla_adapter_tpu/data/rlds_dataset.py, the reference's RLDSDataset).

The VLA recipe's pipeline (window 1, the chunk's future actions,
unlabeled trajectories skipped, goal relabeling, optional augmentation)
runs in numpy (``data/rlds/dataset.py``); each frame becomes an example
through ``data/transform.py:VLABatchTransform`` and ``collator.collate``
stacks them into the batches the train step takes, ``dataset_name``
included.

The statistics are computed once, in the process that builds the
dataset. Under ``DataLoader(num_workers=N)`` each worker then builds its
own pipeline over its share of the trajectories (every N-th, from its
id on), with generators seeded by (seed, worker id), and a shuffle buffer
of 1/N of the whole; so no two workers yield the same frames. Use
:func:`data_loader`: it starts ``spawn`` workers that see no CUDA device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
from torch.utils.data import DataLoader, IterableDataset, get_worker_info

from vla_adapter_torch.core.config import VLAConfig
from vla_adapter_torch.data.collator import collate
from vla_adapter_torch.data.image_processing import spawn_without_accelerator
from vla_adapter_torch.data.rlds.dataset import (
    make_dataset_from_rlds,
    make_interleaved_dataset,
    make_single_dataset,
)
from vla_adapter_torch.data.transform import VLABatchTransform

IMAGE_AUGMENT_KWARGS = dict(
    random_resized_crop=dict(scale=[0.9, 0.9], ratio=[1.0, 1.0]),
    random_brightness=[0.2],
    random_contrast=[0.8, 1.2],
    random_saturation=[0.8, 1.2],
    random_hue=[0.05],
    augment_order=[
        "random_resized_crop", "random_brightness", "random_contrast",
        "random_saturation", "random_hue",
    ],
)
# the single-dataset path's shuffle buffer holds at most this many frames
SINGLE_DATASET_SHUFFLE_CAP = 10_000
WORKER_TIMEOUT_S = 600.0


def vla_traj_transform_kwargs(cfg: VLAConfig) -> dict:
    return dict(
        window_size=1,
        future_action_window_size=cfg.constants.num_actions_chunk - 1,
        skip_unlabeled=True,
        goal_relabeling_strategy="uniform",
    )


def vla_frame_transform_kwargs(cfg: VLAConfig, image_aug: bool) -> dict:
    size = (cfg.vision.primary.image_size, cfg.vision.primary.image_size)
    return dict(resize_size=size,
                image_augment_kwargs=IMAGE_AUGMENT_KWARGS if image_aug
                else None)


class RLDSDataset(IterableDataset):
    """Collated model batches from one or more RLDS datasets (each entry
    of ``dataset_kwargs_list`` as ``make_dataset_from_rlds`` takes it,
    ``traj_source=`` included)."""

    def __init__(
        self,
        cfg: VLAConfig,
        transform: VLABatchTransform,
        dataset_kwargs_list: List[dict],
        sample_weights: Optional[List[float]] = None,
        batch_size: int = 8,
        train: bool = True,
        image_aug: bool = True,
        shuffle_buffer_size: int = 100_000,
        accum_steps: Optional[int] = None,
        seed: int = 0,
    ):
        self.cfg = cfg
        self.transform = transform
        self.sample_weights = sample_weights
        self.batch_size = batch_size
        self.train = train
        self.accum_steps = accum_steps
        self.seed = seed
        self.traj_kwargs = vla_traj_transform_kwargs(cfg)
        self.frame_kwargs = vla_frame_transform_kwargs(cfg, image_aug and train)
        single = len(dataset_kwargs_list) == 1
        self.shuffle_buffer_size = (
            0 if not train else
            min(shuffle_buffer_size, SINGLE_DATASET_SHUFFLE_CAP) if single
            else shuffle_buffer_size)
        self.dataset_statistics: Dict[str, Dict] = {}
        self.dataset_kwargs_list = []
        for kw in dataset_kwargs_list:
            _, stats = make_dataset_from_rlds(train=train, **kw)
            self.dataset_statistics[kw["name"]] = stats
            self.dataset_kwargs_list.append(dict(kw, dataset_statistics=stats))

    def pipeline(self, worker: int = 0, num_workers: int = 1):
        """The frame stream of one worker's share."""
        seed = self.seed if num_workers == 1 else [self.seed, worker]
        buffer = math.ceil(self.shuffle_buffer_size / num_workers)
        common = dict(train=self.train, traj_transform_kwargs=self.traj_kwargs,
                      frame_transform_kwargs=self.frame_kwargs,
                      shuffle_buffer_size=buffer, seed=seed,
                      shard=(worker, num_workers))
        if len(self.dataset_kwargs_list) == 1:
            return make_single_dataset(self.dataset_kwargs_list[0],
                                       **common)[0]
        return make_interleaved_dataset(self.dataset_kwargs_list,
                                        self.sample_weights, **common)[0]

    def _worker_view(self):
        """(frames, transform) of the calling process: all of it in the
        main process, the worker's share in a DataLoader worker, with the
        action-id padding reseeded per worker."""
        info = get_worker_info()
        if info is None:
            return self.pipeline(), self.transform
        seed = int(np.random.SeedSequence(
            [self.transform.seed, info.id]).generate_state(1)[0])
        return (self.pipeline(info.id, info.num_workers),
                dataclasses.replace(self.transform, seed=seed))

    def frames(self) -> Iterator[Dict]:
        yield from self._worker_view()[0]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        frames, transform = self._worker_view()
        examples = []
        for frame in frames:
            examples.append(transform(frame))
            if len(examples) == self.batch_size:
                yield collate(examples, accum_steps=self.accum_steps)
                examples = []


class EpisodicRLDSDataset(RLDSDataset):
    """Whole episodes (lists of examples) instead of batches, for replay
    in evaluation. Build with ``train=False``: the frames then keep their
    order within each episode, which starts again at timestep 0."""

    def __iter__(self) -> Iterator[List[Dict]]:
        frames, transform = self._worker_view()
        episode: List[Dict] = []
        for frame in frames:
            t = int(np.asarray(frame["observation"]["timestep"]).reshape(-1)[0])
            if episode and t == 0:
                yield episode
                episode = []
            episode.append(transform(frame))
        if episode:
            yield episode


def _map_arrays(fn, x):
    if isinstance(x, dict):
        return {k: _map_arrays(fn, v) for k, v in x.items()}
    if isinstance(x, list):
        return [_map_arrays(fn, v) for v in x]
    return fn(x)


def _as_tensors(item):
    """In a worker: the item's arrays as tensors, which the DataLoader
    hands over in shared memory. A pickled array goes through the result
    pipe instead, which the training process drains only while it waits
    in ``next()`` (a batch of 16 at 224 px is 38.5 MB of pixels)."""
    return _map_arrays(lambda v: torch.from_numpy(v)
                       if isinstance(v, np.ndarray) else v, item)


def _as_arrays(items):
    for item in items:
        yield _map_arrays(lambda v: v.numpy() if torch.is_tensor(v) else v,
                          item)


def data_loader(dataset: IterableDataset, num_workers: int = 0) -> Iterator:
    """An iterator over ``dataset``'s items (batches of numpy arrays, as
    the dataset yields them) through a ``DataLoader``; with workers,
    ``spawn`` processes started with no CUDA device visible, whose arrays
    arrive through shared memory. A worker that yields nothing for
    ``WORKER_TIMEOUT_S`` fails the iterator."""
    if num_workers == 0:
        return iter(DataLoader(dataset, batch_size=None,
                               collate_fn=lambda item: item))
    loader = DataLoader(dataset, batch_size=None, collate_fn=_as_tensors,
                        num_workers=num_workers,
                        multiprocessing_context="spawn",
                        timeout=WORKER_TIMEOUT_S)
    with spawn_without_accelerator():
        return _as_arrays(iter(loader))
