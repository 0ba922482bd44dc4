"""The RLDS data engine in numpy (counterpart of
vla_adapter_tpu/data/rlds/dataset.py, which builds the same pipeline on
tf.data).

A dataset here is a :class:`Stream`: a lazy, re-iterable sequence of
numpy trajectories or frames (nested dicts of arrays; strings as bytes).
Iterating it again runs the pipeline again, so a repeated stream draws
new random parameters each epoch, as tf.data's stateful ops do.

  make_dataset_from_rlds     one dataset -> standard-schema trajectories,
                             statistics (computed over split "all" and
                             cached), normalized actions and proprio
  apply_trajectory_transforms  language filter, pad masks, goal relabel,
                             task augmentation, chunk_act_obs, subsample
  flatten_trajectories       trajectories -> frames
  apply_frame_transforms     decode, resize, train-time augmentation
  make_single_dataset        one dataset -> frames (repeat and shuffle of
                             the encoded frames when training)
  make_interleaved_dataset   a weighted mixture of datasets

Only :func:`load_tfds_trajectories`, the reader of TFDS shards, imports
TensorFlow and ``tensorflow_datasets``; everything past it is numpy. An
in-memory source (``traj_source=``, any iterable of raw trajectories)
takes the reader's place. ``shard=(index, count)`` keeps every count-th
trajectory from index on: the share of one ``DataLoader`` worker.
"""

from __future__ import annotations

import itertools
import json
import zlib
from pathlib import Path
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple, Union)

import numpy as np

from vla_adapter_torch.core.constants import NormalizationType
from vla_adapter_torch.data.normalization import (
    compute_statistics,
    normalize_traj,
    statistics_cache_key,
)
from vla_adapter_torch.data.rlds import obs_transforms, traj_transforms
from vla_adapter_torch.data.rlds.traj_transforms import (
    string_length,
    tree_leaves,
    tree_map,
)
from vla_adapter_torch.data.rlds.utils import (
    goal_relabeling,
    task_augmentation,
)

# tf.data.AUTOTUNE: "let the reader choose"
AUTOTUNE = -1
Seed = Union[int, Sequence[int]]


class Stream:
    """A lazy, re-iterable sequence: ``make()`` gives a fresh iterator."""

    def __init__(self, make: Callable[[], Iterator]):
        self._make = make

    def __iter__(self) -> Iterator:
        return iter(self._make())

    def map(self, fn: Callable) -> "Stream":
        return Stream(lambda: map(fn, self))

    def filter(self, pred: Callable) -> "Stream":
        return Stream(lambda: filter(pred, self))


def repeat(stream: Iterable) -> Stream:
    """``stream`` again and again; ends if one pass yields nothing (an
    empty shard)."""
    def make():
        while True:
            empty = True
            for x in stream:
                empty = False
                yield x
            if empty:
                return
    return Stream(make)


def shuffle(stream: Iterable, buffer_size: int,
            rng: np.random.Generator) -> Stream:
    """tf.data's shuffle buffer: each output is drawn uniformly from the
    ``buffer_size`` elements held, and its slot refilled from the input."""
    def make():
        it = iter(stream)
        buf = list(itertools.islice(it, buffer_size))
        exhausted = len(buf) < buffer_size
        while buf:
            i = int(rng.integers(len(buf)))
            out = buf[i]
            nxt = None if exhausted else next(it, None)
            if nxt is None:
                exhausted = True
                buf[i] = buf[-1]
                buf.pop()
            else:
                buf[i] = nxt
            yield out
    return Stream(make)


def sample_from_datasets(datasets: Sequence[Iterable], weights: Sequence[float],
                         rng: np.random.Generator,
                         stop_on_empty_dataset: bool) -> Stream:
    """Each element from a dataset drawn by ``weights``; an exhausted
    dataset ends the stream (``stop_on_empty_dataset``) or drops out."""
    def make():
        its = [iter(d) for d in datasets]
        w = np.asarray(weights, np.float64)
        active = [i for i in range(len(its)) if w[i] > 0]
        while active:
            p = w[active] / w[active].sum()
            k = active[int(rng.choice(len(active), p=p))]
            try:
                yield next(its[k])
            except StopIteration:
                if stop_on_empty_dataset:
                    return
                active.remove(k)
    return Stream(make)


def _copy_tree(tree):
    """The nested dicts copied, the arrays shared: transforms reassign
    keys and never write into arrays, so a source trajectory stays as it
    was for the next epoch."""
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    return tree


def _as_bytes(x) -> np.ndarray:
    """A string array as an object array of bytes."""
    x = np.asarray(x)
    if x.dtype == object and all(isinstance(v, bytes) for v in x.ravel()):
        return x
    return np.array([v.encode() if isinstance(v, str) else bytes(v)
                     for v in x.ravel()], dtype=object).reshape(x.shape)


def _shard(source: Iterable, shard: Tuple[int, int]) -> Iterable:
    index, count = shard
    if count == 1:
        return source
    if isinstance(source, Sequence):
        return source[index::count]
    return Stream(lambda: itertools.islice(source, index, None, count))


# --------------------------------------------------------------------------
# statistics
# --------------------------------------------------------------------------


def compute_dataset_statistics(trajs: Iterable[Dict],
                               save_path: Optional[str] = None) -> Dict:
    """min/max/mean/std/q01/q99 of the actions (and proprio) over every
    trajectory, with ``num_transitions`` and ``num_trajectories``; read
    from ``save_path`` when that file exists, else written there."""
    if save_path is not None and Path(save_path).exists():
        return json.loads(Path(save_path).read_text())
    actions, proprios, n_traj = [], [], 0
    for traj in trajs:
        actions.append(np.asarray(traj["action"], np.float32))
        if "proprio" in traj["observation"]:
            proprios.append(np.asarray(traj["observation"]["proprio"],
                                       np.float32))
        n_traj += 1
    if not actions:
        raise ValueError("no trajectories to compute statistics over")
    acts = np.concatenate(actions, 0)
    stats = {"action": compute_statistics(acts),
             "num_transitions": int(acts.shape[0]),
             "num_trajectories": n_traj}
    if proprios:
        stats["proprio"] = compute_statistics(np.concatenate(proprios, 0))
    if save_path is not None:
        Path(save_path).write_text(json.dumps(stats))
    return stats


# --------------------------------------------------------------------------
# dataset construction
# --------------------------------------------------------------------------


def load_tfds_trajectories(name: str, data_dir: str, train: bool,
                           shuffle: bool, num_parallel_reads: int = AUTOTUNE,
                           split: Optional[str] = None,
                           shard: Tuple[int, int] = (0, 1)) -> Stream:
    """The RLDS episodes of a prepared TFDS dataset as numpy trajectories
    (file-level shuffle only, as the reference reads them). ``split``
    overrides the train/val choice; "all" joins every split, over which
    the statistics are computed so that train and val normalize alike.

    The one place that imports TensorFlow and ``tensorflow_datasets``;
    without them this raises ImportError, and it never reads anything
    else in their place."""
    try:
        import tensorflow as tf
        import tensorflow_datasets as tfds
    except ImportError as err:
        raise ImportError(
            f"reading the RLDS dataset {name!r} from TFDS shards needs the "
            "tensorflow_datasets package (and tensorflow) on the machine "
            "that reads them; pass traj_source= to use trajectories held "
            "in memory") from err
    if not str(data_dir).startswith("gs://") and not (
            Path(data_dir) / name).exists():
        raise FileNotFoundError(f"no TFDS dataset {name!r} under {data_dir}")
    tf.config.set_visible_devices([], "GPU")
    builder = tfds.builder(name, data_dir=data_dir)
    if split == "all":
        split = "+".join(sorted(builder.info.splits.keys()))
    elif split is None:
        split = "train" if train else "val"
        if split not in builder.info.splits:
            split = "train[:95%]" if train else "train[95%:]"
    reads = tf.data.AUTOTUNE if num_parallel_reads == AUTOTUNE \
        else num_parallel_reads

    def make():
        ds = builder.as_dataset(
            split=split, shuffle_files=shuffle,
            read_config=tfds.ReadConfig(
                num_parallel_calls_for_interleave_files=reads))
        if shard[1] > 1:
            ds = ds.shard(shard[1], shard[0])
        ds = ds.map(lambda ep: ep["steps"].batch(1_000_000)
                    .get_single_element(), tf.data.AUTOTUNE)
        return ds.as_numpy_iterator()

    return Stream(make)


def make_dataset_from_rlds(
    name: str,
    data_dir: Optional[str] = None,
    *,
    train: bool = True,
    standardize_fn: Optional[Callable[[dict], dict]] = None,
    shuffle: bool = True,
    image_obs_keys: Dict[str, Optional[str]] = {},
    depth_obs_keys: Dict[str, Optional[str]] = {},
    state_obs_keys: Sequence[Optional[str]] = (),
    language_key: Optional[str] = None,
    action_proprio_normalization_type: NormalizationType = (
        NormalizationType.BOUNDS_Q99),
    dataset_statistics: Optional[Union[dict, str]] = None,
    absolute_action_mask: Optional[Sequence[bool]] = None,
    action_normalization_mask: Optional[Sequence[bool]] = None,
    num_parallel_reads: int = AUTOTUNE,
    traj_source: Optional[Iterable[Dict]] = None,
    statistics_save_path: Optional[str] = None,
    shard: Tuple[int, int] = (0, 1),
) -> Tuple[Stream, Dict]:
    """One RLDS dataset -> (standard-schema trajectories, statistics).

    ``traj_source`` (an iterable of raw trajectories, e.g. a list) takes
    the TFDS reader's place. The statistics are computed over every
    trajectory of the dataset (TFDS split "all"; the whole source), not
    over ``shard``, and cached under ``~/.cache/vla_adapter_torch`` when
    ``data_dir`` is given."""

    def restructure(traj):
        traj = _copy_tree(traj)
        if standardize_fn is not None:
            traj = standardize_fn(traj)
        for k in ("observation", "action"):
            if k not in traj:
                raise ValueError(f"trajectory missing key {k!r}")
        traj_len = len(traj["action"])
        old_obs = traj["observation"]
        new_obs = {}
        for prefix, keys in (("image", image_obs_keys),
                             ("depth", depth_obs_keys)):
            for new, old in keys.items():
                new_obs[f"{prefix}_{new}"] = (
                    np.full(traj_len, b"", object) if old is None
                    else old_obs[old])
        if state_obs_keys:
            new_obs["proprio"] = np.concatenate(
                [np.zeros((traj_len, 1), np.float32) if key is None
                 else np.asarray(old_obs[key]).astype(np.float32)
                 for key in state_obs_keys], axis=1)
        new_obs["timestep"] = np.arange(traj_len, dtype=np.int32)
        task = {}
        if language_key is not None:
            task["language_instruction"] = _as_bytes(traj.pop(language_key))
        out = {
            "observation": new_obs,
            "task": task,
            "action": np.asarray(traj["action"]).astype(np.float32),
            "dataset_name": np.full(traj_len, name.encode(), object),
        }
        if absolute_action_mask is not None:
            out["absolute_action_mask"] = np.tile(
                np.asarray(absolute_action_mask, bool)[None], [traj_len, 1])
        return out

    if traj_source is None:
        source = load_tfds_trajectories(name, data_dir, train, shuffle,
                                        num_parallel_reads, shard=shard)
    else:
        source = _shard(traj_source, shard)
    ds = Stream(lambda: map(restructure, source))

    if dataset_statistics is None:
        if statistics_save_path is None and data_dir is not None:
            # keyed on what changes the statistics: the standardize fn and
            # the schema maps, not the split (they cover split "all")
            spec = repr((
                data_dir,
                getattr(standardize_fn, "__name__", repr(standardize_fn)),
                sorted(image_obs_keys.items()), list(state_obs_keys),
            ))
            cache_dir = Path.home() / ".cache" / "vla_adapter_torch"
            cache_dir.mkdir(parents=True, exist_ok=True)
            statistics_save_path = str(
                cache_dir
                / f"dataset_statistics_{statistics_cache_key(name, spec)}.json")
        if traj_source is None:
            everything = load_tfds_trajectories(name, data_dir, train,
                                                shuffle=False, split="all")
        else:
            everything = traj_source
        dataset_statistics = compute_dataset_statistics(
            map(restructure, everything), save_path=statistics_save_path)
    elif isinstance(dataset_statistics, str):
        dataset_statistics = json.loads(Path(dataset_statistics).read_text())

    if action_normalization_mask is not None:
        dataset_statistics["action"]["mask"] = list(action_normalization_mask)
    stats = dataset_statistics
    return ds.map(lambda t: normalize_traj(
        t, stats, action_proprio_normalization_type)), stats


def apply_trajectory_transforms(
    dataset: Iterable[Dict],
    *,
    train: bool,
    goal_relabeling_strategy: Optional[str] = None,
    goal_relabeling_kwargs: dict = {},
    window_size: int = 1,
    future_action_window_size: int = 0,
    subsample_length: Optional[int] = None,
    skip_unlabeled: bool = False,
    max_action: Optional[float] = None,
    max_proprio: Optional[float] = None,
    task_augment_strategy: Optional[str] = None,
    task_augment_kwargs: dict = {},
    rng: Optional[np.random.Generator] = None,
) -> Stream:
    """The trajectory-level steps, in the JAX pipeline's order; random
    draws (goal relabeling, task augmentation, subsampling) from ``rng``
    (a fresh generator if None)."""
    rng = rng if rng is not None else np.random.default_rng()
    ds = dataset if isinstance(dataset, Stream) else Stream(lambda: dataset)
    if skip_unlabeled:
        ds = ds.filter(lambda x: bool(
            (string_length(x["task"]["language_instruction"]) != 0).any()))
    if max_action is not None:
        ds = ds.filter(lambda x: bool(
            (np.abs(x["action"]) <= max_action).all()))
    if max_proprio is not None:
        ds = ds.filter(lambda x: bool(
            (np.abs(x["observation"].get("proprio", 0.0))
             <= max_proprio).all()))
    ds = ds.map(traj_transforms.add_pad_mask_dict)
    if goal_relabeling_strategy is not None:
        relabel = getattr(goal_relabeling, goal_relabeling_strategy)
        ds = ds.map(lambda t: relabel(t, rng=rng, **goal_relabeling_kwargs))
    if train and task_augment_strategy is not None:
        augment = getattr(task_augmentation, task_augment_strategy)
        ds = ds.map(lambda t: augment(t, rng=rng, **task_augment_kwargs))
    ds = ds.map(lambda t: traj_transforms.chunk_act_obs(
        t, window_size=window_size,
        future_action_window_size=future_action_window_size))
    if train and subsample_length is not None:
        ds = ds.map(lambda t: traj_transforms.subsample(
            t, subsample_length, rng))
    return ds


def flatten_trajectories(dataset: Iterable[Dict]) -> Stream:
    """Trajectories -> their frames, in order."""
    def make():
        for traj in dataset:
            for i in range(len(traj["action"])):
                yield tree_map(lambda x: x[i], traj)
    return Stream(make)


def _stack_trees(trees: List):
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], (bytes, str)):
        return np.array(trees, dtype=object)
    return np.stack(trees)


def _map_obs_window(frame: Dict, fn: Callable[[Dict], Dict]) -> Dict:
    """``fn`` on each slice of the observation's window axis (axis 0 of
    every observation leaf of a chunked frame)."""
    obs = frame["observation"]
    window = len(tree_leaves(obs)[0])
    frame["observation"] = _stack_trees(
        [fn(tree_map(lambda x: x[w], obs)) for w in range(window)])
    return frame


def _instruction_seed(instruction) -> int:
    """A stable hash of an instruction into [0, 2^20), the second word of a
    frame's augmentation seed."""
    data = instruction if isinstance(instruction, bytes) else \
        str(instruction).encode()
    return zlib.crc32(data) % (1 << 20)


def apply_frame_transforms(
    dataset: Iterable[Dict],
    *,
    train: bool,
    resize_size: Union[Tuple[int, int], Dict[str, Tuple[int, int]]] = (224, 224),
    image_augment_kwargs: Optional[dict] = None,
    seed: int = 0,
    rng: Optional[np.random.Generator] = None,
) -> Stream:
    """Decode and resize every camera image of every window slice; when
    training with ``image_augment_kwargs``, augment them. A frame's
    augmentation seed is (its first timestep + a draw from ``rng`` per
    visit, the instruction's hash, else ``seed``): new parameters at each
    visit, reproducible from the generator's seed."""
    rng = rng if rng is not None else np.random.default_rng()
    ds = dataset if isinstance(dataset, Stream) else Stream(lambda: dataset)
    ds = ds.map(lambda fr: _map_obs_window(
        fr, lambda o: obs_transforms.decode_and_resize(o, resize_size)))
    if train and image_augment_kwargs:
        def aug_fn(fr):
            task = fr["task"]
            lang_seed = (_instruction_seed(task["language_instruction"])
                         if "language_instruction" in task else seed)
            visit = int(rng.integers(0, 1 << 30))
            frame_seed = (int(fr["observation"]["timestep"][0]) + visit,
                          lang_seed)
            return _map_obs_window(fr, lambda o: obs_transforms.augment(
                o, frame_seed, image_augment_kwargs))
        ds = ds.map(aug_fn)
    return ds


def _generators(seed: Seed, n: int) -> List[np.random.Generator]:
    return [np.random.default_rng(s)
            for s in np.random.SeedSequence(seed).spawn(n)]


def make_single_dataset(
    dataset_kwargs: dict,
    *,
    train: bool,
    traj_transform_kwargs: dict = {},
    frame_transform_kwargs: dict = {},
    shuffle_buffer_size: int = 0,
    seed: Seed = 0,
    shard: Tuple[int, int] = (0, 1),
) -> Tuple[Stream, Dict]:
    """One dataset -> frames. Training with ``shuffle_buffer_size > 1``
    repeats the frames and shuffles them before the frame transforms, so
    the buffer holds encoded frames, not decoded pixels."""
    traj_rng, shuffle_rng, frame_rng = _generators(seed, 3)
    ds, stats = make_dataset_from_rlds(train=train, shard=shard,
                                       **dataset_kwargs)
    ds = apply_trajectory_transforms(ds, train=train, rng=traj_rng,
                                     **traj_transform_kwargs)
    ds = flatten_trajectories(ds)
    if train and shuffle_buffer_size > 1:
        ds = shuffle(repeat(ds), shuffle_buffer_size, shuffle_rng)
    ds = apply_frame_transforms(ds, train=train, rng=frame_rng,
                                **frame_transform_kwargs)
    return ds, stats


def allocate_threads(n: Optional[int], weights: np.ndarray) -> np.ndarray:
    """A budget of ``n`` threads split in proportion to ``weights``, at
    least 1 each (``AUTOTUNE`` for every dataset when ``n`` is None)."""
    if n is None:
        return np.array([AUTOTUNE] * len(weights))
    assert n >= len(weights), "not enough threads"
    weights = np.asarray(weights, np.float64)
    weights = weights / weights.sum()
    alloc = np.zeros_like(weights, dtype=int)
    while True:
        mask = (alloc == 0) & (weights * n < 1)
        if not mask.any():
            break
        alloc[mask] = 1
        n -= mask.sum()
        weights[mask] = 0
        if weights.sum() > 0:
            weights = weights / weights.sum()
    fractional = weights * n
    alloc += np.floor(fractional).astype(int)
    remainder = n - int(np.floor(fractional).sum())
    order = np.argsort(fractional - np.floor(fractional))[::-1]
    for i in range(remainder):
        alloc[order[i]] += 1
    return alloc


def make_interleaved_dataset(
    dataset_kwargs_list: List[dict],
    sample_weights: Optional[Sequence[float]] = None,
    *,
    train: bool,
    shuffle_buffer_size: int = 100_000,
    traj_transform_kwargs: dict = {},
    frame_transform_kwargs: dict = {},
    balance_weights: bool = False,
    traj_read_threads: Optional[int] = None,
    seed: Seed = 0,
    shard: Tuple[int, int] = (0, 1),
) -> Tuple[Stream, Dict[str, Dict]]:
    """A weighted mixture of datasets -> (frames, {name: statistics}).
    Training repeats each dataset and stops at the first that runs dry, as
    ``sample_from_datasets(stop_on_empty_dataset=True)`` does; evaluation
    goes through each once. ``traj_read_threads`` is split over the
    datasets' TFDS readers by weight."""
    if sample_weights is None:
        sample_weights = [1.0] * len(dataset_kwargs_list)
    if len(sample_weights) != len(dataset_kwargs_list):
        raise ValueError("one sample weight per dataset")

    all_stats = {}
    for kw in dataset_kwargs_list:
        _, stats = make_dataset_from_rlds(train=train, **kw)
        all_stats[kw["name"]] = stats

    weights = np.asarray(sample_weights, np.float64)
    if balance_weights:
        weights = weights * np.array(
            [all_stats[kw["name"]]["num_transitions"]
             for kw in dataset_kwargs_list])
    weights /= weights.sum()
    read_threads = allocate_threads(traj_read_threads, weights)

    sample_rng, shuffle_rng, frame_rng, *traj_rngs = _generators(
        seed, 3 + len(dataset_kwargs_list))
    datasets = []
    for kw, n_reads, traj_rng in zip(dataset_kwargs_list, read_threads,
                                     traj_rngs):
        ds, _ = make_dataset_from_rlds(
            train=train, dataset_statistics=all_stats[kw["name"]],
            num_parallel_reads=int(n_reads), shard=shard,
            **{k: v for k, v in kw.items() if k != "dataset_statistics"})
        ds = apply_trajectory_transforms(repeat(ds) if train else ds,
                                         train=train, rng=traj_rng,
                                         **traj_transform_kwargs)
        datasets.append(flatten_trajectories(ds))

    ds = sample_from_datasets(datasets, weights, sample_rng,
                              stop_on_empty_dataset=train)
    if train and shuffle_buffer_size > 1:
        ds = shuffle(ds, shuffle_buffer_size, shuffle_rng)
    ds = apply_frame_transforms(ds, train=train, rng=frame_rng,
                                **frame_transform_kwargs)
    return ds, all_stats
