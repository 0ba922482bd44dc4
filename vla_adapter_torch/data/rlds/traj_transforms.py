"""Trajectory-level transforms in numpy (counterpart of
vla_adapter_tpu/data/rlds/traj_transforms.py, the reference's
rlds/traj_transforms.py).

A trajectory is a nested dict of numpy arrays that share the leading axis
(the trajectory's length); strings are object arrays of bytes.

* :func:`chunk_act_obs`: a window of ``window_size`` observations (past
  indices floored at 0 and flagged in ``observation/pad_mask``) and the
  chunk of ``future_action_window_size`` future actions (indices clamped
  to the last step). The trajectory is cut to ``len - future`` frames, as
  the reference cuts it: the tail frames whose chunks would be mostly
  the repeated last action are dropped.
* :func:`subsample`: a random subset of the frames of a long trajectory.
* :func:`add_pad_mask_dict`: per-key validity masks (an empty string is
  padding).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np


def tree_map(fn: Callable, tree):
    """``fn`` on every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict, keys in sorted order (as
    ``tf.nest.flatten`` orders them)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def is_string(x) -> bool:
    x = np.asarray(x)
    return x.dtype == object or x.dtype.kind in "SU"


def string_length(x) -> np.ndarray:
    """Element-wise length of a string array."""
    return np.vectorize(len, otypes=[np.int64])(np.asarray(x, object))


def chunk_act_obs(traj: Dict, window_size: int,
                  future_action_window_size: int = 0) -> Dict:
    traj_len = len(traj["action"])
    effective_len = max(traj_len - future_action_window_size, 0)
    base = np.arange(effective_len)[:, None]
    obs_idx = base + np.arange(-window_size + 1, 1)[None, :]
    act_idx = base + np.arange(-window_size + 1,
                               1 + future_action_window_size)[None, :]
    floored_obs_idx = np.maximum(obs_idx, 0)
    clamped_act_idx = np.minimum(np.maximum(act_idx, 0), traj_len - 1)

    traj["observation"] = tree_map(lambda x: x[floored_obs_idx],
                                   traj["observation"])
    traj["action"] = traj["action"][clamped_act_idx]
    traj["observation"]["pad_mask"] = obs_idx >= 0
    traj["task"] = tree_map(lambda x: x[:effective_len], traj["task"])
    for key in ("dataset_name", "absolute_action_mask"):
        if key in traj:
            traj[key] = traj[key][:effective_len]
    return traj


def subsample(traj: Dict, subsample_length: int,
              rng: np.random.Generator) -> Dict:
    traj_len = len(traj["action"])
    if traj_len > subsample_length:
        indices = rng.permutation(traj_len)[:subsample_length]
        traj = tree_map(lambda x: x[indices], traj)
    return traj


def add_pad_mask_dict(traj: Dict) -> Dict:
    traj_len = len(traj["action"])
    for key in ("observation", "task"):
        traj[key]["pad_mask_dict"] = {
            sub: (string_length(val) != 0 if is_string(val)
                  else np.ones([traj_len], bool))
            for sub, val in traj[key].items()}
    return traj
