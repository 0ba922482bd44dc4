"""Dataset statistics and action/proprio normalization (copy of
vla_adapter_tpu/data/normalization.py, with the numpy form of the RLDS
pipeline's trajectory normalization, ``vla_adapter_tpu/data/rlds/dataset.py:
_normalize_traj``).

Stats are the checkpoint's ``dataset_statistics.json`` format: per dataset
{"action": {...}, "proprio": {...}} with min/max/mean/std/q01/q99 lists and
an optional boolean "mask" (dims to normalize; the gripper is excluded).

  NORMAL      x -> (x - mean) / (std + eps)
  BOUNDS      x -> clip(2 (x - min) / (max - min + eps) - 1, -1, 1)
  BOUNDS_Q99  x -> clip(2 (x - q01) / (q99 - q01 + eps) - 1, -1, 1)

Unmasked dims pass through; degenerate dims (min == max) map to 0.
Unnormalization: x -> 0.5 (a + 1) (hi - lo + 1e-8) + lo on masked dims.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from vla_adapter_torch.core.constants import NormalizationType

_EPS = 1e-8


def compute_statistics(arr: np.ndarray) -> Dict[str, list]:
    """Per-dim stats over a (N, D) array."""
    arr = np.asarray(arr, np.float64)
    return {
        "mean": arr.mean(0).tolist(),
        "std": arr.std(0).tolist(),
        "max": arr.max(0).tolist(),
        "min": arr.min(0).tolist(),
        "q01": np.quantile(arr, 0.01, axis=0).tolist(),
        "q99": np.quantile(arr, 0.99, axis=0).tolist(),
    }


def dataset_statistics(actions: np.ndarray,
                       proprio: Optional[np.ndarray] = None,
                       action_mask: Optional[np.ndarray] = None) -> Dict:
    stats = {"action": compute_statistics(actions),
             "num_transitions": int(actions.shape[0])}
    if action_mask is not None:
        stats["action"]["mask"] = np.asarray(action_mask, bool).tolist()
    if proprio is not None:
        stats["proprio"] = compute_statistics(proprio)
    return stats


def _bounds(stats: Dict, norm_type: NormalizationType):
    if norm_type == NormalizationType.BOUNDS:
        return np.asarray(stats["min"]), np.asarray(stats["max"])
    if norm_type == NormalizationType.BOUNDS_Q99:
        return np.asarray(stats["q01"]), np.asarray(stats["q99"])
    raise ValueError(f"unsupported normalization: {norm_type}")


def _mask(stats: Dict) -> np.ndarray:
    if "mask" in stats:
        return np.asarray(stats["mask"], bool)
    return np.ones(len(stats["min"]), bool)


def normalize(x: np.ndarray, stats: Dict,
              norm_type: NormalizationType) -> np.ndarray:
    x = np.asarray(x, np.float64)
    if norm_type == NormalizationType.NORMAL:
        mean, std = np.asarray(stats["mean"]), np.asarray(stats["std"])
        out = (x - mean) / (std + _EPS)
        return np.where(_mask(stats), out, x).astype(np.float32)
    lo, hi = _bounds(stats, norm_type)
    out = np.clip(2.0 * (x - lo) / (hi - lo + _EPS) - 1.0, -1.0, 1.0)
    out = np.where(_mask(stats), out, x)
    degenerate = np.asarray(stats["min"]) == np.asarray(stats["max"])
    return np.where(degenerate, 0.0, out).astype(np.float32)


def unnormalize(a: np.ndarray, stats: Dict,
                norm_type: NormalizationType) -> np.ndarray:
    """Inverse for BOUNDS / BOUNDS_Q99."""
    a = np.asarray(a, np.float64)
    lo, hi = _bounds(stats, norm_type)
    out = 0.5 * (a + 1.0) * (hi - lo + _EPS) + lo
    return np.where(_mask(stats), out, a).astype(np.float32)


def statistics_cache_key(dataset_name: str, spec: str) -> str:
    """sha256 key of a dataset's statistics cache file (the reference keys
    on the dataset spec string)."""
    return hashlib.sha256((dataset_name + spec).encode()).hexdigest()


def save_dataset_statistics(stats: Dict[str, Dict], path) -> None:
    """Write ``dataset_statistics.json``, which serving needs to
    unnormalize."""
    Path(path).write_text(json.dumps(stats, indent=2))


def load_dataset_statistics(path) -> Dict:
    return json.loads(Path(path).read_text())


def normalize_traj(traj: Dict, metadata: Dict,
                   norm_type: NormalizationType) -> Dict:
    """Normalize a trajectory's ``action`` and ``observation/proprio`` in
    place, in float32 as the JAX pipeline's tf version computes it:
    ``(x - mean) / (std + 1e-8)``, or ``clip(2 (x - lo) / (hi - lo + 1e-8)
    - 1, -1, 1)`` with degenerate dimensions (min == max) set to 0 whatever
    the mask says. Unmasked dimensions pass through."""
    f32 = np.float32
    for key in ("action", "proprio"):
        if key == "proprio" and "proprio" not in traj["observation"]:
            continue
        stats = metadata[key]
        mask = np.asarray(stats.get("mask", [True] * len(stats["min"])),
                          bool)
        x = (traj["action"] if key == "action"
             else traj["observation"]["proprio"])
        x = np.asarray(x, f32)
        if norm_type == NormalizationType.NORMAL:
            mean = np.asarray(stats["mean"], f32)
            std = np.asarray(stats["std"], f32)
            out = np.where(mask, (x - mean) / (std + f32(_EPS)), x)
        elif norm_type in (NormalizationType.BOUNDS,
                           NormalizationType.BOUNDS_Q99):
            lo, hi = _bounds(stats, norm_type)
            lo, hi = lo.astype(f32), hi.astype(f32)
            scaled = f32(2.0) * (x - lo) / (hi - lo + f32(_EPS)) - f32(1.0)
            out = np.where(mask, np.clip(scaled, f32(-1), f32(1)), x)
            degenerate = (np.asarray(stats["min"])
                          == np.asarray(stats["max"]))
            out = np.where(degenerate, f32(0), out)
        else:
            raise ValueError(norm_type)
        out = out.astype(f32)
        if key == "action":
            traj["action"] = out
        else:
            traj["observation"]["proprio"] = out
    return traj


# Gripper-action relabeling (the reference's data_utils.py:20-162).

def binarize_gripper_actions(actions: np.ndarray) -> np.ndarray:
    """Continuous [0, 1] gripper -> binary by a backward scan: values
    between 0.05 and 0.95 take the next definite value; a trailing run of
    such values takes the raw final action."""
    actions = np.asarray(actions, np.float32)
    open_mask = actions > 0.95
    in_between = ~(open_mask | (actions < 0.05))
    out = np.empty_like(actions)
    carry = actions[-1]
    for i in range(len(actions) - 1, -1, -1):
        carry = carry if in_between[i] else np.float32(open_mask[i])
        out[i] = carry
    return out


def rel2abs_gripper_actions(actions: np.ndarray) -> np.ndarray:
    """Relative gripper commands (< -0.1 opening, > 0.1 closing) ->
    absolute state (0 closed, 1 open). The start state is the opposite of
    the first command, open when there is none."""
    actions = np.asarray(actions, np.float32)
    thresh = np.where(actions < -0.1, 1, np.where(actions > 0.1, -1, 0))
    nz = np.nonzero(thresh)[0]
    carry = int(-thresh[nz[0]]) if len(nz) else 1
    out = np.empty(len(actions), np.float32)
    for i in range(len(actions)):
        if thresh[i] != 0:
            carry = int(thresh[i])
        out[i] = carry
    return out / np.float32(2) + np.float32(0.5)


def invert_gripper_actions(actions: np.ndarray) -> np.ndarray:
    return 1.0 - np.asarray(actions)


def relabel_bridge_actions(actions: np.ndarray, states: np.ndarray):
    """Bridge-V2 relabel: the movement is the state's delta, the gripper
    dimension is kept, and the last (action-less) step is dropped.
    Returns (T-1, action_dim)."""
    movement = states[1:, :6] - states[:-1, :6]
    return np.concatenate([movement, actions[:-1, -1:]], axis=1)
