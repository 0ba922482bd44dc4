"""Dataset statistics and action/proprio normalization (copy of the serving
part of vla_adapter_tpu/data/normalization.py).

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
