"""OXE dataset-kwargs factory (copy of
vla_adapter_tpu/data/rlds/oxe/materialize.py, the reference's
rlds/oxe/materialize.py:21-120).

Turns a registry entry (+ mixture spec) into make_dataset_from_rlds kwargs,
including the action-encoding contracts: for EEF_POS actions only the
gripper dim is absolute, and every dim except the gripper is normalized.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, List, Sequence, Tuple

from vla_adapter_torch.core.constants import NormalizationType
from vla_adapter_torch.data.rlds.oxe.configs import (
    ActionEncoding,
    OXE_DATASET_CONFIGS,
)
from vla_adapter_torch.data.rlds.oxe.mixtures import OXE_NAMED_MIXTURES
from vla_adapter_torch.data.rlds.oxe.transforms import OXE_STANDARDIZATION_TRANSFORMS

_MASKS = {
    ActionEncoding.EEF_POS: ([False] * 6 + [True], [True] * 6 + [False]),
    ActionEncoding.EEF_R6: ([False] * 9 + [True], [True] * 9 + [False]),
    ActionEncoding.JOINT_POS_BIMANUAL: ([True] * 14, [True] * 14),
}


def make_oxe_dataset_kwargs(
    dataset_name: str,
    data_root_dir: str,
    load_camera_views: Sequence[str] = ("primary",),
    load_depth: bool = False,
    load_proprio: bool = True,
    load_language: bool = True,
    action_proprio_normalization_type: NormalizationType = NormalizationType.BOUNDS_Q99,
) -> Dict[str, Any]:
    cfg = deepcopy(OXE_DATASET_CONFIGS[dataset_name])
    enc = cfg.pop("action_encoding")
    cfg.pop("state_encoding")
    if enc not in _MASKS:
        raise ValueError(f"{dataset_name}: unsupported action encoding {enc}")
    absolute_mask, norm_mask = _MASKS[enc]

    missing = set(load_camera_views) - set(cfg["image_obs_keys"])
    if missing:
        raise ValueError(f"{dataset_name}: missing camera views {missing}")
    cfg["image_obs_keys"] = {
        k: v for k, v in cfg["image_obs_keys"].items() if k in load_camera_views
    }
    cfg["depth_obs_keys"] = {
        k: v for k, v in cfg["depth_obs_keys"].items() if k in load_camera_views
    }
    if not load_depth:
        cfg.pop("depth_obs_keys")
    if not load_proprio:
        cfg.pop("state_obs_keys")

    out: Dict[str, Any] = {
        "name": dataset_name,
        "data_dir": str(data_root_dir),
        "absolute_action_mask": absolute_mask,
        "action_normalization_mask": norm_mask,
        "action_proprio_normalization_type": action_proprio_normalization_type,
        "standardize_fn": OXE_STANDARDIZATION_TRANSFORMS[dataset_name],
        **cfg,
    }
    if load_language:
        out["language_key"] = "language_instruction"
    return out


def get_oxe_dataset_kwargs_and_weights(
    data_root_dir: str,
    mixture_spec: List[Tuple[str, float]] | str,
    **kwargs,
) -> Tuple[List[Dict[str, Any]], List[float]]:
    """Mixture spec (or named mixture) -> (dataset_kwargs_list, weights);
    duplicate entries are dropped with the first weight winning (reference
    materialize.py:100-118)."""
    if isinstance(mixture_spec, str):
        mixture_spec = OXE_NAMED_MIXTURES[mixture_spec]
    seen, filtered = set(), []
    for name, weight in mixture_spec:
        if name in seen:
            continue
        seen.add(name)
        filtered.append((name, weight))
    kwargs_list, weights = [], []
    for name, weight in filtered:
        kwargs_list.append(make_oxe_dataset_kwargs(name, data_root_dir, **kwargs))
        weights.append(weight)
    return kwargs_list, weights
