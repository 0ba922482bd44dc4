"""Goal relabeling in numpy (counterpart of
vla_adapter_tpu/data/rlds/utils/goal_relabeling.py, the reference's
rlds/utils/goal_relabeling.py).

Each transition gets a goal drawn uniformly from its future states; the
goal's observation keys are merged into the "task" dict.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from vla_adapter_torch.data.rlds.traj_transforms import tree_leaves, tree_map


def _tree_merge(*trees: Dict) -> Dict:
    merged: Dict = {}
    for tree in trees:
        for k, v in tree.items():
            if isinstance(v, dict):
                merged[k] = _tree_merge(merged.get(k, {}), v)
            else:
                merged[k] = v
    return merged


def uniform(traj: Dict, rng: np.random.Generator) -> Dict:
    """Goal index of step i uniform over [i + 1, len), in float32 as the
    tf version draws it, and clamped to the last step."""
    f32 = np.float32
    traj_len = len(tree_leaves(traj["observation"])[0])
    rand = rng.random(traj_len, dtype=f32)
    low = (np.arange(traj_len) + 1).astype(f32)
    high = f32(traj_len)
    goal_idxs = (rand * (high - low) + low).astype(np.int32)
    goal_idxs = np.minimum(goal_idxs, traj_len - 1)
    goal = tree_map(lambda x: x[goal_idxs], traj["observation"])
    traj["task"] = _tree_merge(traj["task"], goal)
    return traj
