"""Task augmentation in numpy (counterpart of
vla_adapter_tpu/data/rlds/utils/task_augmentation.py, the reference's
rlds/utils/task_augmentation.py).

Per transition, drops either the goal images or the language instruction
(only where both are present), padding out the dropped key and its pad
mask.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from vla_adapter_torch.data.rlds.traj_transforms import is_string


def _to_padding(x: np.ndarray) -> np.ndarray:
    if is_string(x):
        return np.full(np.shape(x), b"", object)
    return np.zeros_like(x)


def _where(keep: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    keep = keep.reshape(keep.shape + (1,) * (np.ndim(a) - 1))
    return np.where(keep, a, b)


def delete_task_conditioning(traj: Dict, keep_image_prob: float,
                             rng: np.random.Generator) -> Dict:
    task = traj["task"]
    if "language_instruction" not in task:
        return traj
    image_keys = {k for k in task
                  if k.startswith("image_") or k.startswith("depth_")}
    if not image_keys:
        return traj

    traj_len = len(traj["action"])
    keep_images = rng.random(traj_len, dtype=np.float32) < keep_image_prob
    keep_images |= ~task["pad_mask_dict"]["language_instruction"]
    for key in image_keys | {"language_instruction"}:
        keep = keep_images if key in image_keys else ~keep_images
        task[key] = _where(keep, task[key], _to_padding(task[key]))
        mask = task["pad_mask_dict"][key]
        task["pad_mask_dict"][key] = _where(keep, mask, np.zeros_like(mask))
    if "timestep" in task:
        task["timestep"] = np.where(keep_images, task["timestep"],
                                    traj_len - 1)
    return traj
