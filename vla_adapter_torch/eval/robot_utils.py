"""Robot-side utilities shared by the eval harnesses (counterpart of
vla_adapter_tpu/eval/robot_utils.py; the reference's
experiments/robot/robot_utils.py and libero_utils.py).

Gripper conventions in float64, quaternion conversion, and the policy-input
resize through :func:`data.image_processing.prepare_image` (the JPEG round
trip and lanczos3 resize, bit for bit with the reference's TensorFlow
pixels, without TensorFlow).
"""

from __future__ import annotations

import math
import os
import random

import numpy as np
import torch

from vla_adapter_torch.data.image_processing import prepare_image


def set_seed_everywhere(seed: int) -> None:
    """Seed numpy, python and torch (the reference's robot_utils.py:38-51)."""
    np.random.seed(seed)
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    torch.manual_seed(seed)


def normalize_gripper_action(action: np.ndarray, binarize: bool = True
                             ) -> np.ndarray:
    """[0, 1] gripper (last dim) -> [-1, 1], optionally binarized by sign."""
    out = np.array(action, np.float64)
    out[..., -1] = 2.0 * (out[..., -1] - 0.0) / (1.0 - 0.0) - 1.0
    if binarize:
        out[..., -1] = np.sign(out[..., -1])
    return out


def invert_gripper_action(action: np.ndarray) -> np.ndarray:
    """RLDS convention (0 = close, 1 = open) <-> the env's (-1 = open,
    +1 = close): flip the gripper's sign."""
    out = np.array(action, np.float64)
    out[..., -1] *= -1.0
    return out


def process_action(action: np.ndarray) -> np.ndarray:
    """The pre-env action pipeline (the reference's
    run_libero_eval.py:269-280): normalize and binarize the gripper, then
    invert it for the env's convention."""
    return invert_gripper_action(normalize_gripper_action(action,
                                                          binarize=True))


def quat2axisangle(quat: np.ndarray) -> np.ndarray:
    """(x, y, z, w) quaternion -> axis-angle (robosuite's, as the
    reference's libero_utils.py:64-90 copies it)."""
    quat = np.array(quat, np.float64)
    quat[3] = np.clip(quat[3], -1.0, 1.0)
    den = np.sqrt(1.0 - quat[3] * quat[3])
    if math.isclose(den, 0.0):
        return np.zeros(3)
    return (quat[:3] * 2.0 * math.acos(quat[3])) / den


def resize_image_for_policy(img: np.ndarray, size: int) -> np.ndarray:
    """JPEG round trip + lanczos3 resize to the policy size, the path the
    training data took."""
    return prepare_image(img, size=size, center_crop_scale=None)


def rotate_180(img: np.ndarray) -> np.ndarray:
    """LIBERO's cameras are mounted upside down relative to the training
    data."""
    return img[::-1, ::-1]
