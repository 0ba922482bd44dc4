"""Per-dataset standardization transforms, full catalog, in numpy
(counterpart of vla_adapter_tpu/data/rlds/oxe/transforms.py, the
reference's rlds/oxe/transforms.py).

Each transform maps a raw RLDS trajectory (a nested dict of numpy arrays,
strings as bytes) into the pre-restructure schema: ``action`` (T, 7) with
the RLDS gripper convention (0 = closed, 1 = open), plus the proprio keys
that the registry's ``state_obs_keys`` name. Every transform is a
module-level function, so that a dataset that names one pickles into
``DataLoader`` workers.
"""

from __future__ import annotations

import zlib
from typing import Any, Dict, Optional

import numpy as np

from vla_adapter_torch.data.normalization import (
    binarize_gripper_actions,
    rel2abs_gripper_actions,
)
from vla_adapter_torch.data.rlds.traj_transforms import tree_map

Traj = Dict[str, Any]
F32 = np.float32


# --------------------------------------------------------------------------
# math + gripper helpers
# --------------------------------------------------------------------------


def quat_to_euler(quat: np.ndarray) -> np.ndarray:
    """(x, y, z, w) quaternion -> (roll, pitch, yaw), the
    tensorflow_graphics ``euler.from_quaternion`` convention, in the
    quaternion's dtype."""
    x, y, z, w = np.moveaxis(np.asarray(quat), -1, 0)
    roll = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = np.arcsin(np.clip(2 * (w * y - z * x), -1.0, 1.0))
    yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return np.stack([roll, pitch, yaw], axis=-1)


def invert_gripper(actions: np.ndarray) -> np.ndarray:
    return 1.0 - actions


# the backward scan and the relative -> absolute state of
# data/normalization.py, under the JAX module's names
binarize_gripper = binarize_gripper_actions
rel2abs_gripper = rel2abs_gripper_actions


def _cat(*parts, axis=-1) -> np.ndarray:
    return np.concatenate(parts, axis=axis)


def _zlib_floats(blobs: np.ndarray) -> np.ndarray:
    """ZLIB-compressed float32 blobs, one per step -> (T, n) float32."""
    return np.stack([np.frombuffer(zlib.decompress(bytes(b)), F32)
                     for b in np.asarray(blobs, object)])


# --------------------------------------------------------------------------
# shared steps
# --------------------------------------------------------------------------


def _lang_from_obs(traj: Traj) -> Traj:
    traj["language_instruction"] = traj["observation"][
        "natural_language_instruction"]
    return traj


def _rt1_style(traj: Traj, lang_from_obs: bool = True) -> Traj:
    """Action dict {world_vector, rotation_delta,
    gripper_closedness_action} with the rel2abs gripper."""
    a = traj["action"]
    grip = a["gripper_closedness_action"]
    if grip.ndim == 2:
        grip = grip[:, 0]
    traj["action"] = _cat(a["world_vector"], a["rotation_delta"],
                          rel2abs_gripper(grip)[:, None])
    if lang_from_obs:
        _lang_from_obs(traj)
    return traj


def _eef_invert_clip_gripper(traj: Traj, state8: bool = False) -> Traj:
    """Action (T, >= 7): the 6 EEF dimensions, then invert(clip(gripper));
    optionally the state cut to its first 8 dimensions."""
    traj["action"] = _cat(traj["action"][:, :6],
                          invert_gripper(np.clip(traj["action"][:, -1:],
                                                 0, 1)))
    if state8:
        traj["observation"]["state"] = traj["observation"]["state"][:, :8]
    return traj


def _eef_state_tail(traj: Traj) -> None:
    traj["observation"]["eef_state"] = traj["observation"]["state"][:, :6]
    traj["observation"]["gripper_state"] = traj["observation"]["state"][:, -1:]


def _drop_first_step(traj: Traj, nested=("observation",)) -> None:
    for key in list(traj):
        if key == "traj_metadata":
            continue
        if key in nested:
            for k2 in traj[key]:
                traj[key][k2] = traj[key][k2][1:]
        else:
            traj[key] = traj[key][1:]


def _relabel_bridge(traj: Traj) -> Traj:
    """Actions relabeled to the reached state's deltas; the final step
    dropped."""
    state = traj["observation"]["state"]
    movement = state[1:, :6] - state[:-1, :6]
    truncated = tree_map(lambda x: x[:-1], traj)
    truncated["action"] = _cat(movement, traj["action"][:-1, -1:], axis=1)
    obs = truncated["observation"]
    obs["EEF_state"] = obs["state"][:, :6]
    obs["gripper_state"] = obs["state"][:, -1:]
    return truncated


# --------------------------------------------------------------------------
# dataset transforms
# --------------------------------------------------------------------------


def bridge_oxe_dataset_transform(traj: Traj) -> Traj:
    """OXE-mixture Bridge V2: drop the all-zero first step, dict action,
    cast open_gripper; then the state-delta relabel."""
    _drop_first_step(traj, nested=("observation", "action"))
    a = traj["action"]
    traj["action"] = _cat(a["world_vector"], a["rotation_delta"],
                          a["open_gripper"][:, None].astype(F32))
    _lang_from_obs(traj)
    return _relabel_bridge(traj)


def bridge_orig_dataset_transform(traj: Traj) -> Traj:
    """Official Bridge V2: drop the first step, binarize the gripper,
    relabel."""
    _drop_first_step(traj)
    traj["action"] = _cat(traj["action"][:, :6],
                          binarize_gripper(traj["action"][:, -1])[:, None],
                          axis=1)
    return _relabel_bridge(traj)


def ppgm_dataset_transform(traj: Traj) -> Traj:
    traj["action"] = _cat(traj["action"][:, :6],
                          binarize_gripper(traj["action"][:, -1])[:, None],
                          axis=1)
    obs = traj["observation"]
    obs["EEF_state"] = obs["cartesian_position"][:, :6]
    obs["gripper_state"] = obs["gripper_position"][:, -1:]
    return traj


def rt1_dataset_transform(traj: Traj) -> Traj:
    return _rt1_style(traj)


def kuka_dataset_transform(traj: Traj) -> Traj:
    traj = _rt1_style(traj, lang_from_obs=False)
    obs = traj["observation"]
    key = "clip_function_input/base_pose_tool_reached"
    obs[key] = _zlib_floats(obs[key]).reshape(-1, 7)
    obs["gripper_closed"] = _zlib_floats(obs["gripper_closed"]).reshape(-1, 1)
    return _lang_from_obs(traj)


def taco_play_dataset_transform(traj: Traj) -> Traj:
    obs = traj["observation"]
    obs["state_eef"] = obs["robot_obs"][:, :6]
    obs["state_gripper"] = obs["robot_obs"][:, 7:8]
    a = traj["action"]["rel_actions_world"]
    traj["action"] = _cat(a[:, :6], np.clip(a[:, -1:], 0, 1))
    return _lang_from_obs(traj)


def jaco_play_dataset_transform(traj: Traj) -> Traj:
    obs = traj["observation"]
    obs["state_eef"] = obs["end_effector_cartesian_pos"][:, :6]
    obs["state_gripper"] = obs["end_effector_cartesian_pos"][:, -1:]
    a = traj["action"]
    gripper = rel2abs_gripper(a["gripper_closedness_action"][:, 0])
    traj["action"] = _cat(a["world_vector"], np.zeros_like(a["world_vector"]),
                          gripper[:, None])
    return _lang_from_obs(traj)


def berkeley_cable_routing_dataset_transform(traj: Traj) -> Traj:
    a = traj["action"]
    traj["action"] = _cat(a["world_vector"], a["rotation_delta"],
                          np.zeros_like(a["world_vector"][:, :1]))
    return _lang_from_obs(traj)


def roboturk_dataset_transform(traj: Traj) -> Traj:
    a = traj["action"]
    gripper = invert_gripper(np.clip(a["gripper_closedness_action"], 0, 1))
    traj["action"] = _cat(a["world_vector"], a["rotation_delta"], gripper)
    return _lang_from_obs(traj)


def nyu_door_opening_dataset_transform(traj: Traj) -> Traj:
    return _rt1_style(traj)


def viola_dataset_transform(traj: Traj) -> Traj:
    a = traj["action"]
    gripper = invert_gripper(
        np.clip(a["gripper_closedness_action"][:, None], 0, 1))
    traj["action"] = _cat(a["world_vector"], a["rotation_delta"], gripper)
    return _lang_from_obs(traj)


def berkeley_autolab_ur5_dataset_transform(traj: Traj) -> Traj:
    obs = traj["observation"]
    obs["state"] = obs["robot_state"][:, 6:14]
    obs["depth"] = obs.pop("image_with_depth")
    a = traj["action"]
    gripper = rel2abs_gripper(a["gripper_closedness_action"])
    traj["action"] = _cat(a["world_vector"], a["rotation_delta"],
                          gripper[:, None])
    return _lang_from_obs(traj)


def toto_dataset_transform(traj: Traj) -> Traj:
    a = traj["action"]
    traj["action"] = _cat(a["world_vector"], a["rotation_delta"],
                          a["open_gripper"][:, None].astype(F32))
    return _lang_from_obs(traj)


def _first_utf8_piece(codepoints: np.ndarray) -> bytes:
    text = "".join(chr(int(c)) for c in codepoints).encode("utf-8")
    return text.split(b"\x00")[0]


def language_table_dataset_transform(traj: Traj) -> Traj:
    a = traj["action"]
    traj["action"] = _cat(a, np.zeros_like(a), np.zeros_like(a),
                          np.ones_like(a[:, :1]))
    # the instruction is a zero-padded tensor of unicode code points
    traj["language_instruction"] = np.array(
        [_first_utf8_piece(row) for row in traj["observation"]["instruction"]],
        dtype=object)
    return traj


def pusht_dataset_transform(traj: Traj) -> Traj:
    a = traj["action"]
    traj["action"] = _cat(a["world_vector"], a["rotation_delta"],
                          a["gripper_closedness_action"][:, None])
    return _lang_from_obs(traj)


def stanford_kuka_multimodal_dataset_transform(traj: Traj) -> Traj:
    obs = traj["observation"]
    obs["depth_image"] = obs["depth_image"][..., 0]
    a = traj["action"]
    traj["action"] = _cat(a[:, :3], np.zeros_like(a[:, :3]), a[:, -1:])
    return traj


def nyu_rot_dataset_transform(traj: Traj) -> Traj:
    obs = traj["observation"]
    obs["eef_state"] = obs["state"][..., :6]
    obs["gripper_state"] = obs["state"][..., -1:]
    traj["action"] = traj["action"][..., :7]
    return traj


def stanford_hydra_dataset_transform(traj: Traj) -> Traj:
    traj["action"] = _cat(traj["action"][:, :6],
                          invert_gripper(traj["action"][:, -1:]))
    obs = traj["observation"]
    obs["eef_state"] = _cat(obs["state"][:, :3], obs["state"][:, 7:10])
    obs["gripper_state"] = obs["state"][:, -3:-2]
    return traj


def austin_buds_dataset_transform(traj: Traj) -> Traj:
    return _eef_invert_clip_gripper(traj, state8=True)


def nyu_franka_play_dataset_transform(traj: Traj) -> Traj:
    obs = traj["observation"]
    obs["depth"] = obs["depth"][..., 0].astype(F32)
    obs["depth_additional_view"] = (
        obs["depth_additional_view"][..., 0].astype(F32))
    obs["eef_state"] = obs["state"][:, -6:]
    a = traj["action"]
    traj["action"] = _cat(a[:, -8:-2], np.clip(a[:, -2:-1], 0, 1))
    return traj


def maniskill_dataset_transform(traj: Traj) -> Traj:
    traj["observation"]["gripper_state"] = (
        traj["observation"]["state"][..., 7:8])
    return traj


def furniture_bench_dataset_transform(traj: Traj) -> Traj:
    obs = traj["observation"]
    obs["state"] = _cat(obs["state"][:, :7], obs["state"][:, -1:])
    a = traj["action"]
    traj["action"] = _cat(a[:, :3], quat_to_euler(a[:, 3:7]),
                          invert_gripper(np.clip(a[:, -1:], 0, 1)))
    return traj


def cmu_franka_exploration_dataset_transform(traj: Traj) -> Traj:
    traj["action"] = traj["action"][..., :-1]
    return traj


def ucsd_kitchen_dataset_transform(traj: Traj) -> Traj:
    traj["observation"]["joint_state"] = traj["observation"]["state"][:, :7]
    traj["action"] = traj["action"][..., :-1]
    return traj


def ucsd_pick_place_dataset_transform(traj: Traj) -> Traj:
    _eef_state_tail(traj)
    a = traj["action"]
    traj["action"] = _cat(a[:, :3], np.zeros_like(a[:, :3]), a[:, -1:])
    return traj


def austin_sailor_dataset_transform(traj: Traj) -> Traj:
    return _eef_invert_clip_gripper(traj)


def austin_sirius_dataset_transform(traj: Traj) -> Traj:
    return _eef_invert_clip_gripper(traj)


def bc_z_dataset_transform(traj: Traj) -> Traj:
    a = traj["action"]
    traj["action"] = _cat(
        a["future/xyz_residual"][:, :3], a["future/axis_angle_residual"][:, :3],
        invert_gripper(a["future/target_close"][:, :1].astype(F32)))
    return _lang_from_obs(traj)


def _pr2_style(traj: Traj) -> Traj:
    _eef_state_tail(traj)
    traj["action"] = traj["action"][..., :-1]
    return traj


def tokyo_pr2_opening_fridge_dataset_transform(traj: Traj) -> Traj:
    return _pr2_style(traj)


def tokyo_pr2_tabletop_manipulation_dataset_transform(traj: Traj) -> Traj:
    return _pr2_style(traj)


def utokyo_xarm_pick_place_dataset_transform(traj: Traj) -> Traj:
    return traj


def utokyo_xarm_bimanual_dataset_transform(traj: Traj) -> Traj:
    traj["action"] = traj["action"][..., -7:]
    return traj


def robo_net_dataset_transform(traj: Traj) -> Traj:
    obs = traj["observation"]
    obs["eef_state"] = _cat(obs["state"][:, :4],
                            np.zeros_like(obs["state"][:, :2]))
    obs["gripper_state"] = obs["state"][:, -1:]
    a = traj["action"]
    traj["action"] = _cat(a[:, :4], np.zeros_like(a[:, :2]), a[:, -1:])
    return traj


def identity_transform(traj: Traj) -> Traj:
    return traj


def berkeley_mvp_dataset_transform(traj: Traj) -> Traj:
    return traj


def berkeley_rpt_dataset_transform(traj: Traj) -> Traj:
    return traj


def kaist_nonprehensible_dataset_transform(traj: Traj) -> Traj:
    traj["observation"]["state"] = traj["observation"]["state"][:, -7:]
    a = traj["action"]
    traj["action"] = _cat(a[:, :6], np.zeros_like(a[:, :1]))
    return traj


def stanford_mask_vit_dataset_transform(traj: Traj) -> Traj:
    obs = traj["observation"]
    pose = obs["end_effector_pose"]
    obs["eef_state"] = _cat(pose[:, :4], np.zeros_like(pose[:, :2]))
    obs["gripper_state"] = pose[:, -1:]
    a = traj["action"]
    traj["action"] = _cat(a[:, :4], np.zeros_like(a[:, :2]), a[:, -1:])
    return traj


def tokyo_lsmo_dataset_transform(traj: Traj) -> Traj:
    _eef_state_tail(traj)
    return traj


def dlr_sara_pour_dataset_transform(traj: Traj) -> Traj:
    return traj


def dlr_sara_grid_clamp_dataset_transform(traj: Traj) -> Traj:
    traj["observation"]["state"] = traj["observation"]["state"][:, :6]
    return traj


def dlr_edan_shared_control_dataset_transform(traj: Traj) -> Traj:
    traj["action"] = _cat(traj["action"][:, :6],
                          invert_gripper(traj["action"][:, -1:]))
    return traj


def asu_table_top_dataset_transform(traj: Traj) -> Traj:
    traj["observation"]["eef_state"] = traj["ground_truth_states"]["EE"]
    traj["observation"]["gripper_state"] = (
        traj["observation"]["state"][:, -1:])
    return traj


def robocook_dataset_transform(traj: Traj) -> Traj:
    _eef_state_tail(traj)
    return traj


def imperial_wristcam_dataset_transform(traj: Traj) -> Traj:
    traj["action"] = traj["action"][..., :-1]
    return traj


def iamlab_pick_insert_dataset_transform(traj: Traj) -> Traj:
    obs = traj["observation"]
    obs["joint_state"] = obs["state"][:, :7]
    obs["gripper_state"] = obs["state"][:, 7:8]
    a = traj["action"]
    traj["action"] = _cat(a[:, :3], quat_to_euler(a[:, 3:7]), a[:, 7:8])
    return traj


def uiuc_d3field_dataset_transform(traj: Traj) -> Traj:
    a = traj["action"]
    traj["action"] = _cat(a, np.zeros_like(a), np.zeros_like(a[:, :1]))
    return traj


def utaustin_mutex_dataset_transform(traj: Traj) -> Traj:
    return _eef_invert_clip_gripper(traj, state8=True)


def berkeley_fanuc_dataset_transform(traj: Traj) -> Traj:
    obs = traj["observation"]
    obs["joint_state"] = obs["state"][:, :6]
    obs["gripper_state"] = obs["state"][:, 6:7]
    traj["action"] = _cat(traj["action"],
                          invert_gripper(obs["gripper_state"]))
    return traj


def cmu_playing_with_food_dataset_transform(traj: Traj) -> Traj:
    a = traj["action"]
    traj["action"] = _cat(a[:, :3], quat_to_euler(a[:, 3:7]), a[:, -1:])
    return traj


def playfusion_dataset_transform(traj: Traj) -> Traj:
    a = traj["action"]
    traj["action"] = _cat(a[:, :3], a[:, -4:])
    return traj


def cmu_stretch_dataset_transform(traj: Traj) -> Traj:
    obs = traj["observation"]
    obs["eef_state"] = _cat(obs["state"][:, :3],
                            np.zeros_like(obs["state"][:, :3]))
    obs["gripper_state"] = obs["state"][:, -1:]
    traj["action"] = traj["action"][..., :-1]
    return traj


def gnm_dataset_transform(traj: Traj) -> Traj:
    obs = traj["observation"]
    obs["state"] = _cat(obs["position"], np.zeros_like(obs["state"][:, :3]),
                        obs["yaw"])
    a = traj["action"]
    traj["action"] = _cat(a, np.zeros_like(a), np.zeros_like(a),
                          np.zeros_like(a[:, :1]))
    return traj


def fmb_dataset_transform(traj: Traj) -> Traj:
    obs = traj["observation"]
    obs["proprio"] = _cat(obs["eef_pose"], obs["state_gripper_pose"][..., None])
    return traj


def dobbe_dataset_transform(traj: Traj) -> Traj:
    traj["observation"]["proprio"] = traj["observation"]["state"]
    return traj


def roboset_dataset_transform(traj: Traj) -> Traj:
    traj["observation"]["proprio"] = traj["observation"]["state"]
    a = traj["action"]
    traj["action"] = _cat(a[:, :7], invert_gripper(np.clip(a[:, -1:], 0, 1)))
    return traj


def rh20t_dataset_transform(traj: Traj) -> Traj:
    a = traj["action"]
    traj["action"] = _cat(a["tcp_base"], a["gripper"][:, None].astype(F32))
    obs = traj["observation"]
    obs["proprio"] = _cat(obs["tcp_base"], obs["gripper_width"][..., None])
    return traj


def _droid_actions(traj: Traj) -> None:
    a = traj["action_dict"]
    traj["action"] = _cat(a["cartesian_velocity"][:, :3],
                          a["cartesian_velocity"][:, 3:6],
                          1 - a["gripper_position"])
    obs = traj["observation"]
    obs["proprio"] = _cat(obs["cartesian_position"], obs["gripper_position"])


def droid_baseact_transform(traj: Traj,
                            rng: Optional[np.random.Generator] = None) -> Traj:
    """DROID with base-frame velocity actions; the two exterior cameras
    swap places with probability 1/2 (a draw from ``rng``, else from a
    fresh generator)."""
    _droid_actions(traj)
    obs = traj["observation"]
    rng = rng if rng is not None else np.random.default_rng()
    if not rng.random(dtype=F32) > 0.5:
        obs["exterior_image_1_left"], obs["exterior_image_2_left"] = (
            obs["exterior_image_2_left"], obs["exterior_image_1_left"])
    return traj


def droid_finetuning_transform(traj: Traj) -> Traj:
    _droid_actions(traj)
    return traj


def tdroid_dataset_transform(traj: Traj) -> Traj:
    traj["action"] = _cat(traj["action"][:, :6],
                          binarize_gripper(traj["action"][:, -1])[:, None],
                          axis=1)
    obs = traj["observation"]
    obs["EEF_state"] = obs["cartesian_position"][:, :6]
    obs["gripper_state"] = obs["gripper_position"][:, -1:]
    return traj


def libero_dataset_transform(traj: Traj) -> Traj:
    """LIBERO: the gripper -1 (open) .. 1 (close) clipped to [0, 1] and
    flipped, so that 1 is open."""
    gripper = invert_gripper(np.clip(traj["action"][:, -1:], 0, 1))
    traj["action"] = _cat(traj["action"][:, :6], gripper, axis=1)
    obs = traj["observation"]
    obs["EEF_state"] = obs["state"][:, :6]
    obs["gripper_state"] = obs["state"][:, -2:]
    return traj


def calvin_dataset_transform(traj: Traj) -> Traj:
    """CALVIN: the gripper clipped to [0, 1] (already 1 = open);
    gripper_state = [state[6], state[-1]]."""
    gripper = np.clip(traj["action"][:, -1:], 0, 1)
    traj["action"] = _cat(traj["action"][:, :6], gripper, axis=1)
    obs = traj["observation"]
    obs["EEF_state"] = obs["state"][:, :6]
    obs["gripper_state"] = _cat(obs["state"][:, 6:7], obs["state"][:, -1:],
                                axis=1)
    return traj


def aloha_dataset_transform(traj: Traj) -> Traj:
    return traj


OXE_STANDARDIZATION_TRANSFORMS = {
    "bridge_oxe": bridge_oxe_dataset_transform,
    "bridge_orig": bridge_orig_dataset_transform,
    "bridge_dataset": bridge_orig_dataset_transform,
    "ppgm": ppgm_dataset_transform,
    "ppgm_static": ppgm_dataset_transform,
    "ppgm_wrist": ppgm_dataset_transform,
    "fractal20220817_data": rt1_dataset_transform,
    "kuka": kuka_dataset_transform,
    "taco_play": taco_play_dataset_transform,
    "jaco_play": jaco_play_dataset_transform,
    "berkeley_cable_routing": berkeley_cable_routing_dataset_transform,
    "roboturk": roboturk_dataset_transform,
    "nyu_door_opening_surprising_effectiveness": nyu_door_opening_dataset_transform,
    "viola": viola_dataset_transform,
    "berkeley_autolab_ur5": berkeley_autolab_ur5_dataset_transform,
    "toto": toto_dataset_transform,
    "language_table": language_table_dataset_transform,
    "columbia_cairlab_pusht_real": pusht_dataset_transform,
    "stanford_kuka_multimodal_dataset_converted_externally_to_rlds": stanford_kuka_multimodal_dataset_transform,
    "nyu_rot_dataset_converted_externally_to_rlds": nyu_rot_dataset_transform,
    "stanford_hydra_dataset_converted_externally_to_rlds": stanford_hydra_dataset_transform,
    "austin_buds_dataset_converted_externally_to_rlds": austin_buds_dataset_transform,
    "nyu_franka_play_dataset_converted_externally_to_rlds": nyu_franka_play_dataset_transform,
    "maniskill_dataset_converted_externally_to_rlds": maniskill_dataset_transform,
    "furniture_bench_dataset_converted_externally_to_rlds": furniture_bench_dataset_transform,
    "cmu_franka_exploration_dataset_converted_externally_to_rlds": cmu_franka_exploration_dataset_transform,
    "ucsd_kitchen_dataset_converted_externally_to_rlds": ucsd_kitchen_dataset_transform,
    "ucsd_pick_and_place_dataset_converted_externally_to_rlds": ucsd_pick_place_dataset_transform,
    "austin_sailor_dataset_converted_externally_to_rlds": austin_sailor_dataset_transform,
    "austin_sirius_dataset_converted_externally_to_rlds": austin_sirius_dataset_transform,
    "bc_z": bc_z_dataset_transform,
    "utokyo_pr2_opening_fridge_converted_externally_to_rlds": tokyo_pr2_opening_fridge_dataset_transform,
    "utokyo_pr2_tabletop_manipulation_converted_externally_to_rlds": tokyo_pr2_tabletop_manipulation_dataset_transform,
    "utokyo_xarm_pick_and_place_converted_externally_to_rlds": utokyo_xarm_pick_place_dataset_transform,
    "utokyo_xarm_bimanual_converted_externally_to_rlds": utokyo_xarm_bimanual_dataset_transform,
    "robo_net": robo_net_dataset_transform,
    "berkeley_mvp_converted_externally_to_rlds": berkeley_mvp_dataset_transform,
    "berkeley_rpt_converted_externally_to_rlds": berkeley_rpt_dataset_transform,
    "kaist_nonprehensile_converted_externally_to_rlds": kaist_nonprehensible_dataset_transform,
    "stanford_mask_vit_converted_externally_to_rlds": stanford_mask_vit_dataset_transform,
    "tokyo_u_lsmo_converted_externally_to_rlds": tokyo_lsmo_dataset_transform,
    "dlr_sara_pour_converted_externally_to_rlds": dlr_sara_pour_dataset_transform,
    "dlr_sara_grid_clamp_converted_externally_to_rlds": dlr_sara_grid_clamp_dataset_transform,
    "dlr_edan_shared_control_converted_externally_to_rlds": dlr_edan_shared_control_dataset_transform,
    "asu_table_top_converted_externally_to_rlds": asu_table_top_dataset_transform,
    "stanford_robocook_converted_externally_to_rlds": robocook_dataset_transform,
    "imperialcollege_sawyer_wrist_cam": imperial_wristcam_dataset_transform,
    "iamlab_cmu_pickup_insert_converted_externally_to_rlds": iamlab_pick_insert_dataset_transform,
    "uiuc_d3field": uiuc_d3field_dataset_transform,
    "utaustin_mutex": utaustin_mutex_dataset_transform,
    "berkeley_fanuc_manipulation": berkeley_fanuc_dataset_transform,
    "cmu_playing_with_food": cmu_playing_with_food_dataset_transform,
    "cmu_play_fusion": playfusion_dataset_transform,
    "cmu_stretch": cmu_stretch_dataset_transform,
    "berkeley_gnm_recon": gnm_dataset_transform,
    "berkeley_gnm_cory_hall": gnm_dataset_transform,
    "berkeley_gnm_sac_son": gnm_dataset_transform,
    "droid": droid_baseact_transform,
    "fmb_dataset": fmb_dataset_transform,
    "dobbe": dobbe_dataset_transform,
    "roboset": roboset_dataset_transform,
    "rh20t": rh20t_dataset_transform,
    "tdroid_carrot_in_bowl": tdroid_dataset_transform,
    "tdroid_pour_corn_in_pot": tdroid_dataset_transform,
    "tdroid_flip_pot_upright": tdroid_dataset_transform,
    "tdroid_move_object_onto_plate": tdroid_dataset_transform,
    "tdroid_knock_object_over": tdroid_dataset_transform,
    "tdroid_cover_object_with_towel": tdroid_dataset_transform,
    "droid_wipe": droid_finetuning_transform,
    "libero_spatial_no_noops": libero_dataset_transform,
    "libero_object_no_noops": libero_dataset_transform,
    "libero_goal_no_noops": libero_dataset_transform,
    "libero_10_no_noops": libero_dataset_transform,
    "libero_4_task_suites_no_noops": libero_dataset_transform,
    "calvin": calvin_dataset_transform,
    "calvin_abc": calvin_dataset_transform,
    "calvin_abc_rlds": calvin_dataset_transform,
    "aloha1_fold_shorts_20_demos": aloha_dataset_transform,
    "aloha1_fold_shirt_30_demos": aloha_dataset_transform,
    "aloha1_scoop_X_into_bowl_45_demos": aloha_dataset_transform,
    "aloha1_put_X_into_pot_300_demos": aloha_dataset_transform,
}
