"""LIBERO closed-loop evaluation harness (counterpart of
vla_adapter_tpu/eval/libero.py; the reference's run_libero_eval.py).

Per suite, every task for ``num_trials_per_task`` episodes: 10 no-op
settle steps, open-loop execution of the first 8 actions of each chunk,
fixed seeds and initial states, success rates per task and overall, and
optional rollout MP4s. The simulator (LIBERO, robosuite, MuJoCo) stays on
the host and is imported lazily; the card runs the policy.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from pathlib import Path
from typing import Callable, Dict, List

import numpy as np

from vla_adapter_torch.eval.openloop import ActionQueueController
from vla_adapter_torch.eval.robot_utils import (
    process_action,
    quat2axisangle,
    resize_image_for_policy,
    rotate_180,
    set_seed_everywhere,
)

log = logging.getLogger(__name__)

# the reference's run_libero_eval.py:63-69
TASK_MAX_STEPS = {
    "libero_spatial": 220,
    "libero_object": 280,
    "libero_goal": 300,
    "libero_10": 520,
    "libero_90": 400,
}
LIBERO_DUMMY_ACTION = [0, 0, 0, 0, 0, 0, -1]
NUM_STEPS_WAIT = 10
LIBERO_ENV_RESOLUTION = 256


@dataclasses.dataclass(frozen=True)
class LiberoEvalConfig:
    task_suite_name: str = "libero_spatial"
    num_trials_per_task: int = 50
    num_open_loop_steps: int = 8
    image_size: int = 224
    seed: int = 7
    save_videos: bool = False
    video_dir: str = "rollouts"
    initial_states_path: str = "DEFAULT"  # fixed env init states


def prepare_observation(obs, image_size: int) -> Dict[str, np.ndarray]:
    """Env obs -> policy obs: the 180-degree rotation, the parity resize of
    both cameras, proprio = [eef pos, axis-angle, gripper qpos]."""
    img = rotate_180(obs["agentview_image"])
    wrist = rotate_180(obs["robot0_eye_in_hand_image"])
    return {
        "full_image": resize_image_for_policy(img, image_size),
        "wrist_image": resize_image_for_policy(wrist, image_size),
        "state": np.concatenate(
            (obs["robot0_eef_pos"], quat2axisangle(obs["robot0_eef_quat"]),
             obs["robot0_gripper_qpos"])),
        "replay_image": img,
    }


def run_episode(env, task_description: str, policy: Callable,
                cfg: LiberoEvalConfig, initial_state=None) -> tuple:
    """One episode; policy(obs_dict, task_description) -> (chunk, 7).
    Returns (success, the agent-view frames the policy saw)."""
    env.reset()
    obs = (env.set_init_state(initial_state) if initial_state is not None
           else env.get_observation())
    controller = ActionQueueController(
        lambda o: policy(o, task_description), cfg.num_open_loop_steps)
    max_steps = TASK_MAX_STEPS[cfg.task_suite_name]
    replay_images = []
    t, success = 0, False
    while t < max_steps + NUM_STEPS_WAIT:
        if t < NUM_STEPS_WAIT:
            obs, _, done, _ = env.step(LIBERO_DUMMY_ACTION)
            t += 1
            continue
        observation = prepare_observation(obs, cfg.image_size)
        replay_images.append(observation.pop("replay_image"))
        action = process_action(controller.step(observation))
        obs, _, done, _ = env.step(action.tolist())
        if done:
            success = True
            break
        t += 1
    return success, replay_images


def eval_libero(policy: Callable, cfg: LiberoEvalConfig) -> Dict[str, float]:
    """A whole suite. policy(obs_dict, task_description) -> (chunk, 7)
    unnormalized actions (for example a closure over
    ``infer.predict.Predictor``). Returns {"success_rate", "episodes",
    "successes", "per_task"}. Needs the ``libero`` package."""
    try:
        from libero.libero import benchmark  # the simulator: host only
    except ImportError as err:
        raise ImportError("eval_libero needs the LIBERO simulator (the "
                          "`libero` package)") from err

    set_seed_everywhere(cfg.seed)
    suite = benchmark.get_benchmark_dict()[cfg.task_suite_name]()
    custom_states = None
    if cfg.initial_states_path != "DEFAULT":
        custom_states = json.loads(Path(cfg.initial_states_path).read_text())

    total, successes = 0, 0
    per_task = {}
    for task_id in range(suite.n_tasks):
        task = suite.get_task(task_id)
        env, desc = _make_env(task)
        if custom_states is not None:
            initial_states = [np.asarray(s) for s in custom_states[desc]]
        else:
            initial_states = suite.get_task_init_states(task_id)
        task_succ = 0
        for ep in range(cfg.num_trials_per_task):
            init = initial_states[ep % len(initial_states)]
            try:
                ok, frames = run_episode(env, desc, policy, cfg, init)
            except Exception as e:  # episode-level fault tolerance
                log.warning("episode error on %s ep %d: %s", desc, ep, e)
                ok, frames = False, []
            task_succ += int(ok)
            total += 1
            successes += int(ok)
            if cfg.save_videos and frames:
                _save_video(frames, cfg, task_id, ep, ok, desc)
            log.info("%s ep %d: %s (%d/%d)", desc, ep, ok, successes, total)
        per_task[desc] = task_succ / cfg.num_trials_per_task
        env.close()
    return {
        "success_rate": successes / max(total, 1),
        "episodes": total,
        "successes": successes,
        "per_task": per_task,
    }


def _make_env(task, resolution: int = LIBERO_ENV_RESOLUTION):
    """OffScreenRenderEnv seeded 0 (the reference's libero_utils.py:19-26:
    the seed moves objects even under fixed initial states)."""
    import os

    from libero.libero import get_libero_path
    from libero.libero.envs import OffScreenRenderEnv

    bddl = os.path.join(get_libero_path("bddl_files"), task.problem_folder,
                        task.bddl_file)
    env = OffScreenRenderEnv(bddl_file_name=bddl, camera_heights=resolution,
                             camera_widths=resolution)
    env.seed(0)
    return env, task.language


def _save_video(frames: List[np.ndarray], cfg: LiberoEvalConfig,
                task_id: int, ep: int, success: bool, desc: str) -> None:
    try:
        import imageio
    except ImportError:
        return
    out = Path(cfg.video_dir)
    out.mkdir(parents=True, exist_ok=True)
    name = desc.lower().replace(" ", "_")[:50]
    path = out / f"task{task_id}-ep{ep}-succ={success}-{name}.mp4"
    with imageio.get_writer(path, fps=30) as w:
        for f in frames:
            w.append_data(f)
