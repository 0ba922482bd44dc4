"""LIBERO dataset regeneration (counterpart of
vla_adapter_tpu/eval/regenerate_libero.py; the reference's
experiments/robot/libero/regenerate_libero_dataset.py).

Replays the original LIBERO HDF5 demos in the simulator at 256 px,
dropping no-op actions and failed replays, and writes clean HDF5: the
source of the ``libero_*_no_noops`` RLDS datasets. Host only; needs h5py
and the simulator.

    python -m vla_adapter_torch.eval.regenerate_libero \\
        --task_suite libero_spatial --raw_data_dir ... --target_dir ...
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Optional

import numpy as np

from vla_adapter_torch.core.cli import parse_config
from vla_adapter_torch.eval.libero import LIBERO_ENV_RESOLUTION, _make_env
from vla_adapter_torch.utils.overwatch import initialize_overwatch

log = initialize_overwatch(__name__)


@dataclasses.dataclass(frozen=True)
class RegenerateConfig:
    task_suite: str = "libero_spatial"
    raw_data_dir: str = ""
    target_dir: str = ""


def is_noop(action: np.ndarray, prev_action: Optional[np.ndarray]) -> bool:
    """No movement and no gripper change (zero deltas with an unchanged
    gripper are dropped)."""
    zero_move = np.allclose(action[:-1], 0.0)
    if prev_action is None:
        return zero_move
    return zero_move and action[-1] == prev_action[-1]


def replay_demo(env, actions: np.ndarray, initial_state) -> tuple:
    """Replay a demo, collecting the 256-px observations: (success,
    states, agent-view frames, wrist frames, kept actions)."""
    env.reset()
    obs = env.set_init_state(initial_state)
    states, images, wrists, kept = [], [], [], []
    prev = None
    done = False
    for action in actions:
        if is_noop(action, prev):
            prev = action
            continue
        states.append(env.get_sim_state())
        images.append(obs["agentview_image"])
        wrists.append(obs["robot0_eye_in_hand_image"])
        kept.append(action)
        obs, _, done, _ = env.step(action.tolist())
        prev = action
    return done, states, images, wrists, np.asarray(kept)


def main(argv=None) -> None:
    import h5py
    from libero.libero import benchmark

    cfg = parse_config(RegenerateConfig, argv)
    if not (cfg.raw_data_dir and cfg.target_dir):
        raise SystemExit("--raw_data_dir and --target_dir are required")
    suite = benchmark.get_benchmark_dict()[cfg.task_suite]()
    os.makedirs(cfg.target_dir, exist_ok=True)

    total, kept_demos = 0, 0
    for task_id in range(suite.n_tasks):
        task = suite.get_task(task_id)
        env, _ = _make_env(task, resolution=LIBERO_ENV_RESOLUTION)
        src = Path(cfg.raw_data_dir) / f"{task.name}_demo.hdf5"
        dst = Path(cfg.target_dir) / f"{task.name}_demo.hdf5"
        with h5py.File(src, "r") as fin, h5py.File(dst, "w") as fout:
            grp = fout.create_group("data")
            for demo_key in fin["data"]:
                total += 1
                demo = fin[f"data/{demo_key}"]
                actions = np.asarray(demo["actions"])
                init_state = np.asarray(demo["states"])[0]
                ok, states, images, wrists, kept = replay_demo(
                    env, actions, init_state)
                if not ok:
                    log.info("dropping failed replay %s/%s", task.name,
                             demo_key)
                    continue
                kept_demos += 1
                g = grp.create_group(demo_key)
                g.create_dataset("actions", data=kept)
                g.create_dataset("states", data=np.asarray(states))
                o = g.create_group("obs")
                o.create_dataset("agentview_rgb", data=np.asarray(images))
                o.create_dataset("eye_in_hand_rgb", data=np.asarray(wrists))
        env.close()
    log.info("kept %d/%d demos", kept_demos, total)


if __name__ == "__main__":
    main()
