"""CALVIN environment construction (counterpart of
vla_adapter_tpu/eval/calvin_env_wrapper.py; the reference's
vla-scripts/calvin_env_wrapper.py).

Builds the calvin_env playtable environment from a CALVIN dataset
directory (its validation split carries the scene and camera hydra
configs). ``hydra``, ``omegaconf`` and the simulator are imported lazily.
"""

from __future__ import annotations

from pathlib import Path


class CalvinEnvWrapper:
    """The get_obs / get_info / step / reset surface the eval loop uses."""

    def __init__(self, env):
        self.env = env

    def get_obs(self):
        return self.env.get_obs()

    def get_info(self):
        return self.env.get_info()

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        return obs, reward, done, info

    def reset(self, robot_obs=None, scene_obs=None):
        return self.env.reset(robot_obs=robot_obs, scene_obs=scene_obs)


def make_calvin_env(dataset_path: str, show_gui: bool = False
                    ) -> CalvinEnvWrapper:
    import hydra
    from omegaconf import OmegaConf

    render_conf = OmegaConf.load(
        Path(dataset_path) / "validation" / ".hydra" / "merged_config.yaml")
    env = hydra.utils.instantiate(render_conf.env, show_gui=show_gui,
                                  use_vr=False, use_scene_info=True)
    return CalvinEnvWrapper(env)
