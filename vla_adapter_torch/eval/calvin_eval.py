"""CALVIN eval CLI (counterpart of vla_adapter_tpu/eval/calvin_eval.py;
the reference's vla-scripts/evaluate_calvin.py).

Needs the host-side CALVIN stack (calvin_agent, calvin_env, hydra); all of
it is imported inside :func:`build_calvin_assets`.

    python -m vla_adapter_torch.eval.calvin_eval \\
        --ckpt_dir <dir> --dataset_path <calvin_debug_dataset>

Under ``torchrun --nproc_per_node N`` each rank evaluates every N-th
chain on its own card and the depths are gathered (``eval/calvin.py``).
"""

from __future__ import annotations

import dataclasses
import json

from vla_adapter_torch.core.cli import parse_config
from vla_adapter_torch.eval.calvin import CalvinEvalConfig, eval_calvin
from vla_adapter_torch.utils.overwatch import initialize_overwatch

log = initialize_overwatch(__name__)


@dataclasses.dataclass(frozen=True)
class CalvinCLIConfig:
    ckpt_dir: str = ""
    dataset_path: str = ""
    eval: CalvinEvalConfig = CalvinEvalConfig()
    seed: int = 7
    # what the port's load_vla takes beyond the JAX one's arguments
    device: str = "cuda"
    int8: bool = False
    act_int8: bool = False
    w8a8_impl: str = "auto"


def build_calvin_assets(dataset_path: str, num_sequences: int):
    """(env, task_oracle, val_annotations, eval_sequences) from the CALVIN
    validation assets (the reference's evaluate_calvin.py:820-915)."""
    from calvin_agent.evaluation.multistep_sequences import get_sequences
    from calvin_agent.evaluation.utils import (
        get_env_state_for_initial_condition,
    )
    import hydra
    from omegaconf import OmegaConf

    from vla_adapter_torch.eval.calvin_env_wrapper import make_calvin_env

    conf_dir = hydra.utils.to_absolute_path("calvin_models/conf")
    task_oracle = hydra.utils.instantiate(OmegaConf.load(
        f"{conf_dir}/callbacks/rollout/tasks/new_playtable_tasks.yaml"))
    val_annotations = OmegaConf.load(
        f"{conf_dir}/annotations/new_playtable_validation.yaml")
    env = make_calvin_env(dataset_path)

    def to_state(initial):
        if not isinstance(initial, dict):
            return initial  # already a {"robot_obs", "scene_obs"} state
        # both halves matter: the scene (drawer, light, blocks) too
        robot_obs, scene_obs = get_env_state_for_initial_condition(initial)
        return {"robot_obs": robot_obs, "scene_obs": scene_obs}

    eval_sequences = [(to_state(initial), seq)
                      for initial, seq in get_sequences(num_sequences)]
    return env, task_oracle, val_annotations, eval_sequences


def main(argv=None) -> None:
    from vla_adapter_torch.eval.robot_utils import set_seed_everywhere
    from vla_adapter_torch.parallel.sharding import (
        initialize_distributed,
        torchrun_env,
    )
    from vla_adapter_torch.weights.load import load_vla

    cfg = parse_config(CalvinCLIConfig, argv)
    if not (cfg.ckpt_dir and cfg.dataset_path):
        raise SystemExit("--ckpt_dir and --dataset_path are required")
    env = torchrun_env()
    device = cfg.device
    if env is not None:  # one rank per card
        initialize_distributed(*env, device=cfg.device)
        if cfg.device == "cuda":
            device = f"cuda:{env[3]}"
    set_seed_everywhere(cfg.seed)
    predictor = load_vla(cfg.ckpt_dir, device=device, int8=cfg.int8,
                         act_int8=cfg.act_int8, w8a8_impl=cfg.w8a8_impl)
    assets = build_calvin_assets(cfg.dataset_path, cfg.eval.num_sequences)
    results = eval_calvin(predictor, assets, cfg.eval)
    log.info("CALVIN results: %s", json.dumps(results, indent=2))
    print(json.dumps(results))


if __name__ == "__main__":
    main()
