"""CALVIN ABC->D long-horizon evaluation harness (counterpart of
vla_adapter_tpu/eval/calvin.py; the reference's evaluate_calvin.py and
vla_evaluation.py).

1000 five-instruction chains, per-subtask rollouts of up to 80 ensembling
cycles under the "hi3" temporal-ensemble controller, the average
successful sequence length, and CALVIN's conventions:

* the static (200 px) and gripper (84 px) cameras, parity-resized to 224
  by the Predictor (with the 0.9 center crop when it crops);
* proprio = [robot_obs[:7], robot_obs[-1:]], normalized with the
  "calvin_abc_rlds" statistics;
* the model's gripper flipped 1 - a before the standard normalize,
  binarize and invert pipeline.

Under a ``torch.distributed`` process group the chains are split across
ranks (``[rank::world]``; the reference splits them across accelerate
processes) and the depths gathered back in rank order.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from vla_adapter_torch.eval.openloop import (
    HI3_CYCLE_LEN,
    TemporalEnsembleController,
)
from vla_adapter_torch.eval.robot_utils import process_action
from vla_adapter_torch.utils.overwatch import process_count, process_index

log = logging.getLogger(__name__)

NUM_SEQUENCES = 1000
EP_LEN = 80  # ensembling cycles per subtask rollout


@dataclasses.dataclass(frozen=True)
class CalvinEvalConfig:
    num_sequences: int = NUM_SEQUENCES
    ep_len: int = EP_LEN
    unnorm_key: str = "calvin_abc_rlds"
    image_size: int = 224
    # The enriched-language protocol (the reference's
    # evaluate_calvin.py:134,211-213): the GPT-paraphrased table replaces
    # the standard new_playtable_validation.yaml annotations.
    enrich_lang: bool = False
    enrich_lang_path: Optional[str] = None  # default: the packaged asset


def load_enriched_annotations(path: Optional[str] = None
                              ) -> Dict[str, List[str]]:
    """The enriched CALVIN instruction table (34 tasks, ~48 paraphrases
    each; this package's copy of the reference's
    enrich_lang_annotations.json). The reference only ever uses the first
    paraphrase of a task (evaluate_calvin.py:346,398)."""
    if path is None:
        path = str(Path(__file__).parent / "assets" /
                   "enrich_lang_annotations.json")
    with open(path) as f:
        table = json.load(f)
    if not all(isinstance(v, list) and v for v in table.values()):
        raise ValueError(f"{path}: malformed enriched-annotation table")
    return table


def count_success(results: Sequence[int]) -> List[float]:
    """Chain success rates at depth 1..5."""
    results = np.asarray(list(results))
    return [float((results >= i).mean()) for i in range(1, 6)]


def avg_seq_len(results: Sequence[int]) -> float:
    return float(np.mean(list(results)))


class CalvinPolicy:
    """A Predictor on CALVIN observations (the reference's
    DualSystemCalvinEvaluation.step, vla_evaluation.py:240-315)."""

    def __init__(self, predictor, cfg: CalvinEvalConfig):
        self.predictor = predictor
        self.cfg = cfg

    def __call__(self, obs, instruction: str) -> np.ndarray:
        static = obs["rgb_obs"]["rgb_static"]
        gripper = obs["rgb_obs"]["rgb_gripper"]
        proprio = np.concatenate([obs["robot_obs"][:7],
                                  obs["robot_obs"][-1:]])
        chunk = self.predictor.predict_action(
            [static, gripper], instruction, proprio=proprio,
            unnorm_key=self.cfg.unnorm_key)
        chunk = np.array(chunk)
        chunk[:, -1] = 1.0 - chunk[:, -1]  # CALVIN's gripper flip
        return chunk


def rollout_subtask(env, policy: Callable, task_oracle, subtask: str,
                    instruction: str, cfg: CalvinEvalConfig) -> bool:
    """One subtask under hi3 ensembling, success checked every step."""
    obs = env.get_obs()
    start_info = env.get_info()
    controller = TemporalEnsembleController(lambda o: policy(o, instruction))
    for _ in range(cfg.ep_len * HI3_CYCLE_LEN):
        action = process_action(controller.step(obs))
        obs, _, _, info = env.step(action.tolist())
        if task_oracle.get_task_info_for_set(start_info, info, {subtask}):
            return True
    return False


def evaluate_policy(policy: Callable, env, task_oracle, val_annotations,
                    eval_sequences, cfg: CalvinEvalConfig) -> List[int]:
    """Run the chains; returns each chain's depth reached (0..5)."""
    results = []
    for seq_i, (initial_state, sequence) in enumerate(eval_sequences):
        env.reset(robot_obs=initial_state["robot_obs"],
                  scene_obs=initial_state["scene_obs"])
        depth = 0
        for subtask in sequence:
            instruction = val_annotations[subtask][0]
            if rollout_subtask(env, policy, task_oracle, subtask,
                               instruction, cfg):
                depth += 1
            else:
                break
        results.append(depth)
        log.info("chain %d: depth %d | running avg len %.3f",
                 seq_i, depth, avg_seq_len(results))
    return results


def gather_depths(results: Sequence[int], num_chains: int) -> List[int]:
    """Every rank's chain depths, in rank order, on every rank (the
    reference's gather_for_metrics, evaluate_calvin.py:877-914): shards
    differ in length by at most one, so each is padded with -1 to
    ceil(chains / world), gathered as int32 and the pads dropped. The
    tensor lies on the card under NCCL, on the CPU under gloo."""
    import torch.distributed as dist

    n = dist.get_world_size()
    width = (num_chains + n - 1) // n
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    padded = torch.full((width,), -1, dtype=torch.int32, device=device)
    padded[: len(results)] = torch.as_tensor(list(results),
                                             dtype=torch.int32)
    out = [torch.empty_like(padded) for _ in range(n)]
    dist.all_gather(out, padded)
    return [int(d) for d in torch.cat(out).cpu().tolist() if d >= 0]


def eval_calvin(predictor, calvin_env_and_assets, cfg: CalvinEvalConfig
                ) -> Dict[str, float]:
    """The whole CALVIN eval. ``calvin_env_and_assets`` = (env,
    task_oracle, val_annotations, eval_sequences), built by the host-side
    CALVIN stack (``eval/calvin_eval.py:build_calvin_assets``)."""
    env, task_oracle, val_annotations, eval_sequences = calvin_env_and_assets
    if cfg.enrich_lang:
        # the enriched table replaces the standard one wholesale
        val_annotations = load_enriched_annotations(cfg.enrich_lang_path)
    pid, n = process_index(), process_count()
    shard = list(eval_sequences)[pid::n]
    policy = CalvinPolicy(predictor, cfg)
    results = evaluate_policy(policy, env, task_oracle, val_annotations,
                              shard, cfg)
    if n > 1:
        results = gather_depths(results, len(eval_sequences))
    sr = count_success(results)
    return {
        "avg_seq_len": avg_seq_len(results),
        **{f"chain_sr_{i + 1}": s for i, s in enumerate(sr)},
        "num_chains": len(results),
    }
