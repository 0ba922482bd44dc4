"""LIBERO eval CLI (counterpart of vla_adapter_tpu/eval/libero_eval.py;
the reference's experiments/robot/libero/run_libero_eval.py).

    python -m vla_adapter_torch.eval.libero_eval \\
        --ckpt_dir <dir> --eval.task_suite_name libero_object

Loads the checkpoint with ``weights/load.py:load_vla`` on the card (or
``--device cpu``; ``--act_int8 true`` with ``--w8a8_impl`` or ``--int8
true`` for a quantized tier) and runs :func:`eval.libero.eval_libero`,
which needs the LIBERO simulator. Prints the results as one JSON line.
"""

from __future__ import annotations

import dataclasses
import json

from vla_adapter_torch.core.cli import parse_config
from vla_adapter_torch.eval.libero import LiberoEvalConfig, eval_libero
from vla_adapter_torch.utils.overwatch import initialize_overwatch

log = initialize_overwatch(__name__)


@dataclasses.dataclass(frozen=True)
class LiberoCLIConfig:
    ckpt_dir: str = ""
    unnorm_key: str = ""  # default: "<task_suite_name>_no_noops"
    eval: LiberoEvalConfig = LiberoEvalConfig()
    # what the port's load_vla takes beyond the JAX one's arguments
    device: str = "cuda"
    int8: bool = False
    act_int8: bool = False
    w8a8_impl: str = "auto"


def main(argv=None) -> None:
    from vla_adapter_torch.weights.load import load_vla

    cfg = parse_config(LiberoCLIConfig, argv)
    if not cfg.ckpt_dir:
        raise SystemExit("--ckpt_dir is required")
    predictor = load_vla(cfg.ckpt_dir, device=cfg.device, int8=cfg.int8,
                         act_int8=cfg.act_int8, w8a8_impl=cfg.w8a8_impl)
    unnorm_key = cfg.unnorm_key or f"{cfg.eval.task_suite_name}_no_noops"

    def policy(obs, task_description):
        return predictor.predict_action(
            [obs["full_image"], obs["wrist_image"]], task_description,
            proprio=obs["state"], unnorm_key=unnorm_key)

    results = eval_libero(policy, cfg.eval)
    log.info("results: %s", json.dumps(results, indent=2))
    print(json.dumps(results))


if __name__ == "__main__":
    main()
