"""Finetune CLI (counterpart of vla_adapter_tpu/train/finetune.py, the
reference's vla-scripts/finetune.py entry point).

    python -m vla_adapter_torch.train.finetune \\
        --experiment vla-adapter+libero-spatial --data.use_dummy true \\
        --train.batch_size 16 --train.optim.max_steps 10

trains a named recipe (``core/experiments.py``; explicit ``--train.*``
flags override it) on the card, or on the CPU with ``--device cpu``, and
writes its checkpoint under ``<train.run_root_dir>/<run id>``. Only the
``--data.use_dummy true`` batches are ported: the RLDS pipeline needs
TFDS datasets and TensorFlow (``ROADMAP.md`` A.5).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from vla_adapter_torch.core.cli import parse_config
from vla_adapter_torch.core.config import TrainConfig
from vla_adapter_torch.utils.overwatch import initialize_overwatch

log = initialize_overwatch(__name__)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    # The RLDS pipeline's fields (mixture, root_dir, image_aug, ...) come
    # with that pipeline (ROADMAP.md A.5).
    use_dummy: bool = False


@dataclasses.dataclass(frozen=True)
class FinetuneCLIConfig:
    train: TrainConfig = TrainConfig()
    data: DataConfig = DataConfig()
    resume: bool = False
    # A named recipe of core/experiments.py; --train.* / --data.* flags
    # still override it.
    experiment: Optional[str] = None
    device: str = "cuda"


def config_from_experiment(vla_id: str) -> FinetuneCLIConfig:
    """A CLI config seeded from a registered recipe."""
    from vla_adapter_torch.core.experiments import get_experiment

    exp = get_experiment(vla_id)
    return FinetuneCLIConfig(
        train=exp.to_train_config(),
        experiment=vla_id,
    )


def main(argv=None):
    from vla_adapter_torch.train.loop import finetune, get_run_id

    cfg = parse_config(FinetuneCLIConfig, argv)
    if cfg.experiment is not None:
        # parse again on top of the recipe, so that explicit flags win
        cfg = parse_config(FinetuneCLIConfig, argv,
                           base=config_from_experiment(cfg.experiment))
        from vla_adapter_torch.core.experiments import get_experiment

        expected = get_experiment(cfg.experiment).expected_devices
        if expected and expected != 1:
            log.warning("experiment %s was tuned for %d devices; training "
                        "on one (the batch size is the caller's)",
                        cfg.experiment, expected)
    if not cfg.data.use_dummy:
        raise NotImplementedError(
            "RLDS data is not ported yet (ROADMAP.md A.5: it needs TFDS "
            "datasets and TensorFlow); pass --data.use_dummy true")
    log.info("run id: %s", get_run_id(cfg.train))
    state = finetune(cfg.train, resume=cfg.resume, device=cfg.device)
    log.info("step %d: loss %.4f", state.step,
             state.history[-1]["loss"] if state.history else float("nan"))
    return state


if __name__ == "__main__":
    main()
