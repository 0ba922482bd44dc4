"""Finetune CLI (counterpart of vla_adapter_tpu/train/finetune.py, the
reference's vla-scripts/finetune.py entry point).

    python -m vla_adapter_torch.train.finetune \\
        --experiment vla-adapter+libero-spatial --data.root_dir /data/rlds \\
        --train.batch_size 16 --train.optim.max_steps 10

trains a named recipe (``core/experiments.py``; it seeds ``--train.*``
and the data mixture, augmentation and shuffle buffer, and explicit flags
override it) on the card, or on the CPU with ``--device cpu``, and writes
its checkpoint, ``dataset_statistics.json`` included, under
``<train.run_root_dir>/<run id>``. The batches come from the RLDS
pipeline (``data/rlds_dataset.py``) over the TFDS datasets under
``--data.root_dir``, built in ``--data.num_workers`` spawn processes; only
its reader needs ``tensorflow_datasets``. ``--data.use_dummy true`` trains
on random batches instead. Under ``torchrun --nproc_per_node N`` each
process trains on its own card over NCCL: by default the N ranks are the
"data" axis; ``--train.fsdp_axis F`` shards the model with FSDP2 over F of
them and ``--train.tensor_axis T`` splits its projections over T
(Megatron column and row splits, the JAX package's "tensor" placement);
the ranks of a tensor group read the same rows.

    torchrun --nproc_per_node 4 -m vla_adapter_torch.train.finetune \
        --experiment vla-adapter+libero-spatial --data.use_dummy true \
        --train.batch_size 16 --train.tensor_axis 2
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
    mixture: str = "libero_spatial_no_noops"
    root_dir: str = "datasets/rlds"
    use_dummy: bool = False
    image_aug: bool = True
    shuffle_buffer_size: int = 100_000
    tokenizer_dir: Optional[str] = None  # dir with vocab.json/merges.txt
    # DataLoader worker processes building the batches (0: in the
    # training process)
    num_workers: int = 4


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
        data=DataConfig(mixture=exp.data_mix, image_aug=exp.image_aug,
                        shuffle_buffer_size=exp.shuffle_buffer_size),
        experiment=vla_id,
    )


def build_data_iter(cfg: FinetuneCLIConfig):
    """RLDS mixture -> (batch iterator, statistics for the checkpoint):
    one pipeline per ("data", "fsdp") coordinate, seeded by
    ``per_process_seed``, batching its ``process_local_batch_size`` rows of
    the global batch (split into micro-batches under accumulation); the
    ranks of a tensor group build the same one."""
    from vla_adapter_torch.data.action_tokenizer import ActionTokenizer
    from vla_adapter_torch.data.image_processing import image_processor_for
    from vla_adapter_torch.data.rlds.oxe.materialize import (
        get_oxe_dataset_kwargs_and_weights,
    )
    from vla_adapter_torch.data.rlds_dataset import RLDSDataset, data_loader
    from vla_adapter_torch.data.tokenization import (
        TextToIds,
        load_qwen_tokenizer,
    )
    from vla_adapter_torch.data.transform import VLABatchTransform
    from vla_adapter_torch.parallel.sharding import (
        group_initialized,
        per_process_seed,
        process_local_batch_size,
    )

    model_cfg = cfg.train.model
    tensor = cfg.train.tensor_axis if group_initialized() else 1
    seed = per_process_seed(cfg.train.seed, tensor=tensor)
    tok = load_qwen_tokenizer(cfg.data.tokenizer_dir)
    transform = VLABatchTransform(
        model_cfg, tokenize=TextToIds(tok),
        action_tokenizer=ActionTokenizer(len(tok)),
        image_processor=image_processor_for(model_cfg.vision), seed=seed)
    kwargs_list, weights = get_oxe_dataset_kwargs_and_weights(
        cfg.data.root_dir, cfg.data.mixture,
        load_camera_views=("primary", "wrist"))
    accum = cfg.train.grad_accumulation_steps
    ds = RLDSDataset(model_cfg, transform, kwargs_list, weights,
                     batch_size=process_local_batch_size(
                         cfg.train.batch_size, tensor), train=True,
                     image_aug=cfg.data.image_aug,
                     shuffle_buffer_size=cfg.data.shuffle_buffer_size,
                     accum_steps=accum if accum > 1 else None, seed=seed)
    return data_loader(ds, cfg.data.num_workers), ds.dataset_statistics


def main(argv=None):
    from vla_adapter_torch.parallel.sharding import (
        initialize_distributed,
        torchrun_env,
    )
    from vla_adapter_torch.train.loop import finetune, get_run_id
    from vla_adapter_torch.utils.overwatch import process_count

    cfg = parse_config(FinetuneCLIConfig, argv)
    env = torchrun_env()
    if env is not None:  # torchrun: one process per card, NCCL
        initialize_distributed(*env, device=cfg.device)
    if cfg.experiment is not None:
        # parse again on top of the recipe, so that explicit flags win
        cfg = parse_config(FinetuneCLIConfig, argv,
                           base=config_from_experiment(cfg.experiment))
        from vla_adapter_torch.core.experiments import get_experiment

        expected = get_experiment(cfg.experiment).expected_devices
        if expected and expected != process_count():
            log.warning("experiment %s was tuned for %d devices; training "
                        "on %d (the batch size is the caller's)",
                        cfg.experiment, expected, process_count())
    log.info("run id: %s", get_run_id(cfg.train))
    data_iter, stats = (None, None) if cfg.data.use_dummy \
        else build_data_iter(cfg)
    state = finetune(cfg.train, data_iter=data_iter, dataset_statistics=stats,
                     resume=cfg.resume, device=cfg.device)
    log.info("step %d: loss %.4f", state.step,
             state.history[-1]["loss"] if state.history else float("nan"))
    return state


if __name__ == "__main__":
    main()
