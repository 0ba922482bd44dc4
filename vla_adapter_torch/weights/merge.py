"""LoRA merge CLI (counterpart of vla_adapter_tpu/weights/merge.py, the
reference's vla-scripts/merge_lora_weights_and_save.py).

    python -m vla_adapter_torch.weights.merge \\
        --ckpt_dir runs/<run>/latest --out_dir runs/<run>/merged \\
        --lora_scale 2.0

Loads a training checkpoint (``train/checkpoints.py``), folds the LoRA
adapters into the float weights on the card (``--device cpu`` to run on
the CPU) and writes one deployment state dict with ``save_params``. As in
the JAX package, adapters over an int8 base (``weight_q``) stay unmerged.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

from vla_adapter_torch.core.cli import parse_config
from vla_adapter_torch.utils.overwatch import initialize_overwatch

log = initialize_overwatch(__name__)


@dataclasses.dataclass(frozen=True)
class MergeConfig:
    ckpt_dir: str = ""
    out_dir: str = ""
    lora_scale: float = 2.0
    device: str = "cuda"


def merge_checkpoint(ckpt_dir, out_dir, lora_scale: float,
                     device: str = "cuda") -> Path:
    """Checkpoint directory -> ``out_dir`` holding the merged state dict
    (and the run's dataset statistics)."""
    from vla_adapter_torch.infer.predict import resolve_device
    from vla_adapter_torch.models.lora import merge_lora
    from vla_adapter_torch.train.checkpoints import save_params
    from vla_adapter_torch.train.partition import merge_trees
    from vla_adapter_torch.weights.safetensors_io import load_file

    dev = resolve_device(device)
    ckpt_dir = Path(ckpt_dir)
    params = {k: v.to(dev) for k, v in
              load_file(ckpt_dir / "trainable.safetensors").items()}
    if (ckpt_dir / "frozen.safetensors").exists():
        params = merge_trees(params, {k: v.to(dev) for k, v in load_file(
            ckpt_dir / "frozen.safetensors").items()})
    out = save_params(out_dir, merge_lora(params, scale=lora_scale))
    stats = ckpt_dir / "dataset_statistics.json"
    if stats.exists():
        (out / "dataset_statistics.json").write_text(stats.read_text())
    return out


def main(argv=None) -> Path:
    cfg = parse_config(MergeConfig, argv)
    if not (cfg.ckpt_dir and cfg.out_dir):
        raise SystemExit("--ckpt_dir and --out_dir are required")
    out = merge_checkpoint(cfg.ckpt_dir, cfg.out_dir, cfg.lora_scale,
                           cfg.device)
    log.info("merged params written to %s", out)
    return out


if __name__ == "__main__":
    main()
