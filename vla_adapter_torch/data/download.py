"""OXE/RLDS dataset download CLI (copy of vla_adapter_tpu/data/download.py,
the reference's scripts/download.py).

Thin wrapper over TFDS/gsutil: resolves a named mixture to its member
datasets and materializes each into ``data_root_dir``. Network-gated —
environments without egress should rsync pre-built TFDS dirs instead.

    python -m vla_adapter_torch.data.download \
        --mixture libero_4_task_suites_no_noops --data_root_dir /data/rlds
"""

from __future__ import annotations

import dataclasses

from vla_adapter_torch.core.cli import parse_config
from vla_adapter_torch.data.rlds.oxe.mixtures import OXE_NAMED_MIXTURES
from vla_adapter_torch.utils.overwatch import initialize_overwatch

log = initialize_overwatch(__name__)

# Canonical public OXE bucket (the reference pulls the same artifacts).
OXE_GCS_ROOT = "gs://gresearch/robotics"


@dataclasses.dataclass(frozen=True)
class DownloadConfig:
    mixture: str = "bridge"
    data_root_dir: str = "datasets/rlds"
    dry_run: bool = False


def main(argv=None) -> None:
    import subprocess

    cfg = parse_config(DownloadConfig, argv)
    members = sorted({name for name, _ in OXE_NAMED_MIXTURES[cfg.mixture]})
    log.info("mixture %s -> %d datasets", cfg.mixture, len(members))
    for name in members:
        src = f"{OXE_GCS_ROOT}/{name}"
        dst = f"{cfg.data_root_dir}/{name}"
        cmd = ["gsutil", "-m", "cp", "-r", src, dst]
        log.info("%s", " ".join(cmd))
        if not cfg.dry_run:
            subprocess.run(cmd, check=True)


if __name__ == "__main__":
    main()
