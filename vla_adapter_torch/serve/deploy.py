"""Deploy CLI (counterpart of vla_adapter_tpu/serve/deploy.py; the
reference's vla-scripts/deploy.py).

    python -m vla_adapter_torch.serve.deploy --ckpt_dir runs/... --port 8777

Serves a checkpoint directory (``weights/load.py:load_vla``) behind POST
/act, on the card unless ``--device cpu``; ``--act_int8 true`` (with
``--w8a8_impl``) or ``--int8 true`` pick a quantized tier. The checkpoint's
tokenizer files are read through ``transformers``.
"""

from __future__ import annotations

import dataclasses

from vla_adapter_torch.core.cli import parse_config
from vla_adapter_torch.utils.overwatch import initialize_overwatch

log = initialize_overwatch(__name__)


@dataclasses.dataclass(frozen=True)
class DeployConfig:
    ckpt_dir: str = ""
    host: str = "0.0.0.0"
    port: int = 8777
    center_crop: bool = True
    # Coalesce concurrent /act requests into batched forwards
    # (serve/batching.py); max_wait_ms bounds the added latency.
    dynamic_batch: bool = True
    max_batch: int = 16
    max_wait_ms: float = 4.0
    # Image-pipeline process pool size: concurrent requests preprocess on
    # N cores instead of sharing one interpreter lock. 0 = inline on the
    # request threads.
    preprocess_workers: int = 4
    # What the port's load_vla takes beyond the JAX one's arguments: the
    # device, and the quantized tiers (the JAX load_vla takes them in rt).
    device: str = "cuda"
    int8: bool = False
    act_int8: bool = False
    w8a8_impl: str = "auto"


def main(argv=None) -> None:
    from vla_adapter_torch.serve.server import ActionServer
    from vla_adapter_torch.weights.load import load_vla

    cfg = parse_config(DeployConfig, argv)
    if not cfg.ckpt_dir:
        raise SystemExit("--ckpt_dir is required")
    predictor = load_vla(cfg.ckpt_dir, device=cfg.device,
                         int8=cfg.int8, act_int8=cfg.act_int8,
                         w8a8_impl=cfg.w8a8_impl,
                         center_crop=cfg.center_crop)
    log.info("model loaded from %s; serving /act on %s:%d",
             cfg.ckpt_dir, cfg.host, cfg.port)
    ActionServer(
        predictor, host=cfg.host, port=cfg.port,
        dynamic_batch=cfg.dynamic_batch, max_batch=cfg.max_batch,
        max_wait_ms=cfg.max_wait_ms,
        preprocess_workers=cfg.preprocess_workers,
    ).serve_forever()


if __name__ == "__main__":
    main()
