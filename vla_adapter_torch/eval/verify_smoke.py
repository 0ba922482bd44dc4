"""Checkpoint smoke verifier (counterpart of
vla_adapter_tpu/eval/verify_smoke.py; the reference's
vla-scripts/extern/verify_openvla.py).

Loads a checkpoint, runs predict_action on seeded 256-px images (resized
to the policy size on the host) and logs the action chunk and the
latency, the quick "did the export work" check:

    python -m vla_adapter_torch.eval.verify_smoke --ckpt_dir <dir> \\
        --instruction "pick up the remote"

On the card each timed call is bracketed by ``torch.cuda.synchronize``.
``--device cpu``, ``--act_int8 true`` / ``--w8a8_impl`` / ``--int8 true``
and ``--mock_tokenizer true`` as in ``eval/parity_check.py``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from vla_adapter_torch.core.cli import parse_config
from vla_adapter_torch.utils.overwatch import initialize_overwatch

log = initialize_overwatch(__name__)


@dataclasses.dataclass(frozen=True)
class VerifyConfig:
    ckpt_dir: str = ""
    instruction: str = "pick up the object"
    unnorm_key: str = ""
    iters: int = 5
    seed: int = 0
    device: str = "cuda"
    int8: bool = False
    act_int8: bool = False
    w8a8_impl: str = "auto"
    mock_tokenizer: bool = False


def main(argv=None) -> list:
    """Returns the timed calls' seconds."""
    import torch

    from vla_adapter_torch.eval.parity_check import load_predictor

    cfg = parse_config(VerifyConfig, argv)
    if not cfg.ckpt_dir:
        raise SystemExit("--ckpt_dir is required")
    predictor = load_predictor(cfg.ckpt_dir, cfg.device, cfg.mock_tokenizer,
                               int8=cfg.int8, act_int8=cfg.act_int8,
                               w8a8_impl=cfg.w8a8_impl)
    on_card = predictor.device.type == "cuda"
    rng = np.random.default_rng(cfg.seed)
    images = [rng.integers(0, 255, size=(256, 256, 3), dtype=np.uint8)
              for _ in range(predictor.cfg.vision.num_images)]
    proprio_dim = predictor.cfg.constants.proprio_dim
    kw = dict(unnorm_key=cfg.unnorm_key or None)

    action = predictor.predict_action(images, cfg.instruction,
                                      proprio=rng.normal(size=proprio_dim),
                                      **kw)
    log.info("action chunk:\n%s", np.array_str(action, precision=4))
    times = []
    for _ in range(cfg.iters):
        p = rng.normal(size=proprio_dim)
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        predictor.predict_action(images, cfg.instruction, proprio=p, **kw)
        if on_card:
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    log.info("latency over %d calls: median %.1f ms (min %.1f)",
             cfg.iters, 1e3 * float(np.median(times)), 1e3 * min(times))
    return times


if __name__ == "__main__":
    main()
