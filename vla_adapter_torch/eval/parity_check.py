"""Parity gate for a checkpoint (counterpart of
vla_adapter_tpu/eval/parity_check.py, in the same golden-file format).

Loads a checkpoint, runs one forward on a canned observation and compares
the (chunk, action_dim) action with a recorded golden one:

    # record
    python -m vla_adapter_torch.eval.parity_check --mode record \\
        --ckpt_dir <dir> --obs <obs.pkl> --out golden_action.json

    # check (prints {"parity": "PASS"|"FAIL", "max_abs_diff", "atol"})
    python -m vla_adapter_torch.eval.parity_check --mode check \\
        --ckpt_dir <dir> --obs <obs.pkl> --golden golden_action.json

The observation file is the reference's canned pickle
(experiments/robot/libero/sample_libero_spatial_observation.pkl: a dict
with full_image, wrist_image and state) or any .npz with the same keys. A
golden file the JAX tool recorded is checked as it is. ``--device cpu``
runs on the CPU, ``--dtype float32`` in fp32; ``--mock_tokenizer true`` tokenizes with
``data.tokenization.MockTokenizer`` for a checkpoint without tokenizer
files (seeded smoke weights).
"""

from __future__ import annotations

import dataclasses
import json
import pickle
from pathlib import Path
from typing import Dict

import numpy as np

from vla_adapter_torch.core.cli import parse_config
from vla_adapter_torch.utils.overwatch import initialize_overwatch

log = initialize_overwatch(__name__)


@dataclasses.dataclass(frozen=True)
class ParityConfig:
    mode: str = "check"  # check | record
    ckpt_dir: str = ""
    obs: str = ""
    golden: str = "golden_action.json"
    out: str = "golden_action.json"
    instruction: str = ""
    unnorm_key: str = ""
    atol: float = 1e-2   # bf16 forward; tighten for fp32 runs
    device: str = "cuda"
    dtype: str = "bfloat16"  # the forward's: bfloat16 (serving) or float32
    mock_tokenizer: bool = False


def load_observation(path: str) -> Dict[str, np.ndarray]:
    p = Path(path)
    if p.suffix == ".pkl":
        with p.open("rb") as f:
            return pickle.load(f)
    return dict(np.load(p, allow_pickle=True))


def load_predictor(ckpt_dir: str, device: str, mock_tokenizer: bool,
                   dtype: str = "bfloat16", **kw):
    """``load_vla`` of ``ckpt_dir`` on ``device`` in ``dtype``, with the
    MockTokenizer when asked."""
    from vla_adapter_torch.models.layers import FP32_RUNTIME
    from vla_adapter_torch.weights.load import load_vla

    if dtype not in ("bfloat16", "float32"):
        raise ValueError(f"dtype {dtype!r}: bfloat16 or float32")
    if dtype == "float32":
        kw["rt"] = FP32_RUNTIME

    tokenize = None
    if mock_tokenizer:
        from vla_adapter_torch.data.tokenization import MockTokenizer

        tok = MockTokenizer()
        tokenize = lambda text: tok(text).input_ids  # noqa: E731
    return load_vla(ckpt_dir, tokenize=tokenize, device=device, **kw)


def run_forward(cfg: ParityConfig) -> np.ndarray:
    predictor = load_predictor(cfg.ckpt_dir, cfg.device, cfg.mock_tokenizer,
                               cfg.dtype)
    obs = load_observation(cfg.obs)
    images = [np.asarray(obs["full_image"], np.uint8)]
    if "wrist_image" in obs:
        images.append(np.asarray(obs["wrist_image"], np.uint8))
    instruction = cfg.instruction or str(obs.get("instruction",
                                                 "do the task"))
    return predictor.predict_action(images, instruction,
                                    proprio=obs.get("state"),
                                    unnorm_key=cfg.unnorm_key or None)


def main(argv=None) -> None:
    cfg = parse_config(ParityConfig, argv)
    if not (cfg.ckpt_dir and cfg.obs):
        raise SystemExit("--ckpt_dir and --obs are required")
    action = run_forward(cfg)
    if cfg.mode == "record":
        Path(cfg.out).write_text(json.dumps({
            "action": action.tolist(),
            "instruction": cfg.instruction,
            "unnorm_key": cfg.unnorm_key,
        }, indent=2))
        log.info("recorded golden action to %s", cfg.out)
        return
    golden = np.asarray(json.loads(Path(cfg.golden).read_text())["action"])
    diff = np.abs(action - golden)
    ok = bool((diff <= cfg.atol).all())
    print(json.dumps({"parity": "PASS" if ok else "FAIL",
                      "max_abs_diff": float(diff.max()), "atol": cfg.atol}))
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
