"""Training metrics: smoothing and trackers (copy of
vla_adapter_tpu/train/metrics.py, the reference's deque smoothing with W&B
and JSONL trackers).

The JSONL tracker is always available; the W&B tracker imports ``wandb``
when it is built and raises if the package is missing (neither machine
this repo runs on has it).
"""

from __future__ import annotations

import collections
import json
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np


class JSONLinesTracker:
    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = self.path.open("a")

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        self._fh.write(json.dumps({"step": step, **metrics}) + "\n")
        self._fh.flush()

    def close(self):
        self._fh.close()


class WandbTracker:
    def __init__(self, project: str, entity: Optional[str], run_id: str,
                 config: Optional[dict] = None):
        import wandb  # raises ImportError where the package is missing

        self._wandb = wandb
        self._run = wandb.init(project=project, entity=entity, name=run_id,
                               config=config, mode="offline")

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        self._wandb.log({f"VLA Train/{k}": v for k, v in metrics.items()},
                        step=step)

    def close(self):
        self._run.finish()


class Metrics:
    """Smoothed-window metrics with per-step timing and per-dataset
    grouping. ``trackers``: "jsonl" (``<run_dir>/metrics.jsonl``) and/or
    "wandb"."""

    def __init__(self, run_dir, window: int = 32, trackers=("jsonl",),
                 wandb_project: str = "vla-adapter-torch",
                 wandb_entity: Optional[str] = None, run_id: str = "run",
                 config: Optional[dict] = None):
        self._deques: Dict[str, collections.deque] = {}
        self.window = window
        self._trackers = []
        if "jsonl" in trackers:
            self._trackers.append(
                JSONLinesTracker(Path(run_dir) / "metrics.jsonl"))
        if "wandb" in trackers:
            self._trackers.append(
                WandbTracker(wandb_project, wandb_entity, run_id, config))
        self._last_t = time.time()

    def commit(self, **metrics) -> None:
        now = time.time()
        metrics.setdefault("step_time", now - self._last_t)
        self._last_t = now
        for k, v in metrics.items():
            self._deques.setdefault(
                k, collections.deque(maxlen=self.window)).append(float(v))

    def commit_per_dataset(self, dataset_names, per_sample) -> None:
        """Average each dataset's rows of the per-sample metrics (dict of
        name -> (B,) array, aligned with ``dataset_names``) into its own
        smoothed key ``"{dataset}/{metric}"`` (the reference's per-dataset
        trackers)."""
        names = [n.decode() if isinstance(n, bytes) else str(n)
                 for n in dataset_names]
        values = {k: np.asarray(v, np.float64) for k, v in per_sample.items()}
        for k, v in values.items():
            if len(v) != len(names):
                raise ValueError(f"per_sample[{k!r}] has {len(v)} rows for "
                                 f"{len(names)} dataset names")
        for ds in sorted(set(names)):
            rows = np.asarray([i for i, n in enumerate(names) if n == ds])
            for k, v in values.items():
                self._deques.setdefault(
                    f"{ds}/{k}", collections.deque(maxlen=self.window)
                ).append(float(v[rows].mean()))

    def smoothed(self) -> Dict[str, float]:
        return {k: float(np.mean(d)) for k, d in self._deques.items() if d}

    def push(self, step: int) -> Dict[str, float]:
        sm = self.smoothed()
        for t in self._trackers:
            t.log(step, sm)
        return sm

    def close(self):
        for t in self._trackers:
            t.close()
