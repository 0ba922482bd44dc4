"""The port's profiling hooks against the JAX package's, on the CPU.

``StepTimer`` discards the same warm-up steps and gives the same summary
(keys, mean, median, p90, min, count) as the JAX one on one sequence of
``perf_counter`` readings; ``trace`` writes a Chrome trace under its logdir
(CPU activity here) holding the regions ``annotate`` names, and nothing
when disabled; ``pretrain`` times its steps with a ``StepTimer``.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from vla_adapter_tpu.utils import profiling as jprof
from vla_adapter_torch.utils import profiling as tprof


def _timed(mod, readings, steps, warmup, monkeypatch):
    clock = iter(readings)
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    timer = mod.StepTimer(warmup=warmup)
    for _ in range(steps):
        with timer:
            pass
    return timer.summary()


@pytest.mark.parametrize("warmup, steps", [(2, 7), (0, 4), (3, 3)])
def test_step_timer_summary_matches_jax(warmup, steps, monkeypatch):
    rng = np.random.default_rng(warmup * 10 + steps)
    starts = rng.uniform(0, 100, size=steps).cumsum()
    readings = []
    for t0, dt in zip(starts, rng.uniform(0.01, 2.0, size=steps)):
        readings += [float(t0), float(t0 + dt)]
    got = _timed(tprof, readings, steps, warmup, monkeypatch)
    want = _timed(jprof, readings, steps, warmup, monkeypatch)
    assert got == want
    if steps > warmup:
        assert set(got) == {"mean_s", "median_s", "p90_s", "min_s", "steps"}
        assert got["steps"] == steps - warmup
    else:
        assert got == {}


def test_trace_writes_a_trace_with_the_annotated_regions(tmp_path):
    x = torch.randn(64, 64)
    with tprof.trace(str(tmp_path / "on")) as prof:
        with tprof.annotate("vla_step"):
            torch.mm(x, x)
    assert prof is not None
    path = tmp_path / "on" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "vla_step" for e in events)
    with tprof.trace(str(tmp_path / "off"), enabled=False) as prof:
        torch.mm(x, x)
    assert prof is None and not os.path.exists(tmp_path / "off")


def test_pretrain_times_its_steps_and_returns_every_loss():
    """``pretrain(..., timer=StepTimer())`` keeps a time for each step
    after the warm-up and returns every step's loss, the last one also as
    "loss" (the tiny PrismaticVLM, "align", on the CPU)."""
    import dataclasses
    import itertools

    import vla_adapter_torch.core.config as tc
    import vla_adapter_torch.core.constants as tk
    from tests.test_torch_vlm import vlm_inputs
    from tests.torch_tiny import tiny_cfg
    from vla_adapter_torch.models.layers import FP32_RUNTIME
    from vla_adapter_torch.train import pretrain as tpretrain

    cfg = dataclasses.replace(tiny_cfg(tc, tk), use_proprio=False)
    pcfg = tpretrain.PretrainConfig(model=cfg, stage="align", device="cpu")
    timer = tprof.StepTimer(warmup=1)
    _, metrics = tpretrain.pretrain(pcfg, itertools.repeat(vlm_inputs(cfg)),
                                    3, rt=FP32_RUNTIME, timer=timer)
    assert timer.summary()["steps"] == 2
    assert len(metrics["losses"]) == 3
    assert metrics["loss"] == metrics["losses"][-1]
    assert metrics["losses"][-1] < metrics["losses"][0]
