"""The finetune orchestrator (counterpart of vla_adapter_tpu/train/loop.py,
the reference's vla-scripts/finetune.py).

Config -> model -> optimizer -> data -> train step -> metrics and
checkpoints, on one device (the JAX package's mesh has no counterpart
yet: multi-GPU training is ``ROADMAP.md`` A.7). Data comes from any
iterator of model-format batches; by default ``data/dummy.py``'s, the swap
the reference documents for smoke runs.

The model starts in float (a seeded random init from a
``torch.Generator``, or the caller's ``params``), the frozen tensors are
cast to bf16 (``frozen_bf16``) and, under ``base_int8``, the frozen base
is quantized on the device (``models/quantize.py``) into the training
model, whose w8a8 matmuls run the straight-through product
(``models/layers.py:W8A8STE``). The head and proprio projector stay
float. Training builds its own ``VLAModel``: the Predictor's forward runs
under ``torch.inference_mode`` and never serves it.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Dict, Iterator, Mapping, Optional

import numpy as np
import torch

from vla_adapter_torch.core.config import TrainConfig
from vla_adapter_torch.data.dummy import DummyDataset
from vla_adapter_torch.infer.predict import resolve_device
from vla_adapter_torch.models.layers import Runtime, init_random_, prepare_ste_
from vla_adapter_torch.models.quantize import quantize_state_dict
from vla_adapter_torch.models.vla import VLAModel
from vla_adapter_torch.train.checkpoints import (
    find_resume_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from vla_adapter_torch.train.metrics import Metrics
from vla_adapter_torch.train.optim import make_optimizer
from vla_adapter_torch.train.partition import split_trainable
from vla_adapter_torch.train.step import (
    TrainState,
    init_train_state,
    make_eval_step,
    make_train_step,
    to_device,
)


def get_run_id(cfg: TrainConfig) -> str:
    """Hyperparameter-encoding run id (the reference's get_run_id)."""
    if cfg.run_id is not None:
        return cfg.run_id
    lora = f"lora-r{cfg.lora.rank}" if cfg.lora.enabled else "full"
    return (f"{cfg.model.platform}+b{cfg.batch_size}+{lora}"
            f"+lr-{cfg.optim.learning_rate}"
            f"+{'pro' if cfg.model.head.use_pro_version else 'orig'}")


def build_runtime(cfg: TrainConfig, kernels: str = "kernel") -> Runtime:
    return Runtime(
        dtype=torch.bfloat16,
        param_dtype=torch.float32,
        kernels=kernels,
        lora_rank=cfg.lora.rank if cfg.lora.enabled else 0,
        lora_scale=cfg.lora.scale,
        remat=cfg.remat_llm,
        remat_policy=cfg.remat_policy,
        remat_policy_overrides=tuple(cfg.remat_policy_overrides),
        remat_components=tuple(cfg.remat_components),
        weights_int8=cfg.base_int8,
        act_int8=cfg.base_int8,
        train_base_int8=cfg.base_int8,
    )


def float_twin(rt: Runtime) -> Runtime:
    """The float Runtime of a train_base_int8 one: the model that is
    initialized (an init makes float weights to quantize)."""
    return dataclasses.replace(rt, weights_int8=False, act_int8=False,
                               train_base_int8=False)


def initial_state(cfg: TrainConfig, rt: Runtime, device,
                  params: Optional[Mapping[str, torch.Tensor]] = None
                  ) -> Dict[str, torch.Tensor]:
    """The training model's state on ``device``: the float init (seeded
    from ``cfg.seed``, or ``params``), frozen tensors in bf16 under
    ``frozen_bf16``, the frozen base quantized on the device under
    ``rt.train_base_int8``."""
    init = VLAModel(cfg.model, float_twin(rt), device=device)
    if params is None:
        init_random_(init, torch.Generator(device=device).manual_seed(
            cfg.seed))
    else:
        init.load_state_dict(params, strict=True)
    trainable, frozen = split_trainable(dict(init.state_dict()),
                                        cfg.lora.enabled)
    if cfg.frozen_bf16:
        frozen = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
                  for k, v in frozen.items()}
    state = {**trainable, **frozen}
    if rt.train_base_int8:
        expected = VLAModel(cfg.model, rt, device="meta").state_dict()
        state = quantize_state_dict(state, expected, device)
    return state


def finetune(
    cfg: TrainConfig,
    data_iter: Optional[Iterator[Dict[str, np.ndarray]]] = None,
    dataset_statistics: Optional[Dict] = None,
    max_steps: Optional[int] = None,
    rt: Optional[Runtime] = None,
    resume: bool = False,
    val_iter: Optional[Iterator[Dict[str, np.ndarray]]] = None,
    val_batches: int = 8,
    device: str = "cuda",
    params: Optional[Mapping[str, torch.Tensor]] = None,
) -> TrainState:
    """Train ``cfg`` for ``max_steps`` (default ``cfg.optim.max_steps``)
    steps on ``device`` (the card; "cpu" only when asked) and write the
    checkpoint at the end. ``params``: a float initial state dict (with
    adapters) instead of the seeded init. Returns the final state, whose
    ``history`` holds each step's metrics."""
    device = resolve_device(device)
    if cfg.fsdp_axis != 1 or cfg.tensor_axis != 1:
        raise NotImplementedError("the port trains on one device; sharded "
                                  "training is ROADMAP.md A.7")
    rt = rt or build_runtime(cfg)
    max_steps = max_steps if max_steps is not None else cfg.optim.max_steps
    accum = cfg.grad_accumulation_steps
    if data_iter is None:
        seed = int(np.random.SeedSequence([cfg.seed, 0]).generate_state(1)[0])
        data_iter = iter(DummyDataset(cfg.model, cfg.batch_size, seed=seed,
                                      accum_steps=accum if accum > 1
                                      else None))
    first = next(data_iter)

    model = VLAModel(cfg.model, rt, device="meta")
    model.load_state_dict(initial_state(cfg, rt, device, params),
                          strict=True, assign=True)
    tx = make_optimizer(cfg.optim)
    state = init_train_state(model, tx, cfg.lora.enabled)

    run_dir = Path(cfg.run_root_dir) / get_run_id(cfg)
    if resume:
        ckpt = find_resume_checkpoint(run_dir)
        if ckpt is not None:
            load_checkpoint(ckpt, state)
    if rt.train_base_int8:
        prepare_ste_(model)

    step_fn = make_train_step(model, tx, cfg)
    metrics = Metrics(run_dir, window=max(accum, 8), run_id=get_run_id(cfg))

    run_validation = None
    if val_iter is not None:
        eval_fn = make_eval_step(model, cfg.objective)

        def run_validation(step_idx: int):
            """Averaged eval metrics over ``val_batches`` batches."""
            accs = []
            for _ in range(val_batches):
                vb = to_device(next(val_iter), device)
                accs.append({k: float(v) for k, v in
                             eval_fn(state, vb).items()})
            avg = {f"val_{k}": float(np.mean([a[k] for a in accs]))
                   for k in accs[0]}
            metrics.commit(**avg)
            metrics.push(step_idx)
            print(f"step {step_idx} validation: " +
                  " ".join(f"{k}={v:.4f}" for k, v in avg.items()),
                  flush=True)

    model.train()
    _train(cfg, state, step_fn, metrics, data_iter, first, state.step,
           max_steps, device, run_dir, dataset_statistics, run_validation)
    save_checkpoint(run_dir, state, dataset_statistics,
                    latest_only=cfg.save_latest_checkpoint_only)
    metrics.close()
    return state


def _train(cfg, state, step_fn, metrics, data_iter, batch, start_step,
           max_steps, device, run_dir, dataset_statistics, run_validation):
    # A step's metrics are read one step late: reading them waits for the
    # device, so the next step is queued first.
    pending = None  # (step_idx, device metrics, dataset names)
    last = [time.perf_counter()]

    def commit(idx, m, names):
        host = dict(m)
        per_sample = host.pop("per_sample", None)
        values = {k: float(v) for k, v in host.items()}  # waits for step idx
        now = time.perf_counter()
        values["step_time"], last[0] = now - last[0], now
        metrics.commit(**values)
        state.history.append({"step": idx, **values})
        if per_sample and names is not None:
            flat = np.asarray(names).reshape(-1).tolist()
            rows = {k: v.float().cpu().numpy().reshape(-1)
                    for k, v in per_sample.items()}
            if all(len(v) == len(flat) for v in rows.values()):
                metrics.commit_per_dataset(flat, rows)
        if idx % cfg.log_freq == 0:
            sm = metrics.push(idx)
            print(f"step {idx}: " +
                  " ".join(f"{k}={v:.4f}" for k, v in sm.items()), flush=True)

    try:
        for step_idx in range(start_step, max_steps):
            names = batch.get("dataset_name")
            m = step_fn(state, to_device(batch, device), step_idx)
            if pending is not None:
                commit(*pending)
            pending = (step_idx, m, names)
            if step_idx > 0 and step_idx % cfg.save_freq == 0:
                save_checkpoint(run_dir, state, dataset_statistics,
                                latest_only=cfg.save_latest_checkpoint_only)
            if run_validation is not None and step_idx > 0 and (
                    step_idx % cfg.val_freq == 0):
                run_validation(step_idx)
            if step_idx + 1 < max_steps:
                batch = next(data_iter)  # host work beside the device step
    except KeyboardInterrupt:
        # the state here is the last completed step's
        print("interrupted: saving a checkpoint before exit", flush=True)
        save_checkpoint(run_dir, state, dataset_statistics,
                        latest_only=cfg.save_latest_checkpoint_only)
        raise
    if pending is not None:
        commit(*pending)
