"""The finetune orchestrator (counterpart of vla_adapter_tpu/train/loop.py,
the reference's vla-scripts/finetune.py).

Config -> model -> optimizer -> data -> train step -> metrics and
checkpoints, on one card, or on one card per process under a
``torch.distributed`` process group (``parallel/sharding.py``): the
mesh's "data" axis averages the gradients, its "fsdp" axis shards the
model with FSDP2, its "tensor" axis splits the projections (Megatron,
``parallel/tensor.py``), and each ("data", "fsdp") coordinate feeds its
own rows (``process_local_batch_size`` of them, seeded by
``per_process_seed``; the ranks of a tensor group the same rows).
Data comes from any iterator of model-format batches; by default
``data/dummy.py``'s, the swap the reference documents for smoke runs.

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
from vla_adapter_torch.parallel.sharding import (
    create_mesh,
    group_initialized,
    local,
    per_process_seed,
    process_local_batch_size,
    shard_model,
)
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
from vla_adapter_torch.utils.overwatch import is_main_process


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
    tensor_transport=None,
) -> TrainState:
    """Train ``cfg`` for ``max_steps`` (default ``cfg.optim.max_steps``)
    steps on ``device`` (the card; "cpu" only when asked) and write the
    checkpoint at the end. ``params``: a float initial state dict (with
    adapters) instead of the seeded init. Returns the final state, whose
    ``history`` holds each step's metrics.

    Under an initialized process group the run spans its ranks on the
    mesh (``cfg.data_axis``, ``cfg.fsdp_axis``, ``cfg.tensor_axis``):
    ``data_iter`` yields this rank's rows (a tensor group's ranks the same
    ones), the model is placed by ``shard_model`` (with
    ``tensor_transport``, its own), rank 0 writes the checkpoints, and a
    resumed run reads the whole state and places it on the mesh."""
    device = resolve_device(device)
    mesh = None
    if group_initialized():
        mesh = create_mesh(data=cfg.data_axis, fsdp=cfg.fsdp_axis,
                           tensor=cfg.tensor_axis, device=device)
    elif cfg.fsdp_axis != 1 or cfg.tensor_axis != 1:
        # (one process has one card: its "data" axis splits nothing, so
        # data_axis is moot there; the JAX package splits the batch over
        # the devices of its process, with the same numbers)
        raise ValueError(f"fsdp_axis={cfg.fsdp_axis}, tensor_axis="
                         f"{cfg.tensor_axis} need as many processes: start "
                         "a process group (torchrun, or "
                         "parallel.sharding.initialize_distributed)")
    rt = rt or build_runtime(cfg)
    max_steps = max_steps if max_steps is not None else cfg.optim.max_steps
    accum = cfg.grad_accumulation_steps
    if data_iter is None:
        tensor = cfg.tensor_axis if mesh is not None else 1
        data_iter = iter(DummyDataset(
            cfg.model, process_local_batch_size(cfg.batch_size, tensor),
            seed=per_process_seed(cfg.seed, tensor=tensor),
            accum_steps=accum if accum > 1 else None))
    first = next(data_iter)

    model = VLAModel(cfg.model, rt, device="meta")
    model.load_state_dict(initial_state(cfg, rt, device, params),
                          strict=True, assign=True)
    tx = make_optimizer(cfg.optim)
    # the optimizer's moments are made after the placement, as this rank's
    # parts (whole ones of a 7B model would not fit beside the model)
    state = init_train_state(model, tx, cfg.lora.enabled,
                             optimizer_state=False)

    run_dir = Path(cfg.run_root_dir) / get_run_id(cfg)
    if resume:
        ckpt = find_resume_checkpoint(run_dir)
        if ckpt is not None:
            load_checkpoint(ckpt, state)
    if mesh is not None:
        # the int8 base's transposed copies are made inside, from each
        # rank's "tensor" parts, before the "fsdp" split
        place_state_(state, shard_model(model, mesh, tensor_transport), tx)
    else:
        prepare_ste_(model)
        if state.opt_state is None:
            state.opt_state = tx.init(state.trainable)
        else:
            _place_moments(state, lambda v, n: v)

    step_fn = make_train_step(model, tx, cfg, sharding=state.sharding)
    metrics = Metrics(run_dir, window=max(accum, 8), run_id=get_run_id(cfg),
                      trackers=("jsonl",) if is_main_process() else ())

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


def place_state_(state: TrainState, sharding, tx=None) -> TrainState:
    """After ``shard_model``: the state's trainable tensors re-read from
    the model (the tensor split replaced the split ones by their parts,
    FSDP2 the sharded ones by DTensors) and each optimizer moment (whole,
    on the host: ``load_checkpoint``) cut to its parameter's part on this
    rank and moved to its device, or, without an optimizer state (not
    resumed), the optimizer ``tx`` started over those parts."""
    params = dict(state.model.named_parameters())
    state.trainable = {n: params[n] for n in state.trainable}
    if state.opt_state is None:
        state.opt_state = tx.init({n: local(p) for n, p in
                                   state.trainable.items()})
    else:
        _place_moments(state, lambda v, n: sharding.local_slice(
            v, state.trainable[n], n))
    state.sharding = sharding
    return state


def _place_moments(state: TrainState, part) -> None:
    """Each optimizer moment as ``part(moment, name)`` on its parameter's
    device, one at a time (a resumed 7B model's whole moments would not
    fit beside it on the card)."""
    for kind in ("mu", "nu"):
        state.opt_state[kind] = {
            n: part(v, n).to(local(state.trainable[n]).device)
            for n, v in state.opt_state[kind].items()}


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
