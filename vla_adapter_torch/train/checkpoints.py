"""Checkpoint save, load and resume (counterpart of
vla_adapter_tpu/train/checkpoints.py, which writes with orbax).

The same directory contract: ``<run_dir>/latest`` (or ``step-NNNNNN``
when every checkpoint is kept) holds ``trainable``, ``frozen`` and
``opt_state``, ``meta.json`` ({"step": N}) written last, and
``dataset_statistics.json``; a ``latest`` is written into
``latest.tmp`` and swapped in at the end, so a run cut during the write
keeps its previous checkpoint. Each part is one safetensors file written
with the port's own writer (``weights/safetensors_io.py``). Under a
process group (``state.sharding``) every rank gathers the whole state
(FSDP2's shards through ``full_tensor``, the "tensor" axis's parts through
an all-gather over the tensor group) and rank 0 writes the same files a
single process writes, between barriers where the JAX package syncs its
processes; ``load_checkpoint`` reads the whole state, which the loop then
places on the mesh (a checkpoint written at any mesh loads at any other,
and in one process).
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Dict, Optional

import torch

from vla_adapter_torch.weights.safetensors_io import load_file, save_file

LATEST = "latest"


def checkpoint_dir(run_dir, step: int, latest_only: bool) -> Path:
    return Path(run_dir) / (LATEST if latest_only else f"step-{step:06d}")


def flatten_opt_state(opt_state: dict) -> Dict[str, torch.Tensor]:
    """The optimizer state as one flat dict of tensors."""
    out = {"count": opt_state["count"].reshape(1)}
    for part in ("mu", "nu"):
        out.update({f"{part}/{k}": v for k, v in opt_state[part].items()})
    return out


def unflatten_opt_state(flat: Dict[str, torch.Tensor]) -> dict:
    state = {"count": flat["count"].reshape(()), "mu": {}, "nu": {}}
    for key, val in flat.items():
        if "/" in key:
            part, name = key.split("/", 1)
            state[part][name] = val
    return state


def _barrier(state) -> None:
    if state.sharding is not None:
        import torch.distributed as dist

        dist.barrier()


def _whole_state(state):
    """(trainable, frozen, optimizer state) as whole tensors; under a
    process group every rank gathers them, in the same order."""
    sh = state.sharding
    if sh is None:
        return state.trainable, state.frozen(), state.opt_state
    trainable = {n: sh.full(p, n) for n, p in state.trainable.items()}
    frozen = {n: sh.full(v, n) for n, v in state.frozen().items()}
    opt = dict(state.opt_state)
    for part in ("mu", "nu"):
        opt[part] = {n: sh.full_like(v, state.trainable[n], n)
                     for n, v in state.opt_state[part].items()}
    return trainable, frozen, opt


def save_checkpoint(run_dir, state, dataset_statistics: Optional[Dict] = None,
                    latest_only: bool = True) -> Path:
    """Write ``state`` (a ``train.step.TrainState``) under ``run_dir``;
    under a process group every rank calls it and rank 0 writes."""
    from vla_adapter_torch.utils.overwatch import is_main_process

    final = checkpoint_dir(run_dir, state.step, latest_only)
    out = final.with_name(final.name + ".tmp") if latest_only else final
    writer = is_main_process()
    if writer:
        if out.exists():
            shutil.rmtree(out)
        out.mkdir(parents=True)
    _barrier(state)  # the directory is ready
    trainable, frozen, opt_state = _whole_state(state)
    if writer:
        save_file(trainable, out / "trainable.safetensors")
        if frozen:
            save_file(frozen, out / "frozen.safetensors")
        save_file(flatten_opt_state(opt_state), out / "opt_state.safetensors")
        if dataset_statistics is not None:
            (out / "dataset_statistics.json").write_text(
                json.dumps(dataset_statistics, indent=2))
        (out / "meta.json").write_text(json.dumps({"step": state.step}))
        if latest_only:
            if final.exists():
                shutil.rmtree(final)
            out.rename(final)
    _barrier(state)  # written: every rank may read it
    return final


@torch.no_grad()
def load_checkpoint(path, state):
    """Restore ``state`` in place from a checkpoint directory: the
    trainable and frozen tensors are copied into the model's, the
    optimizer state is moved to each moment's device. Returns ``state``.
    The state is whole here (before ``shard_model``): every rank reads
    the files."""
    path = Path(path)
    meta = json.loads((path / "meta.json").read_text())
    trainable = load_file(path / "trainable.safetensors")
    if set(trainable) != set(state.trainable):
        raise ValueError(f"{path}: trainable tensors differ from the "
                         "model's")
    for name, param in state.trainable.items():
        param.copy_(trainable[name])
    if (path / "frozen.safetensors").exists():
        own = state.model.state_dict()
        for name, val in load_file(path / "frozen.safetensors").items():
            if name not in own or name in state.trainable:
                raise ValueError(f"{path}: frozen {name!r} is not a frozen "
                                 "tensor of the model")
            own[name].copy_(val)
    opt = unflatten_opt_state(load_file(path / "opt_state.safetensors"))
    for part in ("mu", "nu"):
        opt[part] = {k: v.to(state.opt_state[part][k].device)
                     for k, v in opt[part].items()}
    state.opt_state = opt
    state.step = int(meta["step"])
    return state


def save_params(path, params: Dict[str, torch.Tensor]) -> Path:
    """Deployment export: one state dict (e.g. after the LoRA merge) as
    ``<path>/params.safetensors``."""
    path = Path(path)
    if path.exists():
        shutil.rmtree(path)
    path.mkdir(parents=True)
    save_file(params, path / "params.safetensors")
    return path


def load_params(path) -> Dict[str, torch.Tensor]:
    return load_file(Path(path) / "params.safetensors")


def find_resume_checkpoint(run_dir) -> Optional[Path]:
    """The latest checkpoint in a run directory, or None."""
    run_dir = Path(run_dir)
    if not run_dir.exists():
        return None
    if (run_dir / LATEST / "meta.json").exists():
        return run_dir / LATEST
    steps = sorted(run_dir.glob("step-*/meta.json"))
    return steps[-1].parent if steps else None
