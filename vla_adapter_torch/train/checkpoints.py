"""Checkpoint save, load and resume (counterpart of
vla_adapter_tpu/train/checkpoints.py, which writes with orbax).

The same directory contract: ``<run_dir>/latest`` (or ``step-NNNNNN``
when every checkpoint is kept) holds ``trainable``, ``frozen`` and
``opt_state``, ``meta.json`` ({"step": N}) written last, and
``dataset_statistics.json``; a ``latest`` is written into
``latest.tmp`` and swapped in at the end, so a run cut during the write
keeps its previous checkpoint. Each part is one safetensors file written
with the port's own writer (``weights/safetensors_io.py``). Under a
process group (``state.sharding``) the whole state is gathered one tensor
at a time, in the same order on every rank (FSDP2's shards through
``full_tensor``, the int8 base's "fsdp" parts through an all-gather over
the "fsdp" group, the "tensor" axis's parts through an all-gather over the
tensor group: ``Sharding.full``), and rank 0 streams each to its file
(``safetensors_io.write_file``) before the next is gathered: a rank holds
its parts and one whole tensor, never the whole state. Rank 0 writes the
same files a single process writes, between barriers where the JAX
package syncs its processes. ``load_checkpoint`` reads the whole state,
which the loop then places on the mesh (a checkpoint written at any mesh
loads at any other, and in one process); the optimizer's moments stay on
the host until the placement cuts them to each rank's parts.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Dict, Optional

import torch

from vla_adapter_torch.weights.safetensors_io import (
    load_file,
    save_file,
    write_file,
)

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


def _whole_parts(state):
    """The checkpoint's files by name, each as (tensor name -> (dtype,
    whole shape), a function making the whole tensor of a name): the
    state's own tensors in one process; under a process group a gather
    that every rank makes, in the same order (``Sharding.full``)."""
    sh = state.sharding
    trainable, frozen = state.trainable, state.frozen()
    opt = flatten_opt_state(state.opt_state)
    # a moment ("mu/<name>", "nu/<name>") is placed as its parameter
    moment_of = {k: k.split("/", 1)[1] for k in opt if "/" in k}

    def shape(t, name):
        return tuple(t.shape) if sh is None else sh.full_shape(t, name)

    def whole(t, name):
        return t if sh is None else sh.full(t, name)

    def whole_opt(k):
        if sh is None or k not in moment_of:
            return opt[k]
        return sh.full_like(opt[k], trainable[moment_of[k]], moment_of[k])

    opt_specs = {k: (v.dtype, shape(trainable[moment_of[k]], moment_of[k])
                     if k in moment_of else tuple(v.shape))
                 for k, v in opt.items()}
    return {
        "trainable": ({n: (p.dtype, shape(p, n)) for n, p in
                       trainable.items()},
                      lambda n: whole(trainable[n], n)),
        "frozen": ({n: (v.dtype, shape(v, n)) for n, v in frozen.items()},
                   lambda n: whole(frozen[n], n)),
        "opt_state": (opt_specs, whole_opt)}


def _write(path, specs, gather, writer: bool) -> None:
    """Every tensor of ``specs`` made by ``gather`` in name order (a
    collective under a process group: every rank drains it), streamed to
    ``path`` by the ``writer``."""
    tensors = (gather(n) for n in sorted(specs))
    if writer:
        write_file(specs, tensors, path)
    else:
        for t in tensors:
            del t   # gathered, then dropped before the next is


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
    for part, (specs, gather) in _whole_parts(state).items():
        if specs or part != "frozen":
            _write(out / f"{part}.safetensors", specs, gather, writer)
    if writer:
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
    optimizer state replaces the state's (or its None) and stays on the
    host, whole: the caller moves it to the parameters' device, or cuts it
    to a rank's parts there (``train.loop.place_state_``). Returns
    ``state``. The state is whole here (before ``shard_model``): every
    rank reads the files."""
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
    state.opt_state = unflatten_opt_state(
        load_file(path / "opt_state.safetensors"))
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
