"""One rank of the port's multi-process CPU tests (gloo), the
single-process runs they are held against, and the launcher the tests
start the ranks with (:func:`start`, :func:`wait`).

    python -m tests.torch_dist_worker --scenario train --mode fsdp \\
        --world 2 --rank 0 --port 29512 --ref REF --out DIR

Imports neither JAX nor the JAX package. The training scenarios start
from the float weights in ``REF/params.pt`` (the JAX package's init,
carried with ``from_jax_params``); the "train" scenario's head noise is
``train_noise_std`` times ``REF/noise.npy``, the draw the test also gives
the JAX package's head, and the "one_rank" scenario draws its own. Each
rank writes what it saw to ``DIR/rank<r>.pt`` for the test to compare.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import vla_adapter_torch.core.config as tc
import vla_adapter_torch.core.constants as tk
from tests.torch_tiny import tiny_cfg

ROOT = Path(__file__).resolve().parent.parent
GLOBAL_BATCH = 8
# mode: the mesh (data, fsdp, tensor)
MODES = {"data": (-1, 1, 1), "fsdp": (1, 2, 1), "hsdp": (2, 2, 1),
         "tp2": (1, 1, 2), "tp4": (1, 1, 4), "dp_tp": (2, 1, 2),
         "fsdp_tp": (1, 2, 2), "tp2_ste": (1, 1, 2), "tp4_ste": (1, 1, 4),
         "dp_tp_ste": (2, 1, 2), "fsdp_tp_ste": (1, 2, 2),
         "fsdp_ste": (1, 2, 1), "hsdp_ste": (2, 2, 1)}
# the Runtime's act_int8_min_dim of a mode's recipe where it is not the
# default (256, above every width of the tiny model: each frozen int8
# Dense takes the weight-only upcast): at 1 every one trains through the
# straight-through w8a8 product, as the flagship's wide ones do
STE_MIN_DIM = 1
ACT_INT8_MIN_DIM = {m: STE_MIN_DIM for m in MODES if m.endswith("_ste")}
GROUP_TIMEOUT_S = 120   # every rank of a group has ended by then


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start(out, scenario: str, world: int, mode: str = "data", ref=None):
    """Start every rank of a group on a free port: (out, processes, start
    time), for :func:`wait`."""
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_dist_worker", "--scenario",
         scenario, "--mode", mode, "--world", str(world), "--rank", str(r),
         "--port", str(port), "--out", str(out)]
        + (["--ref", str(ref)] if ref is not None else []), cwd=ROOT,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        for r in range(world)]
    return Path(out), procs, time.monotonic()


def wait(out, procs, started) -> list:
    """Wait for every rank under one deadline (GROUP_TIMEOUT_S after the
    start), kill any left, assert each exit code, and return each rank's
    record."""
    errors = []
    try:
        for p in procs:
            left = started + GROUP_TIMEOUT_S - time.monotonic()
            _, err = p.communicate(timeout=max(left, 1))
            errors.append(err.decode()[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    assert rcs == [0] * len(procs), "\n".join(errors)
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(len(procs))]


def train_cfg(root, run_id: str, mode=None, accum: int = 1, steps: int = 2,
              C=tc, K=tk):
    """The tiny VLA's LoRA recipe over the int8 base at a global batch of
    8, head noise at the recipe's std, on the mesh of ``mode`` (None: one
    process), in either package's config classes (``C``, ``K``)."""
    data, fsdp, tensor = MODES[mode] if mode else (-1, 1, 1)
    return C.TrainConfig(
        model=tiny_cfg(C, K), batch_size=GLOBAL_BATCH, base_int8=True,
        lora=C.LoRAConfig(rank=4, alpha=8.0), data_axis=data,
        fsdp_axis=fsdp, tensor_axis=tensor, grad_accumulation_steps=accum,
        accum_dtype="bfloat16" if accum > 1 else None, frozen_bf16=False,
        save_freq=1000, log_freq=1000, run_id=run_id, run_root_dir=str(root),
        optim=C.OptimizerConfig(learning_rate=1e-3, max_steps=steps,
                                num_steps_before_decay=1000,
                                grad_clip_norm=1.0))


def global_batch(cfg, accum: int, seed: int = 5):
    from vla_adapter_torch.data.dummy import make_dummy_batch

    return make_dummy_batch(cfg.model, GLOBAL_BATCH, np.random.default_rng(
        seed), accum_steps=accum if accum > 1 else None)


def rows(batch, rank: int, world: int, accum: int):
    """This rank's contiguous rows of the global batch (the example axis
    is 1 under accumulation)."""
    axis = 1 if accum > 1 else 0

    def take(v):
        n = v.shape[axis] // world
        return np.take(v, range(rank * n, (rank + 1) * n), axis=axis)

    return {k: take(np.asarray(v)) for k, v in batch.items()}


def fixed_head_noise(unit: np.ndarray):
    """A stand-in for ``models.vla.head_noise`` that returns
    ``train_noise_std * unit`` at every step and micro-batch."""
    def head_noise(cfg, generator, device):
        return cfg.head.train_noise_std * torch.as_tensor(
            unit, dtype=torch.float32, device=device)

    return head_noise


def run(cfg, batch, steps, init, resume=False, min_dim=None):
    """finetune from the float weights ``init`` over one repeated batch in
    fp32 (a bf16 product rounds differently at another row count), at the
    Runtime's act_int8_min_dim ``min_dim`` (None: its default): (losses,
    whole trainable tensors, the state)."""
    from vla_adapter_torch.train.loop import build_runtime, finetune

    rt = dataclasses.replace(build_runtime(cfg), dtype=torch.float32)
    if min_dim is not None:
        rt = dataclasses.replace(rt, act_int8_min_dim=min_dim)
    with first_grads() as grads:
        state = finetune(cfg, data_iter=itertools.repeat(batch),
                         max_steps=steps, device="cpu", resume=resume, rt=rt,
                         params=init)
    sh = state.sharding
    full = {n: (sh.full(p, n) if sh else p).detach().clone()
            for n, p in state.trainable.items()}
    state.first_grads = {
        n: (sh.full_like(g, state.trainable[n], n) if sh else g
            ).detach().clone() for n, g in grads.items()}
    return [h["loss"] for h in state.history], full, state


@contextlib.contextmanager
def first_grads():
    """A dict that receives the gradients of the first optimizer update
    made inside the block (the train step's, after its reductions over the
    process group: this rank's parts of the split tensors)."""
    from vla_adapter_torch.train import optim

    seen, update = {}, optim.AdamW.update

    def record(self, grads, *args, **kw):
        if not seen:
            seen.update({n: g.detach().clone() for n, g in grads.items()})
        return update(self, grads, *args, **kw)

    optim.AdamW.update = record
    try:
        yield seen
    finally:
        optim.AdamW.update = update


def checkpoint_layout(ckpt) -> dict:
    """{file: {tensor: (shape, dtype)}} of a checkpoint directory, and its
    JSON files' names."""
    from vla_adapter_torch.weights.safetensors_io import load_file

    ckpt = Path(ckpt)
    out = {f.name: {k: (tuple(v.shape), str(v.dtype))
                    for k, v in load_file(f).items()}
           for f in sorted(ckpt.glob("*.safetensors"))}
    out["json"] = sorted(f.name for f in ckpt.glob("*.json"))
    return out


def int8_record(state) -> dict:
    """This rank's int8 tensors of the model as placed: {name: (the dim
    its "fsdp" part is cut on, or None for a whole one, the tensor)} for
    every Dense's ``weight_q`` and, under the straight-through product,
    its ``weight_qt`` and a row split's ``weight_qk``; and the rank's
    "fsdp" coordinate."""
    from vla_adapter_torch.models.layers import Dense

    out = {}
    for mod_name, m in state.model.named_modules():
        if not isinstance(m, Dense) or not m.rt.weights_int8:
            continue
        dims = m.int8_parts.dims if m.int8_parts is not None else {}
        for leaf in ("weight_q", "weight_qt", "weight_qk"):
            t = getattr(m, leaf, None)
            if t is not None:
                out[f"{mod_name}.{leaf}"] = (dims.get(leaf),
                                             t.detach().clone())
    mesh = state.sharding.mesh
    return {"tensors": out,
            "fsdp_rank": mesh["fsdp"].get_local_rank(),
            "tensor_rank": mesh["tensor"].get_local_rank()}


def train_scenario(args, init) -> dict:
    tensor = MODES[args.mode][2]
    if tensor > 1 or args.mode in ACT_INT8_MIN_DIM:
        return tensor_scenario(args, init)
    world, rank = args.world, args.rank
    root = Path(args.out) / "runs"
    out = {}
    cfg = train_cfg(root, f"{args.mode}-full", args.mode)
    batch = global_batch(cfg, 1)
    mine = rows(batch, rank, world, 1)
    out["losses"], out["trained"], state = run(cfg, mine, 2, init)
    from vla_adapter_torch.utils.overwatch import process_count, process_index

    out["rank"], out["world"] = process_index(), process_count()
    mesh = state.sharding.mesh
    out["mesh"] = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    out["checkpoint"] = checkpoint_layout(root / f"{args.mode}-full" /
                                          "latest")
    out["sharded"] = sorted(state.sharding.fsdp_dims)
    out["dtensors"] = sorted(n for n, p in state.model.named_parameters()
                             if type(p).__name__ == "DTensor")
    out["int8_parts"] = int8_record(state)
    # one step, a checkpoint under the group, then a resume to step 2
    cfg_b = dataclasses.replace(cfg, run_id=f"{args.mode}-resumed")
    run(cfg_b, mine, 1, init)
    out["resumed_losses"], out["resumed"], _ = run(cfg_b, mine, 2, init,
                                                   resume=True)
    # accumulation over 2 micro-batches with a bf16 carry, one step
    cfg_a = train_cfg(root, f"{args.mode}-accum", args.mode, accum=2,
                      steps=1)
    out["accum_losses"], out["accum_trained"], _ = run(
        cfg_a, rows(global_batch(cfg_a, 2), rank, world, 2), 1, init)
    return out


def tensor_scenario(args, init) -> dict:
    """A mesh with a "tensor" dim, or a straight-through recipe ("_ste"):
    the 2-step run over this rank's rows (those of its ("data", "fsdp")
    coordinate), its checkpoint's layout and its int8 tensors as placed
    (:func:`int8_record`); on "tp2" also the split Denses
    (:func:`split_dense_records`),
    each rank's parts of the frozen base, a checkpoint written under the
    group and resumed on it, and 2-way accumulation."""
    from vla_adapter_torch.utils.overwatch import process_count, process_index

    tensor = MODES[args.mode][2]
    world, rank = args.world, args.rank
    min_dim = ACT_INT8_MIN_DIM.get(args.mode)
    root = Path(args.out) / "runs"
    out = {"rank": process_index(), "world": process_count()}
    if args.mode == "tp2":
        out["dense"] = split_dense_records()
    cfg = train_cfg(root, f"{args.mode}-full", args.mode)
    mine = rows(global_batch(cfg, 1), rank // tensor, world // tensor, 1)
    out["losses"], out["trained"], state = run(cfg, mine, 2, init,
                                               min_dim=min_dim)
    out["first_grads"] = state.first_grads
    out["ste"] = sum(getattr(m, "ste", False) for m in state.model.modules())
    sh = state.sharding
    out["mesh"] = dict(zip(sh.mesh.mesh_dim_names, tuple(sh.mesh.shape)))
    out["checkpoint"] = checkpoint_layout(root / f"{args.mode}-full" /
                                          "latest")
    out["tensor_dims"] = dict(sh.tensor_dims)
    out["partial"] = sorted(sh.tensor_partial)
    out["fsdp_dims"] = dict(sh.fsdp_dims)
    out["int8_parts"] = int8_record(state)
    if args.mode != "tp2":
        return out
    local = {n: p.detach().clone() for n, p in
             state.model.named_parameters()}
    out["local_frozen"] = {n: v for n, v in local.items()
                           if n not in state.trainable}
    out["local_shapes"] = {n: tuple(v.shape) for n, v in local.items()}
    cfg_b = dataclasses.replace(cfg, run_id=f"{args.mode}-resumed")
    run(cfg_b, mine, 1, init, min_dim=min_dim)
    out["resumed_losses"], out["resumed"], _ = run(
        cfg_b, mine, 2, init, resume=True, min_dim=min_dim)
    cfg_a = train_cfg(root, f"{args.mode}-accum", args.mode, accum=2,
                      steps=1)
    out["accum_losses"], out["accum_trained"], _ = run(
        cfg_a, rows(global_batch(cfg_a, 2), rank // tensor, world // tensor,
                    2), 1, init, min_dim=min_dim)
    return out


DENSE_BRANCHES = ("float", "int8", "ste")


def split_dense_records(m: int = 6, k: int = 32, n: int = 40,
                        seed: int = 7) -> dict:
    """One Dense per branch ("float", weight-only "int8", the
    straight-through "ste" with act_int8_min_dim=1), with LoRA (rank 4,
    non-zero b) and bias, and the "ste" base alone ("ste_base": no LoRA,
    no bias; "ste_base_k24" at K 24, whose halves of 12 are zero-padded
    where K 32's halves of 16 are not), split "col" and "row" over this
    rank's tensor group of 2,
    each beside the unsplit Dense of the same weights: the forward, dx and
    the gradients of the whole tensors (those the rank uses in part summed
    over the group, as the train step sums them), for the test to hold.
    Every row of x and of the output gradient has its absmax on one half
    of K or N, alternating, so half the rows peak on the other rank's
    half."""
    import torch.distributed as dist

    from vla_adapter_torch.models.layers import Dense, FP32_RUNTIME
    from vla_adapter_torch.models.quantize import quantize_weight
    from vla_adapter_torch.parallel.tensor import TensorGroup

    tg = TensorGroup(None, dist.get_rank(), dist.get_world_size())
    rng = np.random.default_rng(seed)

    def peaked(rows_, width):
        a = rng.normal(size=(rows_, width)).astype(np.float32)
        for i in range(rows_):
            half = width // 2
            j = (i % 2) * half + rng.integers(half)
            a[i, j] = 9.0 * np.sign(a[i, j])
        return torch.from_numpy(a)

    out = {}
    n_base = k
    for branch in DENSE_BRANCHES + ("ste_base", "ste_base_k24"):
        base = branch.startswith("ste_base")
        k = 24 if branch == "ste_base_k24" else n_base
        rt = dataclasses.replace(
            FP32_RUNTIME, lora_rank=0 if base else 4, lora_scale=2.0,
            weights_int8=branch != "float", act_int8=branch.startswith("ste"),
            act_int8_min_dim=1, train_base_int8=branch.startswith("ste"))
        weight = torch.from_numpy(
            rng.normal(size=(n, k)).astype(np.float32) / np.sqrt(k))
        tensors = {"bias": torch.from_numpy(
            rng.normal(size=n).astype(np.float32))}
        if not base:
            tensors["lora_a"] = torch.from_numpy(
                rng.normal(size=(k, 4)).astype(np.float32))
            tensors["lora_b"] = torch.from_numpy(
                rng.normal(size=(4, n)).astype(np.float32))
        if branch == "float":
            tensors["weight"] = weight
        else:
            tensors["weight_q"], tensors["weight_scale"] = \
                quantize_weight(weight)
        x, g = peaked(m, k), peaked(m, n)
        for mode in ("col", "row"):
            pair = {}
            for split in (False, True):
                dense = Dense(k, n, use_bias=True, rt=rt)
                with torch.no_grad():
                    for name, t in tensors.items():
                        getattr(dense, name).copy_(t)
                    if base:
                        dense.bias = None
                trained = [name for name in ("bias", "lora_a", "lora_b")
                           if getattr(dense, name, None) is not None]
                for name in trained:
                    getattr(dense, name).requires_grad_(True)
                xin, gout = x.clone(), g
                if split:
                    dense.split_(mode, tg)
                    lo, hi = dense.tp_range
                    if mode == "row":
                        xin = x[:, lo:hi].clone()
                    else:
                        gout = g[:, lo:hi]
                if dense.ste:
                    from vla_adapter_torch.models.layers import prepare_ste_

                    prepare_ste_(dense)
                xin.requires_grad_(True)
                y = dense(xin)
                (y * gout).sum().backward()
                grads = {name: getattr(dense, name).grad.clone()
                         for name in trained}
                if split:
                    for name in dense.tensor_partial():
                        dist.all_reduce(grads[name])
                pair["split" if split else "whole"] = {
                    "y": y.detach(), "dx": xin.grad.detach(), **grads,
                    "state": sorted(dense.state_dict())}
            pair["range"] = dense.tp_range
            out[f"{branch}/{mode}"] = pair
    return out


# the "fsdp_layers" scenario's decoder depth: more layers than FSDP2 may
# hold unsharded at once
PROBE_LAYERS = 4


def int8_dense_records(m: int = 6, k: int = 32, seed: int = 11) -> dict:
    """The int8 weight of a Dense (with LoRA and bias) cut over the world
    ("fsdp", the ranks of the group) on the dim the rule picks: (7, k),
    whose out dim 7 does not divide, on its in dim; (8, k) on its out
    dim; each weight-only and straight-through (act_int8_min_dim 1),
    beside the whole Dense of the same weights: the forward, dx and the
    LoRA gradients, the dims the parts took and this rank's parts."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from vla_adapter_torch.models.layers import (
        FP32_RUNTIME,
        Dense,
        prepare_ste_,
    )
    from vla_adapter_torch.models.quantize import quantize_weight
    from vla_adapter_torch.parallel import sharding

    world = dist.get_world_size()
    mesh = DeviceMesh("cpu", list(range(world)), mesh_dim_names=("fsdp",))
    rng = np.random.default_rng(seed)
    out = {}
    for n in (7, 8):
        weight = torch.from_numpy(
            rng.normal(size=(n, k)).astype(np.float32) / np.sqrt(k))
        tensors = dict(zip(("weight_q", "weight_scale"),
                           quantize_weight(weight)))
        tensors.update(
            bias=torch.from_numpy(rng.normal(size=n).astype(np.float32)),
            lora_a=torch.from_numpy(rng.normal(size=(k, 4))
                                    .astype(np.float32)),
            lora_b=torch.from_numpy(rng.normal(size=(4, n))
                                    .astype(np.float32)))
        x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
        g = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32))
        for branch in ("int8", "ste"):
            rt = dataclasses.replace(
                FP32_RUNTIME, lora_rank=4, lora_scale=2.0, weights_int8=True,
                act_int8=branch == "ste", act_int8_min_dim=1,
                train_base_int8=branch == "ste")
            pair = {}
            for cut in (False, True):
                holder = torch.nn.Module()
                holder.fc = dense = Dense(k, n, rt=rt)
                with torch.no_grad():
                    for name, t in tensors.items():
                        getattr(dense, name).copy_(t)
                for name in ("bias", "lora_a", "lora_b"):
                    getattr(dense, name).requires_grad_(True)
                prepare_ste_(holder)
                if cut:
                    spec = sharding.param_pspec(
                        "fc.weight_q", (n, k), world, min_fsdp_size=1,
                        layout="transposed")
                    pair["dims"] = sharding.shard_int8_(
                        holder, {"fc.weight_q": spec.index("fsdp")}, mesh)
                    pair["parts"] = {
                        name: getattr(dense, name.split(".")[1]).detach()
                        .clone() for name in pair["dims"]}
                xin = x.clone().requires_grad_(True)
                y = dense(xin)
                (y * g).sum().backward()
                pair["cut" if cut else "whole"] = {
                    "y": y.detach(), "dx": xin.grad.detach(),
                    **{name: getattr(dense, name).grad.clone()
                       for name in ("bias", "lora_a", "lora_b")}}
            pair["whole_int8"] = {"weight_q": tensors["weight_q"],
                                  "weight_qt": tensors["weight_q"].t()}
            out[f"{branch}/{n}"] = pair
    return out


def fsdp_layers_scenario(args) -> dict:
    """2 ranks on "fsdp": :func:`int8_dense_records`, then one step of the
    tiny recipe with PROBE_LAYERS decoder layers, every frozen Dense
    straight-through (act_int8_min_dim 1), its decoder layers watched by
    ``chip_smoke.UnshardedLayers`` and its int8 gathers counted
    beside those ``chip_smoke.expected_int8_gathers`` derives."""
    import chip_smoke
    from vla_adapter_torch.parallel import fsdp_int8, sharding
    from vla_adapter_torch.train import loop

    out = {"dense": int8_dense_records()}
    cfg = train_cfg(Path(args.out) / "runs", "layers", "fsdp", steps=1)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, llm=dataclasses.replace(cfg.model.llm,
                                           num_layers=PROBE_LAYERS)))
    seen = {}
    place = loop.place_state_

    def watched(state, sh, tx=None):
        place(state, sh, tx)
        seen["probe"] = chip_smoke.UnshardedLayers(state.model).__enter__()
        seen["expected"] = chip_smoke.expected_int8_gathers(state.model)
        fsdp_int8.reset_gathers()
        return state

    loop.place_state_ = watched
    try:
        state = loop.finetune(
            cfg, data_iter=itertools.repeat(rows(global_batch(cfg, 1),
                                                 args.rank, args.world, 1)),
            max_steps=1, device="cpu", rt=dataclasses.replace(
                loop.build_runtime(cfg), dtype=torch.float32,
                act_int8_min_dim=STE_MIN_DIM))
    finally:
        loop.place_state_ = place
        if "probe" in seen:
            seen["probe"].__exit__()
    probe = seen["probe"]
    out.update(most=probe.most, layers=len(probe.layers),
               decoder_layers=len(sharding.decoder_layers(state.model)),
               gathers=dict(fsdp_int8.GATHERS), expected=seen["expected"],
               ste=sum(getattr(m, "ste", False)
                       for m in state.model.modules()),
               loss=state.history[0]["loss"])
    return out


def one_rank_runs(args, init) -> dict:
    """One process, the head noise drawn as the recipe draws it: 2 steps
    without a group, then under a one-rank group on "data" and under
    FSDP2 on a one-rank "fsdp" mesh (its collectives run on one rank;
    the int8 gathers counted), at the mode's act_int8_min_dim."""
    from vla_adapter_torch.parallel import sharding
    from vla_adapter_torch.parallel.sharding import initialize_distributed

    from vla_adapter_torch.parallel import fsdp_int8

    root = Path(args.out) / "runs"
    cfg = train_cfg(root, "alone")
    batch = global_batch(cfg, 1)
    min_dim = ACT_INT8_MIN_DIM.get(args.mode)
    out = {"alone": run(cfg, batch, 2, init, min_dim=min_dim)[:2]}
    initialize_distributed(f"tcp://localhost:{args.port}", 1, 0,
                           device="cpu")
    out["data"] = run(dataclasses.replace(cfg, run_id="data"), batch, 2,
                      init, min_dim=min_dim)[:2]
    sharding.MIN_FSDP_RANKS = 1
    fsdp_int8.reset_gathers()
    losses, trained, state = run(dataclasses.replace(cfg, run_id="fsdp"),
                                 batch, 2, init, min_dim=min_dim)
    out["fsdp"] = (losses, trained)
    out["fsdp_dtensors"] = sum(type(p).__name__ == "DTensor"
                               for p in state.model.parameters())
    out["int8_gathers"] = dict(fsdp_int8.GATHERS)
    out["ste"] = sum(getattr(m, "ste", False)
                     for m in state.model.modules())
    return out


def single_process_runs(root, init, min_dim=None) -> dict:
    """The "train" scenario's runs in one process over the whole global
    batch, at act_int8_min_dim ``min_dim`` (:func:`run`)."""
    out = {}
    cfg = train_cfg(root, "single")
    out["losses"], out["trained"], state = run(
        cfg, global_batch(cfg, 1), 2, init, min_dim=min_dim)
    out["first_grads"] = state.first_grads
    out["checkpoint"] = checkpoint_layout(Path(root) / "single" / "latest")
    out["checkpoint_dir"] = Path(root) / "single" / "latest"
    cfg_a = train_cfg(root, "single-accum", accum=2, steps=1)
    out["accum_losses"], out["accum_trained"], _ = run(
        cfg_a, global_batch(cfg_a, 2), 1, init, min_dim=min_dim)
    return out


# --- CALVIN's chains over the ranks ------------------------------------------

class ChainEnv:
    """A CALVIN stand-in whose oracle passes subtask ``k`` of chain ``c``
    iff ``k < depth(c)``: each chain's depth is known in advance."""

    def __init__(self):
        self.t, self.chain = 0, None

    def reset(self, robot_obs=None, scene_obs=None):
        self.t, self.chain = 0, int(robot_obs[0])

    def get_obs(self):
        img = np.full((200, 200, 3), self.t % 256, np.uint8)
        return {"rgb_obs": {"rgb_static": img, "rgb_gripper": img[:84, :84]},
                "robot_obs": np.zeros(15)}

    def get_info(self):
        return {"t": self.t}

    def step(self, action):
        self.t += 1
        return self.get_obs(), 0.0, False, {"t": self.t}


def chain_depth(chain: int) -> int:
    return (3 * chain + 1) % 6


class ChainOracle:
    def __init__(self, env: ChainEnv):
        self.env = env

    def get_task_info_for_set(self, start_info, info, subtasks):
        (sub,) = subtasks
        k = int(sub.split("_")[1])
        ok = k < chain_depth(self.env.chain) and info["t"] - \
            start_info["t"] >= 2
        return set(subtasks) if ok else set()


class ConstantPredictor:
    def predict_action(self, images, instruction, proprio=None,
                       unnorm_key=None):
        return np.full((8, 7), 0.5)


def calvin_chains(n: int = 5):
    return [({"robot_obs": np.array([float(c)]), "scene_obs": np.zeros(1)},
             [f"sub_{k}" for k in range(5)]) for c in range(n)]


def calvin_scenario(args) -> dict:
    from vla_adapter_torch.eval.calvin import (
        CalvinEvalConfig,
        evaluate_policy,
        eval_calvin,
    )
    import vla_adapter_torch.eval.calvin as calvin

    env = ChainEnv()
    annotations = {f"sub_{k}": [f"do {k}"] for k in range(5)}
    cfg = CalvinEvalConfig(ep_len=1)
    chains = calvin_chains()
    gathered = {}
    orig = calvin.gather_depths

    def spy(results, num_chains):
        gathered["local"] = list(results)
        gathered["all"] = orig(results, num_chains)
        return gathered["all"]

    calvin.gather_depths = spy
    res = eval_calvin(ConstantPredictor(), (env, ChainOracle(env),
                                            annotations, chains), cfg)
    local = evaluate_policy(calvin.CalvinPolicy(ConstantPredictor(), cfg),
                            env, ChainOracle(env), annotations,
                            chains[args.rank::args.world], cfg)
    return {"result": res, "local": gathered["local"],
            "gathered": gathered["all"], "direct_local": local}


# rank 0's time inside ``local_zero_first``: long enough that another
# rank which did not wait for it would enter before it left
ZERO_FIRST_HOLD_S = 0.5


def zero_first_scenario(args) -> dict:
    """Each rank through ``utils.overwatch.local_zero_first``, appending
    "enter <rank>" and "exit <rank>" to ``OUT/order.log`` (one write each,
    O_APPEND) around its body; rank 0 stays ZERO_FIRST_HOLD_S inside."""
    from vla_adapter_torch.utils.overwatch import local_zero_first

    log = Path(args.out) / "order.log"

    def note(what):
        with open(log, "a") as f:
            f.write(f"{what} {args.rank}\n")

    with local_zero_first():
        note("enter")
        if args.rank == 0:
            time.sleep(ZERO_FIRST_HOLD_S)
        note("exit")
    return {"rank": args.rank}


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--scenario", choices=("train", "calvin",
                                               "one_rank", "fsdp_layers",
                                               "zero_first"))
    parser.add_argument("--mode", choices=tuple(MODES), default="data")
    parser.add_argument("--world", type=int)
    parser.add_argument("--rank", type=int)
    parser.add_argument("--port", type=int)
    parser.add_argument("--ref")
    parser.add_argument("--out")
    args = parser.parse_args()
    torch.set_num_threads(1)

    from vla_adapter_torch.models import vla
    from vla_adapter_torch.parallel import sharding
    import torch.distributed as dist

    # every tensor of the tiny model is below the JAX rule's 2**18
    # elements: shard everything the rule would shard at any size
    sharding.MIN_FSDP_SIZE = 1
    init = None
    if args.ref is not None:
        init = torch.load(Path(args.ref) / "params.pt")
    if args.scenario == "one_rank":
        result = one_rank_runs(args, init)
    else:
        sharding.initialize_distributed(f"tcp://localhost:{args.port}",
                                        args.world, args.rank, device="cpu")
        if args.scenario == "train":
            vla.head_noise = fixed_head_noise(
                np.load(Path(args.ref) / "noise.npy"))
            result = train_scenario(args, init)
        elif args.scenario == "fsdp_layers":
            result = fsdp_layers_scenario(args)
        elif args.scenario == "zero_first":
            result = zero_first_scenario(args)
        else:
            result = calvin_scenario(args)
    torch.save(result, Path(args.out) / f"rank{args.rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
