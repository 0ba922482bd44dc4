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
MODES = {"data": (-1, 1), "fsdp": (1, 2), "hsdp": (2, 2)}
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
    data, fsdp = MODES[mode] if mode else (-1, 1)
    return C.TrainConfig(
        model=tiny_cfg(C, K), batch_size=GLOBAL_BATCH, base_int8=True,
        lora=C.LoRAConfig(rank=4, alpha=8.0), data_axis=data,
        fsdp_axis=fsdp, grad_accumulation_steps=accum,
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


def run(cfg, batch, steps, init, resume=False):
    """finetune from the float weights ``init`` over one repeated batch in
    fp32 (a bf16 product rounds differently at another row count):
    (losses, whole trainable tensors, the state)."""
    from vla_adapter_torch.train.loop import build_runtime, finetune

    rt = dataclasses.replace(build_runtime(cfg), dtype=torch.float32)
    state = finetune(cfg, data_iter=itertools.repeat(batch), max_steps=steps,
                     device="cpu", resume=resume, rt=rt, params=init)
    sh = state.sharding
    full = {n: (sh.full(p) if sh else p).detach().clone()
            for n, p in state.trainable.items()}
    return [h["loss"] for h in state.history], full, state


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


def train_scenario(args, init) -> dict:
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
    int8 = [p for p in state.model.parameters() if p.dtype == torch.int8]
    out["int8"] = (len(int8), sum(type(p).__name__ == "Parameter"
                                  for p in int8))
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


def one_rank_runs(args, init) -> dict:
    """One process, the head noise drawn as the recipe draws it: 2 steps
    without a group, then under a one-rank group on "data" and under
    FSDP2 on a one-rank "fsdp" mesh (its collectives run on one rank)."""
    from vla_adapter_torch.parallel import sharding
    from vla_adapter_torch.parallel.sharding import initialize_distributed

    root = Path(args.out) / "runs"
    cfg = train_cfg(root, "alone")
    batch = global_batch(cfg, 1)
    out = {"alone": run(cfg, batch, 2, init)[:2]}
    initialize_distributed(f"tcp://localhost:{args.port}", 1, 0,
                           device="cpu")
    out["data"] = run(dataclasses.replace(cfg, run_id="data"), batch, 2,
                      init)[:2]
    sharding.MIN_FSDP_RANKS = 1
    losses, trained, state = run(dataclasses.replace(cfg, run_id="fsdp"),
                                 batch, 2, init)
    out["fsdp"] = (losses, trained)
    out["fsdp_dtensors"] = sum(type(p).__name__ == "DTensor"
                               for p in state.model.parameters())
    return out


def single_process_runs(root, init) -> dict:
    """The "train" scenario's runs in one process over the whole global
    batch."""
    out = {}
    cfg = train_cfg(root, "single")
    out["losses"], out["trained"], _ = run(cfg, global_batch(cfg, 1), 2,
                                           init)
    out["checkpoint"] = checkpoint_layout(Path(root) / "single" / "latest")
    cfg_a = train_cfg(root, "single-accum", accum=2, steps=1)
    out["accum_losses"], out["accum_trained"], _ = run(
        cfg_a, global_batch(cfg_a, 2), 1, init)
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


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--scenario", choices=("train", "calvin",
                                               "one_rank"))
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
        else:
            result = calvin_scenario(args)
    torch.save(result, Path(args.out) / f"rank{args.rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
