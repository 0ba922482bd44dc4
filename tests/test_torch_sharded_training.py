"""The port's multi-process training (parallel/sharding.py, the
multi-process parts of train/) against the JAX package's train step and
against one process, on the CPU.

The tiny VLA's LoRA recipe over the int8 base, in fp32, with the recipe's
head noise, starts from one float init of the JAX package's (every leaf
seeded, the LoRA b zero as the recipe starts them). The reference is the JAX
package's train step on the global batch of 8: 2 steps, and one step with
2-way accumulation and a bf16 carry. Held against it, at RESULT_ATOL in
the losses and TENSOR_ATOL in the trained tensors:

* the port's finetune in one process;
* its gloo runs, each rank fed its rows of the global batch: 2 ranks on
  "data", 2 on "fsdp" (FSDP2), 4 on (2, 2) (HSDP). They are also held
  against the one-process run, every rank reads the same metrics, a
  checkpoint written under the group is resumed bit for bit, and rank 0
  writes the files one process writes.

Both packages' heads add ``train_noise_std`` times one shared N(0, 1)
draw (their generators differ; test_torch_sharding.py's one-rank runs
draw the noise as the recipe does). The gloo groups start, on free ports,
as soon as the init is written and run beside the JAX package's steps;
each test asserts its ranks' exit codes under one overall timeout.
"""

import concurrent.futures
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vla_adapter_torch.core.config as tc
import vla_adapter_torch.core.constants as tk
import vla_adapter_tpu.core.config as jc
import vla_adapter_tpu.core.constants as jk
from tests import torch_dist_worker as worker
from tests.torch_tiny import tiny_cfg
from vla_adapter_torch.parallel import sharding as tsh
from vla_adapter_torch.weights.from_jax import from_jax_params

RESULT_ATOL = 1e-5   # losses against one process or the JAX package (fp32)
TENSOR_ATOL = 1e-4   # trained tensors: Adam's first step is near sign(g)
TCFG = tiny_cfg(tc, tk)
GROUPS = {"data": 2, "fsdp": 2, "hsdp": 4}   # mode: ranks


def _jax_runtime(cfg):
    """The JAX package's finetune Runtime in fp32, with XLA attention and
    no recompute (which changes no value and slows the compile here)."""
    from vla_adapter_tpu.train import loop as jloop

    return dataclasses.replace(jloop.build_runtime(cfg), dtype=jnp.float32,
                               attn_impl="xla", remat=False)


def _reference_init(root):
    """The float tree the runs start from, and the unit noise; both
    written to ``root`` for the workers. The tree has the shapes of the
    JAX package's init_train_state (traced, not run) and seeded values:
    zero for a LoRA b (as the recipe starts), N(0, 1) / sqrt(fan in) for
    any other matrix, 1 + N(0, 0.05) for a norm scale, N(0, 0.05) for the
    rest."""
    from vla_adapter_tpu.models.vla import VLAModel as JaxVLA
    from vla_adapter_tpu.train import loop as jloop
    from vla_adapter_tpu.train import optim as joptim
    from vla_adapter_tpu.train import partition as jpart
    from vla_adapter_tpu.train import step as jstep

    cfg = worker.train_cfg(root, "jax", C=jc, K=jk)
    example = {k: jnp.asarray(v) for k, v in
               worker.global_batch(cfg, 1).items()}
    shapes = jax.eval_shape(lambda b, key: jstep.init_train_state(
        JaxVLA(cfg.model, jloop.float_twin(_jax_runtime(cfg))),
        joptim.make_optimizer(cfg.optim), b, key, lora_enabled=True),
        example, jax.random.key(cfg.seed))
    rng = np.random.default_rng(1)

    def value(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        x = rng.normal(size=leaf.shape).astype(np.float32)
        if name == "lora_b":
            return np.zeros(leaf.shape, np.float32)
        if len(leaf.shape) >= 2:
            return x / np.float32(np.sqrt(leaf.shape[-2]))
        return (1 + 0.05 * x) if name == "scale" else 0.05 * x

    params = jax.tree_util.tree_map_with_path(
        value, jpart.merge_trees(shapes.trainable, shapes.frozen))
    consts = TCFG.constants
    unit = np.random.default_rng(2).normal(size=(
        consts.num_actions_chunk,
        consts.action_dim * TCFG.llm.hidden_size)).astype(np.float32)
    torch.save(from_jax_params(params, TCFG), root / "params.pt")
    np.save(root / "noise.npy", unit)
    return params, unit


def _jax_train(params, unit, root) -> dict:
    """The JAX package's train step from the float tree ``params`` (its
    frozen base quantized as its finetune quantizes it) over the global
    batch: 2 steps, and one step with 2-way accumulation; its head's noise
    is ``train_noise_std`` times ``unit``."""
    from vla_adapter_tpu.models import action_head as jah
    from vla_adapter_tpu.models.quantize import quantize_params_jax
    from vla_adapter_tpu.models.vla import VLAModel as JaxVLA
    from vla_adapter_tpu.train import optim as joptim
    from vla_adapter_tpu.train import partition as jpart
    from vla_adapter_tpu.train import step as jstep

    fixed = types.SimpleNamespace(random=types.SimpleNamespace(
        normal=lambda key, shape, dtype: jnp.asarray(unit, dtype)))
    trainable, frozen = jpart.split_trainable(params, True)
    frozen = jax.jit(quantize_params_jax)(frozen)
    runs = []   # (tag, cfg, lowered step, state, batch)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jah, "jax", fixed)
        for accum, steps, tag in ((1, 2, ""), (2, 1, "accum_")):
            cfg = worker.train_cfg(root, "jax", accum=accum, steps=steps,
                                   C=jc, K=jk)
            tx = joptim.make_optimizer(cfg.optim)
            state = jstep.TrainState(
                step=jnp.zeros((), jnp.int32), trainable=trainable,
                frozen=frozen, opt_state=tx.init(trainable))
            batch = jax.tree.map(jnp.asarray, worker.global_batch(cfg, accum))
            lowered = jax.jit(jstep.make_train_step(
                JaxVLA(cfg.model, _jax_runtime(cfg)), tx, cfg)).lower(
                    state, batch, jax.random.key(cfg.seed + 1))
            runs.append((tag, cfg, lowered, state, batch))
    # the two compiles side by side (XLA's, outside the interpreter lock)
    with concurrent.futures.ThreadPoolExecutor(len(runs)) as pool:
        compiled = list(pool.map(lambda r: r[2].compile(), runs))
    out = {}
    for (tag, cfg, _, state, batch), step in zip(runs, compiled):
        rng, losses = jax.random.key(cfg.seed + 1), []
        for i in range(cfg.optim.max_steps):
            state, m = step(state, batch, jax.random.fold_in(rng, i))
            losses.append(float(m["loss"]))
        out[tag + "losses"] = losses
        out[tag + "trained"] = from_jax_params(state.trainable, TCFG)
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(the directory of the init and the noise, the started gloo groups
    by mode, the JAX package's runs)."""
    root = tmp_path_factory.mktemp("ref")
    params, unit = _reference_init(root)
    groups = {mode: worker.start(tmp_path_factory.mktemp(mode), "train",
                                 world, mode, root)
              for mode, world in GROUPS.items()}
    try:
        yield root, groups, _jax_train(params, unit, root)
    finally:
        for _, procs, _ in groups.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


@pytest.fixture(scope="module")
def one_process(tmp_path_factory, reference):
    """The port's runs in one process, the head noise as the workers'."""
    from vla_adapter_torch.models import vla

    root, _, _ = reference
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(vla, "head_noise",
                   worker.fixed_head_noise(np.load(root / "noise.npy")))
        return worker.single_process_runs(tmp_path_factory.mktemp("single"),
                                          torch.load(root / "params.pt"))


def _hold_to(got, want, what):
    """Losses within RESULT_ATOL and trained tensors within TENSOR_ATOL of
    ``want``'s, for the 2-step and the accumulation runs."""
    for tag in ("", "accum_"):
        np.testing.assert_allclose(got[tag + "losses"], want[tag + "losses"],
                                   rtol=0, atol=RESULT_ATOL,
                                   err_msg=f"{what} {tag}losses")
        assert set(got[tag + "trained"]) == set(want[tag + "trained"])
        for n, v in want[tag + "trained"].items():
            np.testing.assert_allclose(
                got[tag + "trained"][n].numpy(), np.asarray(v), rtol=0,
                atol=TENSOR_ATOL, err_msg=f"{what} {tag}{n}")


def test_one_process_matches_jax(reference, one_process):
    """The port's finetune in one process against the JAX package's train
    step, with and without accumulation, the head noise on."""
    _, _, jax_runs = reference
    assert TCFG.head.train_noise_std > 0
    _hold_to(one_process, jax_runs, "one process vs JAX")


@pytest.mark.parametrize("mode", list(GROUPS))
def test_gloo_training_matches_one_process(reference, one_process, mode):
    _, groups, jax_runs = reference
    world = GROUPS[mode]
    ranks = worker.wait(*groups[mode])
    first = ranks[0]
    for r, rec in enumerate(ranks):
        assert (rec["rank"], rec["world"]) == (r, world)
        assert rec["mesh"] == dict(zip(tsh.MESH_AXES, {
            "data": (world, 1, 1), "fsdp": (1, world, 1),
            "hsdp": (2, 2, 1)}[mode]))
        # every rank reads the global batch's metrics
        assert rec["losses"] == first["losses"]
        assert rec["accum_losses"] == first["accum_losses"]
        # a checkpoint written under the group, resumed on it, bit for bit
        assert rec["resumed_losses"] == rec["losses"][1:]
        for n, v in rec["trained"].items():
            assert torch.equal(rec["resumed"][n], v), n
            assert torch.equal(first["trained"][n], v), n
    _hold_to(first, one_process, f"{mode} vs one process")
    _hold_to(first, jax_runs, f"{mode} vs JAX")
    if mode == "data":
        assert first["dtensors"] == [] and first["sharded"] == []
    else:
        # FSDP2 holds every float tensor the rule shards, frozen ones and
        # the int8 scales included; the int8 weights stay whole
        assert first["dtensors"] == first["sharded"]
        assert any(n.endswith("weight_scale") for n in first["sharded"])
        assert not any(n.endswith("weight_q") for n in first["sharded"])
        n_int8, whole = first["int8"]
        assert whole == n_int8 > 0
        assert len(first["sharded"]) > 200
    # rank 0 wrote the files one process writes, with the same tensors
    assert first["checkpoint"] == one_process["checkpoint"]
