"""The runs shared by the tests of the "tensor" mesh axis
(``test_torch_tensor_parallel.py``, ``test_torch_tensor_parallel_ste.py``,
``test_torch_tensor_parallel_fsdp_ste.py``: the modes of
``TENSOR_MODES`` by family, one file each).

Each file's module fixture starts the gloo groups of its own modes only
(``tests/torch_dist_worker.py``) and compiles the JAX package's GSPMD
train steps of those modes beside them, so xdist's ``--dist loadfile``
can put the families on different workers. The bodies of the tests that
every family runs (:func:`hold_mesh_training`, :func:`hold_int8_mode`)
live here, with the tolerances they use.
"""

import concurrent.futures
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vla_adapter_tpu.core.config as jc
import vla_adapter_tpu.core.constants as jk
from tests import torch_dist_worker as worker
from tests.test_torch_sharded_training import (
    RESULT_ATOL,
    TCFG,
    TENSOR_ATOL,
    _jax_runtime,
    _reference_init,
    hold_int8_placement,
)
from vla_adapter_torch.parallel import sharding as tsh
from vla_adapter_torch.weights.from_jax import from_jax_params

# the modes, by family: the weight-only ones, their straight-through
# twins, and the straight-through recipe on "fsdp" and HSDP without a
# tensor split
WEIGHT_ONLY_MODES = ("tp2", "tp4", "dp_tp", "fsdp_tp")
STE_MODES = ("tp2_ste", "tp4_ste", "dp_tp_ste", "fsdp_tp_ste")
FSDP_STE_MODES = ("fsdp_ste", "hsdp_ste")
TENSOR_MODES = WEIGHT_ONLY_MODES + STE_MODES + FSDP_STE_MODES
# fp32 sums over the group in another order than the unsplit product's,
# relative to the largest value compared: a few ulps of 2^-24 per term
DENSE_RTOL = 1e-6
# The straight-through recipe (every frozen Dense requantizing its input
# in the forward and its output gradient in the backward) turns those
# ulps into int8 rounding flips: a value within an ulp of a half level
# rounds one way in one run and the other way in another, which moves it
# by a whole level, 1/127 of its row's largest. On this recipe the port in
# one process and the JAX package read the step-0 loss 1.2e-7 apart but
# their step-0 gradients up to 9.7e-3 of a tensor's largest apart (2.0e-3
# for the split port against one process), and Adam's near-sign first
# update carries a flipped gradient sign into a trained tensor as 2 lr,
# and into the next loss (8.8e-5 apart on (2, 1, 2)): so these runs are
# held at step 0, the loss at RESULT_ATOL and each gradient within
# STE_GRAD_RTOL (two int8 levels) of its tensor's largest value; a sum
# over the group at the wrong scale, or one made twice, moves a gradient
# by its own size.
STE_GRAD_RTOL = 2 / 127


def _jax_train(params, unit, root, modes) -> dict:
    """The JAX package's train step from the float tree ``params`` (its
    frozen base quantized as its finetune quantizes it), 2 steps on a JAX
    mesh of each tensor mode's shape (state and batch placed by its
    ``shard_params``/``shard_batch``); the head's noise is
    ``train_noise_std`` times ``unit``. (Accumulation: the port's one
    process, held against the JAX package's step in
    test_torch_sharded_training, is the reference.)"""
    from vla_adapter_tpu.models import action_head as jah
    from vla_adapter_tpu.models.quantize import quantize_params_jax
    from vla_adapter_tpu.models.vla import VLAModel as JaxVLA
    from vla_adapter_tpu.parallel.sharding import (
        create_mesh,
        shard_batch,
        shard_params,
    )
    from vla_adapter_tpu.train import optim as joptim
    from vla_adapter_tpu.train import partition as jpart
    from vla_adapter_tpu.train import step as jstep

    fixed = types.SimpleNamespace(random=types.SimpleNamespace(
        normal=lambda key, shape, dtype: jnp.asarray(unit, dtype)))
    trainable, frozen = jpart.split_trainable(params, True)
    frozen = jax.jit(quantize_params_jax)(frozen)
    runs = []   # (tag, lowered step, state, batch)
    cfg = worker.train_cfg(root, "jax", C=jc, K=jk)
    tx = joptim.make_optimizer(cfg.optim)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jah, "jax", fixed)
        for tag in modes:
            rt = _jax_runtime(cfg)
            if tag in worker.ACT_INT8_MIN_DIM:
                rt = dataclasses.replace(
                    rt, act_int8_min_dim=worker.ACT_INT8_MIN_DIM[tag])
            step_fn = jax.jit(jstep.make_train_step(JaxVLA(cfg.model, rt),
                                                    tx, cfg))
            mesh = create_mesh(*worker.MODES[tag])
            state = jstep.TrainState(
                step=jnp.zeros((), jnp.int32),
                trainable=shard_params(trainable, mesh),
                frozen=shard_params(frozen, mesh),
                opt_state=jax.tree.map(
                    lambda x: shard_params(x, mesh)
                    if isinstance(x, dict) else x, tx.init(trainable),
                    is_leaf=lambda x: isinstance(x, dict)))
            # every leaf on the mesh (the step count replicated), as the
            # compiled step takes it
            state = jax.device_put(state, jax.tree.map(
                lambda x: x.sharding if isinstance(
                    x.sharding, jax.sharding.NamedSharding)
                else jax.sharding.NamedSharding(
                    mesh, jax.sharding.PartitionSpec()), state))
            batch = shard_batch(jax.tree.map(
                jnp.asarray, worker.global_batch(cfg, 1)), mesh)
            lowered = step_fn.lower(state, batch,
                                    jax.random.key(cfg.seed + 1))
            # the step-0 gradients, as the step takes them, of the
            # straight-through recipes
            grad = None
            if tag in worker.ACT_INT8_MIN_DIM:
                loss_fn = jstep.make_loss_fn(JaxVLA(cfg.model, rt))
                grad = jax.jit(jax.grad(lambda tr, fr, b, r: loss_fn(
                    tr, fr, b, r)[0])).lower(
                        state.trainable, state.frozen, batch,
                        jax.random.fold_in(jax.random.key(cfg.seed + 1), 0))
            runs.append((tag, lowered, grad, state, batch))
    with concurrent.futures.ThreadPoolExecutor(2 * len(runs)) as pool:
        compiled = list(pool.map(lambda lo: lo and lo.compile(),
                                 [lo for r in runs for lo in r[1:3]]))
    out = {}
    for i, (tag, _, _, state, batch) in enumerate(runs):
        step, grad = compiled[2 * i:2 * i + 2]
        rng, losses = jax.random.key(cfg.seed + 1), []
        out[tag] = {}
        if grad is not None:
            out[tag]["first_grads"] = from_jax_params(jax.device_get(grad(
                state.trainable, state.frozen, batch,
                jax.random.fold_in(rng, 0))), TCFG)
        placed = jax.tree.map(lambda x: x.sharding, state)
        for i in range(cfg.optim.max_steps):
            state, m = step(jax.device_put(state, placed), batch,
                            jax.random.fold_in(rng, i))
            losses.append(float(m["loss"]))
        out[tag].update(losses=losses, trained=from_jax_params(
            jax.device_get(state.trainable), TCFG))
    return out


def start_reference(tmp_path_factory, modes):
    """The body of a test file's module fixture ``reference``: (the init's
    directory and float state, the started gloo groups of ``modes``, the
    JAX package's runs of ``modes``); the groups are killed at its end."""
    root = tmp_path_factory.mktemp("ref")
    params, unit = _reference_init(root)
    groups = {mode: worker.start(tmp_path_factory.mktemp(mode), "train",
                                 int(np.prod([abs(d) for d in
                                              worker.MODES[mode]])),
                                 mode, root)
              for mode in modes}
    try:
        yield root, groups, _jax_train(params, unit, root, modes)
    finally:
        for _, procs, _ in groups.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


def one_process_runs(tmp_path_factory, reference, modes):
    """The port's runs in one process, the head noise as the workers', by
    the act_int8_min_dim of ``modes`` (None: the default)."""
    from vla_adapter_torch.models import vla

    root, _, _ = reference
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(vla, "head_noise",
                   worker.fixed_head_noise(np.load(root / "noise.npy")))
        return {d: worker.single_process_runs(
            tmp_path_factory.mktemp("single"),
            torch.load(root / "params.pt"), min_dim=d)
            for d in sorted({worker.ACT_INT8_MIN_DIM.get(m) for m in modes},
                            key=lambda d: -1 if d is None else d)}


def _one_process(one_process_runs, mode):
    return one_process_runs[worker.ACT_INT8_MIN_DIM.get(mode)]


def ranks_of(reference):
    """A test file's ``ranks`` fixture: each mode's rank records, its group
    waited for once."""
    _, groups, _ = reference
    return {}, groups


def _ranks(ranks, mode):
    cache, groups = ranks
    if mode not in cache:
        cache[mode] = worker.wait(*groups[mode])
    return cache[mode]


def _hold_grads(got, want, what):
    """Each gradient within STE_GRAD_RTOL of its tensor's largest value."""
    assert set(got) == set(want)
    for n, v in want.items():
        v = np.asarray(v)
        err = float(np.abs(np.asarray(got[n]) - v).max())
        bound = STE_GRAD_RTOL * float(np.abs(v).max())
        assert err <= bound, (what, n, err, bound)


def _hold(got_losses, got_trained, want_losses, want_trained, what):
    np.testing.assert_allclose(got_losses, want_losses, rtol=0,
                               atol=RESULT_ATOL, err_msg=f"{what} losses")
    assert set(got_trained) == set(want_trained)
    for n, v in want_trained.items():
        np.testing.assert_allclose(
            np.asarray(got_trained[n]), np.asarray(v), rtol=0,
            atol=TENSOR_ATOL, err_msg=f"{what} {n}")


def hold_mesh_training(reference, one_process_runs, ranks, mode):
    """The body of ``test_tensor_mesh_training_matches_jax_and_one_process``
    at ``mode``."""
    _, _, jax_runs = reference
    one_process = _one_process(one_process_runs, mode)
    recs = _ranks(ranks, mode)
    shape = worker.MODES[mode]
    world = int(np.prod(shape))
    first = recs[0]
    for r, rec in enumerate(recs):
        assert (rec["rank"], rec["world"]) == (r, world)
        assert rec["mesh"] == dict(zip(tsh.MESH_AXES, shape))
        assert rec["losses"] == first["losses"]
        for n, v in rec["trained"].items():
            assert torch.equal(first["trained"][n], v), (r, n)
    assert bool(first["tensor_dims"]) == (shape[2] > 1), "the split"
    ste = mode in worker.ACT_INT8_MIN_DIM
    assert (first["ste"] > 0) == ste, (mode, first["ste"])
    jax_run = jax_runs[mode]
    if ste:   # see STE_GRAD_RTOL
        for want in (one_process, jax_run):
            np.testing.assert_allclose(first["losses"][0],
                                       want["losses"][0], rtol=0,
                                       atol=RESULT_ATOL)
        for r, rec in enumerate(recs):
            _hold_grads(rec["first_grads"], one_process["first_grads"],
                        f"{mode} rank {r} vs one process")
        _hold_grads(first["first_grads"], jax_run["first_grads"],
                    f"{mode} vs JAX")
    else:
        _hold(first["losses"], first["trained"], one_process["losses"],
              one_process["trained"], f"{mode} vs one process")
        _hold(first["losses"], first["trained"], jax_run["losses"],
              jax_run["trained"], f"{mode} vs JAX")
    assert first["checkpoint"] == one_process["checkpoint"]
    if mode.startswith("fsdp_tp"):
        # FSDP2 on the local parts, on the dim after the tensor dim
        assert first["fsdp_dims"]
        assert not set(first["fsdp_dims"].items()) & \
            set(first["tensor_dims"].items())


def hold_int8_mode(reference, ranks, mode):
    """The body of ``test_int8_placement_is_param_pspec`` at ``mode``."""
    root, _, _ = reference
    recs = _ranks(ranks, mode)
    leaves = hold_int8_placement(recs, root, mode)
    ste = mode in worker.ACT_INT8_MIN_DIM
    assert ("weight_qt" in leaves) == ste
    assert ("weight_qk" in leaves) == (ste and mode.startswith("fsdp_tp"))
    if mode.startswith("fsdp_tp"):
        assert any(n.endswith(".weight_q") and d == 1
                   for n, (d, _) in recs[0]["int8_parts"]["tensors"].items())
