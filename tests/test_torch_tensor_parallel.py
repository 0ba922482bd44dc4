"""The "tensor" mesh axis of the port (parallel/tensor.py, the split
Dense, attention and head, and the train step's reductions) against the
unsplit Dense, one process and the JAX package's GSPMD train step, on the
CPU over gloo.

* The split Dense at tensor 2, each branch (float, weight-only int8, the
  straight-through w8a8 product) in both modes ("col", "row"), with LoRA
  and bias, against the unsplit Dense of the same weights. The STE base
  product (no LoRA, no bias) is bit for bit in the forward and dx: each
  row's int8 scale is taken over the whole split axis (half the rows peak
  on the other rank's half) and the ranks' int32 partials are summed
  exactly before one dequant; a per-rank scale or a float sum of partials
  fails it. What a split sums in fp32 in another order (the row-split
  float products, ``x[:, lo:hi] @ lora_a[lo:hi]``, the input gradients
  and whole tensors' gradients summed over the group) is held to
  DENSE_RTOL of the largest value; a column split's forward of a float
  or weight-only base adds nothing up across ranks and is bit for bit.
* The tiny VLA's LoRA recipe over the int8 base in fp32 with head noise
  on the meshes (1, 1, 2), (1, 1, 4) (Qwen2's 4/2 and SigLIP's 2 heads are
  not head-aligned there: gathered), (2, 1, 2) and (1, 2, 2), 2 steps each,
  every frozen Dense on the weight-only upcast (the default
  act_int8_min_dim, above the tiny widths), and again ("_ste") every one
  on the straight-through w8a8 product (act_int8_min_dim 1: the split
  products' int32 sums, the column splits' dx under recompute, inside
  whole train steps), against the JAX package's
  train step on a JAX mesh of the same shape and against the port in one
  process at the same act_int8_min_dim: the weight-only runs at
  test_torch_sharded_training's RESULT_ATOL in the losses and TENSOR_ATOL
  in the trained tensors, the straight-through ones at step 0, at
  RESULT_ATOL in the loss and STE_GRAD_RTOL in the gradients (int8
  rounding flips: see there); on (1, 1, 2) also 2-way
  accumulation against one process, a checkpoint resumed bit for bit,
  the checkpoint loaded by one process, and each rank's parts of the
  frozen base equal to ``param_pspec``'s slices of the whole quantized
  tensors.
* The straight-through recipe also on (1, 2, 1) and (2, 2, 1) ("fsdp"
  and HSDP, no tensor split), held as the "_ste" tensor meshes are. On
  every mesh with an "fsdp" dim each rank holds only its parts of the
  int8 base on "fsdp" (``weight_q``, ``weight_qt`` and a row split's
  ``weight_qk``; on (1, 2, 2) a column split's ``weight_q`` on its in
  dim): test_torch_sharded_training's ``hold_int8_placement``.
* A tensor group's ranks draw the same rows, other ("data", "fsdp")
  coordinates other rows.

The JAX package's steps compile beside the gloo groups, which start as
soon as the init is written; each group runs under one deadline.
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

TENSOR_MODES = ("tp2", "tp4", "dp_tp", "fsdp_tp", "tp2_ste", "tp4_ste",
                "dp_tp_ste", "fsdp_tp_ste", "fsdp_ste", "hsdp_ste")
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


def _jax_train(params, unit, root) -> dict:
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
        for tag in TENSOR_MODES:
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


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(the init's directory and float state, the started gloo groups by
    mode, the JAX package's runs)."""
    root = tmp_path_factory.mktemp("ref")
    params, unit = _reference_init(root)
    groups = {mode: worker.start(tmp_path_factory.mktemp(mode), "train",
                                 int(np.prod([abs(d) for d in
                                              worker.MODES[mode]])),
                                 mode, root)
              for mode in TENSOR_MODES}
    try:
        yield root, groups, _jax_train(params, unit, root)
    finally:
        for _, procs, _ in groups.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


@pytest.fixture(scope="module")
def one_process_runs(tmp_path_factory, reference):
    """The port's runs in one process, the head noise as the workers', by
    act_int8_min_dim (None: the default)."""
    from vla_adapter_torch.models import vla

    root, _, _ = reference
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(vla, "head_noise",
                   worker.fixed_head_noise(np.load(root / "noise.npy")))
        return {d: worker.single_process_runs(
            tmp_path_factory.mktemp("single"),
            torch.load(root / "params.pt"), min_dim=d)
            for d in (None, worker.STE_MIN_DIM)}


def _one_process(one_process_runs, mode):
    return one_process_runs[worker.ACT_INT8_MIN_DIM.get(mode)]


@pytest.fixture(scope="module")
def ranks(reference):
    """Each mode's rank records (its group waited for once)."""
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


# --- the split Dense -----------------------------------------------------------

def _dense_pairs(ranks):
    return [(r, rec["dense"]) for r, rec in enumerate(_ranks(ranks, "tp2"))]


def _expect(pair, mode, key):
    """The unsplit Dense's value this rank's split one should hold: a
    column split's output columns, a row split's input columns of dx."""
    lo, hi = pair["range"]
    want = pair["whole"][key]
    if (mode, key) in (("col", "y"), ("row", "dx")):
        return want[:, lo:hi]
    return want


@pytest.mark.parametrize("base", ["ste_base", "ste_base_k24"])
@pytest.mark.parametrize("mode", ["col", "row"])
def test_split_ste_base_is_bit_for_bit(ranks, mode, base):
    """The STE base product split over 2 ranks, forward and dx, equals the
    unsplit Dense bit for bit, rows peaking on either rank's half, at K 32
    (halves of 16) and K 24 (halves of 12, zero-padded to 16)."""
    for rank, dense in _dense_pairs(ranks):
        pair = dense[f"{base}/{mode}"]
        # its transposed and padded int8 copies are no state of the model
        assert pair["split"]["state"] == pair["whole"]["state"]
        for key in ("y", "dx"):
            got, want = pair["split"][key], _expect(pair, mode, key)
            assert torch.equal(got, want), (rank, mode, key,
                                            (got - want).abs().max())


@pytest.mark.parametrize("branch", worker.DENSE_BRANCHES)
@pytest.mark.parametrize("mode", ["col", "row"])
def test_split_dense_matches_unsplit(ranks, branch, mode):
    """Every branch with LoRA and bias, both modes: forward, dx and the
    gradients of bias, lora_a and lora_b within DENSE_RTOL of the largest
    value; a column split's forward sums nothing over the group and is bit
    for bit."""
    for rank, dense in _dense_pairs(ranks):
        pair = dense[f"{branch}/{mode}"]
        for key in ("y", "dx", "bias", "lora_a", "lora_b"):
            got, want = pair["split"][key], _expect(pair, mode, key)
            assert got.shape == want.shape, (key, got.shape, want.shape)
            if (mode, key) == ("col", "y"):
                assert torch.equal(got, want), (rank, branch,
                                                (got - want).abs().max())
            bound = DENSE_RTOL * float(want.abs().max())
            err = float((got - want).abs().max())
            assert err <= bound, (rank, branch, mode, key, err, bound)


# --- the finetune on a tensor mesh -----------------------------------------------

@pytest.mark.parametrize("mode", TENSOR_MODES)
def test_tensor_mesh_training_matches_jax_and_one_process(
        reference, one_process_runs, ranks, mode):
    """2 steps on the mesh against the JAX package's train step on a JAX
    mesh of the same shape and against one process, at the mode's
    act_int8_min_dim (every frozen Dense straight-through, or every one
    weight-only); every rank reads the same losses and holds the same
    whole trained tensors; rank 0 wrote the files one process writes."""
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


def test_tensor_accumulation_and_resume(one_process_runs, ranks):
    """tensor 2: one step with 2-way accumulation and a bf16 carry against
    one process (itself held against the JAX package's step in
    test_torch_sharded_training); a checkpoint written under the group,
    resumed on it, bit for bit with the unbroken run."""
    one_process = _one_process(one_process_runs, "tp2")
    for rec in _ranks(ranks, "tp2"):
        assert rec["resumed_losses"] == rec["losses"][1:]
        for n, v in rec["trained"].items():
            assert torch.equal(rec["resumed"][n], v), n
        _hold(rec["accum_losses"], rec["accum_trained"],
              one_process["accum_losses"], one_process["accum_trained"],
              "tp2 accumulation vs one process")


def test_tensor_checkpoint_loads_in_one_process(reference, ranks,
                                                tmp_path):
    """The checkpoint rank 0 wrote at tensor 2 loads into one process's
    training state: its trained tensors are the group's whole ones."""
    from vla_adapter_torch.models.vla import VLAModel
    from vla_adapter_torch.train.checkpoints import load_checkpoint
    from vla_adapter_torch.train.loop import build_runtime, initial_state
    from vla_adapter_torch.train.optim import make_optimizer
    from vla_adapter_torch.train.step import init_train_state

    root, groups, _ = reference
    first = _ranks(ranks, "tp2")[0]
    cfg = worker.train_cfg(tmp_path, "load")
    rt = build_runtime(cfg)
    model = VLAModel(cfg.model, rt, device="meta")
    model.load_state_dict(initial_state(cfg, rt, "cpu",
                                        torch.load(root / "params.pt")),
                          strict=True, assign=True)
    tx = make_optimizer(cfg.optim)
    state = init_train_state(model, tx, cfg.lora.enabled)
    out = groups["tp2"][0]
    load_checkpoint(out / "runs" / "tp2-full" / "latest", state)
    assert state.step == 2
    for n, v in first["trained"].items():
        assert torch.equal(state.trainable[n].detach(), v), n


def test_tensor_placement_is_param_pspec(reference, ranks):
    """Each rank's part of every split tensor is ``param_pspec``'s slice of
    the whole quantized one (a row split's ``weight_scale`` whole, a
    column split's sliced with its weight); the head's K/V stacks, biases
    and LoRA tensors stay whole; the gradients summed over the group are
    those of the column splits' bias, lora_a and lora_b, the row splits'
    lora_a and the head blocks' gates."""
    from vla_adapter_torch.models.vla import VLAModel
    from vla_adapter_torch.train.loop import build_runtime, initial_state

    root, _, _ = reference
    cfg = worker.train_cfg(root, "whole", "tp2")
    rt = build_runtime(cfg)
    whole = initial_state(cfg, rt, "cpu", torch.load(root / "params.pt"))
    meta = VLAModel(cfg.model, rt, device="meta")
    specs = tsh.model_pspecs(meta, 1, 2)
    for r, rec in enumerate(_ranks(ranks, "tp2")):
        split = rec["tensor_dims"]
        assert split == {n: s.index("tensor") for n, s in specs.items()
                         if "tensor" in s}
        for n, part in rec["local_frozen"].items():
            want = whole[n]
            if n in split:
                want = want.chunk(2, dim=split[n])[r]
            assert torch.equal(part, want), (r, n)
        for n, shape in rec["local_shapes"].items():
            want = list(whole[n].shape)
            if n in split:
                want[split[n]] //= 2
            assert list(shape) == want, (r, n, shape)
        names = set(rec["local_shapes"])
        assert any(n.endswith("o_proj.weight_q") for n in split)
        assert any(n.endswith("fc_in.weight") for n in split)
        assert any(n.endswith("down_proj.weight_scale") for n in names
                   if n not in split)
        assert any("k_adapter" in n for n in names)
        for n in names:
            if any(s in n for s in ("k_adapter", "v_task", "bias",
                                    "lora_")):
                assert n not in split, n
        partial = rec["partial"]
        assert any(n.endswith("gating_factor") for n in partial)
        assert all(n.rsplit(".", 1)[1] in ("bias", "lora_a", "lora_b",
                                           "gating_factor")
                   for n in partial)
        assert any(n.endswith("o_proj.lora_a") for n in partial)
        assert not any(n.endswith("o_proj.lora_b") for n in partial)


def test_tensor_group_shares_rows(monkeypatch):
    """Ranks (t = 0, 1) of a tensor group of 2 draw the same dummy rows;
    the next ("data", "fsdp") coordinate draws others; each draws the
    global batch over (data x fsdp)."""
    from vla_adapter_torch.data.dummy import DummyDataset
    from vla_adapter_torch.train.step import noise_generator

    monkeypatch.setattr(tsh, "process_count", lambda: 4)
    assert tsh.process_local_batch_size(8, tensor=2) == 4
    assert tsh.process_local_batch_size(8) == 2
    seeds = [tsh.per_process_seed(3, rank=r, tensor=2) for r in range(4)]
    assert seeds[0] == seeds[1] != seeds[2] == seeds[3]

    def first(seed):
        return next(iter(DummyDataset(TCFG, 4, seed=seed)))

    a, b, c = first(seeds[0]), first(seeds[1]), first(seeds[2])
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["pixel_values"], c["pixel_values"])
    # the head's noise depends on (seed, step, micro-batch) alone
    draws = [torch.randn(5, generator=noise_generator(3, 1, 0, "cpu"))
             for _ in range(2)]
    assert torch.equal(*draws)


def test_tensor_axis_needs_a_process_group(tmp_path):
    from vla_adapter_torch.train.loop import finetune

    cfg = worker.train_cfg(tmp_path, "t", mode="tp2")
    with pytest.raises(ValueError, match="process group"):
        finetune(cfg, device="cpu", max_steps=1)


@pytest.mark.parametrize("mode", ["fsdp_tp", "fsdp_tp_ste", "fsdp_ste",
                                  "hsdp_ste"])
def test_int8_placement_is_param_pspec(reference, ranks, mode):
    """On an "fsdp" dim each rank's int8 base is ``param_pspec``'s part
    (after the tensor split): ``weight_q``, and under the straight-through
    product ``weight_qt`` and a row split's ``weight_qk``; on (1, 2, 2)
    some column split's ``weight_q`` is cut on its in dim."""
    root, _, _ = reference
    recs = _ranks(ranks, mode)
    leaves = hold_int8_placement(recs, root, mode)
    ste = mode in worker.ACT_INT8_MIN_DIM
    assert ("weight_qt" in leaves) == ste
    assert ("weight_qk" in leaves) == (ste and mode.startswith("fsdp_tp"))
    if mode.startswith("fsdp_tp"):
        assert any(n.endswith(".weight_q") and d == 1
                   for n, (d, _) in recs[0]["int8_parts"]["tensors"].items())
