"""The "tensor" mesh axis of the port (parallel/tensor.py, the split
Dense, attention and head, and the train step's reductions) against the
unsplit Dense, one process and the JAX package's GSPMD train step, on the
CPU over gloo: the weight-only modes. Their straight-through twins are in
``test_torch_tensor_parallel_ste.py``, the straight-through recipe on
"fsdp" and HSDP in ``test_torch_tensor_parallel_fsdp_ste.py``; the runs
all three share, and their tolerances, in ``tests/torch_tensor_modes.py``.

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
  act_int8_min_dim, above the tiny widths), against the JAX package's
  train step on a JAX mesh of the same shape and against the port in one
  process: test_torch_sharded_training's RESULT_ATOL in the losses and
  TENSOR_ATOL in the trained tensors; on (1, 1, 2) also 2-way
  accumulation against one process, a checkpoint resumed bit for bit,
  the checkpoint loaded by one process, and each rank's parts of the
  frozen base equal to ``param_pspec``'s slices of the whole quantized
  tensors. On (1, 2, 2) each rank holds only its parts of the int8 base
  on "fsdp" (``weight_q``; a column split's on its in dim):
  test_torch_sharded_training's ``hold_int8_placement``.
* A tensor group's ranks draw the same rows, other ("data", "fsdp")
  coordinates other rows.

The JAX package's steps compile beside the gloo groups, which start as
soon as the init is written; each group runs under one deadline.
"""

import numpy as np
import pytest
import torch

from tests import torch_dist_worker as worker
from tests import torch_tensor_modes as tm
from tests.test_torch_sharded_training import TCFG
from tests.torch_tensor_modes import DENSE_RTOL, _hold, _one_process, _ranks
from vla_adapter_torch.parallel import sharding as tsh


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(the init's directory and float state, the started gloo groups of
    WEIGHT_ONLY_MODES, the JAX package's runs of them)."""
    yield from tm.start_reference(tmp_path_factory, tm.WEIGHT_ONLY_MODES)


@pytest.fixture(scope="module")
def one_process_runs(tmp_path_factory, reference):
    return tm.one_process_runs(tmp_path_factory, reference,
                               tm.WEIGHT_ONLY_MODES)


@pytest.fixture(scope="module")
def ranks(reference):
    return tm.ranks_of(reference)


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

@pytest.mark.parametrize("mode", tm.WEIGHT_ONLY_MODES)
def test_tensor_mesh_training_matches_jax_and_one_process(
        reference, one_process_runs, ranks, mode):
    """2 steps on the mesh against the JAX package's train step on a JAX
    mesh of the same shape and against one process, at the mode's
    act_int8_min_dim (every frozen Dense straight-through, or every one
    weight-only); every rank reads the same losses and holds the same
    whole trained tensors; rank 0 wrote the files one process writes."""
    tm.hold_mesh_training(reference, one_process_runs, ranks, mode)


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


@pytest.mark.parametrize("mode", ['fsdp_tp'])
def test_int8_placement_is_param_pspec(reference, ranks, mode):
    """On an "fsdp" dim each rank's int8 base is ``param_pspec``'s part
    (after the tensor split): ``weight_q``, and under the straight-through
    product ``weight_qt`` and a row split's ``weight_qk``; on (1, 2, 2)
    some column split's ``weight_q`` is cut on its in dim."""
    tm.hold_int8_mode(reference, ranks, mode)
