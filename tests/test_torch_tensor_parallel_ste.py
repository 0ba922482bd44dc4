"""The "tensor" mesh axis on the straight-through recipe, on the CPU over
gloo: the tiny VLA's LoRA recipe over the int8 base in fp32 with head
noise on the meshes (1, 1, 2), (1, 1, 4), (2, 1, 2) and (1, 2, 2), 2 steps
each, every frozen Dense on the straight-through w8a8 product
(act_int8_min_dim 1: the split products' int32 sums, the column splits'
dx under recompute, inside whole train steps), against the JAX package's
train step on a JAX mesh of the same shape and against the port in one
process at the same act_int8_min_dim: at step 0, at RESULT_ATOL in the
loss and STE_GRAD_RTOL in the gradients (int8 rounding flips:
``tests/torch_tensor_modes.py``). On (1, 2, 2) each rank holds only its
parts of the int8 base on "fsdp" (``weight_q``, ``weight_qt`` and a row
split's ``weight_qk``; a column split's ``weight_q`` on its in dim). The
weight-only twins of these modes are in ``test_torch_tensor_parallel.py``.
"""

import pytest

from tests import torch_tensor_modes as tm


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(the init's directory and float state, the started gloo groups of
    STE_MODES, the JAX package's runs of them)."""
    yield from tm.start_reference(tmp_path_factory, tm.STE_MODES)


@pytest.fixture(scope="module")
def one_process_runs(tmp_path_factory, reference):
    return tm.one_process_runs(tmp_path_factory, reference,
                               tm.STE_MODES)


@pytest.fixture(scope="module")
def ranks(reference):
    return tm.ranks_of(reference)


# --- the finetune on a tensor mesh -----------------------------------------

@pytest.mark.parametrize("mode", tm.STE_MODES)
def test_tensor_mesh_training_matches_jax_and_one_process(
        reference, one_process_runs, ranks, mode):
    """2 steps on the mesh against the JAX package's train step on a JAX
    mesh of the same shape and against one process, at the mode's
    act_int8_min_dim (every frozen Dense straight-through, or every one
    weight-only); every rank reads the same losses and holds the same
    whole trained tensors; rank 0 wrote the files one process writes."""
    tm.hold_mesh_training(reference, one_process_runs, ranks, mode)


@pytest.mark.parametrize("mode", ['fsdp_tp_ste'])
def test_int8_placement_is_param_pspec(reference, ranks, mode):
    """On an "fsdp" dim each rank's int8 base is ``param_pspec``'s part
    (after the tensor split): ``weight_q``, and under the straight-through
    product ``weight_qt`` and a row split's ``weight_qk``; on (1, 2, 2)
    some column split's ``weight_q`` is cut on its in dim."""
    tm.hold_int8_mode(reference, ranks, mode)
