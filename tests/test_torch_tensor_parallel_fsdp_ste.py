"""The straight-through recipe of ``test_torch_tensor_parallel_ste.py`` on
(1, 2, 1) and (2, 2, 1) ("fsdp" and HSDP, no tensor split), on the CPU
over gloo, held as the "_ste" tensor meshes are (``tests/
torch_tensor_modes.py``): each rank holds only its parts of the int8 base
on "fsdp" (``weight_q``, ``weight_qt``): test_torch_sharded_training's
``hold_int8_placement``.
"""

import pytest

from tests import torch_tensor_modes as tm


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(the init's directory and float state, the started gloo groups of
    FSDP_STE_MODES, the JAX package's runs of them)."""
    yield from tm.start_reference(tmp_path_factory, tm.FSDP_STE_MODES)


@pytest.fixture(scope="module")
def one_process_runs(tmp_path_factory, reference):
    return tm.one_process_runs(tmp_path_factory, reference,
                               tm.FSDP_STE_MODES)


@pytest.fixture(scope="module")
def ranks(reference):
    return tm.ranks_of(reference)


# --- the finetune on an "fsdp" mesh ----------------------------------------

@pytest.mark.parametrize("mode", tm.FSDP_STE_MODES)
def test_tensor_mesh_training_matches_jax_and_one_process(
        reference, one_process_runs, ranks, mode):
    """2 steps on the mesh against the JAX package's train step on a JAX
    mesh of the same shape and against one process, at the mode's
    act_int8_min_dim (every frozen Dense straight-through, or every one
    weight-only); every rank reads the same losses and holds the same
    whole trained tensors; rank 0 wrote the files one process writes."""
    tm.hold_mesh_training(reference, one_process_runs, ranks, mode)


@pytest.mark.parametrize("mode", ['fsdp_ste', 'hsdp_ste'])
def test_int8_placement_is_param_pspec(reference, ranks, mode):
    """On an "fsdp" dim each rank's int8 base is ``param_pspec``'s part
    (after the tensor split): ``weight_q``, and under the straight-through
    product ``weight_qt`` and a row split's ``weight_qk``; on (1, 2, 2)
    some column split's ``weight_q`` is cut on its in dim."""
    tm.hold_int8_mode(reference, ranks, mode)
