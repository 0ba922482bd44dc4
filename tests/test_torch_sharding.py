"""The port's process groups (parallel/sharding.py) against the JAX
package and against one process, on the CPU; the sharded training runs
against the JAX package's train step are test_torch_sharded_training.py's.

* the placement rule (param_pspec) against the JAX package's for every
  tensor of the tiny VLA, float and train_base_int8 trees, mapped through
  from_jax's names and transposes;
* per-process seeds and local batch sizes against the JAX package's;
* one rank under "data" and under FSDP2 (a group per decoder layer, the
  int8 base held and gathered as parts), the head noise drawn as the
  recipe draws it, bit for bit with no group, weight-only and
  straight-through;
* 2 ranks on "fsdp": an int8 weight cut on its out dim and, where that
  does not divide, on its in dim, bit for bit with the whole one; the
  decoder layers held unsharded at most two at once in the forward, the
  recompute and the backward; the int8 gathers as derived;
* eval_calvin's chains split over 2 ranks and gathered in rank order;
* the "tensor" axis refused, naming its ROADMAP item.

Each multi-process test spawns its ranks (``tests/torch_dist_worker.py``)
on a free port with an overall timeout and asserts every exit code.
"""


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
from vla_adapter_torch.models import layers as tlayers
from vla_adapter_torch.models.vla import VLAModel
from vla_adapter_torch.parallel import sharding as tsh
from vla_adapter_torch.weights import from_jax


# --- the placement rule against the JAX package's ---------------------------

def _jax_shapes(int8: bool):
    from vla_adapter_tpu.data import dummy as jdummy
    from vla_adapter_tpu.models import layers as jlayers
    from vla_adapter_tpu.models.quantize import quantize_params_jax
    from vla_adapter_tpu.models.vla import VLAModel as JaxVLA
    from vla_adapter_tpu.train import partition as jpart

    cfg = tiny_cfg(jc, jk)
    rt = jlayers.Runtime(dtype=jnp.float32, param_dtype=jnp.float32,
                         attn_impl="xla", lora_rank=4, lora_scale=2.0)
    batch = jdummy.make_dummy_batch(cfg, 2, np.random.default_rng(0))
    model = JaxVLA(cfg, rt)
    shapes = jax.eval_shape(
        lambda b: model.init({"params": jax.random.key(0),
                              "noise": jax.random.key(1)}, train=True,
                             **b)["params"],
        {k: jnp.asarray(v) for k, v in batch.items() if k != "actions"})
    if int8:  # the finetune's tree: the frozen base quantized
        trainable, frozen = jpart.split_trainable(shapes, lora_enabled=True)
        shapes = jpart.merge_trees(
            trainable, jax.eval_shape(quantize_params_jax, frozen))
    return jax.tree_util.tree_flatten_with_path(shapes)[0]


def _port_spec(path, name, spec):
    """The JAX spec of one leaf as the port's tensor(s) hold it (from_jax's
    renames and transposes): {port name: spec}, and the axes the port's
    layout cannot hold (a stack's L, a patch kernel's kh/kw/in)."""
    spec = list(spec)
    lost = []
    i = from_jax._scan_axis(path)
    if i is not None and spec.pop(0):
        lost.append("stack")
    if name == "kernel" and len(spec) == 2:
        spec = spec[::-1]
    elif name == "kernel" and len(spec) == 4:
        if any(spec[:3]):
            lost.append("patch")
        spec = [spec[3], None]
    elif name == "kernel_q":
        spec[-2:] = spec[-2:][::-1]
    leaf, _ = from_jax._leaf(name, np.zeros((1,) * max(len(spec), 2)))
    if i is None:
        names = [".".join(path[:-1] + (leaf,))]
    else:
        head, tail = path[:i + 1], path[i + 2:]
        layers = 2  # every stack of the tiny VLA has 2 layers
        names = [".".join(head + (str(k),) + tail[:-1] + (leaf,))
                 for k in range(layers)]
    return {n: tuple(spec) for n in names}, lost


@pytest.mark.parametrize("min_size", [tsh.MIN_FSDP_SIZE, 1],
                         ids=["default", "any-size"])
@pytest.mark.parametrize("tensor", [1, 2])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_param_pspec_matches_jax(int8, tensor, min_size):
    from vla_adapter_tpu.parallel.sharding import param_pspec as jspec

    want, lost = {}, {}
    for path, leaf in _jax_shapes(int8):
        keys = tuple(str(getattr(k, "key", k)) for k in path)
        p = jax.tree_util.keystr(path, simple=True, separator="/")
        spec = tuple(jspec(p, leaf.shape, 2, tensor, min_fsdp_size=min_size))
        names, gone = _port_spec(keys, keys[-1], spec)
        want.update(names)
        if gone:
            lost.update({n: gone for n in names})
    rt = tlayers.Runtime(dtype=torch.float32, param_dtype=torch.float32,
                         lora_rank=4, lora_scale=2.0, weights_int8=int8,
                         act_int8=int8, train_base_int8=int8)
    model = VLAModel(tiny_cfg(tc, tk), rt, device="meta")
    got = tsh.model_pspecs(model, 2, tensor, min_size)
    assert set(got) == set(want)
    differ = {n: (got[n], want[n]) for n in got if got[n] != want[n]}
    assert differ == {}
    # where the JAX rule picks a dim the port's tensor lacks, the port
    # keeps the tensor whole: here only the L of an (L, N) stack (the
    # head's (L, 1) gates; under TP also the int8 scales, whose N is taken)
    params = dict(model.named_parameters())
    assert all(g == ["stack"] and params[n].ndim == 1 and got[n] in
               ((None,), (tsh.TENSOR_AXIS,)) for n, g in lost.items())
    if min_size == 1:
        assert lost
        assert sum(tsh.FSDP_AXIS in s for s in got.values()) > 200
    else:
        assert all(tsh.FSDP_AXIS not in s for s in got.values())
    if tensor == 2:
        assert got["language_model.layers.0.self_attn.q_proj."
                   + ("weight_q" if int8 else "weight")][0] == \
            tsh.TENSOR_AXIS


def test_fsdp_dims_pick_the_rule_dim_at_one_rank():
    """fsdp_dims at fsdp size 1 shards every tensor the rule shards at
    size 2 (and those whose dims 2 does not divide), on the rule's first
    choice, where every dim divides: a Dense weight's out dim (the port's
    dim 0), a LoRA a's rank dim."""
    rt = tlayers.Runtime(dtype=torch.float32, param_dtype=torch.float32,
                         lora_rank=4, lora_scale=2.0)
    model = VLAModel(tiny_cfg(tc, tk), rt, device="meta")
    one = tsh.fsdp_dims(model, 1, min_fsdp_size=1)
    two = {n: s.index(tsh.FSDP_AXIS) for n, s in
           tsh.model_pspecs(model, 2, 1, min_fsdp_size=1).items()
           if tsh.FSDP_AXIS in s}
    assert set(two) < set(one)
    agree = [n for n in two if one[n] == two[n]]
    assert len(agree) > 0.9 * len(two)
    assert one["projector.fc1.weight"] == two["projector.fc1.weight"] == 0
    assert one["action_head.fc_out.weight"] == 0  # out = 7: odd
    assert one["language_model.layers.0.self_attn.q_proj.lora_a"] == 1
    assert tsh.fsdp_dims(model, 1) == {}  # the tiny VLA: all below 2**18


def test_per_process_seed_and_local_batch_match_jax(monkeypatch):
    from vla_adapter_tpu.parallel import sharding as jsh

    for seed in (0, 7, 2 ** 31 - 1):
        for pi in range(4):
            assert tsh.per_process_seed(seed, pi) == \
                jsh.per_process_seed(seed, pi)
    assert tsh.per_process_seed(3) == jsh.per_process_seed(3)
    assert tsh.process_local_batch_size(16) == \
        jsh.process_local_batch_size(16) == 16
    monkeypatch.setattr(tsh, "process_count", lambda: 4)
    monkeypatch.setattr(tsh, "process_index", lambda: 2)
    assert tsh.process_local_batch_size(16) == 4
    assert tsh.per_process_seed(3) == jsh.per_process_seed(3, 2)
    with pytest.raises(AssertionError):
        tsh.process_local_batch_size(10)


# --- gloo runs -----------------------------------------------------------------

def _spawn(tmp_path, scenario: str, world: int):
    """Start every rank, wait for all under one deadline, assert each exit
    code, and return each rank's record."""
    return worker.wait(*worker.start(tmp_path, scenario, world))


def test_one_rank_group_equals_no_group(tmp_path):
    """A one-rank group on "data", and FSDP2 on a one-rank "fsdp" mesh
    (its all-gather and reduce-scatter run), train bit for bit as one
    process without a group, the head noise drawn as the recipe draws
    it."""
    assert worker.train_cfg(tmp_path, "t").model.head.train_noise_std > 0
    (rec,) = _spawn(tmp_path, "one_rank", 1)
    assert rec["fsdp_dtensors"] > 200
    for key in ("data", "fsdp"):
        assert rec[key][0] == rec["alone"][0], key
        for n, v in rec["alone"][1].items():
            assert torch.equal(rec[key][1][n], v), (key, n)


def test_one_rank_group_equals_no_group_ste(tmp_path):
    """As test_one_rank_group_equals_no_group, every frozen Dense on the
    straight-through w8a8 product (act_int8_min_dim 1): under FSDP2 each
    layer gathers its int8 weights for the forward and their transposed
    copies for dx."""
    (rec,) = worker.wait(*worker.start(tmp_path, "one_rank", 1, "fsdp_ste"))
    assert rec["fsdp_dtensors"] > 200 and rec["ste"] > 30
    assert rec["int8_gathers"]["backward"] > 0
    for key in ("data", "fsdp"):
        assert rec[key][0] == rec["alone"][0], key
        for n, v in rec["alone"][1].items():
            assert torch.equal(rec[key][1][n], v), (key, n)


@pytest.fixture(scope="module")
def fsdp_layers(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("layers"), "fsdp_layers", 2)


@pytest.mark.parametrize("case", ["int8/7", "ste/7", "int8/8", "ste/8"])
def test_int8_parts_on_the_rule_dim(fsdp_layers, case):
    """A Dense's int8 weight on 2 "fsdp" ranks: (7, 32) on its in dim (7
    does not divide), (8, 32) on its out dim, weight-only and
    straight-through (whose transposed copy is cut on its dim 0); each
    rank's parts are the whole tensors' slices, and the forward, dx and
    LoRA gradients equal the whole Dense's bit for bit."""
    n = int(case.split("/")[1])
    ste = case.startswith("ste")
    for rank, rec in enumerate(fsdp_layers):
        pair = rec["dense"][case]
        want_dims = {"fc.weight_q": 1 if n % 2 else 0}
        if ste:
            want_dims["fc.weight_qt"] = 0
        assert pair["dims"] == want_dims
        for name, dim in pair["dims"].items():
            whole = pair["whole_int8"][name.split(".")[1]]
            assert torch.equal(pair["parts"][name],
                               whole.chunk(2, dim=dim)[rank]), name
        for key, want in pair["whole"].items():
            assert torch.equal(pair["cut"][key], want), (rank, case, key)


def test_decoder_layer_groups_and_int8_gathers(fsdp_layers):
    """The tiny recipe with 4 decoder layers on 2 "fsdp" ranks, every
    frozen Dense straight-through: each layer is an FSDP2 group of its
    own, at most two are unsharded at once in the forward, the recompute
    and the backward (each phase probed), and the int8 gathers of the step
    are those chip_smoke.expected_int8_gathers derives."""
    for rec in fsdp_layers:
        assert rec["layers"] == rec["decoder_layers"] == \
            worker.PROBE_LAYERS
        assert set(rec["most"]) == {"forward", "recompute", "backward"}
        assert all(1 <= n <= 2 for n in rec["most"].values()), rec["most"]
        gathers = {k: v for k, v in rec["gathers"].items()
                   if k != "checkpoint"}
        assert gathers == rec["expected"]
        assert rec["expected"]["backward"] > 0 and rec["ste"] > 50
        assert rec["loss"] == fsdp_layers[0]["loss"]


def test_eval_calvin_gathers_chains_in_rank_order(tmp_path):
    """5 chains over 2 ranks: rank 0 runs chains 0, 2, 4 and rank 1 chains
    1, 3; every rank reports all 5 depths, rank 0's first."""
    ranks = _spawn(tmp_path, "calvin", 2)
    depth = [worker.chain_depth(c) for c in range(5)]
    assert ranks[0]["local"] == ranks[0]["direct_local"] == depth[0::2]
    assert ranks[1]["local"] == ranks[1]["direct_local"] == depth[1::2]
    for rec in ranks:
        assert rec["gathered"] == depth[0::2] + depth[1::2]
        assert rec["result"]["num_chains"] == 5
        assert rec["result"]["avg_seq_len"] == pytest.approx(np.mean(depth))


# --- refusals --------------------------------------------------------------------

def test_fsdp_axis_needs_a_process_group(tmp_path):
    from vla_adapter_torch.train.loop import finetune

    cfg = worker.train_cfg(tmp_path, "f", mode="fsdp")
    with pytest.raises(ValueError, match="process group"):
        finetune(cfg, device="cpu", max_steps=1)
    with pytest.raises(RuntimeError, match="process group"):
        tsh.create_mesh()


def test_initialize_distributed_never_falls_back_to_gloo(monkeypatch):
    """Without a card, asking for NCCL fails instead of starting gloo;
    without an address nothing starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL needs a card"):
        tsh.initialize_distributed("tcp://localhost:1", 1, 0)
    tsh.initialize_distributed(None)
    assert not tsh.group_initialized()
