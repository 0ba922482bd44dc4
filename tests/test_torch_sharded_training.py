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
  writes the files one process writes. Under "fsdp" and HSDP each rank
  holds only its part of every int8 weight the rule shards
  (:func:`hold_int8_placement`), and the checkpoint loads in one process
  with the whole frozen base, whose merged model serves what one
  process's does.

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
from vla_adapter_torch.ops.w8a8_matmul import pad_k
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


_WAITED = {}


def _waited(groups, mode):
    """The rank records of ``mode``'s group, waited for once."""
    if mode not in _WAITED:
        _WAITED[mode] = worker.wait(*groups[mode])
    return _WAITED[mode]


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
    ranks = _waited(groups, mode)
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
        # the int8 scales included; each int8 weight the rule shards is
        # held as this rank's part of it, outside FSDP2
        assert first["dtensors"] == first["sharded"]
        assert any(n.endswith("weight_scale") for n in first["sharded"])
        assert not any(n.endswith("weight_q") for n in first["sharded"])
        assert len(first["sharded"]) > 200
        hold_int8_placement(ranks, reference[0], mode)
    # rank 0 wrote the files one process writes, with the same tensors
    assert first["checkpoint"] == one_process["checkpoint"]


def whole_base(root, mode):
    """The recipe's state as one process builds it (the frozen base
    quantized), and its model on the meta device."""
    from vla_adapter_torch.models.vla import VLAModel
    from vla_adapter_torch.train.loop import build_runtime, initial_state

    cfg = worker.train_cfg(root, "whole", mode)
    rt = build_runtime(cfg)
    return (initial_state(cfg, rt, "cpu", torch.load(root / "params.pt")),
            VLAModel(cfg.model, rt, device="meta"))


def hold_int8_placement(recs, root, mode):
    """Each rank's int8 tensors (``torch_dist_worker.int8_record``) are
    ``param_pspec``'s parts of the whole ones: every ``weight_q`` the rule
    shards on "fsdp" (the workers' MIN_FSDP_SIZE is 1) is cut on the
    rule's dim to 1/F of this rank's "tensor" part, as are its
    ``weight_qt`` (the transposed copy, zero-padded on a column split's
    K, on dim 0 where that divides, else dim 1) and a row split's
    ``weight_qk`` (zero-padded), bit for bit with the slices of the whole
    quantized tensors; the rest are whole."""
    _, fsdp, tensor = worker.MODES[mode]
    whole, meta = whole_base(root, mode)
    specs = tsh.model_pspecs(meta, fsdp, tensor, min_fsdp_size=1)
    ruled = {n: s.index(tsh.FSDP_AXIS) for n, s in specs.items()
             if n.endswith(".weight_q") and tsh.FSDP_AXIS in s}
    assert ruled
    leaves = set()
    for r, rec in enumerate(recs):
        parts = rec["int8_parts"]
        f, t = parts["fsdp_rank"], parts["tensor_rank"]
        tensors = parts["tensors"]
        assert {n for n, (d, _) in tensors.items()
                if n.endswith(".weight_q") and d is not None} == set(ruled)
        split = rec.get("tensor_dims", {})
        for n, (dim, part) in tensors.items():
            base, leaf = n.rsplit(".", 1)
            leaves.add(leaf)
            wq = whole[base + ".weight_q"]
            tdim = split.get(base + ".weight_q")
            if tdim is not None:
                wq = wq.chunk(tensor, dim=tdim)[t]
            want = {"weight_q": wq, "weight_qk": pad_k(wq),
                    "weight_qt": pad_k(wq.t()) if tdim == 0
                    else wq.t().contiguous()}[leaf]
            if dim is None:
                assert base + ".weight_q" not in ruled, (r, n)
                assert torch.equal(part, want), (r, n)
                continue
            if leaf == "weight_qt":
                assert dim == next(d for d in (0, 1)
                                   if want.shape[d] % fsdp == 0), (r, n)
            else:
                assert dim == ruled[base + ".weight_q"], (r, n)
            assert part.numel() * fsdp == want.numel(), (r, n)
            assert torch.equal(part, want.chunk(fsdp, dim=dim)[f]), (r, n)
    return leaves


# The merged models of the "fsdp" checkpoint and of one process's: their
# trained tensors agree within TENSOR_ATOL (Adam's near-sign first step)
# and the frozen base bit for bit; these unnormalized actions (|a| up to
# 4.3) read 2.4e-6 apart on the CPU, well inside TENSOR_ATOL.
SERVE_ATOL = TENSOR_ATOL


def _serve_merged(ckpt, out, stats):
    """train -> merge -> export -> load_vla -> Predictor on the CPU: the
    merge keeps the adapters over the int8 base, which is dequantized and
    folded as phase 19 of chip_smoke.py folds it."""
    from tests.test_torch_predict import _images
    from vla_adapter_torch.data.tokenization import MockTokenizer
    from vla_adapter_torch.models.layers import FP32_RUNTIME
    from vla_adapter_torch.models.lora import merge_lora
    from vla_adapter_torch.models.quantize import dequantize_params
    from vla_adapter_torch.train.checkpoints import load_params
    from vla_adapter_torch.weights.export import export_checkpoint_dir
    from vla_adapter_torch.weights.load import load_vla
    from vla_adapter_torch.weights.merge import merge_checkpoint

    merged = load_params(merge_checkpoint(ckpt, out / "merged", 2.0,
                                          device="cpu"))
    params = merge_lora(dequantize_params(merged), scale=2.0)
    tdir = export_checkpoint_dir({k: v.float() for k, v in params.items()},
                                 TCFG, out / "export", norm_stats=stats)
    tok = MockTokenizer()
    pred = load_vla(tdir, tokenize=lambda t: tok(t).input_ids, device="cpu",
                    rt=FP32_RUNTIME)
    return pred.predict_action(_images(13), "open the drawer",
                               proprio=np.random.default_rng(14).normal(
                                   size=8))


def test_fsdp_checkpoint_loads_in_one_process_and_serves(
        reference, one_process, tmp_path):
    """The checkpoint rank 0 wrote on "fsdp" (each rank holding parts of
    the int8 base) loads into one process's training state: its trained
    tensors are the group's whole ones and its frozen base, gathered
    through ``Sharding.full``, equals one process's bit for bit; merged
    and served through ``load_vla`` it acts as one process's merged
    checkpoint does, within SERVE_ATOL."""
    from tests.test_torch_predict import _stats
    from vla_adapter_torch.models.vla import VLAModel
    from vla_adapter_torch.train.checkpoints import load_checkpoint
    from vla_adapter_torch.train.loop import build_runtime, initial_state
    from vla_adapter_torch.train.optim import make_optimizer
    from vla_adapter_torch.train.step import init_train_state
    from vla_adapter_torch.weights.safetensors_io import load_file

    root, groups, _ = reference
    _waited(groups, "fsdp")
    out = groups["fsdp"][0]
    ckpt = out / "runs" / "fsdp-full" / "latest"
    single = one_process["checkpoint_dir"]
    frozen = load_file(ckpt / "frozen.safetensors")
    want = load_file(single / "frozen.safetensors")
    assert set(frozen) == set(want)
    assert any(k.endswith("weight_q") for k in frozen)
    for k, v in want.items():
        assert torch.equal(frozen[k], v), k
    cfg = worker.train_cfg(tmp_path, "load")
    rt = build_runtime(cfg)
    model = VLAModel(cfg.model, rt, device="meta")
    model.load_state_dict(initial_state(cfg, rt, "cpu",
                                        torch.load(root / "params.pt")),
                          strict=True, assign=True)
    state = init_train_state(model, make_optimizer(cfg.optim),
                             cfg.lora.enabled)
    load_checkpoint(ckpt, state)
    assert state.step == 2
    trained = load_file(ckpt / "trainable.safetensors")
    for n, v in trained.items():
        assert torch.equal(state.trainable[n].detach(), v), n
    stats = _stats()
    got = _serve_merged(ckpt, tmp_path / "fsdp", stats)
    ref = _serve_merged(single, tmp_path / "single", stats)
    assert got.shape == (8, 7) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=SERVE_ATOL)
