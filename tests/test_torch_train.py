"""The port's finetune path against the JAX package's, on the CPU.

The tiny VLA of ``tests/torch_tiny.py`` with LoRA (rank 4, scale 2) in
fp32: the straight-through w8a8 product, the LoRA Dense, the partition,
the schedule and optimizer, the loss, one train step, gradient
accumulation, the dummy batches, a 3-step ``finetune``, checkpoints and
resume, the LoRA merge, and the train -> merge -> export -> ``load_vla`` ->
``Predictor`` chain, each held against the JAX package from the same
weights (carried with ``from_jax_params``) and the same numpy inputs.
The head's training noise is off (``train_noise_std=0``) where the
packages' random draws would differ; its distribution is tested alone.

Tolerances: fp32 summation order through a few layers, 1e-4 (the forward
tests' bound); the integer parts of the w8a8 product are exact and equal
bit for bit. Adam's first updates are ~lr * sign(g), so parameters after a
step are compared at 1e-4 + 1e-4 relative, and so are the losses of later
steps.
"""

import dataclasses
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import vla_adapter_torch.core.config as tc
import vla_adapter_torch.core.constants as tk
import vla_adapter_tpu.core.config as jc
import vla_adapter_tpu.core.constants as jk
from tests.test_torch_predict import _images, _stats
from tests.torch_tiny import tiny_cfg
from vla_adapter_tpu.core import experiments as jexp
from vla_adapter_tpu.data import dummy as jdummy
from vla_adapter_tpu.data.tokenization import MockTokenizer as JaxMockTokenizer
from vla_adapter_tpu.infer.predict import Predictor as JaxPredictor
from vla_adapter_tpu.models import layers as jlayers
from vla_adapter_tpu.models import lora as jlora
from vla_adapter_tpu.models.quantize import quantize_kernel as jquantize
from vla_adapter_tpu.models.vla import VLAModel as JaxVLA
from vla_adapter_tpu.train import loop as jloop
from vla_adapter_tpu.train import optim as joptim
from vla_adapter_tpu.train import partition as jpart
from vla_adapter_tpu.train import step as jstep
from vla_adapter_tpu.train.checkpoints import (
    find_resume_checkpoint as jfind,
    load_params as jload_params,
)
from vla_adapter_tpu.weights import export as jexport
from vla_adapter_tpu.weights import load as jload
from vla_adapter_tpu.weights.merge import merge_checkpoint as jmerge
from vla_adapter_torch.core import experiments as texp
from vla_adapter_torch.data import dummy as tdummy
from vla_adapter_torch.data.tokenization import MockTokenizer
from vla_adapter_torch.models import layers as tlayers
from vla_adapter_torch.models import lora as tlora
from vla_adapter_torch.models.vla import VLAModel, head_noise
from vla_adapter_torch.train import checkpoints as tckpt
from vla_adapter_torch.train import finetune as tfinetune
from vla_adapter_torch.train import loop as tloop
from vla_adapter_torch.train import optim as toptim
from vla_adapter_torch.train import partition as tpart
from vla_adapter_torch.train import step as tstep
from vla_adapter_torch.weights import export as texport
from vla_adapter_torch.weights import load as tload
from vla_adapter_torch.weights.from_jax import (
    from_jax_opt_state,
    from_jax_params,
)
from vla_adapter_torch.weights import merge as tmerge_cli
from vla_adapter_torch.weights.merge import merge_checkpoint as tmerge

ATOL = RTOL = 1e-4
RANK, SCALE = 4, 2.0


def _no_noise(cfg):
    return dataclasses.replace(
        cfg, head=dataclasses.replace(cfg.head, train_noise_std=0.0))


JCFG = _no_noise(tiny_cfg(jc, jk))
TCFG = _no_noise(tiny_cfg(tc, tk))
JRT = jlayers.Runtime(dtype=jnp.float32, param_dtype=jnp.float32,
                      attn_impl="xla", lora_rank=RANK, lora_scale=SCALE)
TRT = tlayers.Runtime(dtype=torch.float32, param_dtype=torch.float32,
                      lora_rank=RANK, lora_scale=SCALE)
OPT = dict(learning_rate=1e-3, max_steps=100, num_steps_before_decay=1000)


def _close(got, want, atol=ATOL, rtol=RTOL, msg=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=msg)


def _flat_names(tree, cfg=TCFG):
    return set(from_jax_params(tree, cfg))


def _jax_init(tx, batch, seed):
    """jstep.init_train_state with the init jitted (the same values)."""
    model = JaxVLA(JCFG, JRT)
    rng = jax.random.key(seed)
    init = jax.jit(lambda b: model.init(
        {"params": rng, "noise": jax.random.fold_in(rng, 1)}, train=True,
        **b)["params"])
    params = init({k: jnp.asarray(v) for k, v in batch.items()
                   if k != "actions"})
    trainable, frozen = jpart.split_trainable(params, lora_enabled=True)
    return jstep.TrainState(step=jnp.zeros((), jnp.int32),
                            trainable=trainable, frozen=frozen,
                            opt_state=tx.init(trainable))


@pytest.fixture(scope="module")
def jax_state():
    """JAX's LoRA train state of the tiny VLA, every leaf perturbed (so
    that lora_b, the queries and the gates are not zero)."""
    batch = jdummy.make_dummy_batch(JCFG, 2, np.random.default_rng(0))
    tx = joptim.make_optimizer(jc.OptimizerConfig(**OPT), warmup_steps=0)
    state = _jax_init(tx, batch, 0)
    rng = np.random.default_rng(1)
    perturb = lambda t: jax.tree.map(  # noqa: E731
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(
            np.float32), t)
    return state.replace(trainable=perturb(state.trainable),
                         frozen=perturb(state.frozen))


@pytest.fixture(scope="module")
def params(jax_state):
    return jpart.merge_trees(jax_state.trainable, jax_state.frozen)


def _port_model(params, cfg=TCFG, rt=TRT):
    model = VLAModel(cfg, rt, device="cpu")
    model.load_state_dict(from_jax_params(params, cfg), strict=True)
    return model


# --- the straight-through w8a8 product -------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ste_forward_and_dx_bit_for_bit(dtype):
    """The port's W8A8STE against the JAX w8a8_matmul_ste: the forward
    and the dx of its straight-through backward, bit for bit."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 7, 48)).astype(np.float32)
    dy = rng.normal(size=(2, 7, 80)).astype(np.float32)
    kq, ks = jquantize(rng.normal(size=(48, 80)).astype(np.float32))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    y_j, vjp = jax.vjp(lambda x_: jlayers.w8a8_matmul_ste(
        x_, jnp.asarray(kq), jnp.asarray(ks)), jnp.asarray(x, jdt))
    dx_j = vjp(jnp.asarray(dy, jdt))[0]

    xt = torch.tensor(x).to(tdt).requires_grad_(True)
    wq = torch.from_numpy(kq.T.copy())
    y_t = tlayers.W8A8STE.apply(xt, wq, torch.from_numpy(ks), None,
                                "kernel")
    (dx_t,) = torch.autograd.grad(y_t, xt, torch.tensor(dy).to(tdt))
    assert y_t.dtype == tdt and dx_t.dtype == tdt
    np.testing.assert_array_equal(y_t.detach().float().numpy(),
                                  np.asarray(y_j, np.float32))
    np.testing.assert_array_equal(dx_t.float().numpy(),
                                  np.asarray(dx_j, np.float32))


# --- the LoRA Dense ------------------------------------------------------------

@pytest.mark.parametrize("base", ["float", "int8_ste", "int8_weight_only"])
def test_lora_dense_forward_and_grads(base):
    """y, dx, d lora_a and d lora_b of a LoRA Dense against the JAX Dense;
    over an int8 base (the STE product, or the weight-only upcast of a
    narrow matmul) too."""
    rng = np.random.default_rng(6)
    din, dout = (32, 48) if base != "int8_weight_only" else (8, 48)
    x = rng.normal(size=(3, 5, din)).astype(np.float32)
    g = rng.normal(size=(3, 5, dout)).astype(np.float32)
    int8 = base != "float"
    kw = dict(weights_int8=int8, act_int8=int8, act_int8_min_dim=16)
    jrt = dataclasses.replace(JRT, train_base_int8=int8, **kw)
    trt = dataclasses.replace(TRT, train_base_int8=int8, **kw)
    jd = jlayers.Dense(dout, rt=dataclasses.replace(
        jrt, train_base_int8=False, weights_int8=False, act_int8=False))
    p = jd.init(jax.random.key(1), jnp.asarray(x))["params"]
    p = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.normal(
        size=a.shape).astype(np.float32), p)
    if int8:  # quantize the base kernel; the adapters stay float
        q, s = jquantize(p.pop("kernel"))
        p.update(kernel_q=q, kernel_scale=s)
    lora = {k: jnp.asarray(p[k]) for k in ("lora_a", "lora_b")}
    rest = {k: jnp.asarray(v) for k, v in p.items() if k not in lora}

    def f(lora_, x_):
        return jnp.sum(jlayers.Dense(dout, rt=jrt).apply(
            {"params": {**rest, **lora_}}, x_) * g)

    loss_j, (gp, gx) = jax.value_and_grad(f, argnums=(0, 1))(
        lora, jnp.asarray(x))

    td = tlayers.Dense(din, dout, rt=trt, device="cpu")
    state = {k.split(".", 1)[1]: v for k, v in
             from_jax_params({"d": p}, TCFG).items()}
    td.load_state_dict(state, strict=True)
    td.lora_a.requires_grad_(True)
    td.lora_b.requires_grad_(True)
    xt = torch.tensor(x, requires_grad=True)
    y = td(xt)
    loss_t = (y * torch.tensor(g)).sum()
    ga, gb, gxt = torch.autograd.grad(loss_t, (td.lora_a, td.lora_b, xt))
    _close(loss_t, loss_j, atol=1e-3)
    _close(gxt, gx, msg="dx")
    _close(ga, gp["lora_a"], msg="lora_a")
    _close(gb, gp["lora_b"], msg="lora_b")


# --- partition -------------------------------------------------------------

def test_split_trainable_names_match_jax(jax_state, params):
    model = VLAModel(TCFG, TRT, device="meta")
    names = tpart.mark_trainable_(model, lora_enabled=True)
    assert set(names) == _flat_names(jax_state.trainable)
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    assert frozen == _flat_names(jax_state.frozen)
    state = from_jax_params(params, TCFG)
    tr, fr = tpart.split_trainable(state, lora_enabled=True)
    assert set(tr) == set(names) and set(fr) == frozen
    assert tpart.merge_trees(tr, fr).keys() == state.keys()
    with pytest.raises(ValueError, match="overlapping"):
        tpart.merge_trees(tr, tr)
    full, none = tpart.split_trainable(state, lora_enabled=False)
    assert set(full) == set(state) and not none


# --- schedule and optimizer -------------------------------------------------

def test_lr_schedule_matches_jax():
    cfg_j = jc.OptimizerConfig(learning_rate=5e-4, num_steps_before_decay=8)
    cfg_t = tc.OptimizerConfig(learning_rate=5e-4, num_steps_before_decay=8)
    for warmup in (0, 5):
        sj = joptim.lr_schedule(cfg_j, warmup)
        st = toptim.lr_schedule(cfg_t, warmup)
        for step in range(12):
            assert np.float32(st(step)) == np.float32(sj(step)), (warmup,
                                                                  step)


# optax's f32 Adam against the port's: the bias corrections' powers
# (numpy float32 here, XLA's pow there) may round an ulp apart, which
# moves an update by a relative ~1e-7; three updates stay within 2e-6.
OPT_RTOL = 2e-6


@pytest.mark.parametrize("variant", ["f32", "bf16_moments", "clip_decay"])
def test_optimizer_matches_optax_over_three_updates(variant):
    kw = dict(learning_rate=1e-2, max_steps=30)
    if variant == "bf16_moments":
        kw["moments_dtype"] = "bfloat16"
    if variant == "clip_decay":
        kw.update(grad_clip_norm=1.0, weight_decay=0.01)
    tx_j = joptim.make_optimizer(jc.OptimizerConfig(**kw))
    tx_t = toptim.make_optimizer(tc.OptimizerConfig(**kw))
    rng = np.random.default_rng(7)
    p = {"a": rng.normal(size=(4, 6)).astype(np.float32),
         "b": rng.normal(size=(5,)).astype(np.float32)}
    pj = jax.tree.map(jnp.asarray, p)
    pt = {k: torch.tensor(v) for k, v in p.items()}
    sj, st = tx_j.init(pj), tx_t.init(pt)
    for _ in range(3):
        g = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in p.items()}
        uj, sj = tx_j.update(jax.tree.map(jnp.asarray, g), sj, pj)
        pj = optax.apply_updates(pj, uj)
        ut, st = tx_t.update({k: torch.tensor(v) for k, v in g.items()},
                             st, pt)
        toptim.apply_updates(pt, ut)
        for k in p:
            _close(pt[k], pj[k], atol=0, rtol=OPT_RTOL, msg=k)
    # the JAX state carried over: the count, and the moments
    carried = from_jax_opt_state(sj, TCFG, st["mu"]["a"].dtype)
    assert int(carried["count"]) == int(st["count"]) == 3
    for part in ("mu", "nu"):
        for k in p:
            assert st[part][k].dtype == (torch.bfloat16 if variant ==
                                         "bf16_moments" else torch.float32)
            _close(st[part][k], carried[part][k].float(), atol=0,
                   rtol=OPT_RTOL)


def test_mask_updates_zeroes_masked_slices():
    tx = toptim.mask_updates(toptim.make_optimizer(tc.OptimizerConfig(
        learning_rate=1e-2, weight_decay=0.1)),
        {"a": torch.tensor([1.0, 0.0])})
    p = {"a": torch.ones(2)}
    u, _ = tx.update({"a": torch.ones(2)}, tx.init(p), p)
    assert u["a"][1] == 0 and u["a"][0] != 0


# --- loss, noise, batches -----------------------------------------------------

def test_l1_action_loss_matches_jax():
    rng = np.random.default_rng(8)
    pred, gt = (rng.normal(size=(3, 8, 7)).astype(np.float32)
                for _ in range(2))
    loss_j, m_j = jstep.l1_action_loss(jnp.asarray(pred), jnp.asarray(gt))
    loss_t, m_t = tstep.l1_action_loss(torch.tensor(pred), torch.tensor(gt))
    _close(loss_t, loss_j, atol=1e-6)
    for k in ("curr_action_l1_loss", "next_actions_l1_loss"):
        _close(m_t[k], m_j[k], atol=1e-6)
    for k in m_j["per_sample"]:
        _close(m_t["per_sample"][k], m_j["per_sample"][k], atol=1e-6)


def test_head_noise_distribution_and_generators():
    """N(0, train_noise_std) over the latents' (chunk, action_dim * D),
    the same draw from the same (seed, step, micro-batch) and another at
    another step."""
    cfg = tiny_cfg(tc, tk)
    gen = lambda s, m=0: tstep.noise_generator(42, s, m, "cpu")  # noqa
    n = head_noise(cfg, gen(3), "cpu")
    assert n.shape == (8, 7 * cfg.llm.hidden_size) and n.dtype == torch.float32
    std = cfg.head.train_noise_std
    assert abs(float(n.mean())) < 0.1 * std
    assert abs(float(n.std()) / std - 1) < 0.1
    assert torch.equal(n, head_noise(cfg, gen(3), "cpu"))
    assert not torch.equal(n, head_noise(cfg, gen(4), "cpu"))
    assert not torch.equal(n, head_noise(cfg, gen(3, 1), "cpu"))


@pytest.mark.parametrize("accum", [None, 2])
def test_dummy_batches_equal(accum):
    jb = iter(jdummy.DummyDataset(JCFG, 4, seed=3, accum_steps=accum))
    tb = iter(tdummy.DummyDataset(TCFG, 4, seed=3, accum_steps=accum))
    for _ in range(2):
        a, b = next(jb), next(tb)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for inference in (False, True):
        a = jdummy.make_dummy_batch(JCFG, 3, np.random.default_rng(1),
                                    inference_layout=inference)
        b = tdummy.make_dummy_batch(TCFG, 3, np.random.default_rng(1),
                                    inference_layout=inference)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# --- one train step, accumulation ----------------------------------------------

def _train_cfgs(accum=1, accum_dtype=None):
    kw = dict(grad_accumulation_steps=accum, accum_dtype=accum_dtype)
    return (jc.TrainConfig(model=JCFG, optim=jc.OptimizerConfig(**OPT), **kw),
            tc.TrainConfig(model=TCFG, optim=tc.OptimizerConfig(**OPT), **kw))


def test_loss_and_grads_match_jax(jax_state):
    """The loss, metrics and every trainable gradient of one batch."""
    batch = jdummy.make_dummy_batch(JCFG, 2, np.random.default_rng(2))
    loss_fn = jstep.make_loss_fn(JaxVLA(JCFG, JRT))
    (loss_j, m_j), g_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax_state.trainable, jax_state.frozen,
        jax.tree.map(jnp.asarray, batch), jax.random.key(0))
    model = _port_model(jpart.merge_trees(jax_state.trainable,
                                          jax_state.frozen))
    names = tpart.mark_trainable_(model, lora_enabled=True)
    params = dict(model.named_parameters())
    loss_t, m_t = tstep.make_loss_fn(model)(tstep.to_device(batch, "cpu"),
                                            None)
    grads = torch.autograd.grad(loss_t, [params[n] for n in names])
    _close(loss_t, loss_j)
    for k in ("curr_action_l1_loss", "next_actions_l1_loss"):
        _close(m_t[k], m_j[k])
    want = from_jax_params(g_j, TCFG)
    assert set(want) == set(names)
    scale = max(float(np.abs(v.numpy()).max()) for v in want.values())
    for n, g in zip(names, grads):
        _close(g, want[n], atol=ATOL * scale, msg=n)


@pytest.mark.parametrize("accum,accum_dtype", [(1, None), (2, None),
                                               (2, "bfloat16")])
def test_train_step_matches_jax(jax_state, accum, accum_dtype):
    """One step (accumulation over 2 micro-batches with an fp32 or a bf16
    carry): metrics, grad norm, updated parameters and optimizer count."""
    jcfg, tcfg = _train_cfgs(accum, accum_dtype)
    batch = jdummy.make_dummy_batch(JCFG, 4, np.random.default_rng(2),
                                    accum if accum > 1 else None)
    tx_j = joptim.make_optimizer(jcfg.optim, warmup_steps=0)
    state_j = jstep.TrainState(step=jnp.zeros((), jnp.int32),
                               trainable=jax_state.trainable,
                               frozen=jax_state.frozen,
                               opt_state=tx_j.init(jax_state.trainable))
    new_j, m_j = jax.jit(jstep.make_train_step(JaxVLA(JCFG, JRT), tx_j,
                                               jcfg))(
        state_j, jax.tree.map(jnp.asarray, batch), jax.random.key(0))

    model = _port_model(jpart.merge_trees(jax_state.trainable,
                                          jax_state.frozen))
    tx_t = toptim.make_optimizer(tcfg.optim, warmup_steps=0)
    state_t = tstep.init_train_state(model, tx_t, lora_enabled=True)
    m_t = tstep.make_train_step(model, tx_t, tcfg)(
        state_t, tstep.to_device(batch, "cpu"), 0)
    for k in ("loss", "curr_action_l1_loss", "next_actions_l1_loss",
              "grad_norm"):
        _close(m_t[k], m_j[k], msg=k)
    assert m_t["per_sample"]["loss"].shape == m_j["per_sample"]["loss"].shape
    assert state_t.step == 1 and int(state_t.opt_state["count"]) == 1
    want = from_jax_params(new_j.trainable, TCFG)
    for n, p in state_t.trainable.items():
        _close(p, want[n], msg=n)


# --- finetune, checkpoints, resume ------------------------------------------------

def _finetune_cfgs(root, **kw):
    common = dict(batch_size=2, data_axis=2, save_freq=2, log_freq=10,
                  remat_llm=True, run_id="tiny")
    common.update(kw)
    return (jc.TrainConfig(model=JCFG, optim=jc.OptimizerConfig(
                max_steps=3, **{k: v for k, v in OPT.items()
                                if k != "max_steps"}),
                run_root_dir=str(root / "jax"), **common),
            tc.TrainConfig(model=TCFG, optim=tc.OptimizerConfig(
                max_steps=3, **{k: v for k, v in OPT.items()
                                if k != "max_steps"}),
                run_root_dir=str(root / "port"), **common))


def _initial_params(jcfg):
    """The float state the JAX finetune starts from: its init_train_state
    on its first dummy batch and seed."""
    from vla_adapter_tpu.parallel.sharding import per_process_seed

    first = next(iter(jdummy.DummyDataset(
        JCFG, jcfg.batch_size, seed=per_process_seed(jcfg.seed))))
    st = _jax_init(joptim.make_optimizer(jcfg.optim), first, jcfg.seed)
    return from_jax_params(jpart.merge_trees(st.trainable, st.frozen), TCFG)


@pytest.fixture(scope="module")
def finetuned(tmp_path_factory):
    """Both packages' 3-step LoRA finetune of the tiny VLA (float base,
    frozen base in bf16, remat) from the same initial weights."""
    root = tmp_path_factory.mktemp("ft")
    jcfg, tcfg = _finetune_cfgs(root)
    losses_j = []
    orig = jloop.Metrics.commit

    def commit(self, **m):
        if "loss" in m:
            losses_j.append(float(m["loss"]))
        return orig(self, **m)

    jloop.Metrics.commit = commit
    try:
        jloop.finetune(jcfg, rt=JRT)
    finally:
        jloop.Metrics.commit = orig
    # the port recomputes the towers' blocks and the decoder's layers
    # (the numbers are the same either way)
    rt = dataclasses.replace(TRT, remat=True, remat_components=("vit", "llm"))
    state = tloop.finetune(tcfg, rt=rt, device="cpu",
                           params=_initial_params(jcfg))
    return root, jcfg, tcfg, losses_j, state


def test_finetune_tracks_jax(finetuned):
    _, _, _, losses_j, state = finetuned
    losses_t = [h["loss"] for h in state.history]
    assert len(losses_t) == len(losses_j) == 3
    _close(np.asarray(losses_t), np.asarray(losses_j))
    assert state.step == 3


def test_finetune_refuses_the_cpu_unless_asked(monkeypatch):
    _, tcfg = _train_cfgs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tloop.finetune(tcfg, max_steps=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmerge("x", "y", 2.0)


def test_checkpoint_round_trip_and_resume(tmp_path, params):
    """4 steps unbroken, and 2 steps then a resume to 4 in another run
    directory: the same losses and weights, bit for bit; the checkpoint
    layout of the JAX package (meta.json last, latest swapped in)."""
    batch = tdummy.make_dummy_batch(TCFG, 2, np.random.default_rng(9))
    init = from_jax_params(params, TCFG)

    def run(root, steps, resume=False):
        cfg = tc.TrainConfig(model=TCFG, optim=tc.OptimizerConfig(**OPT),
                             batch_size=2, save_freq=3, run_id="r",
                             run_root_dir=str(root), log_freq=10)
        return tloop.finetune(cfg, data_iter=itertools.repeat(batch),
                              max_steps=steps, rt=TRT, device="cpu",
                              resume=resume, params=init)

    full = run(tmp_path / "a", 4)
    run(tmp_path / "b", 2)
    ckpt = tckpt.find_resume_checkpoint(tmp_path / "b" / "r")
    assert ckpt.name == "latest"
    assert json.loads((ckpt / "meta.json").read_text()) == {"step": 2}
    resumed = run(tmp_path / "b", 4, resume=True)
    assert [h["step"] for h in resumed.history] == [2, 3]
    assert [h["loss"] for h in resumed.history] == \
        [h["loss"] for h in full.history[2:]]
    for n, p in full.trainable.items():
        assert torch.equal(p, resumed.trainable[n]), n
    for part in ("mu", "nu"):
        for n, v in full.opt_state[part].items():
            assert torch.equal(v, resumed.opt_state[part][n])
    assert not (tmp_path / "b" / "r" / "latest.tmp").exists()
    out = tckpt.save_params(tmp_path / "p", dict(full.trainable))
    back = tckpt.load_params(out)
    assert all(torch.equal(back[k], v) for k, v in full.trainable.items())


# --- LoRA merge ------------------------------------------------------------------

def test_merge_strip_graft_match_jax(params):
    state = from_jax_params(params, TCFG)
    merged_t = tlora.merge_lora(state, SCALE)
    merged_j = from_jax_params(jlora.merge_lora(params, SCALE), TCFG)
    assert set(merged_t) == set(merged_j)
    assert not any("lora" in k for k in merged_t)
    for k, v in merged_j.items():
        _close(merged_t[k], v, atol=1e-6, rtol=1e-6, msg=k)
    stripped = tlora.strip_lora(state)
    assert set(stripped) == set(from_jax_params(jlora.strip_lora(params),
                                                TCFG))
    grafted = tlora.add_lora_params(stripped, state)
    assert set(grafted) == set(state)
    with pytest.raises(ValueError, match="missing"):
        tlora.add_lora_params({}, state)
    with pytest.raises(ValueError, match="do not exist"):
        tlora.add_lora_params(dict(stripped, extra=torch.zeros(1)), state)
    # the merged weights serve what the adapters do
    x = {k: torch.from_numpy(v) for k, v in jdummy.make_dummy_batch(
        JCFG, 2, np.random.default_rng(4)).items() if k != "actions"}
    with torch.no_grad():
        a = _port_model(params)(**x)["actions"]
        plain_rt = dataclasses.replace(TRT, lora_rank=0)
        m = VLAModel(TCFG, plain_rt, device="cpu")
        m.load_state_dict(merged_t, strict=True)
        _close(m(**x)["actions"], a.numpy())


def test_merge_over_an_int8_base_keeps_the_adapters(params):
    """As in the JAX package, only float weights are folded: a quantized
    Dense (weight_q) keeps its adapters."""
    state = from_jax_params(params, TCFG)
    name = "language_model.layers.0.mlp.up_proj"
    w = state.pop(name + ".weight")
    state[name + ".weight_q"] = w.to(torch.int8)
    merged = tlora.merge_lora(state, SCALE)
    assert name + ".lora_a" in merged and name + ".lora_b" in merged
    assert torch.equal(merged[name + ".weight_q"], state[name + ".weight_q"])
    assert "language_model.layers.0.mlp.down_proj.lora_a" not in merged
    jtree = jax.tree.map(np.asarray, params)
    node = jtree["language_model"]["layers"]["layer"]["mlp"]["up_proj"]
    node["kernel_q"] = node.pop("kernel").astype(np.int8)
    jm = jlora.merge_lora(jtree, SCALE)
    assert "lora_a" in jm["language_model"]["layers"]["layer"]["mlp"][
        "up_proj"]


# --- train -> merge -> export -> load_vla -> Predictor ----------------------------

# The trained adapters of the two packages agree to ~1.5e-6, but the merge
# folds them into the frozen base's bf16 weights (frozen_bf16, the
# recipe's), where a difference of 1e-7 flips the rounding of a few
# elements by one bf16 ulp (4.9e-4 at |w| ~ 0.1-0.25); that moves these
# unnormalized actions (|a| <= 3) by ~5.5e-4.
CHAIN_ATOL = 2e-3

def test_train_merge_serve_chain_matches_jax(finetuned, tmp_path):
    root, jcfg, tcfg, _, _ = finetuned
    stats = _stats()
    # JAX: its chain (tests/test_lifecycle.py without the episode)
    jmerged = jmerge(jfind(root / "jax" / "tiny"), tmp_path / "jm",
                     lora_scale=SCALE)
    jparams = jload_params(jmerged)
    jdir = jexport.export_checkpoint_dir(jax.device_get(jparams), JCFG,
                                         tmp_path / "je", norm_stats=stats)
    jtok = JaxMockTokenizer()
    jpred = JaxPredictor(cfg=JCFG, params=jload.load_vla_params(jdir, JCFG),
                         tokenize=lambda t: jtok(t).input_ids,
                         norm_stats=jload.load_norm_stats(jdir),
                         rt=jlayers.FP32_RUNTIME)
    # the port's
    ckpt = tckpt.find_resume_checkpoint(root / "port" / "tiny")
    merged = tckpt.load_params(tmerge(ckpt, tmp_path / "tm", SCALE,
                                      device="cpu"))
    assert not any("lora" in k for k in merged)
    tdir = texport.export_checkpoint_dir(
        {k: v.float() for k, v in merged.items()}, TCFG, tmp_path / "te",
        norm_stats=stats)
    ttok = MockTokenizer()
    tpred = tload.load_vla(tdir, tokenize=lambda t: ttok(t).input_ids,
                           device="cpu", rt=tlayers.FP32_RUNTIME)
    imgs, proprio = _images(13), np.random.default_rng(14).normal(size=8)
    got = tpred.predict_action(imgs, "open the drawer", proprio=proprio)
    want = jpred.predict_action(imgs, "open the drawer", proprio=proprio)
    assert got.shape == (8, 7) and np.isfinite(got).all()
    _close(got, want, atol=CHAIN_ATOL)


# --- configs and entry points ------------------------------------------------------

@pytest.mark.parametrize("vla_id", sorted(jexp.VLA_EXPERIMENTS))
def test_experiment_recipes_match_jax(vla_id):
    """Every recipe's TrainConfig (model geometry, LoRA, optimizer, batch,
    int8 base) as the JAX package builds it."""
    got = dataclasses.asdict(texp.get_experiment(vla_id).to_train_config())
    want = dataclasses.asdict(jexp.get_experiment(vla_id).to_train_config())
    assert json.dumps(got, sort_keys=True, default=str) == json.dumps(
        want, sort_keys=True, default=str)
    assert tc.LoRAConfig().scale == jc.LoRAConfig().scale == 2.0


def test_entry_points_refuse_without_cuda_or_data(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NotImplementedError, match="use_dummy"):
        tfinetune.main(["--device", "cpu"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfinetune.main(["--data.use_dummy", "true"])
    # the RLDS pipeline's flags come with it: none is parsed and ignored
    with pytest.raises(KeyError, match="mixture"):
        tfinetune.main(["--data.use_dummy", "true", "--device", "cpu",
                        "--data.mixture", "libero_spatial_no_noops"])
    with pytest.raises(SystemExit):
        tmerge_cli.main([])
    with pytest.raises(NotImplementedError, match="not ported"):
        dataclasses.replace(TRT, remat=True, remat_policy="dots")


def test_metrics_match_jax(tmp_path):
    """Smoothing, per-dataset grouping and the JSONL record of the JAX
    package's Metrics; W&B raises where the package is missing."""
    from vla_adapter_tpu.train.metrics import Metrics as JaxMetrics
    from vla_adapter_torch.train.metrics import Metrics

    jm = JaxMetrics(tmp_path / "j", window=3)
    tm = Metrics(tmp_path / "t", window=3)
    names = [b"libero", "calvin", "libero"]
    for i in range(5):
        for m in (jm, tm):
            m.commit(loss=float(i), step_time=0.5)
            m.commit_per_dataset(names, {"loss": np.arange(3.0) + i})
    assert tm.smoothed() == jm.smoothed()
    assert tm.push(4) == jm.push(4)
    jm.close()
    tm.close()
    assert (tmp_path / "t" / "metrics.jsonl").read_text() == (
        tmp_path / "j" / "metrics.jsonl").read_text()
    with pytest.raises(ValueError, match="rows"):
        Metrics(tmp_path / "x").commit_per_dataset(["a"], {"loss": [1, 2]})
    try:
        import wandb  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            Metrics(tmp_path / "w", trackers=("wandb",))


def test_finetune_validation(tmp_path, params):
    """val_iter: the eval step's metrics (no noise) every val_freq steps,
    in the JSONL record."""
    batch = tdummy.make_dummy_batch(TCFG, 2, np.random.default_rng(9))
    cfg = tc.TrainConfig(model=TCFG, optim=tc.OptimizerConfig(**OPT),
                         batch_size=2, val_freq=1, log_freq=10, run_id="v",
                         run_root_dir=str(tmp_path))
    tloop.finetune(cfg, data_iter=itertools.repeat(batch), max_steps=2,
                   rt=TRT, device="cpu", params=from_jax_params(params, TCFG),
                   val_iter=itertools.repeat(batch), val_batches=2)
    lines = [json.loads(x) for x in
             (tmp_path / "v" / "metrics.jsonl").read_text().splitlines()]
    val = [x for x in lines if "val_loss" in x]
    assert [x["step"] for x in val] == [1] and np.isfinite(val[0]["val_loss"])


def test_chip_smoke_derives_the_flagship_train_launches():
    """chip_smoke.py holds the flagship finetune's launches per micro-batch
    to counts it derives from the training model: B1 on the 73 attention
    layers twice (remat), B1-bwd's three kernels once, B4 forward twice
    (towers, decoder) or once (projector) and dx once, except the towers'
    first q/k/v."""
    import chip_smoke
    from vla_adapter_torch.ops import w8a8_matmul
    from vla_adapter_torch.ops.attention_kernel import (
        BWD_KERNEL_NAME,
        KERNEL_NAME,
    )

    tcfg = chip_smoke.train_config(0)
    assert tcfg.model == tc.VLAConfig() and tcfg.batch_size == 16
    model = VLAModel(tcfg.model, tloop.build_runtime(tcfg), device="meta")
    assert chip_smoke.expected_train_launches(model) == {
        KERNEL_NAME: 146, BWD_KERNEL_NAME: 3 * 73,
        w8a8_matmul.KERNEL_NAME: 2 * 414 + 3 + 414 + 3 - 6}
    shapes = chip_smoke.ste_shapes(tcfg.model, 16)
    assert len(shapes) == 12
    assert ("language_model", 10240, 896, 4864) in shapes
    assert ("featurizer", 32 * 261, 1024, 1024) in shapes


@pytest.mark.parametrize("fault", [None, "without_d_term",
                                   "without_gqa_sum"])
def test_chip_smoke_kernel_vs_plain_check_catches_a_planted_fault(
        monkeypatch, fault):
    """chip_smoke.py's one-step check of the kernel path against the plain
    path, on the tiny VLA over the int8 base on the CPU (where the kernel
    path's attention backward is the plain one): it passes as it is, and
    fails once the kernel path's attention backward drops the softmax's
    rowsum(dp * p) term or the GQA sum (the tiny LLM has 4 query heads on
    2 KV heads)."""
    import chip_smoke
    from tests.torch_faults import FAULTS
    from vla_adapter_torch.ops import attention as tattn

    tcfg = tc.TrainConfig(model=tiny_cfg(tc, tk), batch_size=2,
                          base_int8=True,
                          lora=tc.LoRAConfig(rank=RANK, alpha=RANK * SCALE))
    rt = tloop.build_runtime(tcfg)
    init = tloop.initial_state(tcfg, rt, "cpu")
    batch = tdummy.make_dummy_batch(tcfg.model, 2, np.random.default_rng(0))
    if fault is not None:
        monkeypatch.setattr(tattn, "attention_bwd", FAULTS[fault])
    rec = chip_smoke.kernel_vs_plain_step(
        tcfg, init, batch, "cpu",
        vlm_names=("language_model.layers.0.self_attn.q_proj.lora_b",
                   "projector.fc1.lora_b",
                   "vision_backbone.featurizer.blocks.0.mlp.fc1.lora_b",
                   "vision_backbone.fused_featurizer.blocks.0.attn.v_proj"
                   ".lora_b"))
    assert all(np.isfinite(v) for v in rec["grad_cosine"].values())
    if fault is None:
        assert rec["loss"]["kernel"] == rec["loss"]["plain"]
        assert all(e == 0.0 for e in rec["grad_rel_err"].values())
        chip_smoke.check_kernel_vs_plain(rec)
    else:
        with pytest.raises(AssertionError, match="upstream"):
            chip_smoke.check_kernel_vs_plain(rec)
