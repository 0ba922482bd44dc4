"""The port's full-train path against the JAX package's, on the CPU.

The recipes of ``freeze_stage`` "vla-train" and "vla-full-train"
(``core/experiments.py``) train without LoRA over a float base: every
tensor of the model is trainable (``train/partition.py``), the float
Dense weights, the embedding, both towers, the projector, the head and
the queries. Two layouts, both in fp32 with the weights carried by
``from_jax_params``:

* "flagship": ``tests/torch_tiny.py:tiny_cfg`` (DINOv2 + SigLIP towers,
  Qwen2 with GQA 4/2), the layout of
  ``prism-qwen25-dinosiglip-224px+0_5b+mx-oxe-magic-soup``;
* "mx_bridge": the model of ``siglip-224px+mx-bridge`` (one so400m tower,
  Vicuna-7B: a Llama-family decoder with MHA, untied head) shrunk by
  widths only (``tests/test_torch_zoo.py:_shrink``, the head at two
  blocks of 64).

Each is held against the JAX package: every tensor's gradient of one
batch, and one ``make_train_step`` step (accumulation 1, and 2 under an
fp32 and a bf16 carry: loss, gradient norm, every updated tensor, the
optimizer's count); the JAX programs are compiled together in threads.
``train.loop.finetune`` of each recipe's own config (its remat, its
optimizer) is held against the JAX package's in
``tests/test_torch_full_finetune.py``. A full-train checkpoint (every
tensor, both Adam moments) loads in one process and a resumed run
continues bit for bit. Last, the chip
smoke's check of phase 21 (the kernel path's step-0 loss and gradient
norms against the plain path's one-ulp spread) on the tiny flagship: it
passes as it is, and fails once one tensor's gradient is zeroed or
halved on the kernel path.

Tolerances are ``tests/test_torch_train.py``'s: fp32 summation order
through a few layers, 1e-4 (of each tensor's largest gradient). One kind
of tensor trains here that the LoRA recipe freezes: a tower's key bias,
whose gradient vanishes in exact arithmetic (the softmax ignores a shift
shared by all of a query's scores) and is fp32 rounding in both packages
(1e-10 to 4e-9 of the largest gradient; ``chip_smoke.rounding_gradient``
names them, and the gradient test checks that they are exactly the
nonzero gradients below 1e-6 of the largest). After a step both Adam
moments are held as gradients are (under a bf16 carry within two bf16
ulps), and each element's movement (:func:`_hold_trained`) within 1e-3
of AdamW's move of the port's own gradients and of the JAX package's
movement. Adam moves an element by lr * g / (|g| + eps) at its first
step, so where |g| is within ~100 eps of zero the gradient's last
digits, which differ between the packages, set the move: the second
bound widens by the distance of AdamW's moves of the two packages'
gradients, on under LOOSE_SHARE of the elements.
"""

import concurrent.futures
import contextlib
import dataclasses
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vla_adapter_torch.core.config as tc
import vla_adapter_torch.core.constants as tk
import vla_adapter_tpu.core.config as jc
import vla_adapter_tpu.core.constants as jk
from chip_smoke import rounding_gradient
from tests.test_torch_zoo import _shrink
from tests.torch_tiny import tiny_cfg
from vla_adapter_tpu.core import experiments as jexp
from vla_adapter_tpu.data import dummy as jdummy
from vla_adapter_tpu.models import layers as jlayers
from vla_adapter_tpu.models.vla import VLAModel as JaxVLA
from vla_adapter_tpu.train import optim as joptim
from vla_adapter_tpu.train import step as jstep
from vla_adapter_torch.core import experiments as texp
from vla_adapter_torch.data import dummy as tdummy
from vla_adapter_torch.models import layers as tlayers
from vla_adapter_torch.models.vla import VLAModel
from vla_adapter_torch.train import checkpoints as tckpt
from vla_adapter_torch.train import loop as tloop
from vla_adapter_torch.train import optim as toptim
from vla_adapter_torch.train import partition as tpart
from vla_adapter_torch.train import step as tstep
from vla_adapter_torch.weights.from_jax import from_jax_params

ATOL = RTOL = 1e-4
# a bf16 carry rounds each micro-batch's gradient sum to 8 bits: the
# moments within two bf16 ulps of the largest of a tensor's
CARRY_RTOL = {None: ATOL, "bfloat16": 2.0 ** -6}
# the share of elements whose movement the two packages' gradients, each
# within its bound, put more than 1e-3 of the learning rate apart (read
# 2.4e-4 to 4.4e-4 here: gradients within ~100 eps of zero)
LOOSE_SHARE = 1e-3
OPT = dict(learning_rate=1e-3, max_steps=100, num_steps_before_decay=1000)
JRT = jlayers.Runtime(dtype=jnp.float32, param_dtype=jnp.float32,
                      attn_impl="xla")
TRT = tlayers.Runtime(dtype=torch.float32, param_dtype=torch.float32)


@pytest.fixture(scope="module")
def one_torch_thread():
    """One intra-op thread for the tiny models of a test module: they gain
    nothing from more, and beside the suite's other workers on a few
    cores the threads of a bf16 step oversubscribe them (the chip smoke's
    planted-fault tests took 30-45x their time alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _no_noise(cfg):
    return dataclasses.replace(
        cfg, head=dataclasses.replace(cfg.head, train_noise_std=0.0))


def _bridge(exps):
    """``siglip-224px+mx-bridge``'s model at a test's size, by widths."""
    cfg = _shrink(exps.get_experiment(
        "siglip-224px+mx-bridge").to_train_config().model)
    return dataclasses.replace(cfg, head=dataclasses.replace(
        cfg.head, num_blocks=2, hidden_dim=64, num_attn_heads=4))


# layout -> (JAX config, port config, the full-train recipe of that layout)
LAYOUTS = {
    "flagship": (tiny_cfg(jc, jk), tiny_cfg(tc, tk),
                 "prism-qwen25-dinosiglip-224px+0_5b+mx-oxe-magic-soup"),
    "mx_bridge": (_bridge(jexp), _bridge(texp), "siglip-224px+mx-bridge"),
}


def _cfgs(layout):
    jcfg, tcfg, _ = LAYOUTS[layout]
    return _no_noise(jcfg), _no_noise(tcfg)


def _jax_moments(opt_state, model_cfg):
    """The first and second moments of the JAX package's AdamW state
    (optax's adam state, wherever its chain holds it), by the port's
    names."""
    (adam,) = [s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "nu")) if hasattr(s, "nu")]
    return tuple(from_jax_params(jax.device_get(m), model_cfg)
                 for m in (adam.mu, adam.nu))


def _hold_grads(got, want, rtol=ATOL, msg=""):
    """Gradients or Adam moments by name against the JAX package's, each
    within ``rtol`` of the largest of its tensor's; a
    :func:`rounding_gradient` tensor's, which are rounding in both
    packages, within ``rtol`` of 1e-4 of the model's largest."""
    assert set(got) == set(want)
    largest = max(float(np.abs(v.numpy()).max()) for v in want.values())
    for n, g in got.items():
        w = want[n].numpy()
        scale = (ATOL * largest if rounding_gradient(n)
                 else float(np.abs(w).max()))
        _close(g, w, atol=rtol * scale, rtol=0, msg=msg + n)


def _adam_moves(grads, lrs, b1, b2, eps):
    """Each step's AdamW move, lr m_hat / (sqrt(v_hat) + eps) (weight decay
    0), from one element array's gradients a step, in float64."""
    m = v = 0.0
    moves = []
    for t, (g, lr) in enumerate(zip(grads, lrs), 1):
        g = g.numpy().astype(np.float64)
        m, v = b1 * m + (1 - b1) * g, b2 * v + (1 - b2) * g * g
        moves.append(lr * (m / (1 - b1 ** t)) / (np.sqrt(v / (1 - b2 ** t))
                                                 + eps))
    return moves


def _hold_trained(state, jax_state, start, optim_cfg, lrs, model_cfg,
                  grads_t, grads_j, rtol=ATOL):
    """The port's trained tensors and both Adam moments (``state``)
    against the JAX package's (``jax_state``), both from ``start``, after
    one update a learning rate of ``lrs``, of the gradients ``grads_t``
    (the port's) and ``grads_j`` (the JAX package's), one dict a step.

    Moments as :func:`_hold_grads` holds them at ``rtol``. Each element's
    movement from ``start`` (i) within 1e-3 of AdamW's moves of the port's
    own gradients (:func:`_adam_moves`) and (ii) within 1e-3 of the JAX
    package's movement, both plus 1e-3 of the learning rates' sum and an
    fp32 ulp of the element a step, and (ii) plus the distance of AdamW's
    moves of the two packages' gradients: Adam divides by |g| + eps, so
    where a gradient is within ~100 eps of zero its last digits, which
    differ between the packages, set the move. Returns the share of
    elements where that distance exceeds 1e-3 of the learning rates'
    sum."""
    b1, b2 = optim_cfg.betas
    eps, lr_sum, steps = optim_cfg.eps, sum(lrs), len(lrs)
    assert optim_cfg.weight_decay == 0 and len(grads_t) == len(grads_j) \
        == steps
    want = from_jax_params(jax.device_get(jax_state.trainable), model_cfg)
    moments = dict(zip(("mu", "nu"), _jax_moments(jax_state.opt_state,
                                                  model_cfg)))
    assert set(state.trainable) == set(want) == set(start)
    for part, ref in moments.items():
        _hold_grads(state.opt_state[part], ref, rtol, msg=part + " ")
    loose_n = total = 0
    for n, p in state.trainable.items():
        p = p.detach().float().numpy().astype(np.float64)
        w = want[n].numpy().astype(np.float64)
        p0 = start[n].float().numpy().astype(np.float64)
        moved, moved_j = p - p0, w - p0
        base = 1e-3 * lr_sum + steps * np.spacing(np.maximum(
            np.abs(w), np.abs(p0)).astype(np.float32))
        own = -sum(_adam_moves([g[n] for g in grads_t], lrs, b1, b2, eps))
        apart = sum(np.abs(a - b) for a, b in zip(
            _adam_moves([g[n] for g in grads_t], lrs, b1, b2, eps),
            _adam_moves([g[n] for g in grads_j], lrs, b1, b2, eps)))
        bad = np.abs(moved - own) > 1e-3 * np.abs(own) + base
        assert not bad.any(), ("AdamW of the port's gradients", n,
                               int(bad.sum()), float(np.abs(
                                   moved - own).max()), lr_sum)
        bad = np.abs(moved - moved_j) > 1e-3 * np.abs(moved_j) + base + apart
        assert not bad.any(), ("the JAX package's movement", n,
                               int(bad.sum()), float(np.abs(
                                   moved - moved_j).max()), lr_sum)
        loose_n += int((apart > 1e-3 * lr_sum).sum())
        total += apart.size
    return loose_n / total


def _close(got, want, atol=ATOL, rtol=RTOL, msg=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=msg)


def test_layouts_are_the_recipes_full_train_geometry():
    """Both recipes train every tensor over a float base in both packages;
    the "mx_bridge" layout keeps its recipe's families: one so400m-style
    tower and a Llama-family decoder with MHA and an untied head."""
    for _, _, vla_id in LAYOUTS.values():
        for exps in (jexp, texp):
            cfg = exps.get_experiment(vla_id).to_train_config()
            assert not cfg.lora.enabled and not cfg.base_int8
    jcfg, tcfg = _cfgs("mx_bridge")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tcfg.vision.fused is None and tcfg.vision.primary.name.startswith(
        "siglip")
    llm = tcfg.llm
    assert llm.num_heads == llm.num_kv_heads and not llm.attention_bias
    assert not llm.tie_word_embeddings
    assert _cfgs("flagship")[1].llm.num_kv_heads < _cfgs(
        "flagship")[1].llm.num_heads
    model = VLAModel(tcfg, TRT, device="meta")
    names = tpart.mark_trainable_(model, lora_enabled=False)
    assert len(names) == len(list(model.parameters()))


def _compiled_in_threads(lowered):
    """Each lowered JAX program compiled, all at once in threads (XLA's
    compiles of these tiny programs take most of this file's time, and
    each runs on one core)."""
    with concurrent.futures.ThreadPoolExecutor(len(lowered)) as pool:
        return list(pool.map(lambda lo: lo.compile(), lowered))


_PARAMS = {}


def _jax_params(layout):
    """JAX's float init of the layout, every leaf perturbed (so that the
    gates and the queries are not zero); both layouts' inits compiled at
    once."""
    if not _PARAMS:
        inits = []
        for name in LAYOUTS:
            jcfg, _ = _cfgs(name)
            batch = jdummy.make_dummy_batch(jcfg, 2, np.random.default_rng(0))
            model = JaxVLA(jcfg, JRT)
            rng = jax.random.key(0)
            args = {k: jnp.asarray(v) for k, v in batch.items()
                    if k != "actions"}
            inits.append((jax.jit(lambda b, model=model, rng=rng: model.init(
                {"params": rng, "noise": jax.random.fold_in(rng, 1)},
                train=True, **b)["params"]).lower(args), args))
        compiled = _compiled_in_threads([lo for lo, _ in inits])
        for name, fn, (_, args) in zip(LAYOUTS, compiled, inits):
            prng = np.random.default_rng(1)
            _PARAMS[name] = jax.tree.map(
                lambda a: np.asarray(a) + 0.05 * prng.normal(
                    size=a.shape).astype(np.float32), fn(args))
    return _PARAMS[layout]


STEP_CASES = ((1, None), (2, None), (2, "bfloat16"))


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's results by (layout, case): "grads", the loss,
    metrics and gradients of one batch of 2; and each of STEP_CASES
    ((accumulation, carry)), one train step from the layout's params on a
    batch of 4 (its JAX state, its metrics). The programs are lowered
    first and compiled together."""
    jobs = {}
    for layout in LAYOUTS:
        jcfg, _ = _cfgs(layout)
        params = _jax_params(layout)
        batch = jax.tree.map(jnp.asarray, jdummy.make_dummy_batch(
            jcfg, 2, np.random.default_rng(2)))
        fn = jax.jit(jax.value_and_grad(jstep.make_loss_fn(JaxVLA(jcfg, JRT)),
                                        has_aux=True))
        args = (params, {}, batch, jax.random.key(0))
        jobs[layout, "grads"] = (fn.lower(*args), args)
        for accum, carry in STEP_CASES:
            tcfg_j, _ = _train_cfgs(layout, accum, carry)
            tx = joptim.make_optimizer(tcfg_j.optim, warmup_steps=0)
            state = jstep.TrainState(step=jnp.zeros((), jnp.int32),
                                     trainable=params, frozen={},
                                     opt_state=tx.init(params))
            batch4 = jax.tree.map(jnp.asarray, jdummy.make_dummy_batch(
                jcfg, 4, np.random.default_rng(2),
                accum if accum > 1 else None))
            step = jax.jit(jstep.make_train_step(JaxVLA(jcfg, JRT), tx,
                                                 tcfg_j))
            args = (state, batch4, jax.random.key(0))
            jobs[layout, accum, carry] = (step.lower(*args), args)
    compiled = _compiled_in_threads([lo for lo, _ in jobs.values()])
    return {key: fn(*args) for (key, (_, args)), fn in zip(jobs.items(),
                                                          compiled)}


def _port_model(layout, params):
    _, tcfg = _cfgs(layout)
    model = VLAModel(tcfg, TRT, device="cpu")
    model.load_state_dict(from_jax_params(params, tcfg), strict=True)
    return model


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_full_train_grads_match_jax(jax_runs, layout):
    """The loss, its metrics and the gradient of every tensor of the model
    (the float Dense weights, the embedding, the towers, the projector,
    the head, the queries) from one batch, each within 1e-4 of the
    largest gradient of its own tensor. A gradient that vanishes in exact
    arithmetic (:func:`rounding_gradient`: 1e-10 to 4e-9 of the model's
    largest, every other nonzero one above 1e-5 of it) is fp32 rounding in
    both packages: those are held within 1e-4 of 1e-4 of the model's
    largest gradient; a gradient that is exactly zero stays zero."""
    jcfg, tcfg = _cfgs(layout)
    params = _jax_params(layout)
    batch = jdummy.make_dummy_batch(jcfg, 2, np.random.default_rng(2))
    (loss_j, m_j), g_j = jax_runs[layout, "grads"]
    model = _port_model(layout, params)
    names = tpart.mark_trainable_(model, lora_enabled=False)
    tparams = dict(model.named_parameters())
    loss_t, m_t = tstep.make_loss_fn(model)(tstep.to_device(batch, "cpu"),
                                            None)
    grads = torch.autograd.grad(loss_t, [tparams[n] for n in names])
    _close(loss_t, loss_j)
    for k in ("curr_action_l1_loss", "next_actions_l1_loss"):
        _close(m_t[k], m_j[k])
    want = from_jax_params(g_j, tcfg)
    assert set(want) == set(names) == set(model.state_dict())
    largest = max(float(np.abs(v.numpy()).max()) for v in want.values())
    for n, g in zip(names, grads):
        w = want[n].numpy()
        own = float(np.abs(w).max())
        rounding = 0 < own < 1e-6 * largest
        assert rounding == rounding_gradient(n), (n, own / largest)
        scale = ATOL * largest if rounding else own
        _close(g, w, atol=ATOL * scale, rtol=0, msg=n)


def _train_cfgs(layout, accum=1, accum_dtype=None):
    jcfg, tcfg = _cfgs(layout)
    kw = dict(grad_accumulation_steps=accum, accum_dtype=accum_dtype)
    return (jc.TrainConfig(model=jcfg, optim=jc.OptimizerConfig(**OPT),
                           lora=jc.LoRAConfig(enabled=False), **kw),
            tc.TrainConfig(model=tcfg, optim=tc.OptimizerConfig(**OPT),
                           lora=tc.LoRAConfig(enabled=False), **kw))


@pytest.mark.parametrize("accum,accum_dtype", STEP_CASES)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_full_train_step_matches_jax(jax_runs, layout, accum, accum_dtype):
    """One step of every tensor (accumulation over 2 micro-batches with an
    fp32 or a bf16 carry): metrics, grad norm, every updated tensor and
    the optimizer's count; the JAX state's frozen tree is empty."""
    jcfg, tcfg = _train_cfgs(layout, accum, accum_dtype)
    params = _jax_params(layout)
    batch = jdummy.make_dummy_batch(jcfg.model, 4, np.random.default_rng(2),
                                    accum if accum > 1 else None)
    new_j, m_j = jax_runs[layout, accum, accum_dtype]

    model = _port_model(layout, params)
    tx_t = toptim.make_optimizer(tcfg.optim, warmup_steps=0)
    state_t = tstep.init_train_state(model, tx_t, lora_enabled=False)
    assert not state_t.frozen()
    m_t = tstep.make_train_step(model, tx_t, tcfg)(
        state_t, tstep.to_device(batch, "cpu"), 0)
    for k in ("loss", "curr_action_l1_loss", "next_actions_l1_loss",
              "grad_norm"):
        _close(m_t[k], m_j[k], msg=k)
    assert state_t.step == 1 and int(state_t.opt_state["count"]) == 1
    # each package's gradient: its first moment over 1 - b1
    b1 = tcfg.optim.betas[0]
    mu_j, _ = _jax_moments(new_j.opt_state, tcfg.model)
    loose = _hold_trained(
        state_t, new_j, from_jax_params(params, tcfg.model), tcfg.optim,
        [tx_t.schedule(0)], tcfg.model,
        [{n: m / (1 - b1) for n, m in state_t.opt_state["mu"].items()}],
        [{n: m / (1 - b1) for n, m in mu_j.items()}],
        rtol=CARRY_RTOL[accum_dtype])
    assert loose < LOOSE_SHARE, loose


# --- checkpoints -----------------------------------------------------------

@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_full_train_checkpoint_resumes_bit_for_bit(layout, tmp_path):
    """4 steps unbroken, and 2 steps then a resume to 4 in another run
    directory: the same losses, tensors and moments bit for bit. The
    checkpoint holds every tensor as trainable (no frozen part) and both
    Adam moments of each, and loads into a training state built in
    another process's way (a fresh model, the optimizer started over)."""
    _, tcfg = _cfgs(layout)
    batch = tdummy.make_dummy_batch(tcfg, 2, np.random.default_rng(9))
    init = from_jax_params(_jax_params(layout), tcfg)

    def cfg(root):
        return tc.TrainConfig(model=tcfg, optim=tc.OptimizerConfig(**OPT),
                              lora=tc.LoRAConfig(enabled=False),
                              batch_size=2, save_freq=3, run_id="r",
                              run_root_dir=str(root), log_freq=10)

    def run(root, steps, resume=False):
        return tloop.finetune(cfg(root), data_iter=itertools.repeat(batch),
                              max_steps=steps, rt=TRT, device="cpu",
                              resume=resume, params=init)

    full = run(tmp_path / "a", 4)
    half = run(tmp_path / "b", 2)
    ckpt = tckpt.find_resume_checkpoint(tmp_path / "b" / "r")
    assert json.loads((ckpt / "meta.json").read_text()) == {"step": 2}
    assert not (ckpt / "frozen.safetensors").exists()
    # loaded into a state started afresh
    model = VLAModel(tcfg, TRT, device="cpu")
    model.load_state_dict(init, strict=True)
    tx = toptim.make_optimizer(cfg(tmp_path).optim)
    fresh = tstep.init_train_state(model, tx, lora_enabled=False)
    tckpt.load_checkpoint(ckpt, fresh)
    assert fresh.step == 2 and set(fresh.trainable) == set(init)
    for n, p in half.trainable.items():
        assert torch.equal(fresh.trainable[n], p), n
    for part in ("mu", "nu"):
        assert set(fresh.opt_state[part]) == set(init)
        for n, v in half.opt_state[part].items():
            assert torch.equal(fresh.opt_state[part][n], v), (part, n)
    assert int(fresh.opt_state["count"]) == 2
    resumed = run(tmp_path / "b", 4, resume=True)
    assert [h["step"] for h in resumed.history] == [2, 3]
    assert [h["loss"] for h in resumed.history] == \
        [h["loss"] for h in full.history[2:]]
    for n, p in full.trainable.items():
        assert torch.equal(p, resumed.trainable[n]), n
    for part in ("mu", "nu"):
        for n, v in full.opt_state[part].items():
            assert torch.equal(v, resumed.opt_state[part][n]), (part, n)


# --- chip_smoke.py's phase 21 check ----------------------------------------

FAULTY_TENSOR = "language_model.layers.1.mlp.down_proj.weight"


@pytest.fixture(scope="module")
def full_train_spread():
    """The tiny flagship layout under phase 21's recipe config
    (``full_train_config``: bf16 compute, 2 micro-batches), a batch, and
    the plain path's runs (``plain_spread``) the check holds a kernel run
    against."""
    import chip_smoke

    tcfg = dataclasses.replace(chip_smoke.full_train_config(0),
                               model=tiny_cfg(tc, tk), batch_size=4)
    assert tcfg.grad_accumulation_steps == 2 and not tcfg.lora.enabled
    batch = tdummy.make_dummy_batch(tcfg.model, 4, np.random.default_rng(0),
                                    accum_steps=2)
    runs, _ = chip_smoke.plain_spread(tcfg, batch, 1, dev="cpu")
    return tcfg, batch, runs


@pytest.mark.parametrize("fault", [None, 0.0, 0.5],
                         ids=["as_is", "zeroed", "halved"])
def test_chip_smoke_full_train_check_catches_a_planted_fault(
        full_train_spread, fault, tmp_path):
    """chip_smoke.py's phase 21 comparison (``grads_vs_plain``) on the tiny
    flagship layout trained in full on the CPU, through the recipe's own
    config and ``finetune``, where the kernel path's wrappers run their
    plain versions: it passes as it is (every norm and the loss equal),
    and fails once one tensor's gradient is zeroed or halved by its
    backward (``tests/torch_faults.py:scaled_gradient``)."""
    import chip_smoke
    from tests.torch_faults import scaled_gradient

    tcfg, batch, runs = full_train_spread
    tcfg = dataclasses.replace(tcfg, run_root_dir=str(tmp_path))
    with (scaled_gradient(FAULTY_TENSOR, fault) if fault is not None
          else contextlib.nullcontext()):
        with chip_smoke.first_grad_squares() as grads:
            state = tloop.finetune(tcfg, data_iter=itertools.repeat(batch),
                                   max_steps=1, device="cpu")
    kernel = {"losses": [h["loss"] for h in state.history],
              "grad_norms_by_update": [grads.norms()]}
    assert [r["seed"] for r in runs] == [None,
                                         *chip_smoke.TENSOR_SPREAD_SEEDS]
    rec = chip_smoke.grads_vs_plain(kernel, runs)
    if fault is None:
        assert kernel["grad_norms_by_update"] == runs[0][
            "grad_norms_by_update"]
        chip_smoke.check_grads_vs_plain(rec, "full train")
        assert rec["loss"]["ratio"] == rec["worst_ratio_to_spread"] == 0.0
        assert rec["tensors_held"] == len(state.trainable) - len(
            rec["zero_gradient_tensors"]) - len(rec["rounding_gradients"])
        assert {n for n in state.trainable
                if chip_smoke.rounding_gradient(n)} <= set(
            rec["rounding_gradients"])
    else:
        assert any(FAULTY_TENSOR in f for f in rec["failures"])
        with pytest.raises(AssertionError, match=FAULTY_TENSOR):
            chip_smoke.check_grads_vs_plain(rec, "full train")


def test_chip_smoke_derives_the_full_train_phase():
    """Phase 21's recipe at one rank of its 8 (32 rows as 2 micro-batches
    of 16, the flagship model on the "bridge" platform, every tensor
    trained) and the launches it derives per micro-batch: B1 twice per
    attention layer (remat), B1-bwd's three kernels once, no B4 (a float
    base); and the 7B recipe's LLM attention shape that phases 2 and 11
    time: Vicuna-7B's 32/32 heads of D = 128 over 384 tokens at 32 rows,
    with its dummy batch's key padding."""
    import chip_smoke
    from vla_adapter_torch.ops import w8a8_matmul
    from vla_adapter_torch.ops.attention_kernel import (
        BWD_KERNEL_NAME,
        KERNEL_NAME,
    )

    tcfg = chip_smoke.full_train_config(0)
    assert (tcfg.batch_size, tcfg.grad_accumulation_steps) == (32, 2)
    assert tcfg.model == dataclasses.replace(tc.VLAConfig(),
                                             platform="bridge")
    assert not tcfg.lora.enabled and not tcfg.base_int8
    model = VLAModel(tcfg.model, tloop.build_runtime(tcfg), device="meta")
    assert chip_smoke.expected_train_launches(model) == {
        KERNEL_NAME: 146, BWD_KERNEL_NAME: 3 * 73, w8a8_matmul.KERNEL_NAME: 0}
    fwd, bwd = chip_smoke.seven_b_attention_shape(0)
    name, b, b2, h, hkv, s, d, valid, causal, calls = fwd
    assert (b, b2, h, hkv, s, d, causal, calls) == (32, 32, 32, 32, 384, 128,
                                                    False, 0)
    assert valid.shape == (32, 384) and bool(valid[:, :257].all())
    assert 0 < valid.sum() < valid.size
    assert bwd[:7] == (name, b, h, hkv, s, d, valid) and bwd[7:] == (False,
                                                                      0)
