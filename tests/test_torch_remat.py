"""The remat policies on the CPU: what they give and what they keep.

The tiny VLA of ``tests/torch_tiny.py`` with LoRA (rank 4) in fp32, and the
tiny PrismaticVLM of ``tests/test_torch_vlm.py`` in "full-finetune":

* **Values.** Under each policy ("nothing", "attn_only", "dots",
  "dots_no_batch", "mlp_saved") and under per-component overrides, one
  LoRA finetune step's and one pretrain step's gradients equal those of
  "nothing" and of no remat bit for bit (a policy decides what is kept,
  never what is computed), also over the int8 base that trains through
  the w8a8 product's op; and they match the JAX package's under the
  same policy within 1e-4 of the largest gradient (fp32 summation order).
* **What they keep.** A ``TorchDispatchMode`` counts the products
  (``mm``/``addmm``, ``bmm``/``baddbmm``, the w8a8 product's op) and
  attention's op that the backward runs, with remat and without;
  the difference is what the backward recomputed. It must equal what the
  model's structure gives, counted from its modules: "nothing" recomputes
  every product of the checkpointed stacks, "dots" none, "dots_no_batch"
  only the batched ones (attention's score and value products on the
  plain path, the head's), "mlp_saved" all but gate, up and fc1 (with their
  LoRA products), "attn_only" the attention halves (and the head's whole
  blocks). Attention's kernel op is never kept: every policy recomputes it
  once per checkpointed attention, as the JAX package's policies recompute
  its Pallas call.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import set_checkpoint_early_stop

from tests.test_torch_train import JCFG, JRT, OPT, TCFG, TRT, _jax_init
from tests.test_torch_vlm import JCFG as VLM_JCFG
from tests.test_torch_vlm import TCFG as VLM_TCFG
from tests.test_torch_vlm import jax_vlm_params, vlm_inputs
from vla_adapter_tpu.core import config as jc
from vla_adapter_tpu.data import dummy as jdummy
from vla_adapter_tpu.models.vla import VLAModel as JaxVLA
from vla_adapter_tpu.models.vlm import PrismaticVLM as JVLM
from vla_adapter_tpu.train import optim as joptim
from vla_adapter_tpu.train import partition as jpart
from vla_adapter_tpu.train import stages as jstages
from vla_adapter_tpu.train import step as jstep
from vla_adapter_torch.models.layers import Dense
from vla_adapter_torch.models.quantize import quantize_state_dict
from vla_adapter_torch.models.vla import VLAModel
from vla_adapter_torch.models.vlm import PrismaticVLM
from vla_adapter_torch.train import partition as tpart
from vla_adapter_torch.train import stages as tstages
from vla_adapter_torch.train import step as tstep
from vla_adapter_torch.weights.from_jax import from_jax_params

ATOL = 1e-4
POLICIES = ("nothing", "attn_only", "dots", "dots_no_batch", "mlp_saved")
# name -> (remat_policy, remat_policy_overrides)
CASES = {p: (p, ()) for p in POLICIES}
CASES.update({
    "vit-dots,llm-mlp_saved,head-dots_no_batch": (
        "nothing", (("vit", "dots"), ("llm", "mlp_saved"),
                    ("head", "dots_no_batch"))),
    "llm-attn_only,head-mlp_saved": (
        "dots", (("llm", "attn_only"), ("head", "mlp_saved"))),
})


def _rt(base, case):
    policy, overrides = CASES[case]
    return dataclasses.replace(base, remat=True, remat_policy=policy,
                               remat_policy_overrides=overrides)


def _jrt(case):
    policy, overrides = CASES[case]
    return dataclasses.replace(JRT, remat=True, remat_policy=policy,
                               remat_policy_overrides=overrides)


def _assert_equal(got, want):
    assert set(got) == set(want)
    for n, g in want.items():
        assert torch.equal(got[n], g), n


def _assert_close(got, want):
    scale = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    for n, g in want.items():
        np.testing.assert_allclose(got[n].numpy(), np.asarray(g),
                                   atol=ATOL * scale, rtol=0, err_msg=n)


# --- a LoRA finetune step -----------------------------------------------------------

@pytest.fixture(scope="module")
def lora():
    """JAX's LoRA train state of the tiny VLA (every leaf perturbed), a
    batch, and the port's gradients without remat and under "nothing"."""
    batch = jdummy.make_dummy_batch(JCFG, 2, np.random.default_rng(2))
    tx = joptim.make_optimizer(jc.OptimizerConfig(**OPT), warmup_steps=0)
    state = _jax_init(tx, batch, 0)
    rng = np.random.default_rng(1)
    perturb = lambda t: jax.tree.map(  # noqa: E731
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(
            np.float32), t)
    trainable, frozen = perturb(state.trainable), perturb(state.frozen)
    params = from_jax_params(jpart.merge_trees(trainable, frozen), TCFG)
    case = {"batch": batch, "trainable": trainable, "frozen": frozen,
            "params": params}
    case["none"] = _vla_grads(params, TRT, batch)
    case["nothing"] = _vla_grads(params, _rt(TRT, "nothing"), batch)
    return case


def _vla(params, rt):
    model = VLAModel(TCFG, rt, device="cpu")
    if rt.weights_int8:
        params = quantize_state_dict(params, model.state_dict())
    model.load_state_dict(params, strict=True)
    names = tpart.mark_trainable_(model, lora_enabled=True)
    return model, names


def _vla_grads(params, rt, batch):
    model, names = _vla(params, rt)
    p = dict(model.named_parameters())
    loss, _ = tstep.make_loss_fn(model)(tstep.to_device(batch, "cpu"), None)
    return dict(zip(names, torch.autograd.grad(loss, [p[n] for n in names])))


@pytest.mark.parametrize("case", sorted(CASES))
def test_lora_step_gradients_equal_across_policies(lora, case):
    got = _vla_grads(lora["params"], _rt(TRT, case), lora["batch"])
    _assert_equal(got, lora["none"])
    _assert_equal(got, lora["nothing"])


@pytest.mark.parametrize("case", ["dots", "dots_no_batch", "mlp_saved"])
def test_int8_base_step_gradients_equal_across_policies(lora, case):
    """Over the int8 base (the w8a8 product as a ``torch.library`` op, with
    its straight-through backward, on every Dense of the VLM)."""
    rt8 = dataclasses.replace(TRT, weights_int8=True, act_int8=True,
                              act_int8_min_dim=16, train_base_int8=True)
    want = _vla_grads(lora["params"], rt8, lora["batch"])
    _assert_equal(_vla_grads(lora["params"], _rt(rt8, case), lora["batch"]),
                  want)
    _assert_equal(_vla_grads(lora["params"], _rt(rt8, "nothing"),
                             lora["batch"]), want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lora_step_gradients_match_jax_under_the_policy(lora, case):
    loss_fn = jstep.make_loss_fn(JaxVLA(JCFG, _jrt(case)))
    _, g_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        lora["trainable"], lora["frozen"],
        jax.tree.map(jnp.asarray, lora["batch"]), jax.random.key(0))
    want = from_jax_params(jax.device_get(g_j), TCFG)
    got = _vla_grads(lora["params"], _rt(TRT, case), lora["batch"])
    assert set(got) == set(want)
    _assert_close(got, {n: v.numpy() for n, v in want.items()})


# --- a pretrain step --------------------------------------------------------------------

STAGE = "full-finetune"


@pytest.fixture(scope="module")
def vlm():
    params = jax_vlm_params(VLM_JCFG, seed=4)
    batch = vlm_inputs(VLM_JCFG, seed=5)
    case = {"params": params, "batch": batch}
    case["none"] = _vlm_grads(params, TRT, batch)
    return case


def _vlm_grads(params, rt, batch):
    rt = dataclasses.replace(rt, lora_rank=0)
    model = PrismaticVLM(VLM_TCFG, rt, device="cpu")
    model.load_state_dict(from_jax_params(params, VLM_TCFG), strict=True)
    names = tpart.mark_by_(model, tstages.stage_predicate(STAGE))
    p = dict(model.named_parameters())
    b = tstep.to_device(batch, "cpu")
    loss = model(b["input_ids"], b["text_valid"], b["pixel_values"],
                 labels=b["labels"])["loss"]
    return dict(zip(names, torch.autograd.grad(loss, [p[n] for n in names])))


@pytest.mark.parametrize("case", sorted(CASES))
def test_pretrain_step_gradients_equal_across_policies_and_match_jax(vlm,
                                                                     case):
    got = _vlm_grads(vlm["params"], _rt(TRT, case), vlm["batch"])
    _assert_equal(got, vlm["none"])
    jrt = dataclasses.replace(_jrt(case), lora_rank=0)
    trainable, frozen = jstages.split_by_stage(vlm["params"], STAGE)
    batch = jax.tree.map(jnp.asarray, vlm["batch"])

    def loss_fn(t):
        return JVLM(VLM_JCFG, jrt).apply(
            {"params": jpart.merge_trees(t, frozen)},
            input_ids=batch["input_ids"], text_valid=batch["text_valid"],
            pixel_values=batch["pixel_values"], labels=batch["labels"])["loss"]

    g_j = jax.jit(jax.grad(loss_fn))(trainable)
    want = from_jax_params(jax.device_get(g_j), VLM_TCFG)
    assert set(got) == set(want)
    _assert_close(got, {n: v.numpy() for n, v in want.items()})


# --- what each policy keeps ---------------------------------------------------------------

def _watched():
    aten, vla = torch.ops.aten, torch.ops.vla_adapter_torch
    return {aten.mm.default: "mm", aten.addmm.default: "mm",
            aten.bmm.default: "bmm", aten.baddbmm.default: "bmm",
            vla.w8a8_ste.default: "w8a8", vla.attention.default: "attention"}


class _Products(TorchDispatchMode):
    """Counts the watched ops by kind while active."""

    def __init__(self):
        super().__init__()
        self.watched = _watched()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.watched:
            self.counts[self.watched[func]] += 1
        return func(*args, **(kwargs or {}))


def _backward_counts(params, rt, batch):
    """The watched ops of the backward. Early stopping is off: a region's
    recompute then runs to the region's end, so what it skips is exactly
    what the policy kept (with it on, as in training, the recompute also
    stops after the last tensor the backward needs)."""
    model, names = _vla(params, rt)
    p = dict(model.named_parameters())
    with set_checkpoint_early_stop(False):
        loss, _ = tstep.make_loss_fn(model)(tstep.to_device(batch, "cpu"),
                                            None)
        with _Products() as mode:
            torch.autograd.grad(loss, [p[n] for n in names])
    return mode.counts


def _dense_products(modules):
    """Products of these Denses' forwards: the w8a8 product or one matrix
    product each, and two more for a LoRA delta."""
    out = collections.Counter()
    for m in modules:
        for d in m.modules():
            if isinstance(d, Dense):
                out["w8a8" if d.ste else "mm"] += 1
                out["mm"] += 2 * (d.rt.lora_rank > 0)
    return out


def _attention_products(rt, head_streams=None):
    """One attention's: on the plain path its score and value products
    (bmm), on the kernel path the attention op; the head's attention is
    plain PyTorch either way (a score product per stream, one value
    product)."""
    if head_streams is not None:
        return collections.Counter(bmm=head_streams + 1)
    if rt.kernels == "plain":
        return collections.Counter(bmm=2)
    return collections.Counter(attention=1)


def _expected_recompute(model, case) -> collections.Counter:
    """What the backward recomputes, from the model's structure: for each
    checkpointed unit (a tower block, a decoder layer, a head block) its
    products, less those the policy keeps."""
    rt = model.rt
    towers = [model.vision_backbone.featurizer,
              model.vision_backbone.fused_featurizer]
    units = [("vit", b, b.attn, [b.mlp.fc1])
             for t in towers for b in t.blocks]
    units += [("llm", layer, layer.self_attn,
               [layer.mlp.gate_proj, layer.mlp.up_proj])
              for layer in model.language_model.layers]
    head = model.action_head
    streams = 3  # self, adapter, task
    total = collections.Counter()
    for comp, unit, attn, wide in units:
        policy = rt.remat_policy_of(comp)
        att = _attention_products(rt)
        if policy == "attn_only":
            total += _dense_products([attn]) + att
            continue
        every = _dense_products([unit]) + att
        if policy == "nothing":
            total += every
        elif policy == "dots":
            total += collections.Counter(attention=att["attention"])
        elif policy == "dots_no_batch":
            total += collections.Counter(bmm=att["bmm"],
                                         attention=att["attention"])
        else:  # mlp_saved
            kept = _dense_products(wide)
            total += collections.Counter({k: every[k] - kept[k]
                                          for k in every})
    for block in head.blocks:
        policy = head.rt.remat_policy_of("head")
        every = _dense_products([block]) + _attention_products(
            head.rt, head_streams=streams)
        if policy in ("nothing", "attn_only"):
            total += every
        elif policy == "dots_no_batch":
            total += collections.Counter(bmm=every["bmm"])
        elif policy == "mlp_saved":  # nothing tagged in the head
            total += every
    return +total


VARIANTS = {
    "plain": dict(kernels="plain"),
    "kernel": dict(kernels="kernel"),
    "int8-base": dict(weights_int8=True, act_int8=True, act_int8_min_dim=16,
                      train_base_int8=True),
}


@pytest.fixture(scope="module")
def baseline_counts(lora):
    return {v: _backward_counts(lora["params"],
                                dataclasses.replace(TRT, **kw),
                                lora["batch"])
            for v, kw in VARIANTS.items()}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_policy_recomputes_what_it_does_not_keep(lora, baseline_counts,
                                                 variant, case):
    rt = _rt(dataclasses.replace(TRT, **VARIANTS[variant]), case)
    got = _backward_counts(lora["params"], rt, lora["batch"])
    recomputed = collections.Counter(
        {k: got[k] - baseline_counts[variant][k]
         for k in set(got) | set(baseline_counts[variant])})
    model, _ = _vla(lora["params"], rt)
    assert +recomputed == _expected_recompute(model, case)
    if CASES[case] == ("dots", ()):
        assert not any(recomputed[k] for k in ("mm", "bmm", "w8a8"))
