"""``train.loop.finetune`` of the full-train recipes against the JAX
package's ``finetune``, on the CPU (the parity tests of one step are in
``tests/test_torch_full_train.py``, whose layouts, tolerances and
:func:`_hold_trained` this file shares).

Each recipe's own CLI config (``config_from_experiment``: no LoRA, a
float base, its optimizer, remat of the towers and the decoder) with its
model shrunk to the layout ("flagship" for
``prism-qwen25-dinosiglip-224px+0_5b+mx-oxe-magic-soup``, "mx_bridge"
for ``siglip-224px+mx-bridge``), 2 rows a step for 3 steps, in fp32 on
XLA's attention, both packages from the same initial weights: the
losses at 1e-4, each step's gradients as the gradient test holds them
(the JAX package's read through a first link of its optimizer), and
both Adam moments and every trained tensor as the one-step test holds
them.
The JAX package's ``finetune`` initializes eagerly, one small compile per
operation (~40 s of its ~60 s here); the test runs it with that init
jitted (the same function of the same key and batch) and starts the port
from the weights it returned.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_full_train import (
    LAYOUTS,
    LOOSE_SHARE,
    _cfgs,
    _close,
    _hold_grads,
    _hold_trained,
    one_torch_thread,  # noqa: F401 (the module's fixture)
)
from vla_adapter_tpu.train import finetune as jfinetune
from vla_adapter_tpu.train import loop as jloop
from vla_adapter_tpu.train import optim as joptim
from vla_adapter_tpu.train import partition as jpart
from vla_adapter_tpu.train import step as jstep
from vla_adapter_torch.train import finetune as tfinetune
from vla_adapter_torch.train import loop as tloop
from vla_adapter_torch.train import optim as toptim
from vla_adapter_torch.weights.from_jax import from_jax_params

FINETUNE_STEPS = 3


pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _recipe_cfgs(layout, root):
    """Each package's CLI config of the layout's recipe
    (``config_from_experiment``), its model shrunk, 2 rows a step."""
    jcfg, tcfg = _cfgs(layout)
    vla_id = LAYOUTS[layout][2]
    out = []
    for fin, model, tag in ((jfinetune, jcfg, "jax"),
                            (tfinetune, tcfg, "port")):
        train = fin.config_from_experiment(vla_id).train
        out.append(dataclasses.replace(
            train, model=model, batch_size=2, data_axis=2, save_freq=100,
            log_freq=100, run_id=layout, run_root_dir=str(root / tag),
            optim=dataclasses.replace(train.optim,
                                      max_steps=FINETUNE_STEPS)))
    return out


def _jax_runtime(jcfg):
    """The recipe's JAX runtime in fp32 on XLA's attention."""
    return dataclasses.replace(jloop.build_runtime(jcfg), dtype=jnp.float32,
                               attn_impl="xla")


def _jitted_init(seen: dict):
    """The JAX package's ``train.step.init_train_state`` with its
    ``model.init`` jitted; the float tree it made goes to
    ``seen["params"]``."""

    def init_train_state(model, tx, example_batch, rng, lora_enabled):
        params = jax.jit(lambda b, r: model.init(
            {"params": r, "noise": jax.random.fold_in(r, 1)},
            input_ids=b["input_ids"], prompt_len=b["prompt_len"],
            text_valid=b["text_valid"], pixel_values=b["pixel_values"],
            proprio=b.get("proprio"), train=True)["params"])(
                example_batch, rng)
        seen["params"] = jax.device_get(params)   # the step donates them
        trainable, frozen = jpart.split_trainable(params, lora_enabled)
        return jstep.TrainState(step=jnp.zeros((), jnp.int32),
                                trainable=trainable, frozen=frozen,
                                opt_state=tx.init(trainable))

    return init_train_state


def _gradient_spy(seen: dict):
    """The JAX package's ``make_optimizer`` with a first link that hands
    each step's gradients, as the optimizer gets them, to ``seen`` by the
    step's number (counted by the link's own state)."""

    def record(step, grads):
        seen[int(step)] = jax.tree.map(np.asarray, grads)

    def update(grads, count, params=None):
        jax.debug.callback(record, count, grads)
        return grads, count + 1

    spy = optax.GradientTransformation(
        lambda params: jnp.zeros((), jnp.int32), update)
    return lambda *a, **kw: optax.chain(spy, joptim.make_optimizer(*a, **kw))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_full_finetune_tracks_jax(layout, tmp_path, monkeypatch):
    """``finetune`` of the recipe's own config (every tensor trained, its
    optimizer, remat of the towers and the decoder) on the CPU, 3 steps
    from the JAX package's init: the losses, each step's gradients, both
    Adam moments and every trained tensor against the JAX package's
    ``finetune``."""
    jcfg, tcfg = _recipe_cfgs(layout, tmp_path)
    assert not tcfg.lora.enabled and not tcfg.base_int8 and tcfg.remat_llm
    assert tuple(tcfg.remat_components) == ("vit", "llm")
    losses_j, seen = [], {}
    orig = jloop.Metrics.commit

    def commit(self, **m):
        if "loss" in m:
            losses_j.append(float(m["loss"]))
        return orig(self, **m)

    monkeypatch.setattr(jloop.Metrics, "commit", commit)
    monkeypatch.setattr(jloop, "init_train_state", _jitted_init(seen))
    grads_j, grads_t = {}, []
    monkeypatch.setattr(jloop, "make_optimizer", _gradient_spy(grads_j))
    state_j = jloop.finetune(jcfg, rt=_jax_runtime(jcfg))
    assert state_j.frozen == {}
    rt = dataclasses.replace(tloop.build_runtime(tcfg), dtype=torch.float32)
    assert rt.remat and rt.lora_rank == 0 and not rt.train_base_int8
    start = from_jax_params(seen["params"], tcfg.model)
    update = toptim.AdamW.update

    def record(tx, grads, *args, **kw):
        grads_t.append({n: g.detach().clone() for n, g in grads.items()})
        return update(tx, grads, *args, **kw)

    monkeypatch.setattr(toptim.AdamW, "update", record)
    state = tloop.finetune(tcfg, rt=rt, device="cpu", params=start)
    losses_t = [h["loss"] for h in state.history]
    assert len(losses_t) == len(losses_j) == FINETUNE_STEPS
    _close(np.asarray(losses_t), np.asarray(losses_j))
    assert state.step == FINETUNE_STEPS
    assert set(state.trainable) == set(state.model.state_dict())
    assert len(grads_t) == FINETUNE_STEPS and sorted(grads_j) == list(
        range(FINETUNE_STEPS))
    grads_j = [from_jax_params(grads_j[i], tcfg.model)
               for i in range(FINETUNE_STEPS)]
    for i, (got, want) in enumerate(zip(grads_t, grads_j)):
        _hold_grads(got, want, msg=f"step {i} ")
    schedule = toptim.make_optimizer(tcfg.optim).schedule
    loose = _hold_trained(state, state_j, start, tcfg.optim,
                          [schedule(i) for i in range(FINETUNE_STEPS)],
                          tcfg.model, grads_t, grads_j)
    assert loose < LOOSE_SHARE, loose
