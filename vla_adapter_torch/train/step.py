"""The train step (counterpart of vla_adapter_tpu/train/step.py).

One step: the forward (vision, LLM, head), the L1 loss, the gradients of
the trainable tensors only (``torch.autograd.grad``: the frozen base gets
none), gradient accumulation over micro-batches in ``accum_dtype``, and
the optimizer update. The token objective (``token_prediction_loss``)
needs the LLM's logits, which the port does not compute yet
(``ROADMAP.md`` A.6).

The head's training noise of each micro-batch comes from its own
``torch.Generator``, seeded from (seed + 1, step, micro-batch) by
:func:`noise_generator`, the role of the JAX package's
``fold_in(fold_in(key(seed + 1), step), micro)``: a resumed run draws what
an unbroken one would.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from vla_adapter_torch.core.config import TrainConfig
from vla_adapter_torch.models.vla import VLAModel
from vla_adapter_torch.train.optim import AdamW, apply_updates, global_norm
from vla_adapter_torch.train.partition import mark_trainable_

MODEL_INPUTS = ("input_ids", "prompt_len", "text_valid", "pixel_values",
                 "proprio")


@dataclass
class TrainState:
    """The step count, the model (holding every tensor, trainable and
    frozen), the trainable parameters by name (the model's own), the
    optimizer state, and each step's metrics as the loop read them."""

    step: int
    model: VLAModel
    trainable: Dict[str, torch.nn.Parameter]
    opt_state: dict
    history: List[dict] = field(default_factory=list)

    def frozen(self) -> Dict[str, torch.Tensor]:
        """Every tensor of the model's state dict that is not trained."""
        return {k: v for k, v in self.model.state_dict().items()
                if k not in self.trainable}


def noise_generator(seed: int, step: int, micro: int,
                    device) -> torch.Generator:
    """The generator of the head's noise at (step, micro-batch)."""
    state = np.random.SeedSequence([seed + 1, step, micro]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) >> 1)


def to_device(batch: Mapping[str, Any], device) -> Dict[str, torch.Tensor]:
    """A host batch (numpy arrays) as tensors on ``device``; strings (a
    batch's ``dataset_name``) are left out."""
    out = {}
    for key, val in batch.items():
        arr = np.asarray(val)
        if arr.dtype.kind in "USO":
            continue
        out[key] = torch.as_tensor(arr).to(device)
    return out


def l1_action_loss(pred: torch.Tensor, gt: torch.Tensor):
    """L1 over the chunk and the reference's logging split (the current
    action vs the rest), with per-sample rows for per-dataset metrics."""
    err = (pred.float() - gt.float()).abs()
    loss = err.mean()
    metrics = {
        "loss": loss,
        "curr_action_l1_loss": err[:, 0].mean(),
        "next_actions_l1_loss": err[:, 1:].mean(),
        "per_sample": {
            "loss": err.mean(dim=(1, 2)),
            "curr_action_l1_loss": err[:, 0].mean(dim=-1),
        },
    }
    return loss, metrics


def make_loss_fn(model: VLAModel, objective: str = "l1", train: bool = True):
    """batch (tensors on the model's device), generator -> (loss,
    metrics). ``train=False`` (validation): no head noise."""
    if objective != "l1":
        raise NotImplementedError(
            f"objective {objective!r}: the token objective needs the LLM's "
            "logits, not ported yet (ROADMAP.md A.6)")

    def loss_fn(batch, generator):
        out = model(**{k: batch[k] for k in MODEL_INPUTS if k in batch},
                    train=train, generator=generator)
        return l1_action_loss(out["actions"], batch["actions"])

    return loss_fn


def make_train_step(model: VLAModel, tx: AdamW, cfg: TrainConfig):
    """step(state, batch, step_idx) -> metrics, updating ``state`` in
    place. With ``grad_accumulation_steps`` > 1 the batch has a leading
    micro-batch axis; each micro-batch's grads are added into a carry of
    ``accum_dtype`` (fp32 by default), which then returns to fp32 and is
    divided by the count, before one update (the JAX package's scan)."""
    loss_fn = make_loss_fn(model, cfg.objective)
    accum = cfg.grad_accumulation_steps
    carry_dtype = {None: None, "float32": torch.float32,
                   "bfloat16": torch.bfloat16}[cfg.accum_dtype]

    def single_grads(params: List[torch.Tensor], batch, generator):
        loss, metrics = loss_fn(batch, generator)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        per_sample = metrics.pop("per_sample", {})
        return grads, {k: v.detach() for k, v in metrics.items()}, \
            {k: v.detach() for k, v in per_sample.items()}

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             step_idx: int) -> Dict[str, Any]:
        names = list(state.trainable)
        params = [state.trainable[n] for n in names]
        dev = params[0].device
        if accum > 1:
            carry, m_acc, rows = None, None, []
            for i in range(accum):
                micro = {k: v[i] for k, v in batch.items()}
                g, m, ps = single_grads(
                    params, micro, noise_generator(cfg.seed, step_idx, i, dev))
                if carry_dtype is not None:
                    g = [x.to(carry_dtype) for x in g]
                carry = g if carry is None else [a + x for a, x in
                                                 zip(carry, g)]
                m_acc = m if m_acc is None else {k: m_acc[k] + m[k]
                                                 for k in m}
                rows.append(ps)
            count = torch.full((), float(accum), dtype=torch.float32,
                               device=dev)
            grads = [(c.float() if carry_dtype is not None else c) / count
                     for c in carry]
            metrics = {k: v / count for k, v in m_acc.items()}
            per_sample = {k: torch.stack([r[k] for r in rows])
                          for k in rows[0]}
        else:
            grads, metrics, per_sample = single_grads(
                params, batch, noise_generator(cfg.seed, step_idx, 0, dev))
        grads = dict(zip(names, grads))
        metrics["per_sample"] = per_sample
        metrics["grad_norm"] = global_norm(grads.values())
        updates, state.opt_state = tx.update(grads, state.opt_state,
                                             state.trainable)
        apply_updates(state.trainable, updates)
        state.step += 1
        return metrics

    return step


def make_eval_step(model: VLAModel, objective: str = "l1"):
    """Validation: the trained objective's metrics, head noise off."""
    loss_fn = make_loss_fn(model, objective, train=False)

    @torch.no_grad()
    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        _, metrics = loss_fn(batch, None)
        metrics.pop("per_sample", None)
        return metrics

    return step


def init_train_state(model: VLAModel, tx: AdamW,
                     lora_enabled: bool) -> TrainState:
    """Mark the model's trainable tensors (the rest frozen) and start the
    optimizer over them at step 0."""
    names = mark_trainable_(model, lora_enabled)
    params = dict(model.named_parameters())
    trainable = {n: params[n] for n in names}
    return TrainState(step=0, model=model, trainable=trainable,
                      opt_state=tx.init(trainable))
