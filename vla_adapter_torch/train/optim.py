"""Optimizer and learning-rate schedule (counterpart of
vla_adapter_tpu/train/optim.py, which chains optax transformations).

The reference recipe: AdamW at the base rate, a linear warmup of the
multiplier from 0.1 to 1.0 over ``warmup_fraction * max_steps`` steps
(0.1 + 0.9 * min((step + 1) / warmup, 1)), and a x``decay_factor`` drop at
``num_steps_before_decay``. The port applies optax's chain in its order,
as plain tensor code over the trainable tensors:

    [clip_by_global_norm] -> scale_by_adam (moments stored in
    ``moments_dtype``, fp32 math) -> add_decayed_weights ->
    scale_by_learning_rate

The state is a dict of tensors: ``count`` (int64, steps taken) and the
moments ``mu`` and ``nu`` by parameter name. Scalars that JAX computes in
float32 on the device (the schedule, the bias corrections) are computed
here in numpy float32 and enter the tensor math as float32 values or 0-d
device tensors, so no division by a Python number reaches the card (there
PyTorch multiplies by the reciprocal instead).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from vla_adapter_torch.core.config import OptimizerConfig

_DTYPES = {None: torch.float32, "float32": torch.float32,
           "bfloat16": torch.bfloat16}


def lr_schedule(cfg: OptimizerConfig, warmup_steps: int):
    """step -> learning rate, in float32 as the JAX schedule computes it."""
    f32 = np.float32

    def schedule(step: int) -> float:
        s = f32(step)
        if warmup_steps > 0:
            progress = min(f32(s + f32(1.0)) / f32(warmup_steps), f32(1.0))
            warm = f32(0.1) + f32(0.9) * progress
        else:
            warm = f32(1.0)
        decay = f32(cfg.decay_factor) if step >= cfg.num_steps_before_decay \
            else f32(1.0)
        return float(f32(f32(cfg.learning_rate) * warm) * decay)

    return schedule


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (fp32)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


class AdamW:
    """optax's ``adamw`` (or, with ``moments_dtype``, the JAX package's
    ``scale_by_adam_stored`` chain), optionally after
    ``clip_by_global_norm``, over a dict of trainable tensors.

    ``init(params)`` -> state; ``update(grads, state, params)`` ->
    (updates, new state), both dicts by name; :func:`apply_updates` adds
    the updates. With fp32 moments the arithmetic is optax's, operation
    for operation; the scalars ``b1 ** count`` and ``b2 ** count`` are
    numpy float32 powers, which may round an ulp away from XLA's.
    """

    def __init__(self, cfg: OptimizerConfig,
                 warmup_steps: Optional[int] = None):
        if warmup_steps is None:
            warmup_steps = int(cfg.warmup_fraction * cfg.max_steps)
        self.cfg = cfg
        self.schedule = lr_schedule(cfg, warmup_steps)
        self.moments_dtype = _DTYPES[cfg.moments_dtype]

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        zeros = {n: torch.zeros_like(p, dtype=self.moments_dtype)
                 for n, p in params.items()}
        return {"count": torch.zeros((), dtype=torch.int64),
                "mu": zeros,
                "nu": {n: torch.zeros_like(z) for n, z in zeros.items()}}

    def update(self, grads: Dict[str, torch.Tensor], state: dict,
               params: Dict[str, torch.Tensor]):
        cfg = self.cfg
        names = list(grads)
        g = [grads[n].float() for n in names]
        if cfg.grad_clip_norm is not None:
            norm = global_norm(g)
            max_norm = torch.full((), cfg.grad_clip_norm, dtype=torch.float32,
                                  device=norm.device)
            keep = norm < max_norm
            g = [torch.where(keep, t, (t / norm) * max_norm) for t in g]
        b1, b2 = cfg.betas
        count = int(state["count"]) + 1
        f32 = np.float32
        bc1 = float(f32(1.0) - np.power(f32(b1), f32(count)))
        bc2 = float(f32(1.0) - np.power(f32(b2), f32(count)))
        dev = g[0].device if g else "cpu"
        bc1_t = torch.full((), bc1, dtype=torch.float32, device=dev)
        bc2_t = torch.full((), bc2, dtype=torch.float32, device=dev)
        mu = [state["mu"][n].float() for n in names]
        nu = [state["nu"][n].float() for n in names]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(
            torch._foreach_mul(g, g), 1.0 - b2))
        m_hat = torch._foreach_div(mu, bc1_t)
        v_hat = torch._foreach_div(nu, bc2_t)
        denom = torch._foreach_add(torch._foreach_sqrt(v_hat), cfg.eps)
        upd = torch._foreach_div(m_hat, denom)
        if cfg.weight_decay:
            upd = torch._foreach_add(upd, torch._foreach_mul(
                [params[n].float() for n in names], cfg.weight_decay))
        upd = torch._foreach_mul(upd, -self.schedule(count - 1))
        new_state = {
            "count": torch.tensor(count, dtype=torch.int64),
            "mu": {n: m.to(self.moments_dtype) for n, m in zip(names, mu)},
            "nu": {n: v.to(self.moments_dtype) for n, v in zip(names, nu)},
        }
        return dict(zip(names, upd)), new_state


def mask_updates(tx: AdamW, masks: Optional[Dict[str, torch.Tensor]]):
    """Wrap ``tx`` so that masked-out slices get exactly zero updates: the
    grads are multiplied by the mask before ``tx`` (clean moments) and the
    updates after it (no weight decay there). ``masks`` by name,
    broadcastable to each tensor; None returns ``tx``."""
    if masks is None:
        return tx

    class _Masked:
        schedule = tx.schedule

        def init(self, params):
            return tx.init(params)

        def update(self, grads, state, params):
            def mul(tree):
                return {n: t * masks[n].to(t.dtype) if n in masks else t
                        for n, t in tree.items()}

            updates, state = tx.update(mul(grads), state, params)
            return mul(updates), state

    return _Masked()


def make_optimizer(cfg: OptimizerConfig,
                   warmup_steps: Optional[int] = None) -> AdamW:
    return AdamW(cfg, warmup_steps)


@torch.no_grad()
def apply_updates(params: Dict[str, torch.Tensor],
                  updates: Dict[str, torch.Tensor]) -> None:
    """params += updates in place, in each parameter's dtype."""
    for name, p in params.items():
        p.copy_((p.float() + updates[name]).to(p.dtype))
