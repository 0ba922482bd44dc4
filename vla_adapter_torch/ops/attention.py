"""Attention dispatch in the model's (B, S, H, D) layout.

Counterpart of ``vla_adapter_tpu/ops/attention.py:dot_product_attention``.
``impl="kernel"`` (the default) runs :func:`attention_kernel.fused_attention`,
which launches the CUDA kernel on a CUDA tensor and takes its plain version
on a CPU tensor. ``impl="plain"`` forces the plain version on any device,
for holding the kernel against it. The TPU package's batch-size gate (a
TPU v5e measurement) has no counterpart: on the card the kernel always runs.

Under autograd (grad enabled and q, k or v requiring it) the call goes
through :class:`TrainableAttention`, the counterpart of the JAX package's
``jax.custom_vjp`` around the Pallas forward (``_attention_pallas_trainable``):
the same forward, and a backward through kernel B1-bwd (``impl="kernel"``
on the card: from the saved ``(q, k, v, valid)`` and the forward's row
log-sum-exp) or its plain version (on the CPU, or ``impl="plain"``:
autograd through the recomputed forward).
"""

from __future__ import annotations

from typing import Optional

import torch

from vla_adapter_torch.ops.attention_kernel import (
    attention_bwd,
    attention_bwd_reference,
    attention_reference,
    fused_attention,
)

IMPLS = ("kernel", "plain")


def plain_attention(q, k, v, valid=None, *, causal: bool,
                    sm_scale: float) -> torch.Tensor:
    """The plain version in (B, S, H, D) layout (the TPU package's
    ``xla_attention`` role), with the kernel's numerics."""
    out = attention_reference(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), valid, causal=causal,
                              sm_scale=sm_scale)
    return out.transpose(1, 2)


def _forward(q, k, v, valid, causal: bool, sm_scale: float,
             impl: str) -> torch.Tensor:
    if impl == "plain":
        return plain_attention(q, k, v, valid, causal=causal,
                               sm_scale=sm_scale)
    if impl != "kernel":
        raise ValueError(f"attention impl {impl!r}: expected one of {IMPLS}")
    out = fused_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), valid, causal=causal,
                          sm_scale=sm_scale)
    return out.transpose(1, 2)


class TrainableAttention(torch.autograd.Function):
    """Attention in (B, S, H, D) layout: the forward of
    :func:`dot_product_attention`, saving ``(q, k, v, valid)`` as the JAX
    residuals and, on the kernel path, each row's lse (the same launch;
    under remat it comes from the recomputing forward); the backward,
    B1-bwd (``impl="kernel"``: the kernel on a CUDA tensor, its plain
    version on a CPU one) or its plain version (``impl="plain"``), returns
    dq (B, S, H, D) and dk, dv (B, S, Hkv, D), each contiguous."""

    @staticmethod
    def forward(ctx, q, k, v, valid, causal, sm_scale, impl):
        ctx.causal, ctx.sm_scale, ctx.impl = causal, sm_scale, impl
        if impl != "kernel":
            ctx.save_for_backward(q, k, v, valid)
            return _forward(q, k, v, valid, causal, sm_scale, impl)
        out, lse = fused_attention(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), valid, causal=causal,
                                   sm_scale=sm_scale, return_lse=True)
        out = out.transpose(1, 2)
        ctx.save_for_backward(q, k, v, valid, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, valid, *lse = ctx.saved_tensors
        bwd, kw = attention_bwd_reference, {}
        if ctx.impl != "plain":
            bwd, kw = attention_bwd, {"lse": lse[0]}
        grads = bwd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    valid, dout.contiguous().transpose(1, 2),
                    causal=ctx.causal, sm_scale=ctx.sm_scale, **kw)
        dq, dk, dv = (g.transpose(1, 2) for g in grads)
        return dq, dk, dv, None, None, None, None


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    impl: str = "kernel",
) -> torch.Tensor:
    """q (B, S, H, D); k, v (B, S, Hkv, D); valid (B, S) nonzero = real
    token. Returns (B, S, H, D)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return TrainableAttention.apply(q, k, v, valid, causal, sm_scale,
                                        impl)
    return _forward(q, k, v, valid, causal, sm_scale, impl)
