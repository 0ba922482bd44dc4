"""Attention dispatch in the model's (B, S, H, D) layout.

Counterpart of ``vla_adapter_tpu/ops/attention.py:dot_product_attention``.
``impl="kernel"`` (the default) runs :func:`attention_kernel.fused_attention`,
which launches the CUDA kernel on a CUDA tensor and takes its plain version
on a CPU tensor. ``impl="plain"`` forces the plain version on any device,
for holding the kernel against it. The TPU package's batch-size gate (a
TPU v5e measurement) has no counterpart: on the card the kernel always runs.
"""

from __future__ import annotations

from typing import Optional

import torch

from vla_adapter_torch.ops.attention_kernel import (
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
    if impl == "plain":
        return plain_attention(q, k, v, valid, causal=causal,
                               sm_scale=sm_scale)
    if impl != "kernel":
        raise ValueError(f"attention impl {impl!r}: expected one of {IMPLS}")
    out = fused_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), valid, causal=causal,
                          sm_scale=sm_scale)
    return out.transpose(1, 2)
