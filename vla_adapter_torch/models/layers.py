"""Shared building blocks, float paths (counterpart of
vla_adapter_tpu/models/layers.py). LoRA, int8 and w8a8 are not ported yet.

Every module keeps its parameters in ``rt.param_dtype`` and computes in
``rt.dtype``; norms compute in fp32. Parameter names follow the JAX
package's tree (weights/from_jax.py maps one onto the other); a Dense
stores its kernel as the PyTorch ``(out, in)`` weight.

``init_params_(generator)`` on a module fills its own parameters from a
``torch.Generator``; :func:`init_random_` walks a model with it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from vla_adapter_torch.ops.attention import IMPLS


@dataclass(frozen=True)
class Runtime:
    """dtype: compute dtype; param_dtype: storage dtype of the weights;
    attn_impl: "kernel" (the CUDA kernel on the card, its plain version on
    the CPU) or "plain" (the plain version everywhere)."""

    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    attn_impl: str = "kernel"

    def __post_init__(self):
        if self.attn_impl not in IMPLS:
            raise ValueError(f"attn_impl {self.attn_impl!r}: expected one of {IMPLS}")


# fp32 everywhere — CPU parity tests against the reference numerics.
FP32_RUNTIME = Runtime(dtype=torch.float32, param_dtype=torch.float32)


def normal_init_(t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    t.copy_(torch.randn(t.shape, generator=gen, device=gen.device) * std)


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from ``generator`` (a smoke-test stand-in for a
    checkpoint): lecun-normal kernels, zero biases, unit norms."""
    for module in model.modules():
        if hasattr(module, "init_params_"):
            module.init_params_(generator)
    return model


def new_param(shape, rt: Runtime, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=rt.param_dtype, device=device),
                        requires_grad=False)


class Dense(nn.Module):
    """y = x @ W^T + b in rt.dtype (float branch of the JAX Dense)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 *, rt: Runtime, device=None):
        super().__init__()
        self.rt = rt
        self.weight = new_param((features, in_features), rt, device)
        self.bias = new_param((features,), rt, device) if use_bias else None

    def init_params_(self, gen: torch.Generator) -> None:
        normal_init_(self.weight, 1.0 / math.sqrt(self.weight.shape[1]), gen)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.rt.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class BatchedDense(nn.Module):
    """A stack of per-layer projections in one product: kernel (L, in, out),
    bias (L, out); x (B, L, S, in) -> (B, L, S, out)."""

    def __init__(self, in_features: int, features: int, num_layers: int,
                 use_bias: bool = True, *, rt: Runtime, device=None):
        super().__init__()
        self.rt = rt
        self.kernel = new_param((num_layers, in_features, features), rt, device)
        self.bias = (new_param((num_layers, features), rt, device)
                     if use_bias else None)

    def init_params_(self, gen: torch.Generator) -> None:
        normal_init_(self.kernel, 1.0 / math.sqrt(self.kernel.shape[1]), gen)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.rt.dtype
        y = torch.matmul(x.to(dt), self.kernel.to(dt))
        if self.bias is not None:
            y = y + self.bias.to(dt)[None, :, None, :]
        return y


class RMSNorm(nn.Module):
    """y = w * x / sqrt(mean(x^2) + eps), fp32 math."""

    def __init__(self, dim: int, eps: float = 1e-6, *, rt: Runtime,
                 device=None):
        super().__init__()
        self.rt, self.eps = rt, eps
        self.weight = new_param((dim,), rt, device)

    def init_params_(self, gen: torch.Generator) -> None:
        self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return (xf * self.weight.float()).to(self.rt.dtype)


class LayerNorm(nn.Module):
    """LayerNorm with fp32 internals."""

    def __init__(self, dim: int, eps: float = 1e-6, use_bias: bool = True, *,
                 rt: Runtime, device=None):
        super().__init__()
        self.rt, self.eps = rt, eps
        self.weight = new_param((dim,), rt, device)
        self.bias = new_param((dim,), rt, device) if use_bias else None

    def init_params_(self, gen: torch.Generator) -> None:
        self.weight.fill_(1.0)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.float()
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(), bias,
                         self.eps)
        return y.to(self.rt.dtype)


def gelu(x: torch.Tensor, approximate: bool) -> torch.Tensor:
    """GELU: erf form, or the tanh approximation."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's QuickGELU: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def activation(name: str):
    if name == "gelu":
        return lambda x: gelu(x, approximate=False)
    if name == "gelu_tanh":
        return lambda x: gelu(x, approximate=True)
    if name == "quick_gelu":
        return quick_gelu
    raise ValueError(f"unknown activation {name!r}")
