"""Shared building blocks: the runtime, Dense and BatchedDense in their
float, weight-only int8 and w8a8 forms, norms (counterpart of
vla_adapter_tpu/models/layers.py). LoRA is not ported yet.

Every module keeps its float parameters in ``rt.param_dtype`` and computes
in ``rt.dtype``; norms compute in fp32. Parameter names follow the JAX
package's tree (weights/from_jax.py maps one onto the other); a Dense
stores its kernel as the PyTorch ``(out, in)`` weight. Under
``rt.weights_int8`` a Dense holds ``weight_q`` (out, in) int8 and
``weight_scale`` (out,) float32 instead (models/quantize.py fills them).

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
from vla_adapter_torch.ops.fused_mlp import (
    fused_mlp_reference,
    w8a8_gated_mlp,
    w8a8_mlp,
)
from vla_adapter_torch.ops.w8a8_matmul import (
    w8a8_linear,
    w8a8_linear_reference,
)

W8A8_IMPLS = ("dense", "fused", "mega")


@dataclass(frozen=True)
class Runtime:
    """Runtime knobs orthogonal to the model's geometry.

    dtype: compute dtype; param_dtype: storage dtype of the float weights.
    kernels: "kernel" (every hand-written CUDA kernel of the forward on the
    card, its plain version on the CPU) or "plain" (every kernel's plain
    version on any device).
    weights_int8: every Dense/BatchedDense holds int8 weights with
    per-out-channel scales (the patch embedding stays float).
    act_int8 (w8a8, with weights_int8): activations are quantized per token
    and the product runs int8 x int8 -> int32 (kernel B4/B5); a matmul with
    min(in, out) < act_int8_min_dim takes the weight-only upcast instead.
    w8a8_impl: "dense" (every w8a8 matmul on its own, the JAX package's
    "xla" backend), "fused" (each transformer and projector MLP as one
    fused kernel, B2/B3; everything else as "dense") or "mega" (batch 1
    only: each Qwen2 decoder layer from the attention core on as one
    kernel, B6; the ViT and projector MLPs as in "fused"). "auto" is a
    Predictor value, resolved per batch by :func:`resolve_w8a8_impl`, and
    never picks "mega".
    """

    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    kernels: str = "kernel"
    weights_int8: bool = False
    act_int8: bool = False
    act_int8_min_dim: int = 256
    w8a8_impl: str = "dense"

    def __post_init__(self):
        if self.kernels not in IMPLS:
            raise ValueError(f"kernels {self.kernels!r}: expected one of {IMPLS}")
        if self.w8a8_impl not in W8A8_IMPLS:
            raise ValueError(f"w8a8_impl {self.w8a8_impl!r}: expected one of "
                             f"{W8A8_IMPLS} ('auto' is resolved per batch by "
                             "resolve_w8a8_impl before a model is built)")
        if self.act_int8 and not self.weights_int8:
            raise ValueError("act_int8 needs weights_int8")

    def w8a8(self, *dims: int) -> bool:
        """Whether a matmul with these widths runs w8a8."""
        return self.act_int8 and min(dims) >= self.act_int8_min_dim

    def fused_mlp(self, *dims: int) -> bool:
        """Whether an MLP with these widths runs as one fused kernel."""
        return self.w8a8_impl in ("fused", "mega") and self.w8a8(*dims)

    @property
    def mega(self) -> bool:
        """Whether each Qwen2 decoder layer runs as one kernel (B6)."""
        return self.w8a8_impl == "mega" and self.act_int8


# The batch up to which "auto" serves w8a8 with the fused MLP kernels
# rather than the per-matmul ("dense") backend. On an NVIDIA H100 80GB HBM3
# at 700 W (chip_smoke.py's crossover, PERF.md) the eager forward is
# host-bound and "fused", with ~1900 fewer launches per forward, served
# faster at B=1, 2 and 4 although its MLP kernels take more device time;
# larger batches are not measured.
W8A8_FUSED_MAX_BATCH = 4


def resolve_w8a8_impl(impl: str, batch: int) -> str:
    """Resolve the Predictor's "auto" w8a8 backend for a batch size."""
    if impl == "auto":
        return "fused" if batch <= W8A8_FUSED_MAX_BATCH else "dense"
    return impl


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


def int8_params(module: nn.Module, shape, device) -> None:
    """Register ``weight_q`` (shape) int8 and ``weight_scale`` (shape
    without the in axis) float32 on a Dense/BatchedDense."""
    module.weight_q = nn.Parameter(
        torch.empty(shape, dtype=torch.int8, device=device),
        requires_grad=False)
    module.weight_scale = nn.Parameter(
        torch.empty(shape[:-1], dtype=torch.float32, device=device),
        requires_grad=False)


def w8a8_product(x: torch.Tensor, weight_q: torch.Tensor,
                 weight_scale: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """quantize_rows(x) and the int8 product with the rank-1 dequant, one
    launch of kernel B4 (the quantization inside): x (..., K), weight_q
    (N, K) -> (..., N) in rt.dtype."""
    lead, k = x.shape[:-1], x.shape[-1]
    linear = w8a8_linear_reference if rt.kernels == "plain" else w8a8_linear
    y = linear(x.reshape(-1, k), weight_q, weight_scale, out_dtype=rt.dtype)
    return y.reshape(*lead, weight_q.shape[0])


def fused_mlp(x: torch.Tensor, fc1: "Dense", fc2: "Dense", act: str,
              rt: Runtime, up: "Dense" = None) -> torch.Tensor:
    """act(fc1(x)) [* up(x)] -> fc2 as one launch of kernel B2 (gated,
    with ``up``) or B3 over the Denses' int8 weights and biases; their
    plain version under rt.kernels == "plain"."""
    xf = x.reshape(-1, x.shape[-1])
    if rt.kernels == "plain":
        y = fused_mlp_reference(
            xf, fc1.weight_q, fc1.weight_scale, fc2.weight_q,
            fc2.weight_scale, up_q=None if up is None else up.weight_q,
            up_scale=None if up is None else up.weight_scale, b1=fc1.bias,
            b2=fc2.bias, act=act, out_dtype=rt.dtype)
    elif up is not None:
        y = w8a8_gated_mlp(xf, fc1.weight_q, fc1.weight_scale, up.weight_q,
                           up.weight_scale, fc2.weight_q, fc2.weight_scale,
                           act=act, out_dtype=rt.dtype)
    else:
        y = w8a8_mlp(xf, fc1.weight_q, fc1.weight_scale, fc1.bias,
                     fc2.weight_q, fc2.weight_scale, fc2.bias, act=act,
                     out_dtype=rt.dtype)
    return y.reshape(*x.shape[:-1], fc2.features)


class Dense(nn.Module):
    """y = x @ W^T + b in rt.dtype. Under rt.weights_int8: w8a8 (kernel B4)
    when rt.w8a8 admits both widths, else the weight-only int8 upcast."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 *, rt: Runtime, device=None):
        super().__init__()
        self.rt = rt
        self.in_features, self.features = in_features, features
        if rt.weights_int8:
            int8_params(self, (features, in_features), device)
        else:
            self.weight = new_param((features, in_features), rt, device)
        self.bias = new_param((features,), rt, device) if use_bias else None

    def init_params_(self, gen: torch.Generator) -> None:
        if self.rt.weights_int8:
            raise ValueError("random init of an int8 Dense: init the float "
                             "model and quantize it (models/quantize.py)")
        normal_init_(self.weight, 1.0 / math.sqrt(self.weight.shape[1]), gen)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rt = self.rt
        dt = rt.dtype
        if not rt.weights_int8:
            bias = None if self.bias is None else self.bias.to(dt)
            return F.linear(x.to(dt), self.weight.to(dt), bias)
        if rt.w8a8(self.in_features, self.features):
            y = w8a8_product(x, self.weight_q, self.weight_scale, rt)
        else:  # weight-only: int8 upcast, per-channel scale on the output
            y = F.linear(x.to(dt), self.weight_q.to(dt)) \
                * self.weight_scale.to(dt)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


class BatchedDense(nn.Module):
    """A stack of per-layer projections in one product: kernel (L, in, out)
    (the JAX layout), bias (L, out); x (B, L, S, in) -> (B, L, S, out).
    Under rt.weights_int8 it holds weight_q (L, out, in) int8 and
    weight_scale (L, out); w8a8 runs every layer in one launch of kernel
    B5 (the quantization inside), row block l of x against layer l."""

    def __init__(self, in_features: int, features: int, num_layers: int,
                 use_bias: bool = True, *, rt: Runtime, device=None):
        super().__init__()
        self.rt = rt
        self.in_features, self.features = in_features, features
        if rt.weights_int8:
            int8_params(self, (num_layers, features, in_features), device)
        else:
            self.kernel = new_param((num_layers, in_features, features), rt,
                                    device)
        self.bias = (new_param((num_layers, features), rt, device)
                     if use_bias else None)

    def init_params_(self, gen: torch.Generator) -> None:
        if self.rt.weights_int8:
            raise ValueError("random init of an int8 BatchedDense: init the "
                             "float model and quantize it")
        normal_init_(self.kernel, 1.0 / math.sqrt(self.kernel.shape[1]), gen)
        if self.bias is not None:
            self.bias.zero_()

    def _w8a8(self, x: torch.Tensor) -> torch.Tensor:
        rt = self.rt
        b, num_l, s, k = x.shape
        linear = w8a8_linear_reference if rt.kernels == "plain" \
            else w8a8_linear
        y = linear(x.transpose(0, 1).reshape(num_l, b * s, k), self.weight_q,
                   self.weight_scale, out_dtype=rt.dtype)
        return y.reshape(num_l, b, s, -1).transpose(0, 1)

    def layer(self, x: torch.Tensor, index: int) -> torch.Tensor:
        """x (..., in) through layer ``index`` of the stack alone, weight
        only: the float kernel's slice, or the int8 slice upcast with the
        per-column scale on the product's output, as the original head's
        self stream takes it (no w8a8, as in the JAX package). Only this
        layer's slice is upcast."""
        dt = self.rt.dtype
        if self.rt.weights_int8:
            y = F.linear(x.to(dt), self.weight_q[index].to(dt)) \
                * self.weight_scale[index].to(dt)
        else:
            y = torch.matmul(x.to(dt), self.kernel[index].to(dt))
        if self.bias is not None:
            y = y + self.bias[index].to(dt)
        return y

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rt = self.rt
        dt = rt.dtype
        if not rt.weights_int8:
            y = torch.matmul(x.to(dt), self.kernel.to(dt))
        elif rt.w8a8(self.in_features, self.features):
            y = self._w8a8(x)
        else:
            y = torch.matmul(x.to(dt), self.weight_q.to(dt).transpose(-1, -2)) \
                * self.weight_scale.to(dt)[None, :, None, :]
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
