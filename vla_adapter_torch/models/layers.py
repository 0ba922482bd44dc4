"""Shared building blocks: the runtime, Dense and BatchedDense in their
float, weight-only int8 and w8a8 forms, LoRA, the training twin of the
w8a8 product, norms (counterpart of vla_adapter_tpu/models/layers.py).

Every module keeps its float parameters in ``rt.param_dtype`` and computes
in ``rt.dtype``; norms compute in fp32. Parameter names follow the JAX
package's tree (weights/from_jax.py maps one onto the other); a Dense
stores its kernel as the PyTorch ``(out, in)`` weight. Under
``rt.weights_int8`` a Dense holds ``weight_q`` (out, in) int8 and
``weight_scale`` (out,) float32 instead (models/quantize.py fills them).

With ``rt.lora_rank > 0`` every Dense also holds ``lora_a`` (in, r),
N(0, 1/r) at init, and ``lora_b`` (r, out), zeros (the JAX package's
layout and init), and adds ``lora_scale * (x @ lora_a) @ lora_b`` in
rt.dtype. Which tensors train is the partition's business
(``train/partition.py``).

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
REMAT_COMPONENTS = ("vit", "llm", "head")
REMAT_POLICIES = ("nothing", "attn_only")
# the JAX package's other policies, which name XLA's saveable values
REMAT_NOT_PORTED = ("dots", "dots_no_batch", "mlp_saved")


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
    lora_rank / lora_scale: LoRA adapters on every Dense (0: none).
    remat: recompute each layer of the ``remat_components`` stacks ("vit",
    "llm", "head") in the backward (``torch.utils.checkpoint``), under
    ``remat_policy`` or a per-component override in
    ``remat_policy_overrides`` (((component, policy), ...)): "nothing"
    (the whole layer) or "attn_only" (the attention half of a ViT block or
    decoder layer; the head recomputes its whole block).
    train_base_int8 (with weights_int8, act_int8 and the "dense" backend):
    every w8a8 matmul runs :class:`W8A8STE`, the w8a8 forward with a
    straight-through backward for dx.
    """

    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    kernels: str = "kernel"
    weights_int8: bool = False
    act_int8: bool = False
    act_int8_min_dim: int = 256
    w8a8_impl: str = "dense"
    lora_rank: int = 0
    lora_scale: float = 1.0
    remat: bool = False
    remat_policy: str = "nothing"
    remat_policy_overrides: tuple = ()
    remat_components: tuple = REMAT_COMPONENTS
    train_base_int8: bool = False

    def __post_init__(self):
        if self.kernels not in IMPLS:
            raise ValueError(f"kernels {self.kernels!r}: expected one of {IMPLS}")
        if self.w8a8_impl not in W8A8_IMPLS:
            raise ValueError(f"w8a8_impl {self.w8a8_impl!r}: expected one of "
                             f"{W8A8_IMPLS} ('auto' is resolved per batch by "
                             "resolve_w8a8_impl before a model is built)")
        if self.act_int8 and not self.weights_int8:
            raise ValueError("act_int8 needs weights_int8")
        if self.train_base_int8 and not (self.act_int8
                                         and self.w8a8_impl == "dense"):
            raise ValueError("train_base_int8 needs act_int8 and the "
                             "'dense' w8a8 backend (the fused kernels have "
                             "no backward)")
        for component in self.remat_components:
            if component not in REMAT_COMPONENTS:
                raise ValueError(f"remat component {component!r}: expected "
                                 f"one of {REMAT_COMPONENTS}")
        for policy in ({self.remat_policy}
                       | {p for _, p in self.remat_policy_overrides}):
            if policy in REMAT_NOT_PORTED:
                raise NotImplementedError(
                    f"remat policy {policy!r} is not ported yet "
                    "(ROADMAP.md A.5); use 'nothing' or 'attn_only'")
            if policy not in REMAT_POLICIES:
                raise ValueError(f"unknown remat policy {policy!r}")

    def remat_policy_of(self, component: str):
        """The policy under which stack ``component`` ("vit", "llm" or
        "head") recomputes, or None."""
        if not (self.remat and component in self.remat_components):
            return None
        return next((policy for name, policy in self.remat_policy_overrides
                     if name == component), self.remat_policy)

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


def checkpointed(fn, *args):
    """``fn(*args)`` recomputed in the backward (PyTorch's non-reentrant
    checkpoint: nothing inside is kept but the inputs)."""
    from torch.utils.checkpoint import checkpoint

    return checkpoint(fn, *args, use_reentrant=False)


class W8A8STE(torch.autograd.Function):
    """The w8a8 product with a straight-through backward, the training twin
    of the serving path for a frozen int8 base (the JAX package's
    ``w8a8_matmul_ste``).

    Forward: :func:`w8a8_product`'s math, ``quantize_rows(x)``, the int8
    product and the rank-1 dequant (kernel B4 with the quantization inside
    on the card, the plain version on the CPU or under kernels="plain"),
    in x's dtype. Backward: the activation quantization is the identity;
    ``dys = dy.f32 * weight_scale``, ``(dq, d_scale) = quantize_rows(dys)``,
    ``dx = (dq @ weight_q) * d_scale`` in dy's dtype, the int8 product
    again on B4 (quantization inside) against ``weight_qt``, the
    ``(in, out)`` int8 copy of the weight that B4 reads as its (N, K)
    operand (:func:`prepare_ste_`), with unit column scales: x 1.0 is
    exact, so the result is the JAX function's bit for bit. The weight and
    its scale get no gradient."""

    @staticmethod
    def forward(ctx, x, weight_q, weight_scale, weight_qt, kernels):
        ctx.save_for_backward(weight_q, weight_scale, weight_qt)
        ctx.kernels = kernels
        lead, k = x.shape[:-1], x.shape[-1]
        linear = w8a8_linear_reference if kernels == "plain" else w8a8_linear
        y = linear(x.reshape(-1, k), weight_q, weight_scale,
                   out_dtype=x.dtype)
        return y.reshape(*lead, weight_q.shape[0])

    @staticmethod
    def backward(ctx, dy):
        weight_q, weight_scale, weight_qt = ctx.saved_tensors
        lead, n = dy.shape[:-1], dy.shape[-1]
        dys = dy.reshape(-1, n).float() * weight_scale.float()
        ones = torch.ones(weight_q.shape[1], dtype=torch.float32,
                          device=dy.device)
        if ctx.kernels == "plain" or dy.device.type == "cpu":
            dx = w8a8_linear_reference(dys, weight_q.t(), ones,
                                       out_dtype=dy.dtype)
        else:
            if weight_qt is None:
                raise ValueError("W8A8STE: no transposed int8 weight on the "
                                 "card (models.layers.prepare_ste_)")
            dx = w8a8_linear(dys, weight_qt, ones, out_dtype=dy.dtype)
        return dx.reshape(*lead, weight_q.shape[1]), None, None, None, None


@torch.no_grad()
def prepare_ste_(model: nn.Module) -> int:
    """Give every Dense that trains through :class:`W8A8STE` its
    ``weight_qt``, the ``(in, out)`` copy of its int8 weight that kernel B4
    reads for dx (made from ``weight_q`` as it stands: call after loading
    or quantizing the frozen base). Returns the bytes the copies take."""
    total = 0
    for module in model.modules():
        if isinstance(module, Dense) and module.ste:
            module.weight_qt = module.weight_q.t().contiguous()
            total += module.weight_qt.numel()
    return total


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
    """y = x @ W^T + b in rt.dtype. Under rt.weights_int8: w8a8 (kernel B4;
    :class:`W8A8STE` under rt.train_base_int8) when rt.w8a8 admits both
    widths, else the weight-only int8 upcast. With rt.lora_rank, plus the
    LoRA delta."""

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
        if rt.lora_rank > 0:
            self.lora_a = new_param((in_features, rt.lora_rank), rt, device)
            self.lora_b = new_param((rt.lora_rank, features), rt, device)
        self.ste = rt.train_base_int8 and rt.w8a8(in_features, features)
        if self.ste:
            self.register_buffer("weight_qt", None, persistent=False)

    def init_params_(self, gen: torch.Generator) -> None:
        if self.rt.lora_rank > 0:
            normal_init_(self.lora_a, 1.0 / self.rt.lora_rank, gen)
            self.lora_b.zero_()
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
            y = F.linear(x.to(dt), self.weight.to(dt), bias)
            return self._lora(x, y)
        if self.ste:
            y = W8A8STE.apply(x.to(dt), self.weight_q, self.weight_scale,
                              self.weight_qt, rt.kernels)
        elif rt.w8a8(self.in_features, self.features):
            y = w8a8_product(x, self.weight_q, self.weight_scale, rt)
        else:  # weight-only: int8 upcast, per-channel scale on the output
            y = F.linear(x.to(dt), self.weight_q.to(dt)) \
                * self.weight_scale.to(dt)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return self._lora(x, y)

    def _lora(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if self.rt.lora_rank == 0:
            return y
        dt = self.rt.dtype
        delta = (x.to(dt) @ self.lora_a.to(dt)) @ self.lora_b.to(dt)
        return y + self.rt.lora_scale * delta


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
