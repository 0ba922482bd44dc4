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

import contextlib
import functools
import math
import threading
from dataclasses import dataclass
from typing import Optional

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
    pad_k,
    quantize_to,
    row_scale,
    w8a8_linear,
    w8a8_linear_reference,
)
from vla_adapter_torch.parallel.fsdp_int8 import Int8Parts, take_part
from vla_adapter_torch.parallel.tensor import (
    TensorGroup,
    all_max_,
    copy_in,
    gather_cols,
    int8_product,
    reduce_out,
)

W8A8_IMPLS = ("dense", "fused", "mega")
REMAT_COMPONENTS = ("vit", "llm", "head")
REMAT_POLICIES = ("nothing", "attn_only", "dots", "dots_no_batch",
                  "mlp_saved")


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
    (the whole layer), "attn_only" (the attention half of a ViT block or
    decoder layer; the head recomputes its whole block), or one that keeps
    some of the layer's products (:func:`remat`): "dots" (every product),
    "dots_no_batch" (the products without batch dims) or "mlp_saved" (the
    products tagged ``mlp_wide``: Qwen2's gate and up, the ViT's fc1).
    Phi-2's layers take ``remat_policy`` itself, as the JAX package's do.
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
            if policy not in REMAT_POLICIES:
                raise ValueError(f"unknown remat policy {policy!r}: "
                                 f"expected one of {REMAT_POLICIES}")

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


# --- remat: activation checkpointing under the JAX package's policies ------

_TAG = threading.local()


@contextlib.contextmanager
def checkpoint_name(name: str):
    """Tag the products computed inside the block with ``name`` (the JAX
    package's ``checkpoint_name`` on their result): "mlp_saved" keeps the
    products tagged ``mlp_wide``. Per thread; the recompute runs the same
    code, so it sees the same tags."""
    outer = getattr(_TAG, "name", None)
    _TAG.name = name
    try:
        yield
    finally:
        _TAG.name = outer


def _products():
    """The ops whose outputs the product-keeping policies save (their
    ``dot_general``s in the JAX package): aten's matrix products, as
    PyTorch dispatches Linear and matmul, and the w8a8 training product.
    Attention's kernel (``vla_adapter_torch::attention``) is no product:
    the JAX package's is a Pallas call, whose output no policy keeps."""
    aten = torch.ops.aten
    unbatched = {aten.mm.default, aten.addmm.default,
                 torch.ops.vla_adapter_torch.w8a8_ste.default}
    return unbatched | {aten.bmm.default, aten.baddbmm.default}, unbatched


def sac_policy(policy: str):
    """The selective-checkpoint policy function of a product-keeping remat
    policy: MUST_SAVE the outputs of every product ("dots"), of the
    products without batch dims ("dots_no_batch": Dense and the w8a8
    product; not the batched ones, attention's score products on the plain
    path and the head's BatchedDense) or of the products tagged
    ``mlp_wide`` ("mlp_saved"); recompute the rest."""
    from torch.utils.checkpoint import CheckpointPolicy

    every, unbatched = _products()

    def keep(ctx, op, *args, **kwargs):
        if policy == "dots":
            saved = op in every
        elif policy == "dots_no_batch":
            saved = op in unbatched
        else:
            saved = op in every and getattr(_TAG, "name", None) == "mlp_wide"
        return (CheckpointPolicy.MUST_SAVE if saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return keep


def remat(policy: str, fn, *args):
    """``fn(*args)`` recomputed in the backward (PyTorch's non-reentrant
    checkpoint) under a remat policy: "nothing", and "attn_only" where the
    caller checkpoints a whole layer (Phi-2, the head: the JAX package's
    fallback), keep only the inputs; "dots", "dots_no_batch" and
    "mlp_saved" also keep the products :func:`sac_policy` names (selective
    activation checkpointing), so the backward recomputes the rest."""
    from torch.utils.checkpoint import (
        checkpoint,
        create_selective_checkpoint_contexts,
    )

    if policy in ("nothing", "attn_only"):
        return checkpoint(fn, *args, use_reentrant=False)
    context = functools.partial(create_selective_checkpoint_contexts,
                                sac_policy(policy))
    return checkpoint(fn, *args, use_reentrant=False, context_fn=context)


# The w8a8 training product's forward as a dispatcher op, so that a remat
# policy sees it as one op and can keep its output (the policy sees only
# dispatched ops); its gradient is W8A8STE's. A Function around a plain
# op, not a custom op with torch.library.register_autograd, whose wrapper
# adds host time to every call (a finetune step makes ~1,240; PERF.md,
# PR 11).
_OPS = torch.library.Library("vla_adapter_torch", "FRAGMENT")
_OPS.define("w8a8_ste(Tensor x, Tensor weight_q, Tensor weight_scale, "
            "str kernels) -> Tensor")


def _w8a8_ste(x, weight_q, weight_scale, kernels: str) -> torch.Tensor:
    lead, k = x.shape[:-1], x.shape[-1]
    linear = w8a8_linear_reference if kernels == "plain" else w8a8_linear
    y = linear(x.reshape(-1, k), weight_q, weight_scale, out_dtype=x.dtype)
    return y.reshape(*lead, weight_q.shape[0])


_OPS.impl("w8a8_ste", _w8a8_ste, "CompositeExplicitAutograd")


def _ste_dx(dy, weight_q, weight_scale, weight_qt, kernels):
    """:class:`W8A8STE`'s dx: ``dys = dy.f32 * weight_scale``, quantized
    per row, against the ``(in, out)`` int8 ``weight_qt`` (``weight_q.t()``
    where there is none, on the CPU) with unit column scales."""
    lead, n = dy.shape[:-1], dy.shape[-1]
    dys = dy.reshape(-1, n).float() * weight_scale.float()
    k = weight_q.shape[1] if weight_qt is None else weight_qt.shape[0]
    ones = torch.ones(k, dtype=torch.float32, device=dy.device)
    if kernels == "plain" or dy.device.type == "cpu":
        w = weight_q.t() if weight_qt is None else weight_qt
        dx = w8a8_linear_reference(dys, w, ones, out_dtype=dy.dtype)
    else:
        if weight_qt is None:
            raise ValueError("W8A8STE: no transposed int8 weight on the "
                             "card (models.layers.prepare_ste_)")
        dx = w8a8_linear(dys, weight_qt, ones, out_dtype=dy.dtype)
    return dx.reshape(*lead, k)


def _saved_int8(ctx, dense, *tensors):
    """Save the int8 operands for the backward, or, for a Dense that holds
    parts of them (``dense``), nothing of them: its backward gathers what
    it reads again."""
    ctx.dense = dense
    ctx.save_for_backward(*(None if dense is not None and t is not None
                            and not t.is_floating_point() else t
                            for t in tensors))


def _backward_qt(ctx, weight_qt):
    return weight_qt if ctx.dense is None else ctx.dense.int8("weight_qt")


class W8A8STE(torch.autograd.Function):
    """The w8a8 product with a straight-through backward, the training twin
    of the serving path for a frozen int8 base (the JAX package's
    ``w8a8_matmul_ste``).

    Forward: :func:`w8a8_product`'s math, ``quantize_rows(x)``, the int8
    product and the rank-1 dequant (kernel B4 with the quantization inside
    on the card, the plain version on the CPU or under kernels="plain"),
    in x's dtype, through the op ``vla_adapter_torch::w8a8_ste``. Backward:
    the activation quantization is the identity; ``dys = dy.f32 *
    weight_scale``, ``(dq, d_scale) = quantize_rows(dys)``, ``dx = (dq @
    weight_q) * d_scale`` in dy's dtype, the int8 product again on B4
    (quantization inside) against ``weight_qt``, the ``(in, out)`` int8
    copy of the weight that B4 reads as its (N, K) operand
    (:func:`prepare_ste_`), with unit column scales: x 1.0 is exact, so the
    result is the JAX function's bit for bit. The weight and its scale get
    no gradient. ``dense``: the Dense whose int8 tensors this rank holds in
    part on "fsdp" (``parallel/fsdp_int8.py``): ``weight_q`` is gathered
    for the forward and ``weight_qt`` for the backward (the arguments are
    its parts), and neither whole tensor outlives its product."""

    @staticmethod
    def forward(ctx, x, weight_q, weight_scale, weight_qt, kernels,
                dense=None):
        _saved_int8(ctx, dense, weight_q, weight_scale, weight_qt)
        ctx.kernels = kernels
        if dense is not None:
            weight_q = dense.int8("weight_q")
        return torch.ops.vla_adapter_torch.w8a8_ste(x, weight_q, weight_scale,
                                                    kernels)

    @staticmethod
    def backward(ctx, dy):
        weight_q, weight_scale, weight_qt = ctx.saved_tensors
        dx = _ste_dx(dy, weight_q, weight_scale, _backward_qt(ctx, weight_qt),
                     ctx.kernels)
        return dx, None, None, None, None, None


class RowW8A8STE(torch.autograd.Function):
    """:class:`W8A8STE` of a row-split Dense (the "tensor" axis): x holds
    this rank's slice of K, weight_q (N, K / T) and weight_scale (N,)
    whole. Forward: each row's absmax over the whole K (the local one,
    then a MAX over the group), ``quantize_rows`` against it into xq
    zero-padded to ``weight_qk``'s K (:func:`ops.w8a8_matmul.pad_k`), the
    int32 product summed over the group (kernel B4's int32 output on the
    card), then the dequant once: the unsplit product bit for bit.
    Backward: dy is whole, so dx (this rank's columns) is the unsplit
    backward's against this rank's ``weight_qt``, with no collective.
    ``dense``: as :class:`W8A8STE`'s (``weight_qk`` gathered for the
    forward)."""

    @staticmethod
    def forward(ctx, x, weight_q, weight_scale, weight_qt, weight_qk,
                kernels, tg, dense=None):
        _saved_int8(ctx, dense, weight_q, weight_scale, weight_qt)
        ctx.kernels = kernels
        if dense is not None:
            weight_qk = dense.int8("weight_qk")
        lead, k = x.shape[:-1], x.shape[-1]
        xf = x.reshape(-1, k)
        rs = row_scale(all_max_(xf.float().abs().amax(-1, keepdim=True), tg))
        acc = int8_product(quantize_to(xf, rs, weight_qk.shape[-1]),
                           weight_qk, tg, kernels)
        # the unsplit product's dequant (B4's, w8a8_matmul_reference's)
        y = (acc.float() * rs * weight_scale.float()).to(x.dtype)
        return y.reshape(*lead, weight_qk.shape[0])

    @staticmethod
    def backward(ctx, dy):
        return W8A8STE.backward(ctx, dy)[:5] + (None, None, None)


class ColW8A8STE(torch.autograd.Function):
    """:class:`W8A8STE` of a column-split Dense: weight_q (N / T, K) and
    weight_scale (N / T,), x whole. Forward: the unsplit forward on this
    rank's columns (every row's scale is over the whole K it holds).
    Backward: dy holds this rank's columns, so ``dys = dy * weight_scale``
    takes each row's absmax over the whole N (a MAX over the group), is
    quantized against it, multiplied against this rank's ``weight_qt``
    rows (zero-padded to a K of 16s) in int32 and summed over the group,
    and dequantized once: the whole dx, bit for bit with the unsplit
    backward, on every rank. ``dense``: as :class:`W8A8STE`'s."""

    @staticmethod
    def forward(ctx, x, weight_q, weight_scale, weight_qt, kernels, tg,
                dense=None):
        _saved_int8(ctx, dense, weight_scale, weight_qt)
        ctx.kernels, ctx.tg = kernels, tg
        if dense is not None:
            weight_q = dense.int8("weight_q")
        return torch.ops.vla_adapter_torch.w8a8_ste(x, weight_q, weight_scale,
                                                    kernels)

    @staticmethod
    def backward(ctx, dy):
        weight_scale, weight_qt = ctx.saved_tensors
        weight_qt = _backward_qt(ctx, weight_qt)
        lead, n = dy.shape[:-1], dy.shape[-1]
        dys = dy.reshape(-1, n).float() * weight_scale.float()
        rs = row_scale(all_max_(dys.abs().amax(-1, keepdim=True), ctx.tg))
        acc = int8_product(quantize_to(dys, rs, weight_qt.shape[-1]),
                           weight_qt, ctx.tg, ctx.kernels)
        dx = (acc.float() * rs).to(dy.dtype)
        return dx.reshape(*lead, weight_qt.shape[0]), None, None, None, \
            None, None, None


@torch.no_grad()
def prepare_ste_(model: nn.Module) -> int:
    """Give every Dense that trains through :class:`W8A8STE` its
    ``weight_qt``, the ``(in, out)`` copy of its int8 weight that kernel B4
    reads for dx (made from ``weight_q`` as it stands: call after loading
    or quantizing the frozen base; ``parallel.sharding.shard_model`` calls
    it between the "tensor" split and the "fsdp" one, so that the copies
    are made from each rank's tensor part and then split on "fsdp"). A
    Dense that has its copy already keeps it. Under a "tensor" split the
    int8 operands of a split K are zero-padded to a K of 16s
    (:func:`ops.w8a8_matmul.pad_k`): a column split's ``weight_qt`` and a
    row split's ``weight_qk`` (the forward's weight, of which ``weight_q``
    becomes the view of its first K columns: one copy). Returns the bytes
    the copies made here take."""
    total = 0
    for module in model.modules():
        if isinstance(module, Dense) and module.ste \
                and module.weight_qt is None:
            qt = module.weight_q.detach().t()
            if module.tp_mode == "col":
                module.weight_qt = pad_k(qt)
            else:
                module.weight_qt = qt.contiguous()
            total += module.weight_qt.numel()
            if module.tp_mode == "row":
                w = module.weight_q
                module.weight_qk = pad_k(w.detach())
                if module.weight_qk.data_ptr() != w.data_ptr():
                    module.weight_q = nn.Parameter(
                        module.weight_qk[:, :w.shape[1]],
                        requires_grad=w.requires_grad)
                    total += module.weight_qk.numel() - w.numel()
    return total


def layer_input(x: torch.Tensor) -> torch.Tensor:
    """A decoder layer's input through one autograd node of its own (a
    view) when it takes a gradient. The layer reads it twice (its residual
    and its norm) and the hidden-state stack once more; FSDP2 puts a node
    on the input of each layer group (``parallel.sharding._groups``), at
    which the layer's two gradients are summed before the stack's is
    added. This node sums them in that order without a group too, so the
    two runs stay equal bit for bit."""
    return x.view_as(x) if x.requires_grad else x


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
    LoRA delta.

    Split over the "tensor" axis (:meth:`split_`, by ``shard_model``):
    "col" holds the rows [lo, hi) of the weight (and of an int8 scale) and
    returns those output columns (its input's gradient summed over the
    group: ``copy_in``, or the int32 sum inside :class:`ColW8A8STE`); "row"
    holds the columns [lo, hi) of the weight, takes those input columns (a
    whole input is cut to them) and sums the partial products over the
    group (``reduce_out``, or the int32 sum inside :class:`RowW8A8STE`),
    whole scale and bias applied after. Biases and LoRA tensors stay whole:
    a column split uses the bias and ``lora_b`` columns [lo, hi), a row
    split sums ``x @ lora_a[lo:hi]`` over the group before ``lora_b``;
    those of them a rank uses only in part (:meth:`tensor_partial`) have
    their gradients summed over the group by the train step."""

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
            self.register_buffer("weight_qk", None, persistent=False)
        self.tp: TensorGroup = None
        self.tp_mode = None     # None (whole), "col" or "row"
        self.tp_range = None    # [lo, hi) of the split axis
        self.int8_parts: Int8Parts = None   # the "fsdp" parts, if any

    @torch.no_grad()
    def split_(self, mode: str, tg: TensorGroup) -> None:
        """Keep this rank's part of the weight: "col" its output rows (and
        those of an int8 scale), "row" its input columns. Call before
        :func:`prepare_ste_`."""
        if mode not in ("col", "row"):
            raise ValueError(f"split mode {mode!r}: expected 'col' or 'row'")
        lo, hi = tg.chunk(self.features if mode == "col" else
                          self.in_features)
        names = ["weight_q", "weight_scale"] if self.rt.weights_int8 \
            else ["weight"]
        for name in names:
            p = getattr(self, name)
            if mode == "col":
                part = p[lo:hi]
            elif name == "weight_scale":
                continue   # the whole output's scale
            else:
                part = p[:, lo:hi]
            setattr(self, name, nn.Parameter(part.clone(),
                                             requires_grad=p.requires_grad))
        self.tp, self.tp_mode, self.tp_range = tg, mode, (lo, hi)

    @torch.no_grad()
    def shard_int8_(self, parts: Int8Parts) -> None:
        """Keep this rank's part of each int8 tensor of ``parts.dims``
        ("weight_q", "weight_qt", "weight_qk") on the "fsdp" group (after
        :meth:`split_` and :func:`prepare_ste_`). Every product gathers
        them again (:meth:`int8`), with the rest of its layer's
        (``parallel.fsdp_int8.Int8Layer``)."""
        dims = parts.dims
        if "weight_qk" in dims and dims["weight_qk"] != dims.get("weight_q"):
            raise ValueError("weight_qk splits on weight_q's dim")
        forward = "weight_qk" if "weight_qk" in dims else "weight_q"
        for name in (forward, "weight_qt"):
            if name in dims:
                self.hold_int8_(name, take_part(getattr(self, name),
                                                dims[name], parts.rank,
                                                parts.size))
        self.int8_parts = parts

    def hold_int8_(self, name: str, t: torch.Tensor) -> None:
        """Hold ``t`` as the int8 tensor ``name``; a row split's
        ``weight_q`` is the view of its ``weight_qk``'s first K
        columns."""
        if name == "weight_qk":
            k = self.weight_q.shape[1]
            self.weight_qk = t
            t, name = t[:, :k], "weight_q"
        if name == "weight_q":
            self.weight_q = nn.Parameter(t, requires_grad=False)
        else:
            setattr(self, name, t)

    def int8(self, name: str) -> torch.Tensor:
        """The whole int8 tensor ``name`` ("weight_q", "weight_qt" or
        "weight_qk"): gathered over "fsdp" where this rank holds a part of
        it (:meth:`shard_int8_`), else the Dense's own."""
        if self.int8_parts is None:
            return getattr(self, name)
        return self.int8_parts.whole(self, name)

    def tensor_partial(self):
        """The whole parameters of which a split Dense uses only a part, so
        that each rank's gradient is a part of the whole one (summed over
        the group by the train step)."""
        if self.tp_mode == "col":
            names = ["bias", "lora_a", "lora_b"]
        elif self.tp_mode == "row":
            names = ["lora_a"]
        else:
            return []
        return [n for n in names if getattr(self, n, None) is not None]

    def whole_output(self, y: torch.Tensor) -> torch.Tensor:
        """This Dense's output (or an elementwise function of it) made
        whole where it is column-split, for a replicated consumer."""
        if self.tp_mode != "col":
            return y
        return gather_cols(y, self.tp, partial=False)

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
        if self.tp is not None:
            return self._split_forward(x)
        if not rt.weights_int8:
            bias = None if self.bias is None else self.bias.to(dt)
            y = F.linear(x.to(dt), self.weight.to(dt), bias)
            return self._lora(x, y)
        if self.ste:
            y = W8A8STE.apply(x.to(dt), self.weight_q, self.weight_scale,
                              self.weight_qt, rt.kernels, self._parts())
        elif rt.w8a8(self.in_features, self.features):
            y = w8a8_product(x, self.int8("weight_q"), self.weight_scale, rt)
        else:  # weight-only: int8 upcast, per-channel scale on the output
            y = F.linear(x.to(dt), self.int8("weight_q").to(dt)) \
                * self.weight_scale.to(dt)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return self._lora(x, y)

    def _parts(self):
        """The Dense itself when it holds parts of its int8 tensors (the
        straight-through Functions gather them), else None."""
        return None if self.int8_parts is None else self

    def _lora(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if self.rt.lora_rank == 0:
            return y
        dt = self.rt.dtype
        delta = (x.to(dt) @ self.lora_a.to(dt)) @ self.lora_b.to(dt)
        return y + self.rt.lora_scale * delta

    def _split_forward(self, x: torch.Tensor) -> torch.Tensor:
        """The forward of a split Dense (see the class docstring)."""
        rt, dt, tg = self.rt, self.rt.dtype, self.tp
        lo, hi = self.tp_range
        col = self.tp_mode == "col"
        lora = rt.lora_rank > 0
        if rt.weights_int8 and not self.ste \
                and rt.w8a8(self.in_features, self.features):
            raise ValueError("a split Dense trains: its w8a8 product is the "
                             "straight-through one (train_base_int8)")
        if col:
            xs = copy_in(x, tg)   # the float products' input
        elif x.shape[-1] == self.in_features:
            x = xs = copy_in(x, tg)[..., lo:hi]   # a whole input, cut
        else:
            xs = x
        if self.ste:
            if col:
                y = ColW8A8STE.apply(x.to(dt), self.weight_q,
                                     self.weight_scale, self.weight_qt,
                                     rt.kernels, tg, self._parts())
            else:
                y = RowW8A8STE.apply(x.to(dt), self.weight_q,
                                     self.weight_scale, self.weight_qt,
                                     self.weight_qk, rt.kernels, tg,
                                     self._parts())
        elif rt.weights_int8:
            y = F.linear(xs.to(dt), self.int8("weight_q").to(dt))
            if col:
                y = y * self.weight_scale.to(dt)
        elif col:   # the bias inside the product, as unsplit
            bias = None if self.bias is None else self.bias[lo:hi].to(dt)
            y = F.linear(xs.to(dt), self.weight.to(dt), bias)
        else:
            y = F.linear(xs.to(dt), self.weight.to(dt))
        if col:
            if self.bias is not None and rt.weights_int8:
                y = y + self.bias[lo:hi].to(dt)
            if lora:
                delta = (xs.to(dt) @ self.lora_a.to(dt)) \
                    @ self.lora_b[:, lo:hi].to(dt)
                y = y + rt.lora_scale * delta
            return y
        xa = xs.to(dt) @ self.lora_a[lo:hi].to(dt) if lora else None
        if self.ste:
            if lora:
                xa = reduce_out(xa, tg)
        elif lora:   # one sum for both partials
            y, xa = reduce_out(torch.cat([y, xa], dim=-1), tg).split(
                [self.features, rt.lora_rank], dim=-1)
        else:
            y = reduce_out(y, tg)
        if rt.weights_int8 and not self.ste:
            y = y * self.weight_scale.to(dt)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        if lora:
            y = y + rt.lora_scale * (xa @ self.lora_b.to(dt))
        return y


@dataclass(frozen=True)
class HeadPlan:
    """The attention heads a rank computes under the "tensor" axis: the q
    heads [h0, h1), whose output columns [c0, c1) (counted from head h0)
    are the rows of the o-projection this rank holds; all heads and every
    column when the o-projection is whole. ``tg`` is None when nothing is
    split."""

    h0: int
    h1: int
    c0: int
    c1: int
    tg: TensorGroup = None

    def output(self, out: torch.Tensor) -> torch.Tensor:
        """The o-projection's columns of the heads' output (..., (h1 - h0)
        * d)."""
        if (self.c0, self.c1) == (0, out.shape[-1]):
            return out
        return out[..., self.c0:self.c1]


def head_plan(o_proj: "Dense", num_heads: int, head_dim: int) -> HeadPlan:
    """The heads a rank computes: those whose output columns its row-split
    o-projection reads (rows [lo, hi) of its input: a head-aligned split
    reads whole heads, another takes the heads that overlap them)."""
    if o_proj.tp_mode != "row":
        return HeadPlan(0, num_heads, 0, num_heads * head_dim)
    lo, hi = o_proj.tp_range
    h0, h1 = lo // head_dim, -(-hi // head_dim)
    return HeadPlan(h0, h1, lo - h0 * head_dim, hi - h0 * head_dim,
                    o_proj.tp)


def take_cols(t: torch.Tensor, dense: Optional["Dense"], lo: int, hi: int,
              plan: HeadPlan) -> torch.Tensor:
    """Columns [lo, hi) of a projection's whole output, from ``t`` (its
    output as this rank holds it: ``dense``'s columns when it is
    column-split, else whole; ``dense`` None for a whole tensor). A split
    that holds exactly [lo, hi) is taken as it is; another is gathered
    first. Under a split plan each rank computes only its heads, so the
    gradient of a gathered or a whole tensor is summed over the group."""
    if dense is not None and dense.tp_mode == "col":
        if dense.tp_range == (lo, hi):
            return t
        t = gather_cols(t, dense.tp, partial=plan.tg is not None)
    elif plan.tg is not None:
        t = copy_in(t, plan.tg)
    return t if (lo, hi) == (0, t.shape[-1]) else t[..., lo:hi]


class BatchedDense(nn.Module):
    """A stack of per-layer projections in one product: kernel (L, in, out)
    (the JAX layout), bias (L, out); x (B, L, S, in) -> (B, L, S, out).
    Under rt.weights_int8 it holds weight_q (L, out, in) int8 and
    weight_scale (L, out); w8a8 runs every layer in one launch of kernel
    B5 (the quantization inside), row block l of x against layer l. The
    float and weight-only products run as one (L, B*S, in) batched
    product: a broadcast ``matmul`` of (B, L, S, in) by (L, in, out) would
    copy the stack once per row of the batch (5.25 GiB a stack at the
    7B recipe's 32 rows, kept for the backward)."""

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

    @staticmethod
    def _per_layer(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (B, L, S, in) @ w (L, in, out), row block l against layer l,
        as one (L, B*S, in) batched product."""
        b, num_l, s, k = x.shape
        y = torch.bmm(x.transpose(0, 1).reshape(num_l, b * s, k), w)
        return y.reshape(num_l, b, s, -1).transpose(0, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rt = self.rt
        dt = rt.dtype
        if not rt.weights_int8:
            y = self._per_layer(x.to(dt), self.kernel.to(dt))
        elif rt.w8a8(self.in_features, self.features):
            y = self._w8a8(x)
        else:
            y = self._per_layer(x.to(dt),
                                self.weight_q.to(dt).transpose(-1, -2)) \
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
