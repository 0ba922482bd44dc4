"""The "tensor" mesh axis: Megatron splits over a ``torch.distributed``
group. The JAX package has no module for this: it marks its kernels
column- or row-parallel (``vla_adapter_tpu/parallel/sharding.py``'s rule,
the port's ``parallel.sharding.param_pspec``) and GSPMD derives the
collectives. The port splits the parameters itself
(``parallel.sharding.shard_model``) and places the collectives here, on
plain local tensors (B1, B1-bwd and the straight-through w8a8 product take
ordinary tensors, not DTensors):

* :func:`copy_in`: the identity forward, the gradient summed over the
  group backward (the input of a column-split projection, whose ranks each
  see part of the output's gradient);
* :func:`reduce_out`: the partial sums of a row-split projection summed
  forward, the identity backward;
* :func:`all_max_`: a row absmax taken over the whole of a split axis (the
  int8 row scale of a split K);
* :func:`gather_cols`: a column split made whole, where the split is not
  head-aligned or a whole tensor is consumed;
* :func:`int8_product`: the exact int32 product of a rank's slice of K
  (kernel B4's int32 output on the card), summed over the group.

The ranks of one tensor group hold the same rows: the batch is split over
("data", "fsdp") only, as the JAX package's ``BATCH_SPEC``.

The collectives run over the group's backend (NCCL across cards, gloo on
the CPU), or over a transport the caller passes (``shard_model``'s
``tensor_transport``): an object with ``all_reduce(t, op)`` and
``all_gather(t)`` over the same ranks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.distributed as dist

from vla_adapter_torch.ops.w8a8_matmul import (
    w8a8_matmul,
    w8a8_matmul_reference,
)


@dataclass(frozen=True)
class TensorGroup:
    """The mesh's "tensor" dim as this rank sees it: its process group,
    this rank's index in it and its size, and the transport its
    collectives take instead of ``torch.distributed`` where the caller
    gave one."""

    group: object
    rank: int
    size: int
    transport: object = None

    def chunk(self, n: int) -> Tuple[int, int]:
        """[lo, hi) of this rank's even share of ``n``."""
        if n % self.size:
            raise ValueError(f"{n} does not split over tensor={self.size}")
        per = n // self.size
        return self.rank * per, (self.rank + 1) * per

    def all_gather(self, t: torch.Tensor):
        """Every rank's t, in rank order."""
        if self.transport is not None:
            return self.transport.all_gather(t)
        parts = [torch.empty_like(t, memory_format=torch.contiguous_format)
                 for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return parts

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM):
        """t (contiguous) replaced, in place, by its reduction over the
        group."""
        if self.transport is not None:
            return self.transport.all_reduce(t, op)
        dist.all_reduce(t, op=op, group=self.group)
        return t


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tg):
        ctx.tg = tg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return ctx.tg.all_reduce(dy.contiguous().clone()), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tg):
        return tg.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _GatherCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tg, partial):
        ctx.tg, ctx.partial, ctx.width = tg, partial, x.shape[-1]
        return torch.cat(tg.all_gather(x), dim=-1)

    @staticmethod
    def backward(ctx, dy):
        tg, w = ctx.tg, ctx.width
        if ctx.partial:
            dy = tg.all_reduce(dy.contiguous().clone())
        return dy[..., tg.rank * w:(tg.rank + 1) * w].contiguous(), None, None


def copy_in(x: torch.Tensor, tg: TensorGroup) -> torch.Tensor:
    """x as it is; its gradient summed over the group."""
    return _CopyIn.apply(x, tg)


def reduce_out(x: torch.Tensor, tg: TensorGroup) -> torch.Tensor:
    """The sum of every rank's x; the gradient passes as it is."""
    return _ReduceOut.apply(x, tg)


def gather_cols(x: torch.Tensor, tg: TensorGroup,
                partial: bool) -> torch.Tensor:
    """Every rank's x (..., w) side by side along the last axis (rank
    order). Backward: this rank's columns of the gradient, summed over the
    group first when ``partial`` (each rank's consumer saw part of the
    output), taken as they are when the consumer is replicated."""
    return _GatherCols.apply(x, tg, partial)


def all_max_(x: torch.Tensor, tg: TensorGroup) -> torch.Tensor:
    """x replaced, in place, by its elementwise maximum over the group (no
    gradient)."""
    return tg.all_reduce(x, dist.ReduceOp.MAX)


def int8_product(xq: torch.Tensor, w: torch.Tensor, tg: TensorGroup,
                 kernels: str) -> torch.Tensor:
    """The exact int32 product xq @ w^T of int8 (M, K') and (N, K') over
    this rank's slice of K (zero-padded to K', :func:`ops.w8a8_matmul.
    pad_k`), summed over the group: kernel B4 with its int32 output on the
    card, the plain product on the CPU or under kernels="plain"."""
    if kernels == "plain":
        acc = w8a8_matmul_reference(xq, None, w, None, out_dtype=torch.int32)
    else:
        acc = w8a8_matmul(xq, None, w, None, out_dtype=torch.int32)
    return tg.all_reduce(acc)
