"""The frozen int8 base on the "fsdp" mesh axis. The JAX package's rule
shards ``kernel_q`` as it shards any other tensor
(``parallel/sharding.py:param_pspec``); FSDP2 in torch 2.11 makes every
parameter it shards require a gradient, which an integer tensor refuses,
so the int8 tensors stay outside its groups and are placed here.

Each int8 tensor of a ``Dense`` that the rule shards on "fsdp" is held as
this rank's part only: ``weight_q`` on the rule's dim (after the "tensor"
split, on the dim the rule gives after the tensor dim); under the
straight-through product (``models.layers.W8A8STE``) also ``weight_qt``,
its transposed copy, built from the weight before this split
(``models.layers.prepare_ste_``) and split on its own dim 0 (dim 1 where
dim 0 does not divide), and a row split's zero-padded ``weight_qk`` on
``weight_q``'s dim (``weight_q`` stays the view of its first K columns).

The Denses of one layer (an entry of a module list: a decoder layer, a
tower block; any other Dense alone) gather together (:class:`Int8Layer`):
this rank's parts of their tensors of one pass, "forward" (each Dense's
forward weight: ``weight_qk`` for a row split's straight-through product,
else ``weight_q``) or "backward" (``weight_qt``, for dx), lie in one flat
buffer, which one ``all_gather_into_tensor`` gathers when the first
product of the pass asks for its tensor (the forward, the recompute, the
backward); one ``split_with_sizes_copy`` cuts the gathered buffer into
the whole tensors, and each product takes its own, which then lives no
longer than the product. Parts on dim 0 are their whole tensor's rows
in rank order as copied; parts on another dim (where the rule falls back
to a weight's in dim) are moved into place, one copy more. A tensor a
pass does not take (no gradient reaches the first tower block's q/k/v)
is dropped at the layer's next gather. The gathered bytes are the int8
tensors' own: every whole tensor equals the unsharded one bit for bit.

:data:`GATHERS` counts the gathers by pass (``reset_gathers`` zeroes it):
one per layer and pass that reads a sharded tensor, and under
"checkpoint" those of :func:`gather_parts` that ``Sharding.full`` makes.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

GATHERS: collections.Counter = collections.Counter()
PASSES = ("forward", "backward")


def reset_gathers() -> None:
    GATHERS.clear()


def gather_parts(part: torch.Tensor, dim: int, group, size: int,
                 name: str = "") -> torch.Tensor:
    """The whole tensor of every rank's ``part`` (split on ``dim``, rank
    order) over ``group`` of ``size`` ranks, counted under ``name``."""
    part = part.contiguous()
    out = torch.empty(size * part.numel(), dtype=part.dtype,
                      device=part.device)
    dist.all_gather_into_tensor(out, part.reshape(-1), group=group)
    GATHERS[name] += 1
    return _placed(out.view(size, *part.shape), dim)


def _placed(rank_major: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole tensor of its parts stacked rank-major, ``(size, *part)``,
    split on ``dim``."""
    if dim == 0:
        return rank_major.flatten(0, 1)
    return rank_major.movedim(0, dim).flatten(dim, dim + 1)


def take_part(whole: torch.Tensor, dim: int, rank: int,
              size: int) -> torch.Tensor:
    """This rank's even part of ``whole`` on ``dim``, in storage of its own
    (the whole tensor is freed once nothing else holds it)."""
    if whole.shape[dim] % size:
        raise ValueError(f"dim {dim} of {tuple(whole.shape)} does not split "
                         f"over fsdp={size}")
    return whole.chunk(size, dim=dim)[rank].clone(
        memory_format=torch.contiguous_format)


def pass_of(name: str) -> str:
    """The pass that reads the int8 tensor ``name``."""
    return "backward" if name == "weight_qt" else "forward"


@dataclass
class Int8Parts:
    """How a Dense holds its int8 tensors on the "fsdp" group: the group,
    this rank's index in it, its size, the dim each sharded tensor is
    split on (by name: "weight_q", "weight_qt", "weight_qk") and the
    :class:`Int8Layer` that gathers them."""

    group: object
    rank: int
    size: int
    dims: Dict[str, int] = field(default_factory=dict)
    layer: "Int8Layer" = None

    def whole(self, module, name: str) -> torch.Tensor:
        """The whole tensor ``name`` of ``module``: gathered with its
        layer's where this rank holds a part of it, else the module's
        own."""
        if name not in self.dims:
            return getattr(module, name)
        return self.layer.take(module, name)


class Int8Layer:
    """The int8 parts of one layer's Denses (each holding its
    :class:`Int8Parts`, on one group), packed per pass into one flat
    buffer of this rank's parts that each Dense's tensors view; the
    Denses' ``hold_int8_`` re-points them. :meth:`take` hands a product
    its whole tensor, gathering the pass's buffer when the last gather
    holds none for it."""

    def __init__(self, denses: Sequence[torch.nn.Module]):
        first = denses[0].int8_parts
        self.group, self.size = first.group, first.size
        self.members: Dict[str, List] = {p: [] for p in PASSES}
        for dense in denses:
            parts = dense.int8_parts
            if (parts.group, parts.size) != (self.group, self.size):
                raise ValueError("a layer's int8 parts span two groups")
            forward = "weight_qk" if "weight_qk" in parts.dims else "weight_q"
            for name in (forward, "weight_qt"):
                if name in parts.dims:
                    self.members[pass_of(name)].append(
                        (dense, name, parts.dims[name]))
            parts.layer = self
        self.flat: Dict[str, torch.Tensor] = {}
        for kind, members in self.members.items():
            if not members:
                continue
            flat = torch.cat([getattr(d, n).reshape(-1)
                              for d, n, _ in members])
            offset = 0
            for dense, name, _ in members:
                part = getattr(dense, name)
                dense.hold_int8_(name, flat[offset:offset + part.numel()]
                                 .view(part.shape))
                offset += part.numel()
            self.flat[kind] = flat
        self._wholes: Dict[tuple, torch.Tensor] = {}

    def take(self, dense, name: str) -> torch.Tensor:
        key = (id(dense), name)
        if key not in self._wholes:
            if not any(d is dense and n == name
                       for d, n, _ in self.members[pass_of(name)]):
                raise KeyError(f"{name} is not an int8 part of this layer")
            self._wholes = self._gather(pass_of(name))
        return self._wholes.pop(key)

    def _gather(self, kind: str) -> Dict[tuple, torch.Tensor]:
        """Every whole tensor of ``kind``'s members by (id(Dense), name),
        from one all-gather of the pass's flat buffer over the group."""
        flat, members = self.flat[kind], self.members[kind]
        out = torch.empty(self.size * flat.numel(), dtype=flat.dtype,
                          device=flat.device)
        dist.all_gather_into_tensor(out, flat, group=self.group)
        GATHERS[kind] += 1
        shapes = [getattr(d, n).shape for d, n, _ in members]
        rank_major = [torch.empty((self.size, *s), dtype=flat.dtype,
                                  device=flat.device) for s in shapes]
        torch.split_with_sizes_copy(
            out.view(self.size, -1), [s.numel() for s in shapes], dim=1,
            out=[t.view(self.size, -1) for t in rank_major])
        return {(id(d), n): _placed(t, dim).contiguous()
                for (d, n, dim), t in zip(members, rank_major)}
