"""Process groups, the device mesh and sharded training (counterpart of
vla_adapter_tpu/parallel/sharding.py, which places a GSPMD mesh).

The reference trains with torch DDP (the finetune recipe) and FSDP
HYBRID_SHARD (pretraining) over NCCL. The JAX package expresses both as one
mesh with the axes ("data", "fsdp", "tensor"); the port runs them on
``torch.distributed``, one process per card:

* "data" (mesh (N, 1, 1)): DDP semantics. Every rank holds every tensor;
  each micro-batch's trainable gradients are averaged across ranks before
  they enter the accumulation carry, as the JAX step's gradients are the
  global batch's mean before its carry rounds them.
* "fsdp" (mesh (1, N, 1)): FSDP2 ``fully_shard`` on each vision tower,
  the action head and each decoder layer, then on the rest of the model
  (the embedding, the final norm, the projector); each floating-point
  parameter that :func:`param_pspec` shards is split on the dim the JAX
  rule picks (``shard_placement_fn``), all-gathered per group for its
  forward and again for its backward (and its recompute), its gradient
  reduce-scattered (averaged) as the group's backward ends. The int8
  weights the rule shards are split on its dim outside FSDP2
  (``parallel/fsdp_int8.py``: FSDP2 refuses integer parameters) and
  gathered one layer and pass at a time. Parameters the rule leaves
  whole stay out of FSDP (``ignored_params``); the trainable ones are
  averaged as under "data".
* both (mesh (R, S, 1)): HSDP, sharded within "fsdp", replicated across
  "data".
* "tensor" (mesh (., ., T)): Megatron splits on plain local tensors
  (``parallel/tensor.py``), placed by :func:`param_pspec` as the JAX
  package's GSPMD places them: column-parallel q/k/v, gate/up, fc1 and
  fc_in weights (with their int8 scales), row-parallel o/out_proj,
  down_proj, fc2 and fc_out weights; biases, LoRA tensors, norms and the
  head's K/V stacks stay whole. Each split ``Dense`` keeps its part
  (``Dense.split_``) and the attention of its heads; FSDP2 then shards
  the local parts over the "fsdp" dim, on the dim the rule picks after
  the tensor dim. The ranks of one tensor group share their rows and
  their head noise; gradients and metrics are averaged over the
  ("data", "fsdp") ranks only, and the gradients of whole parameters a
  rank uses in part are summed over the tensor group. The tensor dim is
  the mesh's innermost: ranks t, t + T, ... share a tensor coordinate.

Start the group with :func:`initialize_distributed` (NCCL on the card,
gloo only when the caller asks for the CPU), or run under ``torchrun``
(:func:`torchrun_env` reads its variables).

The JAX package's batch placement helpers (``shard_batch``,
``shard_batch_from_local``, ``batch_sharding``, ``replicated``,
``host_local_rows``, ``params_shardings``, ``shard_params``) have no
counterpart: each rank feeds its own rows as ordinary tensors, and
:func:`shard_model` places the parameters.
"""

from __future__ import annotations

import math
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from vla_adapter_torch.utils.overwatch import (
    group_initialized,
    process_count,
    process_index,
)

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TENSOR_AXIS = "tensor"
MESH_AXES = (DATA_AXIS, FSDP_AXIS, TENSOR_AXIS)
# The smallest tensor (elements) the "fsdp" axis shards (the JAX rule's).
MIN_FSDP_SIZE = 2 ** 18
# The smallest "fsdp" dim on which shard_model runs FSDP2. At 1 a one-rank
# mesh runs it too, its all-gather and reduce-scatter over one card.
MIN_FSDP_RANKS = 2


def torchrun_env() -> Optional[Tuple[str, int, int, int]]:
    """(address, world size, rank, local rank) from ``torchrun``'s
    variables, or None outside it."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    address = (f"tcp://{os.environ.get('MASTER_ADDR', 'localhost')}:"
               f"{os.environ.get('MASTER_PORT', '29500')}")
    rank = int(os.environ["RANK"])
    return (address, int(os.environ["WORLD_SIZE"]), rank,
            int(os.environ.get("LOCAL_RANK", rank)))


def initialize_distributed(address: Optional[str] = None,
                           world: Optional[int] = None,
                           rank: Optional[int] = None,
                           local_rank: Optional[int] = None,
                           device: str = "cuda",
                           backend: Optional[str] = None) -> None:
    """Start the process group (``init_process_group``): NCCL on the card,
    with this process on card ``local_rank`` (default: the rank), or gloo
    when ``device`` is "cpu". Never falls back from one to the other.
    ``backend="gloo"`` on the card is the caller's explicit choice (gloo's
    collectives take CUDA tensors; NCCL refuses two ranks on one card).
    Without an ``address`` this is a single-process run and nothing
    starts; a second call is a no-op."""
    if address is None or group_initialized():
        return
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"initialize_distributed: "
                               f"{(backend or 'nccl').upper()} needs a card; "
                               "pass device=\"cpu\" for gloo")
        torch.cuda.set_device(rank if local_rank is None else local_rank)
        backend = backend or "nccl"
    elif kind == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"initialize_distributed: {backend} on the CPU")
        backend = "gloo"
    else:
        raise ValueError(f"initialize_distributed: device {device!r}")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"initialize_distributed: backend {backend!r}")
    dist.init_process_group(backend, init_method=address, world_size=world,
                            rank=rank)


def create_mesh(data: int = -1, fsdp: int = 1, tensor: int = 1,
                device=None):
    """A ``DeviceMesh`` with the dims ("data", "fsdp", "tensor") over the
    process group's ranks (one card each); data=-1: the ranks left. Needs
    an initialized process group. The mesh is on the card under NCCL and
    on the CPU under gloo; under another backend (torch's "fake" group,
    whose collectives move nothing: a memory estimate) on ``device``'s
    type (default "cuda")."""
    if not group_initialized():
        raise RuntimeError("create_mesh needs a process group "
                           "(initialize_distributed)")
    from torch.distributed.device_mesh import DeviceMesh

    n = process_count()
    if data == -1:
        assert n % (fsdp * tensor) == 0, (n, fsdp, tensor)
        data = n // (fsdp * tensor)
    need = data * fsdp * tensor
    assert need <= n, (data, fsdp, tensor, n)
    ranks = torch.arange(need).reshape(data, fsdp, tensor)
    device_type = {"nccl": "cuda", "gloo": "cpu"}.get(
        dist.get_backend(), torch.device(device or "cuda").type)
    return DeviceMesh(device_type, ranks, mesh_dim_names=MESH_AXES)


# --- the placement rule ------------------------------------------------------

# The JAX package's tensor-parallel regexes over the port's names (a Flax
# ``kernel`` is the port's ``weight``, ``kernel_q`` its ``weight_q``,
# ``kernel_scale`` its ``weight_scale``): column-parallel q/k/v, MLP-up
# and fc1 kernels, row-parallel o/down/fc2 kernels, and the int8 scales of
# the column-split kernels.
_TP_COL = re.compile(
    r"(q_proj|k_proj|v_proj|gate_proj|up_proj|fc1|fc_in)\.weight(_q)?$")
_TP_ROW = re.compile(r"(o_proj|down_proj|out_proj|fc2|fc_out)\.weight(_q)?$")
_TP_COL_SCALE = re.compile(
    r"(q_proj|k_proj|v_proj|gate_proj|up_proj|fc1|fc_in)\.weight_scale$")

LAYOUTS = ("same", "transposed", "conv")


def _jax_view(shape: Sequence[int], layers: int, layout: str):
    """The tensor as the JAX package holds it: [(size, port dim or None)]
    per JAX dim. A port tensor of a scanned stack is one layer of a JAX
    array with a leading L; a Dense weight (out, in) and an int8 weight_q
    (..., out, in) are the JAX (..., in, out); the patch embedding (out,
    kh*kw*in) is the JAX (kh, kw, in, out), of whose dims only out is a
    port dim."""
    dims = [(int(s), d) for d, s in enumerate(shape)]
    if layout == "transposed":
        dims[-2:] = dims[-2:][::-1]
    elif layout == "conv":
        (out, _), (k, _) = dims
        dims = [(1, None), (1, None), (k, None), (out, 0)]
    elif layout != "same":
        raise ValueError(f"layout {layout!r}: expected one of {LAYOUTS}")
    return ([(layers, None)] if layers is not None else []) + dims


def _jax_spec(name: str, view, fsdp_size: int, tensor_size: int,
              min_fsdp_size: int, any_fsdp: bool = False) -> List:
    """The JAX package's param_pspec over the JAX view. ``any_fsdp``: pick
    the FSDP dim even at fsdp_size 1 (where every dim divides)."""
    ndim = len(view)
    spec = [None] * ndim
    if tensor_size > 1:
        if ndim >= 2 and _TP_COL.search(name) and \
                view[-1][0] % tensor_size == 0:
            spec[-1] = TENSOR_AXIS
        elif ndim >= 2 and _TP_ROW.search(name) and \
                view[-2][0] % tensor_size == 0:
            spec[-2] = TENSOR_AXIS
        elif _TP_COL_SCALE.search(name) and view[-1][0] % tensor_size == 0:
            spec[-1] = TENSOR_AXIS
    size = math.prod(s for s, _ in view)
    if (fsdp_size > 1 or any_fsdp) and size >= min_fsdp_size:
        # all but a stack's leading layer axis; the trailing dim first
        start = 1 if ndim >= 3 else 0
        for d in range(ndim - 1, start - 1, -1):
            if spec[d] is None and view[d][0] % fsdp_size == 0:
                spec[d] = FSDP_AXIS
                break
    return spec


def _to_port(spec, view, ndim: int) -> Tuple:
    out = [None] * ndim
    for axis, (_, port_dim) in zip(spec, view):
        if axis is not None and port_dim is not None:
            out[port_dim] = axis
    return tuple(out)


def param_pspec(name: str, shape: Sequence[int], fsdp_size: int,
                tensor_size: int = 1, min_fsdp_size: int = MIN_FSDP_SIZE,
                layers: Optional[int] = None, layout: str = "same") -> Tuple:
    """The mesh axis of each of the port tensor's dims (None: whole), by
    the JAX package's rule. FSDP: the largest divisible dim of a tensor of
    at least ``min_fsdp_size`` elements, the JAX layout's trailing dim
    first (a Dense weight's out dim, the port's dim 0), never a stack's
    leading layer axis. TP: the column-, row- and scale-parallel splits.
    ``layers``: the size of the scanned stack the tensor is one layer of
    (the JAX array's L; None outside a stack). ``layout``: "transposed" for a
    Dense weight and an int8 weight_q, "conv" for the patch embedding,
    else "same". Where the JAX rule picks a dim the port's tensor does not
    have (the L of an (L, N) stack, a patch kernel's kh/kw/in), the port
    keeps the tensor whole."""
    view = _jax_view(shape, layers, layout)
    spec = _jax_spec(name, view, fsdp_size, tensor_size, min_fsdp_size)
    return _to_port(spec, view, len(shape))


def param_layouts(model: nn.Module) -> Dict[str, Tuple[int, str]]:
    """(layers, layout) of each of the model's parameters, for
    :func:`param_pspec`."""
    from vla_adapter_torch.models.layers import Dense
    from vla_adapter_torch.models.vit import PatchEmbed

    out = {}
    for mod_name, module in model.named_modules():
        parts = mod_name.split(".") if mod_name else []
        layers = None
        for i in range(len(parts) - 1):
            if parts[i] in ("layers", "blocks") and parts[i + 1].isdigit():
                layers = len(model.get_submodule(".".join(parts[:i + 1])))
        for leaf, _ in module.named_parameters(recurse=False):
            if isinstance(module, PatchEmbed) and leaf in ("weight",
                                                           "weight_q"):
                layout = "conv"
            elif leaf == "weight_q" or (leaf == "weight"
                                        and isinstance(module, Dense)):
                layout = "transposed"
            else:
                layout = "same"
            out[".".join(parts + [leaf])] = (layers, layout)
    return out


def model_pspecs(model: nn.Module, fsdp_size: int, tensor_size: int = 1,
                 min_fsdp_size: int = MIN_FSDP_SIZE) -> Dict[str, Tuple]:
    """:func:`param_pspec` of every parameter of ``model``, by name."""
    params = dict(model.named_parameters())
    return {name: param_pspec(name, params[name].shape, fsdp_size,
                              tensor_size, min_fsdp_size, layers, layout)
            for name, (layers, layout) in param_layouts(model).items()}


def fsdp_dims(model: nn.Module, fsdp_size: int,
              min_fsdp_size: Optional[int] = None,
              tensor_size: int = 1) -> Dict[str, int]:
    """The dim FSDP splits, of each parameter the rule shards: the
    :func:`param_pspec` choice (after the "tensor" dim of a
    ``tensor_size`` split), taken at fsdp_size 1 too (every dim divides
    there, so the rule's first candidate). ``min_fsdp_size``: by default
    :data:`MIN_FSDP_SIZE`. The model's shapes are the whole ones."""
    if min_fsdp_size is None:
        min_fsdp_size = MIN_FSDP_SIZE
    params = dict(model.named_parameters())
    out = {}
    for name, (layers, layout) in param_layouts(model).items():
        view = _jax_view(params[name].shape, layers, layout)
        spec = _to_port(_jax_spec(name, view, fsdp_size, tensor_size,
                                  min_fsdp_size, any_fsdp=True),
                        view, params[name].ndim)
        if FSDP_AXIS in spec:
            out[name] = spec.index(FSDP_AXIS)
    return out


# --- per-process data ---------------------------------------------------------

def per_process_seed(seed: int, rank: Optional[int] = None,
                     tensor: int = 1) -> int:
    """A distinct, deterministic data seed per ("data", "fsdp")
    coordinate: ``seed`` and the coordinate (the rank over the ``tensor``
    ranks of a tensor group, the mesh's innermost dim) through a
    SeedSequence (the reference seeds one RLDS pipeline per rank, so ranks
    never repeat each other's shuffles; the ranks of a tensor group draw
    the same rows)."""
    pi = (process_index() if rank is None else rank) // tensor
    return int(np.random.SeedSequence([seed, pi]).generate_state(1)[0])


def process_local_batch_size(global_batch_size: int, tensor: int = 1) -> int:
    """This process's rows of the global batch (the config's batch size is
    global, whatever the topology): the batch over the ("data", "fsdp")
    ranks, the ranks of a tensor group holding the same rows."""
    n = process_count() // tensor
    assert global_batch_size % n == 0, (global_batch_size, n)
    return global_batch_size // n


# --- the model on the mesh ------------------------------------------------------

def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's part of a tensor: a DTensor's local shard, else the
    tensor."""
    return t.to_local() if _is_dtensor(t) else t


@dataclass
class Sharding:
    """How :func:`shard_model` placed a model: the mesh, the FSDP-managed
    parameters (name -> dim), the int8 ones held in part on "fsdp"
    outside FSDP2 (name -> dim of the tensor-split part; their buffers'
    dims are the Denses' own), the tensor-split ones (name -> dim of the
    whole tensor), the whole parameters a rank uses in part (their
    gradients summed over the tensor group), the tensor group and the group
    of the ("data", "fsdp") ranks that share this rank's tensor coordinate
    (None: the world, when tensor is 1)."""

    mesh: object
    fsdp_dims: Dict[str, int] = field(default_factory=dict)
    int8_dims: Dict[str, int] = field(default_factory=dict)
    tensor_dims: Dict[str, int] = field(default_factory=dict)
    tensor_partial: Sequence[str] = ()
    tp: object = None
    dp_group: object = None

    @property
    def dp_size(self) -> int:
        """The ranks whose rows differ: data x fsdp."""
        return self.mesh[DATA_AXIS].size() * self.mesh[FSDP_AXIS].size()

    def _fsdp_group(self):
        return self.mesh[FSDP_AXIS].get_group()

    def _mean_dp(self, flat: torch.Tensor) -> torch.Tensor:
        if self.dp_size > 1:
            dist.all_reduce(flat, group=self.dp_group)
            flat = flat / torch.full((), float(self.dp_size),
                                     dtype=flat.dtype, device=flat.device)
        return flat

    def reduce_gradients(self, grads: List[torch.Tensor],
                         names: Sequence[str] = ()) -> List[torch.Tensor]:
        """Average the gradients FSDP did not reduce (plain tensors) over
        the ("data", "fsdp") ranks, in one flat buffer per dtype; FSDP's
        own (DTensors, already reduce-scattered and averaged) pass through.
        Then sum the local parts of those of ``names`` that a rank uses in
        part (:attr:`tensor_partial`) over the tensor group, in one flat
        buffer per dtype."""
        out = list(grads)
        plain = [i for i, g in enumerate(grads) if not _is_dtensor(g)]
        _flat_apply(out, plain, self._mean_dp)
        partial = set(self.tensor_partial)
        summed = [i for i, n in enumerate(names) if n in partial]
        if summed:
            local_parts = [local(g) for g in out]
            _flat_apply(local_parts, summed, self.tp.all_reduce)
            for i in summed:
                out[i] = _with_local(out[i], local_parts[i])
        return out

    def global_norm(self, tensors: Sequence[torch.Tensor],
                    names: Sequence[str]) -> torch.Tensor:
        """``optim.global_norm`` of the full tensors from this rank's
        parts: each tensor's fp32 sum of squares, those of FSDP-sharded
        tensors summed over the "fsdp" group and those of tensor-split ones
        over the tensor group (whole ones counted once), then added in
        order (the unsharded sum's order) and the root taken."""
        sq = torch.stack([t.float().square().sum() for t in tensors])
        for split, reduce in (
                (self.fsdp_dims,
                 lambda t: dist.all_reduce(t, group=self._fsdp_group())),
                (self.tensor_dims, lambda t: self.tp.all_reduce(t))):
            mask = torch.as_tensor([n in split for n in names],
                                   device=sq.device)
            if mask.any():
                part = torch.where(mask, sq, torch.zeros_like(sq))
                reduce(part)
                sq = torch.where(mask, part, sq)
        return torch.sqrt(sum(sq.unbind()))

    def mean_metrics(self, metrics: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """The global batch's metrics: each scalar averaged over the
        ("data", "fsdp") ranks (every rank sees the same values: a tensor
        group's ranks hold the same rows)."""
        if not metrics:
            return metrics
        names = list(metrics)
        vec = self._mean_dp(torch.stack([metrics[k].float() for k in names]))
        return dict(zip(names, vec.unbind()))

    def full(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """The whole tensor of the parameter ``name`` (or its gradient) on
        every rank: a collective for a DTensor, an int8 part on "fsdp" or
        a tensor-split one."""
        from vla_adapter_torch.parallel.fsdp_int8 import gather_parts

        if _is_dtensor(t):
            t = t.full_tensor()
        elif name in self.int8_dims:
            t = gather_parts(t, self.int8_dims[name], self._fsdp_group(),
                             self.mesh[FSDP_AXIS].size(), "checkpoint")
        return self._tensor_gather(t, name)

    def full_shape(self, t: torch.Tensor, name: str) -> Tuple[int, ...]:
        """The shape :meth:`full` gives ``t`` (or :meth:`full_like` a
        tensor placed as ``t``), with no collective."""
        shape = list(t.shape)   # a DTensor's is whole on its mesh already
        if name in self.int8_dims and not _is_dtensor(t):
            shape[self.int8_dims[name]] *= self.mesh[FSDP_AXIS].size()
        if name in self.tensor_dims:
            shape[self.tensor_dims[name]] *= self.tp.size
        return tuple(shape)

    def _tensor_gather(self, t: torch.Tensor, name) -> torch.Tensor:
        if name not in self.tensor_dims:
            return t
        return torch.cat(self.tp.all_gather(t), dim=self.tensor_dims[name])

    def full_like(self, t: torch.Tensor, like: torch.Tensor,
                  name: str) -> torch.Tensor:
        """The whole tensor of ``t``, this rank's part of a tensor placed
        as the parameter ``like`` named ``name`` (an optimizer moment of a
        sharded or split parameter)."""
        if _is_dtensor(like):
            from torch.distributed.tensor import DTensor

            t = DTensor.from_local(t, like.device_mesh, like.placements,
                                   shape=like.shape,
                                   stride=like.stride()).full_tensor()
        return self._tensor_gather(t, name)

    def local_slice(self, full: torch.Tensor, like: torch.Tensor,
                    name: str) -> torch.Tensor:
        """This rank's part of the whole tensor ``full`` as the parameter
        ``like`` named ``name`` holds its own: its tensor-split part, then
        the DTensor's shard of that (shards are even: the rule picks
        divisible dims)."""
        out = full
        if name in self.tensor_dims:
            out = out.chunk(self.tp.size, dim=self.tensor_dims[name])[
                self.tp.rank]
        if _is_dtensor(like):
            mesh = like.device_mesh
            for i, placement in enumerate(like.placements):
                if placement.is_shard():
                    out = out.chunk(mesh.size(i), dim=placement.dim)[
                        mesh.get_local_rank(i)]
        return out.contiguous()


def _flat_apply(tensors: List[torch.Tensor], idx: Sequence[int], fn) -> None:
    """``fn`` over the tensors at ``idx`` as one flat buffer per dtype, the
    results written back into ``tensors`` (views of the buffer)."""
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i in idx:
        by_dtype.setdefault(tensors[i].dtype, []).append(i)
    for group in by_dtype.values():
        flat = fn(torch.cat([tensors[i].reshape(-1) for i in group]))
        offset = 0
        for i in group:
            n = tensors[i].numel()
            tensors[i] = flat[offset:offset + n].view_as(tensors[i])
            offset += n


def _with_local(t: torch.Tensor, part: torch.Tensor) -> torch.Tensor:
    """``t`` with its local part replaced by ``part`` (a DTensor keeps its
    placement)."""
    if not _is_dtensor(t):
        return part
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(part, t.device_mesh, t.placements,
                              shape=t.shape, stride=t.stride())


def _groups(model: nn.Module) -> List[nn.Module]:
    """The modules FSDP2 gathers and frees as one group each, before the
    rest of the model: each vision tower, the action head and each decoder
    layer (Qwen2's, which also serves the Llama-2, Vicuna and Mistral
    backbones, and Phi's). The decoder's embedding and final norm stay in
    the root group: the VLA reads the embedding outside the decoder's
    forward. FSDP2 adds an autograd node on a group's inputs, where the
    gradients of a layer's two reads of its input (its residual and its
    norm) are summed before the hidden-state stack's is added; the
    decoders give each layer its input through one node of their own
    (``models.layers.layer_input``), so that a run without groups sums in
    that order too and the two stay equal bit for bit."""
    from vla_adapter_torch.models.action_head import L1RegressionActionHead
    from vla_adapter_torch.models.vit import VisionTransformer

    return [m for m in model.modules()
            if isinstance(m, (VisionTransformer, L1RegressionActionHead))
            ] + decoder_layers(model)


def decoder_layers(model: nn.Module) -> List[nn.Module]:
    """The model's decoder layers, each an FSDP2 group of its own under
    "fsdp"."""
    from vla_adapter_torch.models.phi import PhiDecoderLayer
    from vla_adapter_torch.models.qwen2 import Qwen2DecoderLayer

    return [m for m in model.modules()
            if isinstance(m, (Qwen2DecoderLayer, PhiDecoderLayer))]


def _dp_group(mesh):
    """The process group of the ("data", "fsdp") ranks that share this
    rank's tensor coordinate; every rank creates every such group, in
    order (None, the world, when the tensor dim is 1)."""
    tensor = mesh[TENSOR_AXIS].size()
    if tensor == 1:
        return None
    ranks = mesh.mesh.reshape(-1, tensor)
    mine = None
    for t in range(tensor):
        group = dist.new_group(ranks[:, t].tolist())
        if t == mesh[TENSOR_AXIS].get_local_rank():
            mine = group
    return mine


def split_tensor_(model: nn.Module, mesh, transport=None
                  ) -> Tuple[Dict[str, int], List[str], object]:
    """Split every parameter :func:`param_pspec` gives the "tensor" axis,
    in place, to this rank's part: each such weight (or int8 weight and,
    column-split, its scale) is a ``Dense``'s, which takes the role the
    rule gives it ("col" for the output dim, "row" for the input dim;
    ``Dense.split_``). ``transport``: None (the collectives over the
    tensor group's backend), or ``transport(group, rank, size, device)``
    making the object they go through instead
    (``parallel.tensor.TensorGroup``). Returns (name -> split dim, the
    whole parameters a rank uses in part, the ``TensorGroup``)."""
    from vla_adapter_torch.models.layers import Dense
    from vla_adapter_torch.parallel.tensor import TensorGroup

    sub = mesh[TENSOR_AXIS]
    group, rank = sub.get_group(), sub.get_local_rank()
    if transport is not None:
        transport = transport(group, rank, sub.size(),
                              next(model.parameters()).device)
    tg = TensorGroup(group, rank, sub.size(), transport)
    specs = model_pspecs(model, mesh[FSDP_AXIS].size(), tg.size)
    split = {n: spec.index(TENSOR_AXIS) for n, spec in specs.items()
             if TENSOR_AXIS in spec}
    done = set()
    for mod_name, module in model.named_modules():
        if not isinstance(module, Dense):
            continue
        prefix = f"{mod_name}." if mod_name else ""
        weight = prefix + ("weight_q" if module.rt.weights_int8 else "weight")
        if weight not in split:
            continue
        mode = "col" if split[weight] == 0 else "row"
        scale = prefix + "weight_scale"
        if module.rt.weights_int8 and (scale in split) != (mode == "col"):
            raise ValueError(f"{scale}: the rule splits it with a {mode} "
                             "weight" + (" not" if mode == "col" else ""))
        module.split_(mode, tg)
        done |= {weight, scale} if scale in split else {weight}
    missed = sorted(set(split) - done)
    if missed:
        raise ValueError(f"the rule splits {missed[:4]} over \"tensor\", "
                         "which no Dense holds")
    partial = []
    for mod_name, module in model.named_modules():
        prefix = f"{mod_name}." if mod_name else ""
        partial += [prefix + leaf for leaf in
                    getattr(module, "tensor_partial", lambda: [])()]
    return split, partial, tg


def shard_int8_(model: nn.Module, dims: Dict[str, int], fsdp_mesh
                ) -> Dict[str, int]:
    """Cut each Dense's int8 weight named in ``dims`` (name -> the rule's
    dim of its ``weight_q``) to this rank's part on the one-dim
    ``fsdp_mesh`` (``Dense.shard_int8_``): ``weight_q`` on that dim, its
    ``weight_qt`` on dim 0 (dim 1 where dim 0 does not divide), a row
    split's ``weight_qk`` on ``weight_q``'s dim; then pack each layer's
    parts to be gathered together (``fsdp_int8.Int8Layer``). Returns the
    dims of every tensor cut, buffers included, by name."""
    from vla_adapter_torch.models.layers import Dense
    from vla_adapter_torch.parallel.fsdp_int8 import Int8Layer, Int8Parts

    group, size = fsdp_mesh.get_group(), fsdp_mesh.size()
    rank = fsdp_mesh.get_local_rank()
    out, done = {}, set()
    layers: Dict[str, List[nn.Module]] = {}
    for mod_name, module in model.named_modules():
        prefix = f"{mod_name}." if mod_name else ""
        if prefix + "weight_q" not in dims:
            continue
        if not isinstance(module, Dense):
            raise ValueError(f"{prefix}weight_q: the rule shards an int8 "
                             "tensor no Dense holds")
        own = {"weight_q": dims[prefix + "weight_q"]}
        qt = module.weight_qt if module.ste else None
        if qt is not None:
            fits = [d for d in (0, 1) if qt.shape[d] % size == 0]
            if fits:
                own["weight_qt"] = fits[0]
        if module.ste and module.weight_qk is not None:
            own["weight_qk"] = own["weight_q"]
        module.shard_int8_(Int8Parts(group, rank, size, own))
        layers.setdefault(_layer_of(mod_name), []).append(module)
        out.update({prefix + k: d for k, d in own.items()})
        done.add(prefix + "weight_q")
    missed = sorted(set(dims) - done)
    if missed:
        raise ValueError(f"int8 tensors {missed[:4]} are held by no Dense")
    for denses in layers.values():
        Int8Layer(denses)
    return out


def _layer_of(module_name: str) -> str:
    """The layer whose Denses gather their int8 parts together: the module
    path up to its first index (an entry of a module list: a decoder
    layer, a tower block), else the Dense's own path."""
    parts = module_name.split(".")
    for i, part in enumerate(parts):
        if part.isdigit():
            return ".".join(parts[:i + 1])
    return module_name


def shard_model(model: nn.Module, mesh, tensor_transport=None) -> Sharding:
    """Place ``model`` (its whole state on this rank's device) on
    ``mesh``. On a "tensor" dim above 1, first the Megatron splits
    (:func:`split_tensor_`); then ``models.layers.prepare_ste_`` builds the
    int8 base's transposed copies from the local parts. On an "fsdp" dim
    below :data:`MIN_FSDP_RANKS` nothing more moves: the step averages the
    gradients ("data"). Otherwise every tensor the rule shards
    (:data:`MIN_FSDP_SIZE`) is split on its dim (after the tensor dim),
    frozen ones included: the int8 weights outside FSDP2
    (:func:`shard_int8_`: FSDP2 in torch 2.11 makes each sharded parameter
    with ``requires_grad=True``, which an integer tensor refuses; each
    layer gathers its weights for a pass in one all-gather), the
    floating-point ones by FSDP2 ``fully_shard``, in one group per vision
    tower, one for the action head and one per decoder layer (each
    gathered for its forward, freed after it and gathered again for its
    backward, which also covers its recompute), and one for the rest; HSDP over ("data", "fsdp") when
    "data" is above 1. Parameters the rule leaves whole stay whole
    (``ignored_params``). Re-read the model's parameters afterwards: FSDP2
    replaces them with DTensors, and the splits with their parts.
    ``tensor_transport``: :func:`split_tensor_`'s ``transport``."""
    if mesh.size() != process_count():
        raise ValueError(f"a mesh of {mesh.size()} ranks in a group of "
                         f"{process_count()}: every rank trains")
    fsdp_size = mesh[FSDP_AXIS].size()
    tensor = mesh[TENSOR_AXIS].size()
    sharding = Sharding(mesh=mesh, dp_group=_dp_group(mesh))
    # the FSDP dims from the whole shapes, before the tensor split
    dims = fsdp_dims(model, fsdp_size, tensor_size=tensor)
    if tensor > 1:
        (sharding.tensor_dims, sharding.tensor_partial,
         sharding.tp) = split_tensor_(model, mesh, tensor_transport)
    from vla_adapter_torch.models.layers import prepare_ste_

    prepare_ste_(model)
    if fsdp_size < MIN_FSDP_RANKS:
        return sharding
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    floating = {n for n, p in model.named_parameters()
                if p.is_floating_point()}
    int8 = {n: d for n, d in dims.items() if n not in floating}
    shard_int8_(model, int8, mesh[FSDP_AXIS])
    sharding.int8_dims = int8
    params = dict(model.named_parameters())
    dims = {n: d for n, d in dims.items() if n in floating}
    by_id = {id(params[n]): d for n, d in dims.items()}
    dp_mesh = (mesh[(DATA_AXIS, FSDP_AXIS)] if mesh[DATA_AXIS].size() > 1
               else mesh[FSDP_AXIS])
    ignored = {p for n, p in params.items() if n not in dims}
    for module in _groups(model) + [model]:
        fully_shard(module, mesh=dp_mesh,
                    shard_placement_fn=lambda p: Shard(by_id[id(p)]),
                    ignored_params=ignored)
    sharding.fsdp_dims = dims
    return sharding
