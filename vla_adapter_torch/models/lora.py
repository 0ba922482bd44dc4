"""LoRA merge, strip and graft over the port's state dict (counterpart of
vla_adapter_tpu/models/lora.py).

Every Dense holds its adapters as ``<name>.lora_a`` (in, r) and
``<name>.lora_b`` (r, out) beside its ``(out, in)`` ``<name>.weight``
(``models/layers.py``). Merging folds ``scale * (A @ B)`` into a float
weight and drops the adapters; as in the JAX package, only a node with a
float weight is folded: a Dense of an int8 base (``weight_q``) keeps its
adapters unmerged.
"""

from __future__ import annotations

from typing import Dict

import torch

_ADAPTERS = ("lora_a", "lora_b")


def _prefix(name: str) -> str:
    return name.rsplit(".", 1)[0]


def merge_lora(state: Dict[str, torch.Tensor],
               scale: float) -> Dict[str, torch.Tensor]:
    """Fold each float weight's adapters into it (in float32, cast back to
    the weight's dtype) and drop them; adapters beside an int8
    ``weight_q`` pass through unmerged. Returns a new state dict, which a
    model built with ``lora_rank=0`` loads when every Dense was float."""
    out = {}
    for name, value in state.items():
        leaf = name.rsplit(".", 1)[-1]
        prefix = _prefix(name)
        if leaf in _ADAPTERS and prefix + ".weight" in state:
            continue  # folded below
        if leaf == "weight" and prefix + ".lora_a" in state:
            a = state[prefix + ".lora_a"].float()
            b = state[prefix + ".lora_b"].float()
            delta = scale * (a @ b)                   # (in, out)
            value = (value.float() + delta.t()).to(value.dtype)
        out[name] = value
    return out


def strip_lora(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Drop every adapter without merging (back to the base)."""
    return {k: v for k, v in state.items()
            if k.rsplit(".", 1)[-1] not in _ADAPTERS}


def add_lora_params(state: Dict[str, torch.Tensor],
                    reference: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """Graft the adapters of ``reference`` (the state of a model built
    with lora_rank > 0, e.g. freshly initialized) onto an adapter-free
    ``state``. Strict: the only difference allowed is the adapters; an
    entry of ``state`` the reference lacks, or a non-adapter entry of the
    reference missing from ``state``, raises."""
    extra = sorted(set(state) - set(reference))
    if extra:
        raise ValueError(f"checkpoint entries {extra[:5]} do not exist in "
                         "the model: wrong config or stale checkpoint")
    out = {}
    for name, value in reference.items():
        if name in state:
            out[name] = state[name]
        elif name.rsplit(".", 1)[-1] in _ADAPTERS:
            out[name] = value
        else:
            raise ValueError(f"checkpoint is missing {name!r}")
    return out
