"""Trainable vs frozen parameters (counterpart of
vla_adapter_tpu/train/partition.py).

The reference recipe trains LoRA adapters on every linear of the VLM, the
action queries, the action head and the proprio projector; the base VLM
stays frozen. The port splits the model's state dict by name (the JAX
tree's paths joined with "."), the same rule over the same names, and
marks the frozen tensors ``requires_grad=False`` so that autograd never
computes their gradients.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
from torch import nn


def is_trainable_path(path: Tuple[str, ...], lora_enabled: bool) -> bool:
    """The reference's trainability rule over a parameter's path."""
    if not lora_enabled:
        return True  # full finetune
    if path[0] in ("action_head", "proprio_projector"):
        return True
    if path[-1] in ("lora_a", "lora_b"):
        return True
    return path[0] == "action_queries"


def split_tree(state: Dict[str, torch.Tensor],
               pred: Callable[[Tuple[str, ...]], bool]
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Split a state dict into (matching, rest) by ``pred`` on each name's
    path."""
    a, b = {}, {}
    for name, value in state.items():
        (a if pred(tuple(name.split("."))) else b)[name] = value
    return a, b


def merge_trees(a: Dict[str, torch.Tensor],
                b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`split_tree` for disjoint state dicts."""
    overlap = sorted(set(a) & set(b))
    if overlap:
        raise ValueError(f"overlapping entries {overlap[:5]}")
    return {**a, **b}


def split_trainable(state: Dict[str, torch.Tensor], lora_enabled: bool):
    """(trainable, frozen) per the reference recipe."""
    return split_tree(state, lambda p: is_trainable_path(p, lora_enabled))


def mark_trainable_(model: nn.Module, lora_enabled: bool) -> List[str]:
    """Set ``requires_grad`` on the model's parameters by the rule and
    return the trainable names, in the model's order."""
    names = []
    for name, param in model.named_parameters():
        train = is_trainable_path(tuple(name.split(".")), lora_enabled)
        param.requires_grad_(train)
        if train:
            names.append(name)
    return names
