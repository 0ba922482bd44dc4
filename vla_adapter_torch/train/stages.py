"""Training-stage freeze policies (counterpart of
vla_adapter_tpu/train/stages.py; the reference's
``PrismaticVLM.freeze_backbones(stage)``).

Each stage is a predicate over a parameter's path (its state-dict name
split at "."), which ``train/partition.split_tree`` uses:

  align               projector only
  finetune            projector + LLM
  full-finetune       everything
  last-layer-finetune embeddings + the LAST decoder layer (+ the tied head)
  vla-train           projector + LLM (vision frozen) + action modules
  vla-full-train      everything + action modules
  vla-sandwich-train  vision + projector + last LLM layer + action modules
  lora                LoRA adapters + action modules (the finetune recipe)

The two last-layer stages keep the JAX package's rule: the predicate takes
the embedding and every decoder layer, and :func:`stage_update_mask`
gives each layer's tensors a mask, 1 for the last layer and 0 for the
others, that ``train/optim.mask_updates`` applies around the optimizer:
every other layer gets exactly zero updates, zero Adam moments and no
weight decay, as the JAX package's (L, ...) mask gives its stacked
layers. Trainability comes from the predicate alone: the embedding, frozen
at construction, trains where the stage says so.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

Path = Tuple[str, ...]

# stages whose LLM trainability is "embeddings + last decoder layer" only
_LAST_LAYER_STAGES = ("last-layer-finetune", "vla-sandwich-train")
_ACTION_MODULES = ("action_head", "proprio_projector", "action_queries")
STAGES = ("align", "finetune", "full-finetune", "last-layer-finetune",
          "vla-train", "vla-full-train", "vla-sandwich-train", "lora")


def _is_action(path: Path) -> bool:
    return path[0] in _ACTION_MODULES


def _is_projector(path: Path) -> bool:
    return path[0] == "projector"


def _is_vision(path: Path) -> bool:
    return path[0] == "vision_backbone"


def _is_llm(path: Path) -> bool:
    return path[0] == "language_model"


def _is_llm_embed_or_layers(path: Path) -> bool:
    return tuple(path[:2]) in (("language_model", "embed"),
                               ("language_model", "layers"))


def stage_predicate(stage: str) -> Callable[[Path], bool]:
    if stage == "align":
        return _is_projector
    if stage == "finetune":
        return lambda p: _is_projector(p) or _is_llm(p)
    if stage in ("full-finetune", "vla-full-train"):
        return lambda p: True
    if stage == "last-layer-finetune":
        return _is_llm_embed_or_layers
    if stage == "vla-train":
        return lambda p: _is_projector(p) or _is_llm(p) or _is_action(p)
    if stage == "vla-sandwich-train":
        return lambda p: (_is_vision(p) or _is_projector(p)
                          or _is_llm_embed_or_layers(p) or _is_action(p))
    if stage == "lora":
        return lambda p: _is_action(p) or p[-1] in ("lora_a", "lora_b")
    raise ValueError(f"unknown training stage {stage!r}")


def split_by_stage(state: Dict[str, torch.Tensor], stage: str):
    """(trainable, frozen) state dicts for ``stage``."""
    from vla_adapter_torch.train.partition import split_tree

    return split_tree(state, stage_predicate(stage))


def stage_update_mask(trainable: Dict[str, torch.Tensor], stage: str
                      ) -> Optional[Dict[str, torch.Tensor]]:
    """For the last-layer stages, {name: 0-d float32 mask} for every
    trainable tensor of a decoder layer (1 on the last layer, 0 on the
    others), for ``train/optim.mask_updates``; None for the other stages."""
    if stage not in _LAST_LAYER_STAGES:
        return None
    last = max(int(n.split(".")[2]) for n in trainable
               if n.startswith("language_model.layers."))
    return {n: torch.full((), float(int(n.split(".")[2]) == last),
                          device=t.device)
            for n, t in trainable.items()
            if n.startswith("language_model.layers.")}
