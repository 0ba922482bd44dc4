"""The JAX package's Flax param tree -> the port's state_dict.

``from_jax_params(params, cfg)`` takes the tree as nested dicts of numpy
arrays (``jax.device_get`` of the Flax params) and returns a state_dict for
the port's module of the same tree: ``models.vla.VLAModel`` or
``models.vlm.PrismaticVLM`` (``cfg`` a VLAConfig; a Qwen2 or Phi language
model, the Llama-2 and Mistral zoo backbones among the Qwen2 family: no
attention bias, GQA, the tied head both packages build), or a bare
``Qwen2Model`` / ``PhiModel`` (``cfg`` its LLM config).
The port's module names mirror the Flax names, so the mapping is by
rule:

* scanned stacks carry a leading layer axis — ``layers/layer/...`` and
  ``blocks/block/...`` become ``layers.<i>.`` / ``blocks.<i>.``;
* a Dense kernel ``(in, out)`` becomes the ``(out, in)`` weight; the patch
  conv kernel ``(kh, kw, in, out)`` is flattened to ``(out, kh*kw*in)``;
  the head's hoisted stacks (``k_adapter``/``v_adapter``/``k_task``/
  ``v_task``, kernel ``(L, in, out)``) keep their layout as ``kernel``;
* norm ``scale`` and embedding ``embedding`` become ``weight``;
* a quantized tree (the JAX package's ``quantize_params``) carries over
  too: ``kernel_q`` (in, out) becomes the ``(out, in)`` int8 ``weight_q``
  (a BatchedDense stack (L, in, out) becomes (L, out, in)) and
  ``kernel_scale`` becomes ``weight_scale``, for a model built with
  ``Runtime(weights_int8=True)``. A float tree serves an int8 model as
  well: the Predictor quantizes it (models/quantize.py);
* LoRA adapters ``lora_a`` (in, r) and ``lora_b`` (r, out) keep their
  names and layout.

``from_jax_opt_state(opt_state, cfg)`` carries an optax Adam state (the
JAX training state's ``opt_state``, ``jax.device_get``-ed) over as the
port's optimizer state (``train/optim.py``): the step count and the
moments ``mu``, ``nu`` by the port's parameter names.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from vla_adapter_torch.core.config import PhiConfig, Qwen2Config

_SCANNED = {"layers": "layer", "blocks": "block"}


def _flatten(tree: Mapping[str, Any], prefix=()) -> Dict[tuple, np.ndarray]:
    """Leaves by path; float leaves (fp32, or bf16 from ml_dtypes) as fp32."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out.update(_flatten(val, prefix + (key,)))
        else:
            arr = np.asarray(val)
            out[prefix + (key,)] = (arr if arr.dtype.kind in "biu"
                                    else arr.astype(np.float32))
    return out


def _leaf(name: str, arr: np.ndarray):
    """(torch leaf name, array) for one Flax leaf of one layer."""
    if name == "kernel":
        if arr.ndim == 2:
            return "weight", arr.T
        if arr.ndim == 4:  # patch conv (kh, kw, in, out)
            return "weight", arr.reshape(-1, arr.shape[-1]).T
        return "kernel", arr  # BatchedDense stack (L, in, out)
    if name == "kernel_q":
        return "weight_q", np.swapaxes(arr, -1, -2)
    if name == "kernel_scale":
        return "weight_scale", arr
    if name in ("scale", "embedding"):
        return "weight", arr
    return name, arr


def _scan_axis(path: tuple):
    """Index i where path[i:i+2] is a scanned stack (``layers/layer`` or
    ``blocks/block``), else None."""
    for i in range(len(path) - 2):
        if _SCANNED.get(path[i]) == path[i + 1]:
            return i
    return None


def _layer_counts(cfg) -> dict:
    """Layers of each scanned stack's owner; None: a bare LLM's stack."""
    if isinstance(cfg, (Qwen2Config, PhiConfig)):
        return {None: cfg.num_layers}
    counts = {"language_model": cfg.llm.num_layers,
              "featurizer": cfg.vision.primary.resolved_feature_layer + 1,
              "action_head": cfg.head.num_blocks}
    if cfg.vision.fused is not None:
        counts["fused_featurizer"] = cfg.vision.fused.resolved_feature_layer + 1
    return counts


def from_jax_params(params: Mapping[str, Any],
                    cfg) -> Dict[str, torch.Tensor]:
    """Flax params -> the port's state_dict: fp32 tensors, and int8
    ``weight_q`` with fp32 ``weight_scale`` from a quantized tree.

    ``cfg`` (a VLAConfig, or the LLM config of a bare decoder tree) is
    checked against the tree's layer counts."""
    counts = _layer_counts(cfg)
    state = {}

    def put(key_parts, name, arr):
        leaf, val = _leaf(name, arr)
        state[".".join(key_parts + (leaf,))] = torch.from_numpy(
            np.ascontiguousarray(val))

    for path, arr in _flatten(params).items():
        i = _scan_axis(path)
        if i is None:
            put(path[:-1], path[-1], arr)
            continue
        owner = next((p for p in reversed(path[:i]) if p in counts), None)
        if arr.shape[0] != counts[owner]:
            raise ValueError(f"{'/'.join(path)}: {arr.shape[0]} layers, "
                             f"config says {counts[owner]}")
        head, tail = path[:i + 1], path[i + 2:]
        for layer in range(arr.shape[0]):
            put(head + (str(layer),) + tail[:-1], tail[-1], arr[layer])
    return state


def _adam_state(node):
    """The first node of an optax state tree with ``count``, ``mu`` and
    ``nu`` (ScaleByAdamState), depth first."""
    if all(hasattr(node, a) for a in ("count", "mu", "nu")):
        return node
    if isinstance(node, (tuple, list)):
        for child in node:
            found = _adam_state(child)
            if found is not None:
                return found
    return None


def from_jax_opt_state(opt_state, cfg,
                       moments_dtype: Optional[torch.dtype] = None) -> dict:
    """An optax Adam state -> {"count": int64 scalar, "mu": {name: tensor},
    "nu": {...}}, the moments in ``moments_dtype`` (default: float32)."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the optimizer "
                         "state")
    dtype = moments_dtype or torch.float32

    def moments(tree):
        return {k: v.to(dtype) for k, v in from_jax_params(tree, cfg).items()}

    return {"count": torch.tensor(int(np.asarray(adam.count)),
                                  dtype=torch.int64),
            "mu": moments(adam.mu), "nu": moments(adam.nu)}
