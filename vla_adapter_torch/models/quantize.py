"""Int8 weight quantization for serving (counterpart of
vla_adapter_tpu/models/quantize.py).

Symmetric per-output-channel quantization of every Dense and BatchedDense
weight: ``weight ~ weight_q (int8) * weight_scale[out]``, the scale
``absmax * float32(1/127)`` (0 becomes 1), rounding half to even, clipped
to +-127: bit for bit the JAX package's numpy ``quantize_kernel``. The
patch embedding (a convolution in the JAX package), embeddings, norms and
biases stay float.

The quantizer runs on whatever device the weight is on, so a Predictor
quantizes on the card at construction (``quantize_state_dict``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_INV_127 = float(np.float32(1.0 / 127.0))  # exactly representable in f32


def quantize_kernel(kernel: torch.Tensor, in_axis: int = -2
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """kernel float with its ``in`` axis at ``in_axis`` (-2 for the JAX
    package's (..., in, out) kernels, -1 for the port's (..., out, in)
    weights) -> (int8 kernel_q of the same shape, float32 per-out-channel
    scale without the in axis)."""
    k = kernel.float()
    absmax = k.abs().amax(dim=in_axis, keepdim=True)
    scale = absmax * _INV_127
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.round(k / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale.squeeze(in_axis)


def quantize_weight(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The port's (..., out, in) weight -> (weight_q (..., out, in) int8,
    weight_scale (..., out) float32)."""
    return quantize_kernel(weight, in_axis=-1)


def quantize_state_dict(state: Mapping[str, torch.Tensor],
                        expected: Mapping[str, torch.Tensor],
                        device=None) -> Dict[str, torch.Tensor]:
    """Fill the state an int8 model expects from a float or quantized one.

    ``expected`` is the int8 model's own state_dict (e.g. built on the meta
    device): for each ``<name>.weight_q`` it wants, a float
    ``<name>.weight`` in ``state`` (Dense, (out, in)) or ``<name>.kernel``
    (BatchedDense, the JAX (L, in, out) layout) is moved to ``device`` and
    quantized there; entries that are already quantized pass through. The
    float originals are not kept."""
    out, used = {}, set()
    for key in expected:
        if key in state:
            out[key] = state[key] if device is None else state[key].to(device)
            used.add(key)
            continue
        prefix, leaf = key.rsplit(".", 1)
        if leaf == "weight_scale":
            continue  # filled with its weight_q
        if leaf != "weight_q":
            raise KeyError(f"{key} is missing from the state")
        if prefix + ".weight" in state:
            src = prefix + ".weight"
            w = state[src]
        elif prefix + ".kernel" in state:
            src = prefix + ".kernel"
            w = state[src].transpose(-1, -2)
        else:
            raise KeyError(f"{key}: no float weight under {prefix}")
        q, scale = quantize_weight(w if device is None else w.to(device))
        out[key] = q.contiguous()
        out[prefix + ".weight_scale"] = scale
        used.add(src)
    unused = sorted(set(state) - used)
    if unused:
        raise KeyError(f"unexpected entries in the state: {unused[:5]}")
    return out


def _quantized_names(cfg) -> list:
    """The ``<name>`` of every ``<name>.weight_q`` that an int8 VLAModel of
    ``cfg`` holds: each Dense and BatchedDense but the patch embeddings."""
    from vla_adapter_torch.models.layers import Runtime
    from vla_adapter_torch.models.vla import VLAModel

    model = VLAModel(cfg, Runtime(weights_int8=True), device="meta")
    return [k[:-len(".weight_q")] for k in model.state_dict()
            if k.endswith(".weight_q")]


def _float_kernel(state: Mapping[str, torch.Tensor], name: str
                  ) -> torch.Tensor:
    """The float weight of ``name`` as the JAX package's (..., in, out)
    kernel: a Dense's (out, in) ``weight`` transposed, a BatchedDense's
    (L, in, out) ``kernel`` as it is."""
    if name + ".kernel" in state:
        return state[name + ".kernel"]
    return state[name + ".weight"].transpose(-1, -2)


def quantization_report(params: Mapping[str, torch.Tensor], cfg,
                        top_k: int = 10) -> Dict[str, object]:
    """The int8 round trip's error per quantized weight of a float state
    dict, so that "validate before deploying" has a number: every weight
    the int8 tiers quantize (``cfg`` says which) is quantized per output
    channel and dequantized. Returns {"per_layer": {name: {"max_abs_err",
    "rel_err" (over the weight's absmax), "shape" (in, ..., out as the JAX
    package's kernels)}}, "worst": [(name, rel_err), ... top_k],
    "max_rel_err": float}. Names are the state dict's, without
    ``.weight``/``.kernel``; a scanned layer of the JAX package's stacks is
    an entry of its own here."""
    per_layer: Dict[str, Dict[str, object]] = {}
    for name in _quantized_names(cfg):
        k = _float_kernel(params, name).detach().float()
        q, scale = quantize_kernel(k)
        err = (q.float() * scale.unsqueeze(-2) - k).abs()
        denom = max(float(k.abs().max()), 1e-12)
        per_layer[name] = {"max_abs_err": float(err.max()),
                           "rel_err": float(err.max()) / denom,
                           "shape": list(k.shape)}
    worst = sorted(per_layer.items(),
                   key=lambda kv: -kv[1]["rel_err"])[:top_k]
    return {"per_layer": per_layer,
            "worst": [(n, d["rel_err"]) for n, d in worst],
            "max_rel_err": max((d["rel_err"] for d in per_layer.values()),
                               default=0.0)}


def forward_error_report(cfg, params: Mapping[str, torch.Tensor], rt=None,
                         batch: int = 1, seed: int = 0,
                         act_int8: bool = False,
                         device="cuda") -> Dict[str, float]:
    """The int8 tier's action error on a fixed random forward: the float
    model against weight-only int8 (or, with ``act_int8``, w8a8) on the
    same weights and the same seeded inputs (the JAX package's, drawn with
    numpy), max and mean abs diff over the (B, chunk, dim) chunk in
    normalized action units (the [-1, 1] training space). The number to
    check before serving a quantized tier. Runs on ``device`` (the card
    unless "cpu"); the quantized copy is made there."""
    import dataclasses

    from vla_adapter_torch.infer.predict import resolve_device
    from vla_adapter_torch.models.layers import Runtime
    from vla_adapter_torch.models.vla import VLAModel

    device = resolve_device(device)
    rt = rt or Runtime(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    rng = np.random.default_rng(seed)
    v = cfg.vision
    inputs = dict(
        input_ids=torch.from_numpy(rng.integers(
            3, min(cfg.llm.vocab_size, 10_000),
            size=(batch, cfg.max_text_tokens))).to(device),
        prompt_len=torch.full((batch,), 8, dtype=torch.long, device=device),
        text_valid=torch.ones((batch, cfg.max_text_tokens),
                              dtype=torch.int32, device=device),
        pixel_values=torch.from_numpy(rng.normal(size=(
            batch, v.num_images, v.primary.image_size, v.primary.image_size,
            v.channels_per_image)).astype(np.float32)).to(device, rt.dtype),
        proprio=torch.from_numpy(rng.normal(
            size=(batch, cfg.constants.proprio_dim)).astype(np.float32)
        ).to(device))

    def actions(model_rt, state):
        model = VLAModel(cfg, model_rt, device="meta")
        model.load_state_dict(state, strict=True, assign=True)
        with torch.inference_mode():
            return model.eval()(**inputs)["actions"].float()

    float_state = {k: t.to(device, rt.param_dtype) for k, t in params.items()}
    a_float = actions(rt, float_state)
    q_rt = dataclasses.replace(rt, weights_int8=True, act_int8=act_int8)
    expected = VLAModel(cfg, q_rt, device="meta").state_dict()
    a_int8 = actions(q_rt, quantize_state_dict(float_state, expected,
                                               device))
    diff = (a_float - a_int8).abs()
    return {"max_abs_action_diff": float(diff.max()),
            "mean_abs_action_diff": float(diff.mean())}


def dequantize_params(params: Mapping[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """The inverse (lossy) of the quantization: every ``weight_q`` /
    ``weight_scale`` pair becomes a float32 ``weight`` (a Dense, (out, in))
    or ``kernel`` (a BatchedDense stack, (L, in, out)), which a float model
    loads."""
    out = {}
    for key, val in params.items():
        if key.endswith(".weight_scale"):
            continue
        if not key.endswith(".weight_q"):
            out[key] = val
            continue
        prefix = key[:-len(".weight_q")]
        w = val.float() * params[prefix + ".weight_scale"].float()[..., None]
        if w.dim() == 3:
            out[prefix + ".kernel"] = w.transpose(-1, -2)
        else:
            out[prefix + ".weight"] = w
    return out
