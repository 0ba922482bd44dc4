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
