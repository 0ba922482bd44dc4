"""Projector MLPs (counterpart of vla_adapter_tpu/models/projector.py).

* :class:`FusedProjector` — vision -> LLM: 2176 -> 4*2176 -> 896 -> 896 with
  erf-GELUs between.
* :class:`Projector` — single tower: vision -> llm -> llm, one GELU.
* :class:`ProprioProjector` — proprio -> llm: fc1 -> GELU -> fc2.

Under the fused w8a8 backend, when every width clears act_int8_min_dim,
fc1 -> GELU -> fc2 of the first two is one launch of kernel B3.
"""

from __future__ import annotations

import torch
from torch import nn

from vla_adapter_torch.models.layers import Dense, Runtime, fused_mlp, gelu


class FusedProjector(nn.Module):
    def __init__(self, vision_dim: int, llm_dim: int, rt: Runtime,
                 device=None):
        super().__init__()
        self.rt = rt
        self.dims = (vision_dim, 4 * vision_dim, llm_dim)
        self.fc1 = Dense(vision_dim, 4 * vision_dim, rt=rt, device=device)
        self.fc2 = Dense(4 * vision_dim, llm_dim, rt=rt, device=device)
        self.fc3 = Dense(llm_dim, llm_dim, rt=rt, device=device)

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        if self.rt.fused_mlp(*self.dims):
            x = fused_mlp(patches, self.fc1, self.fc2, "gelu", self.rt)
        else:
            x = self.fc2(gelu(self.fc1(patches), approximate=False))
        return self.fc3(gelu(x, approximate=False))


class Projector(nn.Module):
    def __init__(self, vision_dim: int, llm_dim: int, rt: Runtime,
                 device=None):
        super().__init__()
        self.rt = rt
        self.dims = (vision_dim, llm_dim, llm_dim)
        self.fc1 = Dense(vision_dim, llm_dim, rt=rt, device=device)
        self.fc2 = Dense(llm_dim, llm_dim, rt=rt, device=device)

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        if self.rt.fused_mlp(*self.dims):
            return fused_mlp(patches, self.fc1, self.fc2, "gelu", self.rt)
        return self.fc2(gelu(self.fc1(patches), approximate=False))


class ProprioProjector(nn.Module):
    """proprio (B, P) -> (B, llm_dim)."""

    def __init__(self, proprio_dim: int, llm_dim: int, rt: Runtime,
                 device=None):
        super().__init__()
        self.rt = rt
        self.fc1 = Dense(proprio_dim, llm_dim, rt=rt, device=device)
        self.fc2 = Dense(llm_dim, llm_dim, rt=rt, device=device)

    def forward(self, proprio: torch.Tensor) -> torch.Tensor:
        x = gelu(self.fc1(proprio.to(self.rt.dtype)), approximate=False)
        return self.fc2(x)
