"""Projector MLPs, float paths (counterpart of
vla_adapter_tpu/models/projector.py).

* :class:`FusedProjector` — vision -> LLM: 2176 -> 4*2176 -> 896 -> 896 with
  erf-GELUs between.
* :class:`Projector` — single tower: vision -> llm -> llm, one GELU.
* :class:`ProprioProjector` — proprio -> llm: fc1 -> GELU -> fc2.
"""

from __future__ import annotations

import torch
from torch import nn

from vla_adapter_torch.models.layers import Dense, Runtime, gelu


class FusedProjector(nn.Module):
    def __init__(self, vision_dim: int, llm_dim: int, rt: Runtime,
                 device=None):
        super().__init__()
        self.fc1 = Dense(vision_dim, 4 * vision_dim, rt=rt, device=device)
        self.fc2 = Dense(4 * vision_dim, llm_dim, rt=rt, device=device)
        self.fc3 = Dense(llm_dim, llm_dim, rt=rt, device=device)

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        x = gelu(self.fc1(patches), approximate=False)
        x = gelu(self.fc2(x), approximate=False)
        return self.fc3(x)


class Projector(nn.Module):
    def __init__(self, vision_dim: int, llm_dim: int, rt: Runtime,
                 device=None):
        super().__init__()
        self.fc1 = Dense(vision_dim, llm_dim, rt=rt, device=device)
        self.fc2 = Dense(llm_dim, llm_dim, rt=rt, device=device)

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
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
