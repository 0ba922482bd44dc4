"""Robot-platform constants (copy of vla_adapter_tpu/core/constants.py).

An explicit, immutable registry keyed by platform name; every component
receives a :class:`PlatformConstants` through the config tree.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class NormalizationType(str, enum.Enum):
    """Action/proprio normalization schemes."""

    NORMAL = "normal"          # mean 0 / std 1
    BOUNDS = "bounds"          # [min, max] -> [-1, 1]
    BOUNDS_Q99 = "bounds_q99"  # [q01, q99] -> [-1, 1], clipped


# Token-space constants (Qwen2.5-0.5B).
IGNORE_INDEX = -100
ACTION_TOKEN_BEGIN_IDX = 151386
# The stop id appended after the action block at inference time.
STOP_INDEX = 2
# Learnable action-query tokens appended to the LLM input.
NUM_ACTION_QUERY_TOKENS = 64


@dataclass(frozen=True)
class PlatformConstants:
    """Per-robot-platform action/proprio geometry."""

    name: str
    num_actions_chunk: int
    action_dim: int
    proprio_dim: int
    normalization_type: NormalizationType = NormalizationType.BOUNDS_Q99
    num_action_query_tokens: int = NUM_ACTION_QUERY_TOKENS


LIBERO = PlatformConstants(
    name="libero", num_actions_chunk=8, action_dim=7, proprio_dim=8,
    normalization_type=NormalizationType.BOUNDS_Q99,
)
CALVIN = PlatformConstants(
    name="calvin", num_actions_chunk=8, action_dim=7, proprio_dim=8,
    normalization_type=NormalizationType.BOUNDS_Q99,
)
ALOHA = PlatformConstants(
    name="aloha", num_actions_chunk=25, action_dim=14, proprio_dim=14,
    normalization_type=NormalizationType.BOUNDS,
)
BRIDGE = PlatformConstants(
    name="bridge", num_actions_chunk=5, action_dim=7, proprio_dim=7,
    normalization_type=NormalizationType.BOUNDS_Q99,
)

PLATFORMS: dict[str, PlatformConstants] = {
    p.name: p for p in (LIBERO, CALVIN, ALOHA, BRIDGE)
}


def get_platform(name: str) -> PlatformConstants:
    """Look up a robot platform by name (case-insensitive)."""
    key = name.lower()
    if key not in PLATFORMS:
        raise KeyError(f"Unknown robot platform {name!r}; known: {sorted(PLATFORMS)}")
    return PLATFORMS[key]
