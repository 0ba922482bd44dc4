"""Attention masks as boolean tensors, True = may attend (counterpart of
vla_adapter_tpu/ops/masks.py).

Three modes: ``bidirectional`` (key padding only: the released
checkpoints), ``causal`` (the base VLM and generation) and
``prefix_bidir`` (a causal prefix with a bidirectional suffix block, for
ablations). The models pass ``valid`` and ``causal`` to the attention
kernel instead of a materialized mask; these builders are the mask those
arguments stand for.
"""

from __future__ import annotations

from typing import Optional

import torch


def padding_mask(valid: torch.Tensor) -> torch.Tensor:
    """(B, S) validity -> (B, 1, S, S): only the key side is masked."""
    valid = valid.bool()
    b, s = valid.shape
    return valid[:, None, None, :] & torch.ones(
        (b, 1, s, 1), dtype=torch.bool, device=valid.device)


def causal_mask(seq_len: int, device=None) -> torch.Tensor:
    """(1, 1, S, S) lower-triangular."""
    i = torch.arange(seq_len, device=device)[:, None]
    j = torch.arange(seq_len, device=device)[None, :]
    return (j <= i)[None, None]


def prefix_bidirectional_mask(seq_len: int, suffix_start,
                              device=None) -> torch.Tensor:
    """Causal prefix; positions >= suffix_start attend bidirectionally among
    themselves and to the whole prefix. ``suffix_start``: an int, a 0-d
    tensor, or (B,) per row."""
    i = torch.arange(seq_len, device=device)[:, None]
    j = torch.arange(seq_len, device=device)[None, :]
    base = j <= i
    suffix_start = torch.as_tensor(suffix_start, device=device)
    if suffix_start.ndim == 0:
        return (base | ((i >= suffix_start) & (j >= suffix_start)))[None, None]
    start = suffix_start[:, None, None]
    return (base[None] | ((i[None] >= start) & (j[None] >= start)))[:, None]


def combine_masks(*masks: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """AND of the broadcastable masks given (None ones skipped)."""
    out = None
    for m in masks:
        if m is not None:
            out = m if out is None else (out & m)
    return out


def build_attention_mask(mode: str, valid: Optional[torch.Tensor],
                         seq_len: int, suffix_start=None
                         ) -> Optional[torch.Tensor]:
    """The (B|1, 1, S, S) mask of ``mode``."""
    device = None if valid is None else valid.device
    pad = padding_mask(valid) if valid is not None else None
    if mode == "bidirectional":
        return pad
    if mode == "causal":
        return combine_masks(causal_mask(seq_len, device), pad)
    if mode == "prefix_bidir":
        if suffix_start is None:
            raise ValueError("prefix_bidir requires suffix_start")
        return combine_masks(
            prefix_bidirectional_mask(seq_len, suffix_start, device), pad)
    raise ValueError(f"unknown attention mask mode: {mode!r}")
