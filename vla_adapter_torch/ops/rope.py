"""Rotary position embeddings (counterpart of vla_adapter_tpu/ops/rope.py).

Two layouts, never mixed:

* ``half`` — Qwen2 layout: halves rotated as ``(x1, x2) -> (x1*cos - x2*sin,
  x2*cos + x1*sin)`` with the frequency vector duplicated ``cat(f, f)``.
* ``interleaved`` — even/odd pairs rotated in place, used by the Pro bridge
  blocks. Its table is the *duplicated-halves* one as well: the reference
  pairs an interleaved rotation with ``cat(f, f)``, and so does this port.
"""

from __future__ import annotations

from typing import Optional

import torch


def rope_cos_sin(seq_len: int, head_dim: int, theta: float,
                 dtype: torch.dtype = torch.float32, device=None,
                 positions: Optional[torch.Tensor] = None):
    """(cos, sin) of shape (seq_len, head_dim) for positions 0..seq_len-1,
    or for ``positions`` (S,) where given (a cached decode step's, on the
    device); frequencies in fp32, cast at the end."""
    if positions is not None:
        device = positions.device
    inv_freq = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
        / head_dim))
    if positions is None:
        positions = torch.arange(seq_len, dtype=torch.float32, device=device)
    else:
        positions = positions.to(torch.float32)
    freqs = positions[:, None] * inv_freq[None, :]      # (S, head_dim/2)
    emb = torch.cat([freqs, freqs], dim=-1)              # (S, head_dim)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope_half(x: torch.Tensor, cos: torch.Tensor,
                    sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D); cos/sin (S, D)."""
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    return (x * cos + _rotate_half(x) * sin).to(x.dtype)


def _rotate_interleaved(x: torch.Tensor) -> torch.Tensor:
    """Pairwise (e, o) -> (-o, e)."""
    return torch.stack([-x[..., 1::2], x[..., ::2]], dim=-1).reshape(x.shape)


def interleaved_cos_sin(seq_len: int, head_dim: int, base: float,
                        dtype: torch.dtype = torch.float32, device=None):
    """The duplicated-halves table, as the reference uses for its
    interleaved rotation (kept on purpose)."""
    return rope_cos_sin(seq_len, head_dim, base, dtype=dtype, device=device)


def apply_rope_interleaved(x: torch.Tensor, cos: torch.Tensor,
                           sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, D) with cos/sin (S, D)."""
    return (x * cos + _rotate_interleaved(x) * sin).to(x.dtype)
