"""Bridge-attention action head, original and Pro blocks (counterpart of
vla_adapter_tpu/models/action_head.py).

Input: the per-layer VLM hidden states (B, L+1, T + Q, D): T "task"
positions and Q action-query positions; block i reads entry i + 1. The
task and adapter (action states + proprio token) K/V streams do not depend
on the evolving chunk latents, so all layers' projections run as batched
products before the block loop (``BatchedDense``), as in the JAX package.
Each block attends over three streams [self | adapter | task]; a tanh gate
scales the task-stream logits; then ``ffn(attn_out + x)``.

* Pro (``use_pro_version``): each stream has its own K/V (four stacks
  ``k_adapter``/``v_adapter``/``k_task``/``v_task``, plus ``k_self``/
  ``v_self`` in the block), with interleaved RoPE on K and q.
* Original (``BridgeBlock``): one shared K/V projection per layer, the
  head's stacks ``k_proj``/``v_proj``, applied to the adapter and task
  streams before the loop and to the self stream inside it through the
  layer's slice (``BatchedDense.layer``); no RoPE.

In training the zero chunk latents get the caller's noise (the JAX
package's N(0, train_noise_std) draw, drawn outside the head by
``models/vla.py``), and under ``rt.remat`` with "head" among its
components each block recomputes in the backward (under any policy, as
in the JAX package).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vla_adapter_torch.core.config import ActionHeadConfig
from vla_adapter_torch.models.layers import (
    BatchedDense,
    Dense,
    LayerNorm,
    Runtime,
    checkpointed,
    new_param,
    normal_init_,
)
from vla_adapter_torch.ops.rope import apply_rope_interleaved, interleaved_cos_sin


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(..., S, D) -> (..., H, S, d)."""
    *lead, s, _ = t.shape
    return t.reshape(*lead, s, num_heads, -1).transpose(-3, -2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    """(B, H, S, d) -> (B, S, D)."""
    b, h, s, d = t.shape
    return t.transpose(1, 2).reshape(b, s, h * d)


def _rope_batched(t: torch.Tensor, base: float) -> torch.Tensor:
    """Interleaved RoPE over the position axis (-2), in t's dtype: the
    tables are computed in fp32 and cast."""
    cos, sin = interleaved_cos_sin(t.shape[-2], t.shape[-1], base,
                                   dtype=torch.float32, device=t.device)
    return apply_rope_interleaved(t, cos.to(t.dtype), sin.to(t.dtype))


def _attend(q: torch.Tensor, streams: List[Tuple[torch.Tensor, torch.Tensor]],
            gate_on_last: torch.Tensor) -> torch.Tensor:
    """Softmax over the concatenated stream logits. q (B, H, T, d); the gate
    scales the last stream's logits. Logits stay in q.dtype (gate, then the
    1/sqrt(d) division) until an fp32 softmax. Returns (B, T, D)."""
    d = q.shape[-1]
    logits = []
    for i, (k, _) in enumerate(streams):
        s = torch.matmul(q, k.transpose(-1, -2))
        if i == len(streams) - 1:
            s = s * gate_on_last
        logits.append(s)
    # made on q's device (no host copy, so a CUDA graph can capture it)
    denom = torch.full((), math.sqrt(d), dtype=torch.float32,
                       device=q.device).to(q.dtype)
    scores = torch.cat(logits, dim=-1) / denom
    p = F.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.matmul(p, torch.cat([v for _, v in streams], dim=2))
    return _merge(out)


class BridgeBlockPro(nn.Module):
    """Per-stream K/V; the adapter/task streams arrive projected and roped,
    the self stream projects and ropes the evolving latents here."""

    def __init__(self, cfg: ActionHeadConfig, rt: Runtime, device=None):
        super().__init__()
        self.cfg, self.rt = cfg, rt
        d = cfg.hidden_dim
        self.gating_factor = new_param((1,), rt, device)
        self.q_proj = Dense(d, d, rt=rt, device=device)
        self.k_self = Dense(d, d, rt=rt, device=device)
        self.v_self = Dense(d, d, rt=rt, device=device)
        self.o_proj = Dense(d, d, rt=rt, device=device)
        self.ffn_norm = LayerNorm(d, 1e-5, rt=rt, device=device)
        self.ffn_fc = Dense(d, d, rt=rt, device=device)

    def init_params_(self, gen: torch.Generator) -> None:
        # random gate (the checkpoint's init is 0, which would blank the
        # task stream's logits in a smoke run)
        normal_init_(self.gating_factor, 1.0, gen)

    def forward(self, x, k_adapter, v_adapter, k_task, v_task):
        cfg, dt = self.cfg, self.rt.dtype
        h = cfg.num_attn_heads
        ratio_g = torch.tanh(self.gating_factor.to(dt))
        q = _rope_batched(_heads(self.q_proj(x), h), cfg.rope_base)
        k_self = _rope_batched(_heads(self.k_self(x), h), cfg.rope_base)
        v_self = _heads(self.v_self(x), h)
        streams = [(k_self, v_self), (k_adapter, v_adapter), (k_task, v_task)]
        out = self.o_proj(_attend(q, streams, ratio_g))
        return F.relu(self.ffn_fc(self.ffn_norm(out + x)))


class BridgeBlock(nn.Module):
    """Original block: the K/V projections are the head's shared stacks;
    the block gets its layer's adapter and task K/V and the self stream's
    K/V, projected by the head from its input."""

    def __init__(self, cfg: ActionHeadConfig, rt: Runtime, device=None):
        super().__init__()
        self.cfg, self.rt = cfg, rt
        d = cfg.hidden_dim
        self.gating_factor = new_param((1,), rt, device)
        self.q_proj = Dense(d, d, rt=rt, device=device)
        self.o_proj = Dense(d, d, rt=rt, device=device)
        self.ffn_norm = LayerNorm(d, 1e-5, rt=rt, device=device)
        self.ffn_fc = Dense(d, d, rt=rt, device=device)

    def init_params_(self, gen: torch.Generator) -> None:
        normal_init_(self.gating_factor, 1.0, gen)  # see BridgeBlockPro

    def forward(self, x, k_adapter, v_adapter, k_task, v_task, k_self,
                v_self):
        h = self.cfg.num_attn_heads
        ratio_g = torch.tanh(self.gating_factor.to(self.rt.dtype))
        streams = [(_heads(k_self, h), _heads(v_self, h)),
                   (k_adapter, v_adapter), (k_task, v_task)]
        out = self.o_proj(_attend(_heads(self.q_proj(x), h), streams,
                                  ratio_g))
        return F.relu(self.ffn_fc(self.ffn_norm(out + x)))


class L1RegressionActionHead(nn.Module):
    """Regress the normalized action chunk from per-layer hidden states.

    forward(hidden_states (B, L+1, T + Q, D), proprio_features (B, 1, D) or
    None, noise (num_actions_chunk, action_dim * D) fp32 or None, added to
    the zero latents) -> (B, num_actions_chunk, action_dim) in rt.dtype."""

    def __init__(self, cfg: ActionHeadConfig, llm_dim: int, action_dim: int,
                 num_actions_chunk: int, num_task_tokens: int, rt: Runtime,
                 device=None):
        super().__init__()
        self.cfg, self.rt = cfg, rt
        self.action_dim = action_dim
        self.num_actions_chunk = num_actions_chunk
        self.num_task_tokens = num_task_tokens
        d, nb = cfg.hidden_dim, cfg.num_blocks
        stacks = (("k_adapter", "v_adapter", "k_task", "v_task")
                  if cfg.use_pro_version else ("k_proj", "v_proj"))
        for name in stacks:
            setattr(self, name, BatchedDense(llm_dim, d, nb, rt=rt,
                                             device=device))
        self.input_norm = LayerNorm(action_dim * llm_dim, 1e-5, rt=rt,
                                    device=device)
        self.fc_in = Dense(action_dim * llm_dim, d, rt=rt, device=device)
        block = BridgeBlockPro if cfg.use_pro_version else BridgeBlock
        self.blocks = nn.ModuleList(block(cfg, rt, device)
                                    for _ in range(nb))
        self.out_norm = LayerNorm(d, 1e-5, rt=rt, device=device)
        self.fc_out = Dense(d, action_dim, rt=rt, device=device)

    def forward(self, hidden_states: torch.Tensor,
                proprio_features: Optional[torch.Tensor],
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg, dt = self.cfg, self.rt.dtype
        b, _, _, llm_dim = hidden_states.shape
        nb, h, t = cfg.num_blocks, cfg.num_attn_heads, self.num_task_tokens
        h_task = hidden_states[:, 1:nb + 1, :t].to(dt)
        h_adapter = hidden_states[:, 1:nb + 1, t:].to(dt)
        if proprio_features is not None:
            # the proprio token joins the action-state stream of every block
            p = proprio_features[:, None].to(dt).expand(b, nb, 1, llm_dim)
            h_adapter = torch.cat([h_adapter, p], dim=2)

        if cfg.use_pro_version:
            k_adapter = _rope_batched(_heads(self.k_adapter(h_adapter), h),
                                      cfg.rope_base)
            v_adapter = _heads(self.v_adapter(h_adapter), h)
            k_task = _rope_batched(_heads(self.k_task(h_task), h),
                                   cfg.rope_base)
            v_task = _heads(self.v_task(h_task), h)
        else:  # the shared stacks over both streams
            k_adapter = _heads(self.k_proj(h_adapter), h)
            v_adapter = _heads(self.v_proj(h_adapter), h)
            k_task = _heads(self.k_proj(h_task), h)
            v_task = _heads(self.v_proj(h_task), h)

        x = torch.zeros((b, self.num_actions_chunk, self.action_dim * llm_dim),
                        dtype=dt, device=hidden_states.device)
        if noise is not None:
            x = x + noise.to(dt)
        x = F.relu(self.fc_in(self.input_norm(x)))
        remat = (self.rt.remat_policy_of("head") is not None
                 and torch.is_grad_enabled())
        for i, block in enumerate(self.blocks):
            streams = (k_adapter[:, i], v_adapter[:, i], k_task[:, i],
                       v_task[:, i])
            if not cfg.use_pro_version:  # the self stream: layer i's slice
                streams += (self.k_proj.layer(x, i), self.v_proj.layer(x, i))
            x = checkpointed(block, x, *streams) if remat else block(x,
                                                                     *streams)
        return self.fc_out(self.out_norm(x))
