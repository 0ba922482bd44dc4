"""Phi-2 decoder (counterpart of vla_adapter_tpu/models/phi.py; the
reference's ``phi-2-3b`` backbone, HF ``PhiForCausalLM``).

Unlike the Qwen2 family (models/qwen2.py):
  * LayerNorm with bias, not RMSNorm;
  * parallel blocks: ``x + attn(ln(x)) + mlp(ln(x))`` over one pre-LN;
  * partial rotary: only the first ``rotary_dim`` dims of q and k rotate
    (half layout, a ``rotary_dim``-wide table), the rest pass through;
  * MHA; q/k/v/dense all biased; MLP ``fc1 -> gelu(tanh) -> fc2``;
  * an untied ``lm_head`` with bias.

Same return contract as ``Qwen2Model``: {last_hidden_state,
hidden_states?, logits?}. Attention runs through kernel B1 (32 heads of
D = 80); under w8a8 every Dense goes through kernel B4 alone, as the JAX
package's do (Phi has no stacked MLP path, so no B2/B3, and no "mega").
There is no cached decode: the JAX package has none for Phi.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from vla_adapter_torch.core.config import PhiConfig
from vla_adapter_torch.models.layers import (
    Dense,
    LayerNorm,
    Runtime,
    remat,
    gelu,
    layer_input,
    normal_init_,
)
from vla_adapter_torch.ops.attention import dot_product_attention
from vla_adapter_torch.ops.rope import apply_rope_half, rope_cos_sin


class PhiAttention(nn.Module):
    def __init__(self, cfg: PhiConfig, rt: Runtime, device=None):
        super().__init__()
        self.cfg, self.rt = cfg, rt
        d, inner = cfg.hidden_size, cfg.num_heads * cfg.head_dim
        self.q_proj = Dense(d, inner, rt=rt, device=device)
        self.k_proj = Dense(d, inner, rt=rt, device=device)
        self.v_proj = Dense(d, inner, rt=rt, device=device)
        self.dense = Dense(inner, d, rt=rt, device=device)

    def forward(self, x, cos, sin, valid, causal: bool) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = x.shape
        shape = (b, s, cfg.num_heads, cfg.head_dim)
        r = cfg.rotary_dim
        q = self.q_proj(x).view(shape)
        k = self.k_proj(x).view(shape)
        v = self.v_proj(x).view(shape)
        q = torch.cat([apply_rope_half(q[..., :r], cos, sin), q[..., r:]], -1)
        k = torch.cat([apply_rope_half(k[..., :r], cos, sin), k[..., r:]], -1)
        out = dot_product_attention(q, k, v, valid, causal=causal,
                                    impl=self.rt.kernels)
        return self.dense(out.reshape(b, s, cfg.num_heads * cfg.head_dim))


class PhiDecoderLayer(nn.Module):
    """Parallel attention + MLP over one shared pre-LN."""

    def __init__(self, cfg: PhiConfig, rt: Runtime, device=None):
        super().__init__()
        # the JAX package's Phi layers take rt.remat_policy itself, not the
        # "llm" override ("attn_only": the whole layer, no attention half)
        self.remat = (rt.remat_policy if rt.remat_policy_of("llm") is not None
                      else None)
        self.input_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                         rt=rt, device=device)
        self.self_attn = PhiAttention(cfg, rt, device)
        self.fc1 = Dense(cfg.hidden_size, cfg.intermediate_size, rt=rt,
                         device=device)
        self.fc2 = Dense(cfg.intermediate_size, cfg.hidden_size, rt=rt,
                         device=device)

    def forward(self, x, cos, sin, valid, causal: bool) -> torch.Tensor:
        if self.remat is not None and torch.is_grad_enabled():
            return remat(self.remat, self._forward, x, cos, sin, valid,
                         causal)
        return self._forward(x, cos, sin, valid, causal)

    def _forward(self, x, cos, sin, valid, causal: bool) -> torch.Tensor:
        h = self.input_layernorm(x)
        attn = self.self_attn(h, cos, sin, valid, causal)
        ff = self.fc2(gelu(self.fc1(h), approximate=True))
        return x + attn + ff


class PhiModel(nn.Module):
    """Decoder stack; ``embed`` frozen at construction (as Qwen2Model's)."""

    def __init__(self, cfg: PhiConfig, rt: Runtime, device=None):
        super().__init__()
        self.cfg, self.rt = cfg, rt
        self.embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                  device=device, dtype=rt.param_dtype)
        self.embed.weight.requires_grad_(False)
        self.layers = nn.ModuleList(
            PhiDecoderLayer(cfg, rt, device) for _ in range(cfg.num_layers))
        self.final_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                         rt=rt, device=device)
        self.lm_head = Dense(cfg.hidden_size, cfg.vocab_size, rt=rt,
                             device=device)

    def init_params_(self, gen: torch.Generator) -> None:
        normal_init_(self.embed.weight, 0.02, gen)

    def embed_tokens(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.embed(input_ids).to(self.rt.dtype)

    def forward(
        self,
        inputs_embeds: Optional[torch.Tensor] = None,
        valid: Optional[torch.Tensor] = None,
        causal: bool = True,
        output_hidden_states: bool = False,
        *,
        input_ids: Optional[torch.Tensor] = None,
        positions: Optional[torch.Tensor] = None,
        compute_logits: bool = False,
    ) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        if inputs_embeds is None:
            inputs_embeds = self.embed_tokens(input_ids)
        x = inputs_embeds.to(self.rt.dtype)
        cos, sin = rope_cos_sin(x.shape[1], cfg.rotary_dim, cfg.rope_theta,
                                dtype=self.rt.dtype, device=x.device,
                                positions=positions)
        layer_inputs = []
        for layer in self.layers:
            layer_inputs.append(x)
            x = layer(layer_input(x), cos, sin, valid, causal)
        final = self.final_layernorm(x)
        out = {"last_hidden_state": final}
        if output_hidden_states:
            out["hidden_states"] = torch.stack(layer_inputs + [final], dim=1)
        if compute_logits:
            out["logits"] = self.lm_head(final)
        return out
