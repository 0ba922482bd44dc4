"""Qwen2-family decoder forward (counterpart of
vla_adapter_tpu/models/qwen2.py: ``Qwen2Model.__call__``).

Bidirectional or causal attention over the whole sequence, with per-key
validity. Returns every hidden state: index 0 the embeddings, i in 1..L-1
the output of layer i, index L the final-norm output (the HF convention the
action head indexes). Under the "mega" w8a8 backend each decoder layer runs
from the attention core on as one kernel (B6), at batch 1 and
bidirectional only. Under ``rt.remat`` with "llm" among its components
each layer (policy "nothing") or its attention half ("attn_only")
recomputes in the backward. Cached decoding is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from vla_adapter_torch.core.config import Qwen2Config
from vla_adapter_torch.models.layers import (
    Dense,
    RMSNorm,
    Runtime,
    checkpointed,
    fused_mlp,
    normal_init_,
)
from vla_adapter_torch.ops.attention import dot_product_attention
from vla_adapter_torch.ops.megalayer import (
    megalayer_reference,
    w8a8_qwen2_layer,
)
from vla_adapter_torch.ops.rope import apply_rope_half, rope_cos_sin


class Qwen2Attention(nn.Module):
    """Bias on q/k/v, none on o; half-layout RoPE on q and k."""

    def __init__(self, cfg: Qwen2Config, rt: Runtime, device=None):
        super().__init__()
        self.cfg, self.rt = cfg, rt
        d, hd = cfg.hidden_size, cfg.head_dim
        bias = cfg.attention_bias
        self.q_proj = Dense(d, cfg.num_heads * hd, bias, rt=rt, device=device)
        self.k_proj = Dense(d, cfg.num_kv_heads * hd, bias, rt=rt, device=device)
        self.v_proj = Dense(d, cfg.num_kv_heads * hd, bias, rt=rt, device=device)
        self.o_proj = Dense(cfg.num_heads * hd, d, False, rt=rt, device=device)

    def qkv(self, x, cos, sin):
        """The roped q (B, S, H, Dh) and k, v (B, S, Hkv, Dh)."""
        cfg = self.cfg
        b, s, _ = x.shape
        q = self.q_proj(x).view(b, s, cfg.num_heads, cfg.head_dim)
        k = self.k_proj(x).view(b, s, cfg.num_kv_heads, cfg.head_dim)
        v = self.v_proj(x).view(b, s, cfg.num_kv_heads, cfg.head_dim)
        return apply_rope_half(q, cos, sin), apply_rope_half(k, cos, sin), v

    def forward(self, x, cos, sin, valid, causal: bool) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = x.shape
        q, k, v = self.qkv(x, cos, sin)
        out = dot_product_attention(q, k, v, valid, causal=causal,
                                    impl=self.rt.kernels)
        return self.o_proj(out.reshape(b, s, cfg.num_heads * cfg.head_dim))


class Qwen2MLP(nn.Module):
    """silu(gate(x)) * up(x) -> down. Under the fused w8a8 backend the whole
    MLP is one launch of kernel B2 over the same int8 weights."""

    def __init__(self, cfg: Qwen2Config, rt: Runtime, device=None):
        super().__init__()
        self.rt = rt
        self.dims = d, f = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = Dense(d, f, False, rt=rt, device=device)
        self.up_proj = Dense(d, f, False, rt=rt, device=device)
        self.down_proj = Dense(f, d, False, rt=rt, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rt.fused_mlp(*self.dims):
            return fused_mlp(x, self.gate_proj, self.down_proj, "silu",
                             self.rt, up=self.up_proj)
        gate = torch.nn.functional.silu(self.gate_proj(x))
        return self.down_proj(gate * self.up_proj(x))


class Qwen2DecoderLayer(nn.Module):
    def __init__(self, cfg: Qwen2Config, rt: Runtime, device=None):
        super().__init__()
        self.rt = rt
        self.remat = rt.remat_policy_of("llm")
        self.eps = eps = cfg.rms_norm_eps
        self.input_layernorm = RMSNorm(cfg.hidden_size, eps, rt=rt, device=device)
        self.self_attn = Qwen2Attention(cfg, rt, device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, eps, rt=rt,
                                                device=device)
        self.mlp = Qwen2MLP(cfg, rt, device)

    def forward(self, x, cos, sin, valid, causal: bool) -> torch.Tensor:
        if self.rt.mega:
            return self._mega(x, cos, sin, valid, causal)
        if self.remat == "nothing" and torch.is_grad_enabled():
            return checkpointed(self._forward, x, cos, sin, valid, causal)
        return self._forward(x, cos, sin, valid, causal)

    def _attn_delta(self, x, cos, sin, valid, causal: bool):
        return self.self_attn(self.input_layernorm(x), cos, sin, valid, causal)

    def _forward(self, x, cos, sin, valid, causal: bool) -> torch.Tensor:
        if self.remat == "attn_only" and torch.is_grad_enabled():
            x = x + checkpointed(self._attn_delta, x, cos, sin, valid, causal)
        else:
            x = x + self._attn_delta(x, cos, sin, valid, causal)
        return x + self.mlp(self.post_attention_layernorm(x))

    def _mega(self, x, cos, sin, valid, causal: bool) -> torch.Tensor:
        """input_layernorm, q/k/v and RoPE as in the other backends, then
        one launch of kernel B6 (its plain version under kernels="plain"):
        attention, o-projection, residual, post-attention norm, the gated
        MLP and the second residual over the same int8 weights."""
        if x.shape[0] != 1:
            raise ValueError(
                f"w8a8_impl='mega' serves batch 1 only (got {x.shape[0]}): "
                "its kernel attends across all rows; use 'fused' or 'dense'")
        if causal:
            raise ValueError("w8a8_impl='mega' implements bidirectional "
                             "attention only")
        attn, mlp = self.self_attn, self.mlp
        q, k, v = attn.qkv(self.input_layernorm(x), cos, sin)
        layer = (megalayer_reference if self.rt.kernels == "plain"
                 else w8a8_qwen2_layer)
        out = layer(
            x[0], q[0], k[0], v[0], None if valid is None else valid[0],
            self.post_attention_layernorm.weight.float(),
            attn.o_proj.weight_q, attn.o_proj.weight_scale,
            mlp.gate_proj.weight_q, mlp.gate_proj.weight_scale,
            mlp.up_proj.weight_q, mlp.up_proj.weight_scale,
            mlp.down_proj.weight_q, mlp.down_proj.weight_scale, eps=self.eps)
        return out[None]


class Qwen2Model(nn.Module):
    """Decoder stack with a tied embedding table (``embed``)."""

    def __init__(self, cfg: Qwen2Config, rt: Runtime, device=None):
        super().__init__()
        self.cfg, self.rt = cfg, rt
        self.embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                  device=device, dtype=rt.param_dtype)
        self.embed.weight.requires_grad_(False)
        self.layers = nn.ModuleList(
            Qwen2DecoderLayer(cfg, rt, device) for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, rt=rt,
                            device=device)

    def init_params_(self, gen: torch.Generator) -> None:
        normal_init_(self.embed.weight, 0.02, gen)

    def embed_tokens(self, input_ids: torch.Tensor) -> torch.Tensor:
        """(B, S) ids -> (B, S, D) in rt.dtype."""
        return self.embed(input_ids).to(self.rt.dtype)

    def forward(
        self,
        inputs_embeds: torch.Tensor,
        valid: Optional[torch.Tensor] = None,
        causal: bool = True,
        output_hidden_states: bool = False,
    ) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        x = inputs_embeds.to(self.rt.dtype)
        cos, sin = rope_cos_sin(x.shape[1], cfg.head_dim, cfg.rope_theta,
                                dtype=self.rt.dtype, device=x.device)
        layer_inputs = []
        for layer in self.layers:
            layer_inputs.append(x)
            x = layer(x, cos, sin, valid, causal)
        final = self.norm(x)
        out = {"last_hidden_state": final}
        if output_hidden_states:
            out["hidden_states"] = torch.stack(layer_inputs + [final], dim=1)
        return out
