"""Qwen2-family decoder forward (counterpart of
vla_adapter_tpu/models/qwen2.py: ``Qwen2Model.__call__``).

Bidirectional or causal attention over the whole sequence, with per-key
validity. Returns every hidden state: index 0 the embeddings, i in 1..L-1
the output of layer i, index L the final-norm output (the HF convention the
action head indexes). Under the "mega" w8a8 backend each decoder layer runs
from the attention core on as one kernel (B6), at batch 1 and
bidirectional only. Under ``rt.remat`` with "llm" among its components
each layer recomputes in the backward (``layers.remat``: policy "nothing",
or keeping the products "dots", "dots_no_batch" or "mlp_saved" name, the
MLP's gate and up tagged ``mlp_wide``), or its attention half alone
("attn_only").

The forward also takes ``input_ids`` and ``positions``, returns the tied
head's ``logits`` (``final @ embed.weight.T`` in ``rt.dtype``, as Flax's
``Embed.attend`` computes them) with ``compute_logits``, and each layer's
roped k and v, ``kv_cache`` (L, B, S, Hkv, Dh) each, with ``return_kv``
(the prefill of a cached decode; it bypasses "mega", as the JAX package's
does). :meth:`Qwen2Model.decode_step` is the cached single-token step
(``Qwen2Attention.decode_step``: grouped fp32 attention against the whole
cache, in plain PyTorch as in the JAX package, no kernel), and
:class:`Qwen2Decode` the JAX package's module of that name over the same
weights. The step writes the cache in place at ``pos``, which may be a
device tensor, so one captured CUDA graph serves every step.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vla_adapter_torch.core.config import Qwen2Config
from vla_adapter_torch.models.layers import (
    Dense,
    RMSNorm,
    Runtime,
    checkpoint_name,
    fused_mlp,
    head_plan,
    layer_input,
    normal_init_,
    remat,
    take_cols,
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
        """The roped q (B, S, H, Dh) and k, v (B, S, Hkv, Dh). Under the
        "tensor" axis (q/k/v column-split, o_proj row-split) the heads of
        this rank (:func:`layers.head_plan`) and the KV heads of their
        groups; where those are not whole groups (a split that is not
        head-aligned), one KV head per q head."""
        cfg = self.cfg
        b, s, _ = x.shape
        d, g = cfg.head_dim, cfg.num_heads // cfg.num_kv_heads
        plan = head_plan(self.o_proj, cfg.num_heads, d)
        k0, k1 = plan.h0 // g, (plan.h1 - 1) // g + 1
        q = take_cols(self.q_proj(x), self.q_proj, plan.h0 * d, plan.h1 * d,
                      plan).view(b, s, -1, d)
        k, v = (take_cols(dense(x), dense, k0 * d, k1 * d, plan
                          ).view(b, s, -1, d)
                for dense in (self.k_proj, self.v_proj))
        if plan.h0 % g or (plan.h1 - plan.h0) % g:
            idx = torch.arange(plan.h0, plan.h1, device=x.device) // g - k0
            k, v = k[:, :, idx], v[:, :, idx]
        return apply_rope_half(q, cos, sin), apply_rope_half(k, cos, sin), v

    def forward(self, x, cos, sin, valid, causal: bool,
                return_kv: bool = False):
        b, s, _ = x.shape
        q, k, v = self.qkv(x, cos, sin)
        out = dot_product_attention(q, k, v, valid, causal=causal,
                                    impl=self.rt.kernels)
        plan = head_plan(self.o_proj, self.cfg.num_heads, self.cfg.head_dim)
        out = self.o_proj(plan.output(out.reshape(b, s, -1)))
        return (out, (k, v)) if return_kv else out

    def decode_step(self, x, k_cache, v_cache, pos, cos, sin):
        """One token: x (B, 1, D); k_cache, v_cache (B, T, Hkv, Dh), written
        in place at ``pos`` ((1,) long tensor); cos, sin (1, Dh) at pos in
        x's dtype. Grouped fp32 attention against the whole cache, keys at
        positions <= pos, no repeat of k/v."""
        cfg = self.cfg
        b = x.shape[0]
        hkv, g = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
        q, k, v = self.qkv(x, cos, sin)
        k_cache.index_copy_(1, pos, k)
        v_cache.index_copy_(1, pos, v)
        qg = q.reshape(b, 1, hkv, g, cfg.head_dim).float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_cache.float()) \
            * cfg.head_dim ** -0.5
        seen = torch.arange(k_cache.shape[1], device=x.device) <= pos
        s = torch.where(seen, s, torch.full((), -2.0e9, device=x.device))
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhgqk,bkhd->bqhgd", p, v_cache.float())
        out = out.to(x.dtype).reshape(b, 1, cfg.num_heads * cfg.head_dim)
        return self.o_proj(out)


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
        with checkpoint_name("mlp_wide"):
            gate, up = self.gate_proj(x), self.up_proj(x)
        return self.down_proj(torch.nn.functional.silu(gate) * up)


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

    def forward(self, x, cos, sin, valid, causal: bool,
                return_kv: bool = False):
        if return_kv:
            h = self.input_layernorm(x)
            attn, kv = self.self_attn(h, cos, sin, valid, causal,
                                      return_kv=True)
            x = x + attn
            return x + self.mlp(self.post_attention_layernorm(x)), kv
        if self.rt.mega:
            return self._mega(x, cos, sin, valid, causal)
        if self.remat not in (None, "attn_only") and torch.is_grad_enabled():
            return remat(self.remat, self._forward, x, cos, sin, valid,
                         causal)
        return self._forward(x, cos, sin, valid, causal)

    def decode_step(self, x, k_cache, v_cache, pos, cos, sin):
        if self.rt.w8a8_impl == "mega":
            raise NotImplementedError(
                "w8a8_impl='mega' serves the batch-1 VLA forward only; use "
                "'fused' or 'dense' for generation")
        h = self.input_layernorm(x)
        x = x + self.self_attn.decode_step(h, k_cache, v_cache, pos, cos, sin)
        return x + self.mlp(self.post_attention_layernorm(x))

    def _attn_delta(self, x, cos, sin, valid, causal: bool):
        return self.self_attn(self.input_layernorm(x), cos, sin, valid, causal)

    def _forward(self, x, cos, sin, valid, causal: bool) -> torch.Tensor:
        if self.remat == "attn_only" and torch.is_grad_enabled():
            x = x + remat("attn_only", self._attn_delta, x, cos, sin, valid,
                          causal)
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
    """Decoder stack with a tied embedding table (``embed``), frozen at
    construction; whoever trains it (a training stage, a full finetune)
    sets ``requires_grad`` by name."""

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

    def lm_head(self, hidden: torch.Tensor) -> torch.Tensor:
        """The tied head: hidden (..., D) -> logits (..., V) in rt.dtype."""
        dt = self.rt.dtype
        return F.linear(hidden.to(dt), self.embed.weight.to(dt))

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
        return_kv: bool = False,
    ) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        if inputs_embeds is None:
            inputs_embeds = self.embed_tokens(input_ids)
        x = inputs_embeds.to(self.rt.dtype)
        cos, sin = rope_cos_sin(x.shape[1], cfg.head_dim, cfg.rope_theta,
                                dtype=self.rt.dtype, device=x.device,
                                positions=positions)
        layer_inputs, ks, vs = [], [], []
        for layer in self.layers:
            layer_inputs.append(x)
            if return_kv:
                x, (k, v) = layer(x, cos, sin, valid, causal, return_kv=True)
                ks.append(k)
                vs.append(v)
            else:
                x = layer(layer_input(x), cos, sin, valid, causal)
        final = self.norm(x)
        out = {"last_hidden_state": final}
        if output_hidden_states:
            out["hidden_states"] = torch.stack(layer_inputs + [final], dim=1)
        if compute_logits:
            out["logits"] = self.lm_head(final)
        if return_kv:
            out["kv_cache"] = (torch.stack(ks), torch.stack(vs))
        return out

    def decode_step(self, input_ids: torch.Tensor,
                    kv_cache: Tuple[torch.Tensor, torch.Tensor], pos):
        """One cached step: input_ids (B, 1); kv_cache (k, v), each
        (L, B, T, Hkv, Dh) with roped k, written in place at ``pos`` (an int
        or a (1,) long tensor on the device). The mask is position <= pos
        with no per-sequence validity: every cached slot below pos must be
        a real token (uniform prompt lengths). Returns (logits (B, V),
        kv_cache)."""
        cfg = self.cfg
        x = self.embed_tokens(input_ids)
        if not torch.is_tensor(pos):
            pos = torch.full((1,), pos, dtype=torch.long, device=x.device)
        cos, sin = rope_cos_sin(1, cfg.head_dim, cfg.rope_theta,
                                dtype=self.rt.dtype, positions=pos)
        k_cache, v_cache = kv_cache
        for i, layer in enumerate(self.layers):
            x = layer.decode_step(x, k_cache[i], v_cache[i], pos, cos, sin)
        return self.lm_head(self.norm(x))[:, 0], kv_cache


class Qwen2Decode(nn.Module):
    """The KV-cached single-token decode over ``model``'s weights (the JAX
    package's twin module, which shares Qwen2Model's param tree):
    ``forward(input_ids (B, 1), kv_cache, pos) -> (logits (B, V),
    kv_cache)``. Batched decode needs a uniform prompt length: ragged
    prompts go through the uncached ``models.generate.greedy_generate``,
    which masks per sequence."""

    def __init__(self, model: Qwen2Model):
        super().__init__()
        if model.rt.w8a8_impl == "mega":
            raise NotImplementedError(
                "w8a8_impl='mega' serves the batch-1 VLA forward only; use "
                "'fused' or 'dense' for generation")
        self.model = model

    def forward(self, input_ids, kv_cache, pos):
        return self.model.decode_step(input_ids, kv_cache, pos)
