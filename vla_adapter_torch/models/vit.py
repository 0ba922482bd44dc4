"""Vision transformers, DINOv2-reg4 / SigLIP (counterpart of
vla_adapter_tpu/models/vit.py).

timm ``VisionTransformer`` semantics as the reference uses them: patch
embedding -> positional embedding (patch tokens only under
``pos_embed_patches_only``, with cls/register tokens prepended after it;
else on the full sequence) -> pre-norm blocks with optional LayerScale ->
the raw output of block ``feature_layer``, no final norm, prefix tokens
stripped. Only ``feature_layer + 1`` blocks are built: later blocks never
reach the output. Input is NHWC. With ``film_llm_dim`` set, every block
modulates its tokens between the sublayers by the language vector (FiLM).
Under ``rt.remat`` with "vit" among its components each block recomputes
in the backward (``layers.remat``: "nothing", "dots", "dots_no_batch" or
"mlp_saved", fc1 tagged ``mlp_wide``), or its attention half alone
("attn_only").
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from vla_adapter_torch.core.config import ViTConfig
from vla_adapter_torch.models.layers import (
    Dense,
    LayerNorm,
    Runtime,
    normal_init_,
    new_param,
    activation,
    checkpoint_name,
    fused_mlp,
    head_plan,
    remat,
    take_cols,
)
from vla_adapter_torch.ops.attention import dot_product_attention


class PatchEmbed(Dense):
    """The stride-p p x p patch convolution as one product over flattened
    (p, p, C) patches; the weight is the Flax (kh, kw, in, out) kernel
    flattened and transposed. It stays float under the int8 tiers, as the
    JAX package's convolution does, and has no LoRA adapters (the JAX
    package's is a convolution, not a Dense)."""

    def __init__(self, patch: int, in_channels: int, hidden: int, *,
                 rt: Runtime, device=None):
        rt = dataclasses.replace(rt, weights_int8=False, act_int8=False,
                                 train_base_int8=False, lora_rank=0)
        super().__init__(patch * patch * in_channels, hidden, rt=rt,
                         device=device)
        self.patch = patch

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> (B, (H/p) * (W/p), hidden), row-major patches."""
        b, h, w, c = images.shape
        p = self.patch
        gh, gw = h // p, w // p
        x = images[:, :gh * p, :gw * p].reshape(b, gh, p, gw, p, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * c)
        return super().forward(x)


class ViTAttention(nn.Module):
    def __init__(self, cfg: ViTConfig, rt: Runtime, device=None):
        super().__init__()
        self.cfg, self.rt = cfg, rt
        e, hd = cfg.hidden_size, cfg.num_heads * cfg.head_dim
        self.q_proj = Dense(e, hd, cfg.qkv_bias, rt=rt, device=device)
        self.k_proj = Dense(e, hd, cfg.qkv_bias, rt=rt, device=device)
        self.v_proj = Dense(e, hd, cfg.qkv_bias, rt=rt, device=device)
        self.out_proj = Dense(hd, e, rt=rt, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Under the "tensor" axis (q/k/v column-split, out_proj row-split)
        each rank attends over its own heads (:func:`layers.head_plan`)."""
        b, n, _ = x.shape
        d = self.cfg.head_dim
        plan = head_plan(self.out_proj, self.cfg.num_heads, d)
        lo, hi = plan.h0 * d, plan.h1 * d
        q, k, v = (take_cols(dense(x), dense, lo, hi, plan).view(b, n, -1, d)
                   for dense in (self.q_proj, self.k_proj, self.v_proj))
        out = dot_product_attention(q, k, v, None, causal=False,
                                    impl=self.rt.kernels)
        return self.out_proj(plan.output(out.reshape(b, n, -1)))


class ViTMLP(nn.Module):
    """fc1 -> activation -> fc2; under the fused w8a8 backend one launch of
    kernel B3 (gelu there is the TPU kernel's A&S erf)."""

    def __init__(self, cfg: ViTConfig, rt: Runtime, device=None):
        super().__init__()
        self.cfg, self.rt = cfg, rt
        self.fc1 = Dense(cfg.hidden_size, cfg.mlp_dim, rt=rt, device=device)
        self.fc2 = Dense(cfg.mlp_dim, cfg.hidden_size, rt=rt, device=device)
        self.act = activation(cfg.mlp_activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if self.rt.fused_mlp(cfg.hidden_size, cfg.mlp_dim):
            return fused_mlp(x, self.fc1, self.fc2, cfg.mlp_activation,
                             self.rt)
        with checkpoint_name("mlp_wide"):
            h = self.fc1(x)
        return self.fc2(self.act(h))


class LayerScale(nn.Module):
    # Random init: 0.1, so a smoke run's residual branches are not ~0
    # (timm's 1e-5 makes the blocks near-identity).
    RANDOM_INIT = 0.1

    def __init__(self, dim: int, rt: Runtime, device=None):
        super().__init__()
        self.rt = rt
        self.gamma = new_param((dim,), rt, device)

    def init_params_(self, gen: torch.Generator) -> None:
        self.gamma.fill_(self.RANDOM_INIT)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(self.rt.dtype)


class ViTBlock(nn.Module):
    """Pre-norm block. With ``cfg.film_llm_dim`` set, FiLM between the
    attention and MLP sublayers: ``x * (1 + gamma) + beta``, gamma and beta
    two Dense projections of the language vector (the reference's
    film_vit_wrapper; a checkpoint's are zero at init, the identity)."""

    def __init__(self, cfg: ViTConfig, rt: Runtime, device=None):
        super().__init__()
        self.remat = rt.remat_policy_of("vit")
        e, eps = cfg.hidden_size, cfg.layernorm_eps
        self.norm1 = LayerNorm(e, eps, rt=rt, device=device)
        self.attn = ViTAttention(cfg, rt, device)
        self.norm2 = LayerNorm(e, eps, rt=rt, device=device)
        self.mlp = ViTMLP(cfg, rt, device)
        self.ls1 = self.ls2 = None
        if cfg.layer_scale_init is not None:
            self.ls1 = LayerScale(e, rt, device)
            self.ls2 = LayerScale(e, rt, device)
        self.film_scale = self.film_shift = None
        if cfg.film_llm_dim is not None:
            self.film_scale = Dense(cfg.film_llm_dim, e, rt=rt, device=device)
            self.film_shift = Dense(cfg.film_llm_dim, e, rt=rt, device=device)

    def forward(self, x: torch.Tensor,
                lang: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.remat not in (None, "attn_only") and torch.is_grad_enabled():
            return remat(self.remat, self._forward, x, lang)
        return self._forward(x, lang)

    def _attn_delta(self, x: torch.Tensor) -> torch.Tensor:
        h = self.attn(self.norm1(x))
        return h if self.ls1 is None else self.ls1(h)

    def _forward(self, x: torch.Tensor,
                 lang: Optional[torch.Tensor]) -> torch.Tensor:
        if self.remat == "attn_only" and torch.is_grad_enabled():
            x = x + remat("attn_only", self._attn_delta, x)
        else:
            x = x + self._attn_delta(x)
        if self.film_scale is not None:
            if lang is None:
                raise ValueError("a FiLM block needs the language vector")
            gamma = self.film_scale(lang)[:, None, :]
            beta = self.film_shift(lang)[:, None, :]
            x = x * (1.0 + gamma) + beta
        h = self.mlp(self.norm2(x))
        if self.ls2 is not None:
            h = self.ls2(h)
        return x + h


class VisionTransformer(nn.Module):
    """Feature extractor: images (B, H, W, 3) NHWC -> (B, N_patches, E);
    a FiLM tower also takes the language vector (B, film_llm_dim), which a
    tower without FiLM ignores."""

    def __init__(self, cfg: ViTConfig, rt: Runtime, device=None):
        super().__init__()
        self.cfg, self.rt = cfg, rt
        e = cfg.hidden_size
        self.patch_embed = PatchEmbed(cfg.patch_size, 3, e, rt=rt,
                                      device=device)
        n_pos = cfg.num_patches + (0 if cfg.pos_embed_patches_only
                                   else cfg.num_prefix_tokens)
        self.pos_embed = new_param((1, n_pos, e), rt, device)
        self.cls_token = (new_param((1, 1, e), rt, device)
                          if cfg.use_cls_token else None)
        self.reg_token = (new_param((1, cfg.num_register_tokens, e), rt, device)
                          if cfg.num_register_tokens else None)
        self.norm_pre = (LayerNorm(e, cfg.layernorm_eps, rt=rt, device=device)
                         if cfg.pre_norm else None)
        self.blocks = nn.ModuleList(
            ViTBlock(cfg, rt, device)
            for _ in range(cfg.resolved_feature_layer + 1))

    def init_params_(self, gen: torch.Generator) -> None:
        normal_init_(self.pos_embed, 0.02, gen)
        for tok in (self.cls_token, self.reg_token):
            if tok is not None:
                tok.zero_()

    def forward(self, images: torch.Tensor,
                lang: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg, dt = self.cfg, self.rt.dtype
        x = self.patch_embed(images.to(dt))
        b, _, e = x.shape
        prefix = [t.to(dt).expand(b, -1, -1)
                  for t in (self.cls_token, self.reg_token) if t is not None]
        if cfg.pos_embed_patches_only:
            x = torch.cat(prefix + [x + self.pos_embed.to(dt)], dim=1)
        else:
            x = torch.cat(prefix + [x], dim=1) + self.pos_embed.to(dt)
        if self.norm_pre is not None:
            x = self.norm_pre(x)
        if cfg.film_llm_dim is None:
            lang = None
        elif lang is not None:
            lang = lang.to(dt)
        for block in self.blocks:
            x = block(x, lang)
        return x[:, cfg.num_prefix_tokens:]
