"""The full VLA policy forward (counterpart of vla_adapter_tpu/models/vla.py).

fused dual-ViT -> projector -> Qwen2 decoder (bidirectional) -> per-layer
hidden states -> bridge-attention action head. Fixed shapes: text is padded
to ``cfg.max_text_tokens`` and each row carries ``prompt_len``, the real
prompt tokens before the action-query block.

Reference quirks kept on purpose:
  * the multimodal sequence is [text token 0 | vision patches | text 1:];
  * the action-query embeddings (zero-init in a checkpoint) replace the
    placeholder embeddings at [prompt_len, prompt_len + Q);
  * the action-state window starts ONE position before the action block:
    multimodal index ``num_patches + prompt_len - 1``;
  * the "task" stream is multimodal positions [0, num_patches);
  * the proprio token goes only into the head;
  * FiLM towers (``vision.use_film``) are conditioned on the mean prompt
    embedding over valid text tokens, action-query positions excluded,
    taken after the queries are spliced in.

Training (``train=True``) adds N(0, ``head.train_noise_std``) noise of one
(chunk, action_dim * D) draw to the head's zero latents, drawn here from
the caller's ``generator`` (outside any recomputed region, so a
recompute cannot draw it again). Under ``rt.train_base_int8`` the head and
the proprio projector are built with a float Runtime: they are trained
whole, with exact gradients.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from vla_adapter_torch.core.config import VLAConfig
from vla_adapter_torch.models.action_head import L1RegressionActionHead
from vla_adapter_torch.models.layers import Runtime, new_param, normal_init_
from vla_adapter_torch.models.projector import (
    FusedProjector,
    Projector,
    ProprioProjector,
)
from vla_adapter_torch.models.qwen2 import Qwen2Model
from vla_adapter_torch.models.vit import VisionTransformer


def head_noise(cfg: VLAConfig, generator: Optional[torch.Generator],
               device) -> torch.Tensor:
    """The head's training noise: one N(0, train_noise_std) draw of its
    latents' shape (chunk, action_dim * llm_dim), fp32, shared by every row
    of the batch (the JAX package's draw over ``x.shape[1:]``)."""
    consts = cfg.constants
    return cfg.head.train_noise_std * torch.randn(
        (consts.num_actions_chunk, consts.action_dim * cfg.llm.hidden_size),
        generator=generator, dtype=torch.float32, device=device)


class FusedVisionBackbone(nn.Module):
    """pixel_values (B, n_img, H, W, C) NHWC, C = 6 ([3 primary | 3 fused])
    or 3 -> (B, n_img * patches, primary_dim + fused_dim). Images fold into
    the batch, so each tower runs once."""

    def __init__(self, cfg: VLAConfig, rt: Runtime, device=None):
        super().__init__()
        vcfg = cfg.vision
        self.featurizer = VisionTransformer(vcfg.primary, rt, device)
        self.fused_featurizer = (VisionTransformer(vcfg.fused, rt, device)
                                 if vcfg.fused is not None else None)

    def forward(self, pixel_values: torch.Tensor,
                lang: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``lang`` (B, D): the FiLM towers' language vector, one per
        request, repeated for each of its images."""
        b, n_img, h, w, c = pixel_values.shape
        flat = pixel_values.reshape(b * n_img, h, w, c)
        flat_lang = (None if lang is None else
                     lang[:, None].expand(-1, n_img, -1).reshape(b * n_img, -1))
        feats = self.featurizer(flat[..., 0:3], flat_lang)
        if self.fused_featurizer is not None:
            feats = torch.cat([feats, self.fused_featurizer(flat[..., 3:6],
                                                            flat_lang)],
                              dim=-1)
        return feats.reshape(b, n_img * feats.shape[1], feats.shape[2])


class VLAModel(nn.Module):
    """End-to-end policy.

    forward inputs (fixed shapes):
      input_ids    (B, T) int — [prompt | Q queries (any ids) | stop | pad]
      prompt_len   (B,) int — real prompt tokens before the action block
      text_valid   (B, T) — nonzero on prompt + queries (+ stop)
      pixel_values (B, n_img, H, W, C) NHWC float
      proprio      (B, proprio_dim) float or None
    train: add the head's training noise (:func:`head_noise`, drawn from
    ``generator``).
    Returns {"actions": (B, chunk, action_dim) normalized} and, with
    return_hidden_states, the head input (B, L+1, num_patches + Q, D).
    """

    def __init__(self, cfg: VLAConfig, rt: Runtime = Runtime(), device=None):
        super().__init__()
        self.cfg, self.rt = cfg, rt
        consts = cfg.constants
        d = cfg.llm.hidden_size
        self.language_model = Qwen2Model(cfg.llm, rt, device)
        self.action_queries = new_param(
            (consts.num_action_query_tokens, d), rt, device)
        self.vision_backbone = FusedVisionBackbone(cfg, rt, device)
        proj_cls = FusedProjector if cfg.vision.fused is not None else Projector
        self.projector = proj_cls(cfg.vision.embed_dim, d, rt, device)
        head_rt = rt
        if rt.train_base_int8:
            head_rt = dataclasses.replace(rt, weights_int8=False,
                                          act_int8=False,
                                          train_base_int8=False)
        self.proprio_projector = (
            ProprioProjector(consts.proprio_dim, d, head_rt, device)
            if cfg.use_proprio else None)
        self.action_head = L1RegressionActionHead(
            cfg.head, d, consts.action_dim, consts.num_actions_chunk,
            cfg.num_patches, head_rt, device)

    def init_params_(self, gen: torch.Generator) -> None:
        normal_init_(self.action_queries, 0.02, gen)

    def forward(
        self,
        input_ids: torch.Tensor,
        prompt_len: torch.Tensor,
        text_valid: torch.Tensor,
        pixel_values: torch.Tensor,
        proprio: Optional[torch.Tensor] = None,
        return_hidden_states: bool = False,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        cfg, dt = self.cfg, self.rt.dtype
        num_q = cfg.num_action_query_tokens
        num_patches = cfg.num_patches
        b = input_ids.shape[0]
        dev = input_ids.device
        llm = self.language_model

        # --- text embeddings + query splice ---
        text_embeds = llm.embed_tokens(input_ids)
        q_pos = prompt_len.long()[:, None] + torch.arange(num_q, device=dev)
        rows = torch.arange(b, device=dev)[:, None]
        text_embeds[rows, q_pos] = self.action_queries.to(dt)

        # --- FiLM's language vector: mean prompt embedding (queries out) ---
        lang_cond = None
        if cfg.vision.use_film:
            pos = torch.arange(text_embeds.shape[1], device=dev)[None]
            start = prompt_len.long()[:, None]
            in_queries = (pos >= start) & (pos < start + num_q)
            lang_mask = text_valid.float() * (~in_queries).float()
            lang_cond = ((text_embeds * lang_mask[..., None]).sum(dim=1)
                         / lang_mask.sum(dim=1, keepdim=True).clamp(min=1.0))

        # --- vision + multimodal splice [tok0 | patches | text 1:] ---
        projected = self.projector(self.vision_backbone(pixel_values,
                                                        lang_cond))
        mm_embeds = torch.cat(
            [text_embeds[:, :1], projected.to(dt), text_embeds[:, 1:]], dim=1)
        text_valid = (text_valid != 0).to(torch.int32)
        mm_valid = torch.cat(
            [text_valid[:, :1],
             torch.ones((b, num_patches), dtype=torch.int32, device=dev),
             text_valid[:, 1:]], dim=1)

        hs = llm(mm_embeds, valid=mm_valid,
                 causal=not cfg.bidirectional_attention,
                 output_hidden_states=True)["hidden_states"]

        # --- extraction (note the deliberate off-by-one) ---
        task_states = hs[:, :, :num_patches]
        start = num_patches + prompt_len.long() - 1
        idx = start[:, None] + torch.arange(num_q, device=dev)   # (B, Q)
        idx = idx[:, None, :, None].expand(-1, hs.shape[1], -1, hs.shape[3])
        action_states = torch.gather(hs, 2, idx)                 # (B, L+1, Q, D)
        head_input = torch.cat([task_states, action_states], dim=2)

        proprio_features = None
        if self.proprio_projector is not None and proprio is not None:
            proprio_features = self.proprio_projector(proprio)[:, None, :]
        noise = None
        if train and cfg.head.train_noise_std > 0:
            noise = head_noise(cfg, generator, dev)
        out = {"actions": self.action_head(head_input, proprio_features,
                                           noise)}
        if return_hidden_states:
            out["hidden_states"] = head_input
        return out
