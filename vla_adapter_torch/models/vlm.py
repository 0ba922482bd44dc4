"""PrismaticVLM, the plain vision-language model (counterpart of
vla_adapter_tpu/models/vlm.py): fused ViT -> projector -> causal LLM with
a multimodal next-token objective, for VLM pretraining (the align and
finetune stages, ``train/pretrain.py``) and autoregressive actions
(``models/generate.py:predict_action_autoregressive``).

The multimodal layout is the VLA's, [text token 0 | patches | text 1:];
attention is causal; with ``pixel_values`` None the forward is unimodal.
Logits come back in text coordinates: text position 0 takes the last
patch position's logit, so that under the shift it predicts the first
post-image token from an image-aware position.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from vla_adapter_torch.core.config import VLAConfig
from vla_adapter_torch.core.constants import IGNORE_INDEX
from vla_adapter_torch.models.layers import Runtime
from vla_adapter_torch.models.llm import llm_model_class
from vla_adapter_torch.models.projector import FusedProjector, Projector
from vla_adapter_torch.models.vla import FusedVisionBackbone


class PrismaticVLM(nn.Module):
    def __init__(self, cfg: VLAConfig, rt: Runtime = Runtime(), device=None):
        super().__init__()
        self.cfg, self.rt = cfg, rt
        d = cfg.llm.hidden_size
        self.language_model = llm_model_class(cfg.llm)(cfg.llm, rt, device)
        self.vision_backbone = FusedVisionBackbone(cfg, rt, device)
        proj_cls = FusedProjector if cfg.vision.fused is not None else Projector
        self.projector = proj_cls(cfg.vision.embed_dim, d, rt, device)

    def forward(
        self,
        input_ids: torch.Tensor,
        text_valid: torch.Tensor,
        pixel_values: Optional[torch.Tensor] = None,
        labels: Optional[torch.Tensor] = None,
        compute_logits: bool = True,
    ) -> Dict[str, torch.Tensor]:
        """input_ids, text_valid (B, T); pixel_values (B, n_img, H, W, C) or
        None; labels (B, T) with IGNORE_INDEX where no loss is taken.
        Returns last_hidden_state, logits (B, T, V) in text coordinates,
        and with labels the CE ``loss``."""
        dt = self.rt.dtype
        llm = self.language_model
        text_embeds = llm.embed_tokens(input_ids)
        text_valid = (text_valid != 0).to(torch.int32)
        num_patches = 0
        embeds, valid = text_embeds, text_valid
        if pixel_values is not None:
            projected = self.projector(self.vision_backbone(pixel_values))
            b, num_patches = projected.shape[:2]
            embeds = torch.cat([text_embeds[:, :1], projected.to(dt),
                                text_embeds[:, 1:]], dim=1)
            valid = torch.cat(
                [text_valid[:, :1],
                 torch.ones((b, num_patches), dtype=torch.int32,
                            device=input_ids.device),
                 text_valid[:, 1:]], dim=1)
        out = llm(embeds, valid=valid, causal=True,
                  compute_logits=compute_logits or labels is not None)
        result = {"last_hidden_state": out["last_hidden_state"]}
        if "logits" in out:
            logits = out["logits"][:, num_patches:]
            result["logits"] = logits
            if labels is not None:
                result["loss"] = multimodal_ce_loss(logits, labels,
                                                    text_valid)
        return result


def shifted_nll(logits: torch.Tensor, labels: torch.Tensor,
                valid: torch.Tensor):
    """The HF shift (logits at t predict labels at t + 1), in fp32: (nll
    (B, T-1), mask (B, T-1) of the positions whose label is not
    IGNORE_INDEX and that are valid, targets (B, T-1))."""
    targets = labels[:, 1:].long()
    mask = (targets != IGNORE_INDEX) & (valid[:, 1:] != 0)
    safe = torch.where(mask, targets, torch.zeros_like(targets))
    logp = F.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return nll, mask, targets


def multimodal_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """The mean shifted CE over the supervised positions (0 if none)."""
    nll, mask, _ = shifted_nll(logits, labels, valid)
    return (nll * mask).sum() / mask.sum().clamp(min=1)
