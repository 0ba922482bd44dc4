"""Checkpoint layouts -> the port's state_dict (counterpart of
vla_adapter_tpu/weights/convert.py, with no Flax tree in between).

Three source layouts:
  * HF ``Qwen2ForCausalLM`` and ``PhiForCausalLM`` state dicts (the
    language model);
  * timm ViT state dicts (the DINOv2 / SigLIP towers);
  * the reference's exported OpenVLA checkpoint: the HF layout after the
    rename map of the reference's finetune.py (dino_featurizer ->
    featurizer, siglip_featurizer -> fused_featurizer, llm_backbone.llm ->
    language_model, projector.projector.{0,2,4} -> fc{1,2,3}, gamma ->
    scale_factor), with the action head and the proprio projector in
    their own ``.pt`` files.

Every converter takes a flat ``{name: tensor}`` dict and returns the
``VLAModel.state_dict()`` names (``models/vla.py``) for its part, the
tensors as they came (a weight that keeps its layout is not copied). The
port keeps torch's ``(out, in)`` layout for a Dense weight, so most names
map one to one; what changes shape is the patch conv, timm's fused qkv and
the head's hoisted stacks.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import torch

from vla_adapter_torch.core.config import (
    PhiConfig,
    Qwen2Config,
    ViTConfig,
    VLAConfig,
)

StateDict = Dict[str, torch.Tensor]


def strip_prefix(sd: Mapping[str, torch.Tensor], prefix: str) -> StateDict:
    """Drop a leading prefix (e.g. DDP's 'module.') from every key that has
    it (the reference's remove_ddp_in_checkpoint)."""
    return {(k[len(prefix):] if k.startswith(prefix) else k): v
            for k, v in sd.items()}


def qwen2_state_from_hf(sd: Mapping[str, torch.Tensor], cfg: Qwen2Config,
                        prefix: str = "model.") -> StateDict:
    """HF Qwen2ForCausalLM -> ``Qwen2Model`` names. q/k/v carry biases
    when ``cfg.attention_bias``; an ``lm_head`` (tied, or unused by the
    action path) is ignored."""
    out = {"embed.weight": sd[prefix + "embed_tokens.weight"],
           "norm.weight": sd[prefix + "norm.weight"]}
    names = ["input_layernorm.weight", "post_attention_layernorm.weight",
             "self_attn.o_proj.weight", "mlp.gate_proj.weight",
             "mlp.up_proj.weight", "mlp.down_proj.weight"]
    for proj in ("q_proj", "k_proj", "v_proj"):
        names.append(f"self_attn.{proj}.weight")
        if cfg.attention_bias:
            names.append(f"self_attn.{proj}.bias")
    for i in range(cfg.num_layers):
        for name in names:
            out[f"layers.{i}.{name}"] = sd[f"{prefix}layers.{i}.{name}"]
    return out


def phi_state_from_hf(sd: Mapping[str, torch.Tensor], cfg: PhiConfig,
                      prefix: str = "model.") -> StateDict:
    """HF PhiForCausalLM -> ``PhiModel`` names: LayerNorms with biases, the
    attention's q/k/v/dense and the MLP's fc1/fc2 with biases, the untied
    ``lm_head`` (stored without ``prefix``, as HF does) with its bias."""
    out = {"embed.weight": sd[prefix + "embed_tokens.weight"]}
    renames = [("input_layernorm", "input_layernorm"),
               ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2")]
    renames += [(f"self_attn.{n}", f"self_attn.{n}")
                for n in ("q_proj", "k_proj", "v_proj", "dense")]
    for i in range(cfg.num_layers):
        for src, dst in renames:
            for kind in ("weight", "bias"):
                out[f"layers.{i}.{dst}.{kind}"] = \
                    sd[f"{prefix}layers.{i}.{src}.{kind}"]
    for kind in ("weight", "bias"):
        out[f"final_layernorm.{kind}"] = sd[f"{prefix}final_layernorm.{kind}"]
        out[f"lm_head.{kind}"] = sd[f"lm_head.{kind}"]
    return out


def llm_state_from_hf(sd: Mapping[str, torch.Tensor], cfg,
                      prefix: str = "model.") -> StateDict:
    """The converter of the LLM family of ``cfg``."""
    if isinstance(cfg, PhiConfig):
        return phi_state_from_hf(sd, cfg, prefix)
    return qwen2_state_from_hf(sd, cfg, prefix)


def vit_state_from_timm(sd: Mapping[str, torch.Tensor], cfg: ViTConfig,
                        prefix: str = "") -> StateDict:
    """timm VisionTransformer -> ``VisionTransformer`` names.

    The patch conv ``(out, in, kh, kw)`` becomes the port's flattened
    ``(out, kh*kw*in)``; the fused ``attn.qkv`` splits into q/k/v; LayerScale
    is timm's ``gamma`` or the HF export's ``scale_factor``. Positional
    embeddings (patches only, or with the prefix tokens) and register
    tokens keep their shapes. Only blocks 0..feature_layer are taken: the
    port never runs the blocks past the tap."""
    p = prefix
    conv = sd[p + "patch_embed.proj.weight"]
    out = {"patch_embed.weight": conv.permute(0, 2, 3, 1).reshape(
               conv.shape[0], -1),
           "patch_embed.bias": sd[p + "patch_embed.proj.bias"],
           "pos_embed": sd[p + "pos_embed"]}
    if cfg.use_cls_token:
        out["cls_token"] = sd[p + "cls_token"]
    if cfg.num_register_tokens:
        out["reg_token"] = sd[p + "reg_token"]
    if cfg.pre_norm:
        out["norm_pre.weight"] = sd[p + "norm_pre.weight"]
        out["norm_pre.bias"] = sd[p + "norm_pre.bias"]
    for i in range(cfg.resolved_feature_layer + 1):
        src, dst = f"{p}blocks.{i}.", f"blocks.{i}."
        for kind in ("weight", "bias"):
            for q, t in zip(("q_proj", "k_proj", "v_proj"),
                            sd[f"{src}attn.qkv.{kind}"].chunk(3, dim=0)):
                out[f"{dst}attn.{q}.{kind}"] = t
            out[f"{dst}attn.out_proj.{kind}"] = sd[f"{src}attn.proj.{kind}"]
            for name in ("norm1", "norm2", "mlp.fc1", "mlp.fc2"):
                out[f"{dst}{name}.{kind}"] = sd[f"{src}{name}.{kind}"]
        if cfg.layer_scale_init is not None:
            for ls in ("ls1", "ls2"):
                key = f"{src}{ls}.gamma"
                if key not in sd:
                    key = f"{src}{ls}.scale_factor"
                out[f"{dst}{ls}.gamma"] = sd[key]
    return out


def mlp_projector_state_from_torch(sd: Mapping[str, torch.Tensor],
                                   names: Sequence[str] = ("fc1", "fc2"),
                                   prefix: str = "") -> StateDict:
    """fcN-style MLP (the vision and proprio projectors): the names map one
    to one."""
    return {f"{n}.{kind}": sd[f"{prefix}{n}.{kind}"]
            for n in names for kind in ("weight", "bias")}


def _with_prefix(prefix: str, sd: Mapping[str, torch.Tensor]) -> StateDict:
    return {prefix + k: v for k, v in sd.items()}


def vla_state_from_hf(sd: Mapping[str, torch.Tensor],
                      cfg: VLAConfig) -> StateDict:
    """The OpenVLA HF-layout backbone (``vision_backbone.featurizer.*``,
    ``vision_backbone.fused_featurizer.*``, ``projector.fc{1,2,3}.*``,
    ``language_model.model.*``, ``action_queries.weight``) -> the port's
    names. The action head and the proprio projector come from their own
    files (:func:`action_head_state_from_torch`,
    :func:`mlp_projector_state_from_torch`)."""
    out = _with_prefix("language_model.", llm_state_from_hf(
        sd, cfg.llm, prefix="language_model.model."))
    out["action_queries"] = sd["action_queries.weight"]
    out.update(_with_prefix("vision_backbone.featurizer.", vit_state_from_timm(
        sd, cfg.vision.primary, prefix="vision_backbone.featurizer.")))
    names = ("fc1", "fc2")
    if cfg.vision.fused is not None:
        out.update(_with_prefix(
            "vision_backbone.fused_featurizer.", vit_state_from_timm(
                sd, cfg.vision.fused,
                prefix="vision_backbone.fused_featurizer.")))
        names = ("fc1", "fc2", "fc3")
    out.update(_with_prefix("projector.", mlp_projector_state_from_torch(
        sd, names, prefix="projector.")))
    return out


# each head's per-block projections that stay in the block, and those the
# port hoists into (L, in, out) stacks of the head (models/action_head.py)
PRO_BLOCK_NAMES = ("q_proj", "k_self", "v_self", "o_proj")
PRO_HOISTED_NAMES = ("k_adapter", "v_adapter", "k_task", "v_task")
ORIGINAL_BLOCK_NAMES = ("q_proj", "o_proj")
ORIGINAL_HOISTED_NAMES = ("k_proj", "v_proj")


def head_names(use_pro_version: bool):
    """(per-block names, hoisted stack names) of a head."""
    if use_pro_version:
        return PRO_BLOCK_NAMES, PRO_HOISTED_NAMES
    return ORIGINAL_BLOCK_NAMES, ORIGINAL_HOISTED_NAMES


def action_head_state_from_torch(sd: Mapping[str, torch.Tensor],
                                 num_blocks: int, use_pro_version: bool,
                                 prefix: str = "model.") -> StateDict:
    """The reference's L1RegressionActionHead -> ``action_head`` names
    (without the ``action_head.`` prefix).

    torch layout: {prefix}layer_norm1 / fc1 / mlp_resnet_blocks.{i}.* /
    layer_norm2 / fc2. The Pro blocks' unused ``film_gen`` parameters are
    ignored. The hoisted K/V projections (the Pro head's four, the original
    head's shared ``k_proj``/``v_proj``) become ``(L, in, out)`` kernels."""
    block_names, hoisted_names = head_names(use_pro_version)
    p = prefix
    out = {}
    for src, dst in (("layer_norm1", "input_norm"), ("fc1", "fc_in"),
                     ("layer_norm2", "out_norm"), ("fc2", "fc_out")):
        for kind in ("weight", "bias"):
            out[f"{dst}.{kind}"] = sd[f"{p}{src}.{kind}"]

    def blk(i, name):
        return sd[f"{p}mlp_resnet_blocks.{i}.{name}"]

    for i in range(num_blocks):
        for kind in ("weight", "bias"):
            for n in block_names:
                out[f"blocks.{i}.{n}.{kind}"] = blk(i, f"{n}.{kind}")
            out[f"blocks.{i}.ffn_norm.{kind}"] = blk(i, f"ffn.0.{kind}")
            out[f"blocks.{i}.ffn_fc.{kind}"] = blk(i, f"ffn.1.{kind}")
        out[f"blocks.{i}.gating_factor"] = blk(i, "gating_factor")
    for n in hoisted_names:
        out[f"{n}.kernel"] = torch.stack([blk(i, f"{n}.weight").T
                                          for i in range(num_blocks)])
        out[f"{n}.bias"] = torch.stack([blk(i, f"{n}.bias")
                                        for i in range(num_blocks)])
    return out


# The reference finetune.py's rename map from the native Prismatic layout
# to the HF module layout, substring replacements applied in order.
NATIVE_TO_HF_RENAMES = (
    ("vision_backbone.dino_featurizer", "vision_backbone.featurizer"),
    ("vision_backbone.siglip_featurizer", "vision_backbone.fused_featurizer"),
    ("llm_backbone.llm", "language_model"),
    ("projector.projector.0", "projector.fc1"),
    ("projector.projector.2", "projector.fc2"),
    ("projector.projector.4", "projector.fc3"),
    ("gamma", "scale_factor"),
)


def native_prismatic_to_hf(sd: Mapping[str, torch.Tensor]) -> StateDict:
    out = {}
    for k, v in sd.items():
        for a, b in NATIVE_TO_HF_RENAMES:
            k = k.replace(a, b)
        out[k] = v
    return out
