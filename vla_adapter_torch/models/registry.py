"""Backbone ids -> configs (counterpart of vla_adapter_tpu/models/registry.py).

The reference's registries key its vision and LLM backbones by id strings
(prismatic/models/materialize.py); a checkpoint's config.json names its
vision backbone that way, and :func:`weights.load.vla_config_from_checkpoint`
resolves it here. Each entry is a pure config; weights come through
``weights/convert.py``.

Qwen2, LLaMA-2, Vicuna and Mistral share the decoder of ``models/qwen2.py``
(RMSNorm, GQA, RoPE, a SiLU-gated MLP) and differ only in geometry, biases
and RoPE settings, so all map onto :class:`Qwen2Config`. Phi-2 (parallel
attention and MLP, partial rotary) is :class:`PhiConfig`, served by
``models/phi.py``. ``LLM_PROMPT_FAMILY`` names each LLM's prompt builder
(``data/prompting.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Union

from vla_adapter_torch.core.config import (
    DINOV2_VIT_L_224,
    SIGLIP_SO400M_224,
    FusedVisionConfig,
    PhiConfig,
    Qwen2Config,
    ViTConfig,
)

# --- vision backbones -------------------------------------------------------

DINOV2_VIT_L_384 = ViTConfig(
    name="dinov2-vit-l-14-reg4-384", image_size=384,
    hidden_size=1024, num_layers=24, num_heads=16, mlp_dim=4096,
    use_cls_token=True, num_register_tokens=4, pos_embed_patches_only=True,
    layer_scale_init=1e-5,
)
SIGLIP_SO400M_384 = ViTConfig(
    name="siglip-so400m-14-384", image_size=384,
    hidden_size=1152, num_layers=27, num_heads=16, mlp_dim=4304,
    use_cls_token=False, pos_embed_patches_only=False,
    mlp_activation="gelu_tanh",
)
CLIP_VIT_L_224 = ViTConfig(
    name="clip-vit-l-14-224", image_size=224,
    hidden_size=1024, num_layers=24, num_heads=16, mlp_dim=4096,
    use_cls_token=True, pos_embed_patches_only=False, pre_norm=True,
    mlp_activation="quick_gelu", layernorm_eps=1e-5,
)
CLIP_VIT_L_336 = dataclasses.replace(
    CLIP_VIT_L_224, name="clip-vit-l-14-336", image_size=336)
CLIP_VIT_B_224 = ViTConfig(
    name="clip-vit-b-16-224", image_size=224, patch_size=16,
    hidden_size=768, num_layers=12, num_heads=12, mlp_dim=3072,
    use_cls_token=True, pos_embed_patches_only=False, pre_norm=True,
    mlp_activation="quick_gelu", layernorm_eps=1e-5,
)
DINOV2_VIT_L_336 = dataclasses.replace(
    DINOV2_VIT_L_384, name="dinov2-vit-l-14-reg4-336", image_size=336)
IN1K_VIT_L_224 = ViTConfig(
    name="in1k-vit-l-16-224", image_size=224, patch_size=16,
    hidden_size=1024, num_layers=24, num_heads=16, mlp_dim=4096,
    use_cls_token=True, pos_embed_patches_only=False,
)


def _siglip_b16(px: int) -> ViTConfig:
    return ViTConfig(
        name=f"siglip-vit-b-16-{px}", image_size=px, patch_size=16,
        hidden_size=768, num_layers=12, num_heads=12, mlp_dim=3072,
        use_cls_token=False, pos_embed_patches_only=False,
        mlp_activation="gelu_tanh",
    )


def _single(v: ViTConfig) -> FusedVisionConfig:
    return FusedVisionConfig(primary=v, fused=None, num_images=1)


# The reference's ids (prismatic/models/materialize.py) and the JAX
# package's -224px aliases.
VISION_BACKBONES: Dict[str, FusedVisionConfig] = {
    # fused dual-tower (the VLA-Adapter default)
    "dinosiglip-vit-so-224px": FusedVisionConfig(
        primary=DINOV2_VIT_L_224, fused=SIGLIP_SO400M_224, num_images=2),
    "dinosiglip-vit-so-384px": FusedVisionConfig(
        primary=DINOV2_VIT_L_384, fused=SIGLIP_SO400M_384, num_images=2),
    "dinoclip-vit-l-224px": FusedVisionConfig(
        primary=DINOV2_VIT_L_224, fused=CLIP_VIT_L_224, num_images=2),
    "dinoclip-vit-l-336px": FusedVisionConfig(
        primary=DINOV2_VIT_L_336, fused=CLIP_VIT_L_336, num_images=2),
    # single towers
    "clip-vit-b": _single(CLIP_VIT_B_224),
    "clip-vit-l": _single(CLIP_VIT_L_224),
    "clip-vit-l-336px": _single(CLIP_VIT_L_336),
    "siglip-vit-b16-224px": _single(_siglip_b16(224)),
    "siglip-vit-b16-256px": _single(_siglip_b16(256)),
    "siglip-vit-b16-384px": _single(_siglip_b16(384)),
    "siglip-vit-so400m": _single(SIGLIP_SO400M_224),
    "siglip-vit-so400m-384px": _single(SIGLIP_SO400M_384),
    "dinov2-vit-l": _single(DINOV2_VIT_L_224),
    "in1k-vit-l": _single(IN1K_VIT_L_224),
    "dinov2-vit-l-224px": _single(DINOV2_VIT_L_224),
    "siglip-vit-so400m-224px": _single(SIGLIP_SO400M_224),
    "clip-vit-l-224px": _single(CLIP_VIT_L_224),
    "in1k-vit-l-224px": _single(IN1K_VIT_L_224),
}


def with_num_images(cfg: FusedVisionConfig, n: int) -> FusedVisionConfig:
    """The reference's ``set_num_images_in_input(n)`` (a zoo entry's
    ``image_sequence_len``): the same towers, n frames per sample."""
    return dataclasses.replace(cfg, num_images=n)


# --- LLM backbones ----------------------------------------------------------

_LLAMA_STYLE = dict(rope_theta=1e4, attention_bias=False,
                    tie_word_embeddings=False, rms_norm_eps=1e-5)
_LLAMA2_7B = Qwen2Config(
    vocab_size=32000, hidden_size=4096, num_layers=32, num_heads=32,
    num_kv_heads=32, intermediate_size=11008, head_dim=128, **_LLAMA_STYLE)
_LLAMA2_13B = Qwen2Config(
    vocab_size=32000, hidden_size=5120, num_layers=40, num_heads=40,
    num_kv_heads=40, intermediate_size=13824, head_dim=128, **_LLAMA_STYLE)
_MISTRAL_7B = Qwen2Config(
    vocab_size=32000, hidden_size=4096, num_layers=32, num_heads=32,
    num_kv_heads=8, intermediate_size=14336, head_dim=128, **_LLAMA_STYLE)

LLM_BACKBONES: Dict[str, Union[Qwen2Config, PhiConfig]] = {
    "qwen25-0_5b-extra": Qwen2Config(),  # +256 action tokens, vocab padded
    "qwen25-0_5b-pure": Qwen2Config(),
    "qwen25-1_5b-pure": Qwen2Config(
        hidden_size=1536, num_layers=28, num_heads=12, num_kv_heads=2,
        intermediate_size=8960, head_dim=128),
    "qwen25-3b-pure": Qwen2Config(
        hidden_size=2048, num_layers=36, num_heads=16, num_kv_heads=2,
        intermediate_size=11008, head_dim=128),
    "qwen25-7b-pure": Qwen2Config(
        vocab_size=152064, hidden_size=3584, num_layers=28, num_heads=28,
        num_kv_heads=4, intermediate_size=18944, head_dim=128),
    "llama2-7b-pure": _LLAMA2_7B,
    "llama2-7b-chat": _LLAMA2_7B,
    "vicuna-v15-7b": _LLAMA2_7B,
    "llama2-13b-pure": _LLAMA2_13B,
    "llama2-13b-chat": _LLAMA2_13B,
    "vicuna-v15-13b": _LLAMA2_13B,
    "mistral-v0.1-7b-pure": _MISTRAL_7B,
    "mistral-v0.1-7b-instruct": _MISTRAL_7B,
    "phi-2-3b": PhiConfig(),
}

# the prompt-builder family of each LLM id (data/prompting.py)
LLM_PROMPT_FAMILY: Dict[str, str] = {
    "qwen25-0_5b-extra": "qwen",
    "qwen25-0_5b-pure": "qwen",
    "qwen25-1_5b-pure": "qwen",
    "qwen25-3b-pure": "qwen",
    "qwen25-7b-pure": "qwen",
    "llama2-7b-pure": "pure",
    "llama2-13b-pure": "pure",
    "llama2-7b-chat": "llama2-chat",
    "llama2-13b-chat": "llama2-chat",
    "vicuna-v15-7b": "vicuna",
    "vicuna-v15-13b": "vicuna",
    "mistral-v0.1-7b-pure": "pure",
    "mistral-v0.1-7b-instruct": "mistral-instruct",
    "phi-2-3b": "phi",
}


def get_vision_backbone(backbone_id: str) -> FusedVisionConfig:
    if backbone_id not in VISION_BACKBONES:
        raise KeyError(f"unknown vision backbone {backbone_id!r}; "
                       f"known: {sorted(VISION_BACKBONES)}")
    return VISION_BACKBONES[backbone_id]


def get_llm_backbone(backbone_id: str) -> Union[Qwen2Config, PhiConfig]:
    if backbone_id not in LLM_BACKBONES:
        raise KeyError(f"unknown LLM backbone {backbone_id!r}; "
                       f"known: {sorted(LLM_BACKBONES)}")
    return LLM_BACKBONES[backbone_id]
