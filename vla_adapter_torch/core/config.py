"""Configuration trees (copy of vla_adapter_tpu/core/config.py): the
model's, the training run's (``LoRAConfig``, ``OptimizerConfig``,
``TrainConfig``, with the JAX package's defaults), and the model's JSON
encoding in a checkpoint's ``config.json``.

Canonical geometry:
  vision  : fused DINOv2 ViT-L/14-reg4 (1024) + SigLIP so400m/14 (1152) @224px
  project : 2176 -> 8704 -> 896 -> 896 fused GELU MLP
  language: Qwen2.5-0.5B — 24 layers, hidden 896, 14 heads / 2 KV heads,
            head_dim 64, ffn 4864, RoPE theta 1e6, tied embeddings,
            vocab 151936, RMSNorm eps 1e-6
  head    : 24-block bridge-attention MLPResNet, hidden 896, L1 regression
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

from vla_adapter_torch.core.constants import (
    NormalizationType,
    PlatformConstants,
    get_platform,
)


@dataclass(frozen=True)
class ViTConfig:
    """A pre-norm ViT covering the timm variants the reference uses.

    ``feature_layer`` selects the block whose output is tapped (default
    ``num_layers - 2``), with no final norm and prefix tokens stripped.
    """

    name: str
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_dim: int = 4096
    use_cls_token: bool = True
    num_register_tokens: int = 0
    # timm `no_embed_class`: positional embeddings on patch tokens only.
    pos_embed_patches_only: bool = False
    # timm `pre_norm`: LayerNorm over the tokens before block 0.
    pre_norm: bool = False
    layer_scale_init: Optional[float] = None  # None -> no LayerScale
    mlp_activation: str = "gelu"  # "gelu" (erf), "gelu_tanh", "quick_gelu"
    layernorm_eps: float = 1e-6
    qkv_bias: bool = True
    feature_layer: Optional[int] = None
    # When set, every block applies FiLM modulation x*(1+gamma)+beta between
    # its attention and MLP sublayers, conditioned on a language vector of
    # this dimension (the reference's film_vit_wrapper; off in the flagship).
    film_llm_dim: Optional[int] = None

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def num_prefix_tokens(self) -> int:
        return (1 if self.use_cls_token else 0) + self.num_register_tokens

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def resolved_feature_layer(self) -> int:
        return self.num_layers - 2 if self.feature_layer is None else self.feature_layer


# timm `vit_large_patch14_reg4_dinov2.lvd142m` @224px
DINOV2_VIT_L_224 = ViTConfig(
    name="dinov2-vit-l-14-reg4-224",
    hidden_size=1024,
    num_layers=24,
    num_heads=16,
    mlp_dim=4096,
    use_cls_token=True,
    num_register_tokens=4,
    pos_embed_patches_only=True,
    layer_scale_init=1e-5,
    mlp_activation="gelu",
)

# timm `vit_so400m_patch14_siglip_224`
SIGLIP_SO400M_224 = ViTConfig(
    name="siglip-so400m-14-224",
    hidden_size=1152,
    num_layers=27,
    num_heads=16,
    mlp_dim=4304,
    use_cls_token=False,
    num_register_tokens=0,
    pos_embed_patches_only=False,
    layer_scale_init=None,
    mlp_activation="gelu_tanh",
)


@dataclass(frozen=True)
class FusedVisionConfig:
    """Dual-tower fused backbone: channels per image are [3 primary | 3
    fused]; features concatenate on the hidden dim (1024 + 1152 = 2176)."""

    primary: ViTConfig = DINOV2_VIT_L_224
    fused: Optional[ViTConfig] = SIGLIP_SO400M_224
    num_images: int = 2  # third-person + wrist
    use_film: bool = False

    @property
    def embed_dim(self) -> int:
        return self.primary.hidden_size + (self.fused.hidden_size if self.fused else 0)

    @property
    def num_patches_per_image(self) -> int:
        return self.primary.num_patches

    @property
    def num_patches(self) -> int:
        return self.num_patches_per_image * self.num_images

    @property
    def channels_per_image(self) -> int:
        return 6 if self.fused is not None else 3


@dataclass(frozen=True)
class Qwen2Config:
    """Qwen2-family decoder config."""

    vocab_size: int = 151936
    hidden_size: int = 896
    num_layers: int = 24
    num_heads: int = 14
    num_kv_heads: int = 2
    intermediate_size: int = 4864
    head_dim: int = 64
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    tie_word_embeddings: bool = True
    attention_bias: bool = True  # bias on q/k/v, none on o
    max_position_embeddings: int = 32768

    @property
    def kv_groups(self) -> int:
        return self.num_heads // self.num_kv_heads


QWEN25_0_5B = Qwen2Config()


@dataclass(frozen=True)
class ActionHeadConfig:
    """Bridge-attention MLPResNet head."""

    num_blocks: int = 24
    hidden_dim: int = 896
    num_attn_heads: int = 8
    use_pro_version: bool = True
    train_noise_std: float = 0.02
    rope_base: float = 10000.0  # Pro blocks only


@dataclass(frozen=True)
class VLAConfig:
    """Top-level model config for action prediction."""

    platform: str = "libero"
    custom_constants: Optional[PlatformConstants] = None
    vision: FusedVisionConfig = FusedVisionConfig()
    llm: Qwen2Config = QWEN25_0_5B
    head: ActionHeadConfig = ActionHeadConfig()
    use_proprio: bool = True
    # Bidirectional attention over the multimodal sequence (the released
    # checkpoints) or causal (base-VLM mode).
    bidirectional_attention: bool = True
    n_action_bins: int = 256
    # Text-token budget sequences are padded to: prompt + action queries
    # (+ stop at inference).
    max_text_tokens: int = 128

    @property
    def constants(self) -> PlatformConstants:
        if self.custom_constants is not None:
            return self.custom_constants
        return get_platform(self.platform)

    @property
    def num_patches(self) -> int:
        return self.vision.num_patches

    @property
    def num_action_query_tokens(self) -> int:
        return self.constants.num_action_query_tokens


def vla_config_to_dict(cfg: VLAConfig) -> dict:
    """Lossless JSON-able encoding, the ``"vla_adapter_tpu"`` block of a
    checkpoint's config.json (the same encoding as the JAX package's, so
    each package loads the other's exports)."""
    d = dataclasses.asdict(cfg)
    if d.get("custom_constants"):
        d["custom_constants"]["normalization_type"] = (
            cfg.custom_constants.normalization_type.value)
    return d


def vla_config_from_dict(d: dict) -> VLAConfig:
    """Inverse of :func:`vla_config_to_dict`. A Phi language model (the
    JAX package's ``PhiConfig``, told apart by ``partial_rotary_factor``)
    raises: the port has no Phi model yet."""
    d = dict(d)
    if "partial_rotary_factor" in d["llm"]:
        raise NotImplementedError("a Phi language model is not ported yet")
    cc = d.get("custom_constants")
    if cc:
        cc = dict(cc)
        cc["normalization_type"] = NormalizationType(cc["normalization_type"])
        d["custom_constants"] = PlatformConstants(**cc)
    v = dict(d["vision"])
    v["primary"] = ViTConfig(**v["primary"])
    if v.get("fused"):
        v["fused"] = ViTConfig(**v["fused"])
    d["vision"] = FusedVisionConfig(**v)
    d["llm"] = Qwen2Config(**d["llm"])
    d["head"] = ActionHeadConfig(**d["head"])
    return VLAConfig(**d)


# ---------------------------------------------------------------------------
# LoRA / training


@dataclass(frozen=True)
class LoRAConfig:
    """LoRA finetuning (the reference's finetune.py: r=64, alpha=2r,
    dropout 0, every linear of the VLM, Gaussian init)."""

    enabled: bool = True
    rank: int = 64
    alpha: float = 128.0
    dropout: float = 0.0
    target: str = "all-linear"

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


@dataclass(frozen=True)
class OptimizerConfig:
    """AdamW with a linear warmup of the multiplier from 0.1 to 1 over
    ``warmup_fraction * max_steps`` steps and a x``decay_factor`` drop at
    ``num_steps_before_decay`` (the reference's MultiStepLR)."""

    learning_rate: float = 5e-4
    weight_decay: float = 0.0
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    warmup_fraction: float = 0.1
    num_steps_before_decay: int = 100_000
    decay_factor: float = 0.1
    grad_clip_norm: Optional[float] = None
    max_steps: int = 200_005
    # Storage dtype of the Adam moments ("bfloat16" halves them; the update
    # math stays fp32: train/optim.py). None = fp32 moments.
    moments_dtype: Optional[str] = None


@dataclass(frozen=True)
class TrainConfig:
    model: VLAConfig = VLAConfig()
    lora: LoRAConfig = LoRAConfig()
    optim: OptimizerConfig = OptimizerConfig()
    # "l1": continuous regression through the bridge head (the VLA-Adapter
    # recipe). The token objective is not ported yet.
    objective: str = "l1"
    batch_size: int = 16          # global batch
    grad_accumulation_steps: int = 1
    seed: int = 42
    # The JAX package's mesh axes; the port trains on one device and
    # refuses any other layout (train/loop.py).
    data_axis: int = -1
    fsdp_axis: int = 1
    tensor_axis: int = 1
    remat_llm: bool = True        # recompute each layer in the backward
    # "nothing" (recompute the whole layer) or "attn_only" (the attention
    # half only); "dots", "dots_no_batch" and "mlp_saved" are not ported.
    remat_policy: str = "nothing"
    # Per-component overrides, ((component, policy), ...).
    remat_policy_overrides: Tuple[Tuple[str, str], ...] = ()
    # Which stacks recompute when remat_llm: "vit", "llm", "head".
    remat_components: Tuple[str, ...] = ("vit", "llm")
    # Store the frozen (not trained) parameters in bf16.
    frozen_bf16: bool = True
    # Run the frozen base's matmuls w8a8 (forward, and dx in the backward
    # through a straight-through estimator; models/layers.py). The head,
    # proprio projector and LoRA adapters stay float.
    base_int8: bool = False
    # Storage dtype of the grad-accumulation carry (None = fp32).
    accum_dtype: Optional[str] = None
    save_freq: int = 10_000
    save_latest_checkpoint_only: bool = True
    run_root_dir: str = "runs"
    run_id: Optional[str] = None
    val_freq: int = 10_000
    log_freq: int = 10
