"""The pretrained-VLM model zoo: id -> structural config (counterpart of
vla_adapter_tpu/models/zoo.py, copied: the port imports nothing of the JAX
package).

The reference's MODEL_REGISTRY (prismatic/models/registry.py, 51 models)
and ``dinosiglip-224px-resize-naive+7b`` of its conf/models.py: for each
model its vision backbone, LLM backbone, image-resize strategy and
projector arch, keyed by id and by display name. Weights are never
fetched: a zoo model runs here on seeded weights, converted ones
(``weights/convert.py``) or ``from_jax_params``.

Use:
    entry = get_zoo_entry("prism-dinosiglip+7b")
    cfg = build_vlm_config(entry)     # -> VLAConfig for PrismaticVLM
    processor = dataclasses.replace(image_processor_for(cfg.vision),
                                    resize_strategy=entry.image_resize_strategy)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from vla_adapter_torch.core.config import VLAConfig
from vla_adapter_torch.models.registry import (
    get_llm_backbone,
    get_vision_backbone,
    with_num_images,
)


@dataclass(frozen=True)
class ZooEntry:
    model_id: str
    name: str
    vision_backbone_id: str = "clip-vit-l-336px"
    llm_backbone_id: str = "vicuna-v15-7b"
    image_resize_strategy: str = "letterbox"
    arch_specifier: str = "gelu-mlp"  # | no-align+fused-gelu-mlp
    llm_max_length: int = 2048
    image_sequence_len: int = 1


def _e(model_id: str, name: str, **kw) -> ZooEntry:
    return ZooEntry(model_id=model_id, name=name, **kw)


_FUSED = dict(arch_specifier="no-align+fused-gelu-mlp")
_PRISM7 = dict(image_resize_strategy="resize-naive",
               llm_backbone_id="llama2-7b-pure")
_PRISM13 = dict(image_resize_strategy="resize-naive",
                llm_backbone_id="llama2-13b-pure")

_ENTRIES = [
    # --- LLaVa v1.5 reproductions ---
    _e("reproduction-llava-v15+7b", "LLaVa v1.5 7B (Reproduction)"),
    _e("reproduction-llava-v15+13b", "LLaVa v1.5 13B (Reproduction)",
       llm_backbone_id="vicuna-v15-13b"),
    # --- optimization-procedure ablations ---
    _e("one-stage+7b", "Single-Stage 7B"),
    _e("one-stage+13b", "Single-Stage 13B", llm_backbone_id="vicuna-v15-13b"),
    _e("full-ft-multi-stage+7b", "Finetune ViT (Multi-Stage) 7B"),
    _e("full-ft-one-stage+7b", "Finetune ViT (Single-Stage) 7B"),
    # --- visual-representation ablations (224px singles) ---
    _e("in1k-224px+7b", "IN1K ViT-L 224px 7B", vision_backbone_id="in1k-vit-l"),
    _e("dinov2-224px+7b", "DINOv2 ViT-L 224px 7B",
       vision_backbone_id="dinov2-vit-l"),
    _e("clip-224px+7b", "CLIP ViT-L 224px 7B", vision_backbone_id="clip-vit-l"),
    _e("siglip-224px+7b", "SigLIP ViT-SO 224px 7B",
       vision_backbone_id="siglip-vit-so400m"),
    # --- image-processing ablations ---
    _e("clip-336px-resize-crop+7b", "CLIP 336px (Resize Crop) 7B",
       image_resize_strategy="resize-crop"),
    _e("clip-336px-resize-naive+7b", "CLIP 336px (Naive Resize) 7B",
       image_resize_strategy="resize-naive"),
    _e("siglip-384px-letterbox+7b", "SigLIP 384px (Letterbox) 7B",
       vision_backbone_id="siglip-vit-so400m-384px"),
    _e("siglip-384px-resize-crop+7b", "SigLIP 384px (Resize Crop) 7B",
       vision_backbone_id="siglip-vit-so400m-384px",
       image_resize_strategy="resize-crop"),
    _e("siglip-384px-resize-naive+7b", "SigLIP 384px (Naive Resize) 7B",
       vision_backbone_id="siglip-vit-so400m-384px",
       image_resize_strategy="resize-naive"),
    # --- fused backbones ---
    _e("dinoclip-336px-letterbox+7b", "DINOv2 + CLIP 336px (Letterbox) 7B",
       vision_backbone_id="dinoclip-vit-l-336px", **_FUSED),
    _e("dinoclip-336px-resize-naive+7b", "DINOv2 + CLIP 336px (Naive) 7B",
       vision_backbone_id="dinoclip-vit-l-336px",
       image_resize_strategy="resize-naive", **_FUSED),
    _e("dinosiglip-384px-letterbox+7b", "DINOv2 + SigLIP 384px (Letterbox) 7B",
       vision_backbone_id="dinosiglip-vit-so-384px", **_FUSED),
    _e("dinosiglip-384px-resize-naive+7b", "DINOv2 + SigLIP 384px (Naive) 7B",
       vision_backbone_id="dinosiglip-vit-so-384px",
       image_resize_strategy="resize-naive", **_FUSED),
    _e("dinosiglip-224px-resize-naive+7b", "DINOv2 + SigLIP 224px (Naive) 7B",
       vision_backbone_id="dinosiglip-vit-so-224px",
       image_resize_strategy="resize-naive", **_FUSED),
    # --- language-model ablations ---
    _e("llama2+7b", "LLaMa-2 7B", llm_backbone_id="llama2-7b-pure"),
    _e("llama2+13b", "LLaMa-2 13B", llm_backbone_id="llama2-13b-pure"),
    _e("llama2-chat+7b", "LLaMa-2 Chat 7B", llm_backbone_id="llama2-7b-chat"),
    _e("llama2-chat+13b", "LLaMa-2 Chat 13B",
       llm_backbone_id="llama2-13b-chat"),
    _e("mistral-v0.1+7b", "Mistral v0.1 7B",
       llm_backbone_id="mistral-v0.1-7b-pure"),
    _e("mistral-instruct-v0.1+7b", "Mistral Instruct v0.1 7B",
       llm_backbone_id="mistral-v0.1-7b-instruct"),
    _e("phi-2+3b", "Phi-2 3B", llm_backbone_id="phi-2-3b"),
    # --- co-training ablations ---
    _e("vicuna-no-cotraining+7b", "Vicuna w/o Co-training 7B"),
    _e("llama2-no-cotraining+7b", "LLaMa-2 w/o Co-training 7B",
       llm_backbone_id="llama2-7b-pure"),
    # --- training-duration ablations (structurally the base model) ---
    _e("train-1.25-epochs+7b", "1.25 Epochs 7B"),
    _e("train-1.5-epochs+7b", "1.5 Epochs 7B"),
    _e("train-2-epochs+7b", "2 Epochs 7B"),
    _e("train-3-epochs+7b", "3 Epochs 7B"),
    # --- data ablations ---
    _e("llava-lvis4v+7b", "LLaVa + LVIS-4V 7B"),
    _e("llava-lrv+7b", "LLaVa + LRV 7B"),
    _e("llava-lvis4v-lrv+7b", "LLaVa + LVIS-4V + LRV 7B"),
    # --- Prism models ---
    _e("prism-clip-controlled+7b", "Prism CLIP (Controlled) 7B",
       vision_backbone_id="clip-vit-l-336px", **_PRISM7),
    _e("prism-clip-controlled+13b", "Prism CLIP (Controlled) 13B",
       vision_backbone_id="clip-vit-l-336px", **_PRISM13),
    _e("prism-clip+7b", "Prism CLIP 7B",
       vision_backbone_id="clip-vit-l-336px", **_PRISM7),
    _e("prism-clip+13b", "Prism CLIP 13B",
       vision_backbone_id="clip-vit-l-336px", **_PRISM13),
    _e("prism-siglip-controlled+7b", "Prism SigLIP (Controlled) 7B",
       vision_backbone_id="siglip-vit-so400m-384px", **_PRISM7),
    _e("prism-siglip-controlled+13b", "Prism SigLIP (Controlled) 13B",
       vision_backbone_id="siglip-vit-so400m-384px", **_PRISM13),
    _e("prism-siglip+7b", "Prism SigLIP 7B",
       vision_backbone_id="siglip-vit-so400m-384px", **_PRISM7),
    # reference quirk preserved: prism-siglip+13b is registered with the
    # CLIP tower (conf/models.py:430) — almost certainly a typo upstream,
    # kept for metadata parity
    _e("prism-siglip+13b", "Prism SigLIP 13B",
       vision_backbone_id="clip-vit-l-336px", **_PRISM13),
    _e("prism-dinosiglip-controlled+7b", "Prism DINOSigLIP (Controlled) 7B",
       vision_backbone_id="dinosiglip-vit-so-384px", **_PRISM7, **_FUSED),
    _e("prism-dinosiglip-controlled+13b", "Prism DINOSigLIP (Controlled) 13B",
       vision_backbone_id="dinosiglip-vit-so-384px", **_PRISM13, **_FUSED),
    _e("prism-dinosiglip+7b", "Prism DINOSigLIP 7B",
       vision_backbone_id="dinosiglip-vit-so-384px", **_PRISM7, **_FUSED),
    _e("prism-dinosiglip+13b", "Prism DINOSigLIP 13B",
       vision_backbone_id="dinosiglip-vit-so-384px", **_PRISM13, **_FUSED),
    _e("prism-dinosiglip-224px-controlled+7b",
       "Prism DINOSigLIP 224px (Controlled) 7B",
       vision_backbone_id="dinosiglip-vit-so-224px", **_PRISM7, **_FUSED),
    _e("prism-dinosiglip-224px+7b", "Prism DINOSigLIP 224px 7B",
       vision_backbone_id="dinosiglip-vit-so-224px", **_PRISM7, **_FUSED),
    # --- Qwen2.5-0.5B Prism (the VLA-Adapter base VLM) ---
    _e("prism-qwen25-dinosiglip-224px+0_5b", "Prism Qwen2.5 0.5B",
       vision_backbone_id="dinosiglip-vit-so-224px",
       image_resize_strategy="resize-naive",
       llm_backbone_id="qwen25-0_5b-pure", **_FUSED),
    _e("prism-qwen25-extra-dinosiglip-224px+0_5b",
       "Prism Qwen2.5 0.5B (+256 action tokens)",
       vision_backbone_id="dinosiglip-vit-so-224px",
       image_resize_strategy="resize-naive",
       llm_backbone_id="qwen25-0_5b-extra", **_FUSED),
]

MODEL_ZOO: Dict[str, ZooEntry] = {e.model_id: e for e in _ENTRIES}
# name -> id aliases (reference GLOBAL_REGISTRY keyed both ways)
GLOBAL_ZOO: Dict[str, ZooEntry] = {
    **MODEL_ZOO, **{e.name: e for e in _ENTRIES},
}


def available_models() -> list:
    return sorted(MODEL_ZOO)


def get_zoo_entry(model_id_or_name: str) -> ZooEntry:
    if model_id_or_name not in GLOBAL_ZOO:
        raise KeyError(
            f"unknown model {model_id_or_name!r}; known ids: {available_models()}"
        )
    return GLOBAL_ZOO[model_id_or_name]


def build_vlm_config(entry: ZooEntry,
                     max_text_tokens: Optional[int] = None) -> VLAConfig:
    """ZooEntry -> VLAConfig for PrismaticVLM (models/vlm.py): causal, no
    proprio, ``max_text_tokens`` or the entry's ``llm_max_length``."""
    vision = get_vision_backbone(entry.vision_backbone_id)
    if entry.image_sequence_len > 1:
        # the reference's image_sequence_len: same towers, N frames a sample
        vision = with_num_images(vision, entry.image_sequence_len)
    return VLAConfig(
        vision=vision,
        llm=get_llm_backbone(entry.llm_backbone_id),
        use_proprio=False,
        bidirectional_attention=False,
        max_text_tokens=max_text_tokens or entry.llm_max_length,
    )
