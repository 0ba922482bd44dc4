"""VLA experiment registry (copy of vla_adapter_tpu/core/experiments.py,
the reference's prismatic/conf/vla.py).

Named recipes binding a vision and an LLM backbone (ids resolved by
``models/registry.py``), a data mixture and the training
hyperparameters. ``expected_devices`` is the device count a recipe was
tuned for (the reference's ``expected_world_size``): the port trains on
any number of cards, one process each (``parallel/sharding.py``), and
warns when the count differs; the global batch is the caller's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class VLAExperiment:
    vla_id: str
    vision_backbone_id: str
    llm_backbone_id: str
    data_mix: str
    platform: str = "libero"
    use_pro_version: bool = True
    freeze_stage: str = "lora"
    global_batch_size: int = 64
    learning_rate: float = 5e-4
    max_steps: int = 200_000
    expected_devices: int = 0           # 0 = not gated
    image_aug: bool = True
    shuffle_buffer_size: int = 100_000

    def to_train_config(self):
        from vla_adapter_torch.core.config import (
            ActionHeadConfig,
            LoRAConfig,
            OptimizerConfig,
            TrainConfig,
            VLAConfig,
        )
        from vla_adapter_torch.models.registry import (
            get_llm_backbone,
            get_vision_backbone,
        )

        model = VLAConfig(
            platform=self.platform,
            vision=get_vision_backbone(self.vision_backbone_id),
            llm=get_llm_backbone(self.llm_backbone_id),
            head=ActionHeadConfig(use_pro_version=self.use_pro_version),
        )
        return TrainConfig(
            model=model,
            lora=LoRAConfig(enabled=self.freeze_stage == "lora"),
            optim=OptimizerConfig(learning_rate=self.learning_rate,
                                  max_steps=self.max_steps),
            batch_size=self.global_batch_size,
            run_id=self.vla_id,
            # LoRA recipes freeze the base, so its matmuls run w8a8 (dx
            # through the straight-through estimator); full-train stages
            # keep the float base, whose weights get gradients.
            base_int8=self.freeze_stage == "lora",
        )


def _exp(**kw) -> VLAExperiment:
    return VLAExperiment(**kw)


VLA_EXPERIMENTS: Dict[str, VLAExperiment] = {
    e.vla_id: e
    for e in [
        # --- the VLA-Adapter recipes (reference README.md:253-487) ---
        _exp(vla_id="vla-adapter+libero-spatial",
             vision_backbone_id="dinosiglip-vit-so-224px",
             llm_backbone_id="qwen25-0_5b-extra",
             data_mix="libero_spatial_no_noops", platform="libero",
             global_batch_size=64, max_steps=100_000, expected_devices=4),
        _exp(vla_id="vla-adapter+libero-object",
             vision_backbone_id="dinosiglip-vit-so-224px",
             llm_backbone_id="qwen25-0_5b-extra",
             data_mix="libero_object_no_noops", platform="libero",
             global_batch_size=64, max_steps=100_000, expected_devices=4),
        _exp(vla_id="vla-adapter+libero-goal",
             vision_backbone_id="dinosiglip-vit-so-224px",
             llm_backbone_id="qwen25-0_5b-extra",
             data_mix="libero_goal_no_noops", platform="libero",
             global_batch_size=64, max_steps=100_000, expected_devices=4),
        _exp(vla_id="vla-adapter+libero-long",
             vision_backbone_id="dinosiglip-vit-so-224px",
             llm_backbone_id="qwen25-0_5b-extra",
             data_mix="libero_10_no_noops", platform="libero",
             global_batch_size=64, max_steps=100_000, expected_devices=4),
        _exp(vla_id="vla-adapter+calvin-abc",
             vision_backbone_id="dinosiglip-vit-so-224px",
             llm_backbone_id="qwen25-0_5b-extra",
             data_mix="calvin_abc_rlds", platform="calvin",
             global_batch_size=64, max_steps=100_000, expected_devices=4),
        # --- OXE pretraining recipes (reference conf/vla.py) ---
        _exp(vla_id="prism-qwen25-dinosiglip-224px+0_5b+mx-oxe-magic-soup",
             vision_backbone_id="dinosiglip-vit-so-224px",
             llm_backbone_id="qwen25-0_5b-extra",
             data_mix="oxe_magic_soup", platform="bridge",
             freeze_stage="vla-train", global_batch_size=256,
             learning_rate=2e-5, expected_devices=8),
        _exp(vla_id="siglip-224px+mx-bridge",
             vision_backbone_id="siglip-vit-so400m-224px",
             llm_backbone_id="vicuna-v15-7b",
             data_mix="bridge", platform="bridge",
             freeze_stage="vla-train", global_batch_size=256,
             learning_rate=2e-5, expected_devices=8),
        _exp(vla_id="prism-dinosiglip-224px+mx-oxe-magic-soup-plus",
             vision_backbone_id="dinosiglip-vit-so-224px",
             llm_backbone_id="llama2-7b-pure",
             data_mix="oxe_magic_soup_plus", platform="bridge",
             freeze_stage="vla-full-train", global_batch_size=2048,
             learning_rate=2e-5, expected_devices=64),
    ]
}


def get_experiment(vla_id: str) -> VLAExperiment:
    if vla_id not in VLA_EXPERIMENTS:
        raise KeyError(
            f"unknown experiment {vla_id!r}; known: {sorted(VLA_EXPERIMENTS)}"
        )
    return VLA_EXPERIMENTS[vla_id]
