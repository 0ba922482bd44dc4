"""LLM-family dispatch: config -> decoder module class (counterpart of
vla_adapter_tpu/models/llm.py).

Every decoder has ``embed_tokens`` and ``forward(inputs_embeds, valid,
causal, output_hidden_states, *, input_ids, positions, compute_logits)``
returning {last_hidden_state, hidden_states?, logits?}, so the VLM and VLA
wiring hosts either family.
"""

from __future__ import annotations

from vla_adapter_torch.core.config import PhiConfig, Qwen2Config


def llm_model_class(llm_cfg):
    """The decoder ``nn.Module`` class for an LLM config."""
    if isinstance(llm_cfg, PhiConfig):
        from vla_adapter_torch.models.phi import PhiModel

        return PhiModel
    if isinstance(llm_cfg, Qwen2Config):
        from vla_adapter_torch.models.qwen2 import Qwen2Model

        return Qwen2Model
    raise TypeError(f"unknown LLM config type {type(llm_cfg).__name__}")
