"""The port's state_dict -> the reference's checkpoint layout (counterpart
of vla_adapter_tpu/weights/export.py; the inverse of ``weights/convert.py``).

:func:`export_checkpoint_dir` writes the file layout that the reference
and both packages' loaders read:
  <dir>/model.safetensors                     the HF-layout backbone
  <dir>/action_head--0_checkpoint.pt          the head (torch layout)
  <dir>/proprio_projector--0_checkpoint.pt    if the model has one
  <dir>/dataset_statistics.json               if norm_stats are given
  <dir>/config.json                           HF-style, with the lossless
                                              "vla_adapter_tpu" block
Tensors keep their dtype (a bf16 model writes BF16).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Mapping, Optional

import torch

from vla_adapter_torch.core.config import (
    PhiConfig,
    Qwen2Config,
    ViTConfig,
    VLAConfig,
    vla_config_to_dict,
)
from vla_adapter_torch.weights.convert import StateDict, head_names
from vla_adapter_torch.weights.safetensors_io import save_file


def _sub(state: Mapping[str, torch.Tensor], prefix: str) -> StateDict:
    """The entries under ``prefix``, the prefix taken off."""
    return {k[len(prefix):]: v for k, v in state.items()
            if k.startswith(prefix)}


def qwen2_state_to_hf(state: Mapping[str, torch.Tensor], cfg: Qwen2Config,
                      prefix: str = "model.") -> StateDict:
    """``Qwen2Model`` names -> HF Qwen2ForCausalLM (no lm_head: tied)."""
    out = {prefix + "embed_tokens.weight": state["embed.weight"],
           prefix + "norm.weight": state["norm.weight"]}
    for i in range(cfg.num_layers):
        for name, t in _sub(state, f"layers.{i}.").items():
            out[f"{prefix}layers.{i}.{name}"] = t
    return out


def vit_state_to_timm(state: Mapping[str, torch.Tensor], cfg: ViTConfig,
                      prefix: str = "") -> StateDict:
    """``VisionTransformer`` names -> timm (patch conv ``(out, in, kh,
    kw)``, fused qkv, LayerScale as ``gamma``)."""
    p, ps = prefix, cfg.patch_size
    conv = state["patch_embed.weight"]
    out = {p + "patch_embed.proj.weight": conv.reshape(
               conv.shape[0], ps, ps, -1).permute(0, 3, 1, 2),
           p + "patch_embed.proj.bias": state["patch_embed.bias"],
           p + "pos_embed": state["pos_embed"]}
    for name in ("cls_token", "reg_token", "norm_pre.weight",
                 "norm_pre.bias"):
        if name in state:
            out[p + name] = state[name]
    for i in range(cfg.resolved_feature_layer + 1):
        src, dst = f"blocks.{i}.", f"{p}blocks.{i}."
        for kind in ("weight", "bias"):
            out[f"{dst}attn.qkv.{kind}"] = torch.cat(
                [state[f"{src}attn.{q}.{kind}"]
                 for q in ("q_proj", "k_proj", "v_proj")])
            out[f"{dst}attn.proj.{kind}"] = state[f"{src}attn.out_proj.{kind}"]
            for name in ("norm1", "norm2", "mlp.fc1", "mlp.fc2"):
                out[f"{dst}{name}.{kind}"] = state[f"{src}{name}.{kind}"]
        if cfg.layer_scale_init is not None:
            for ls in ("ls1", "ls2"):
                out[f"{dst}{ls}.gamma"] = state[f"{src}{ls}.gamma"]
    return out


def vla_state_to_hf(state: Mapping[str, torch.Tensor],
                    cfg: VLAConfig) -> StateDict:
    """The backbone of a ``VLAModel`` state_dict -> the flat HF layout of
    ``model.safetensors``. A FiLM backbone raises: the layout has no names
    for the FiLM projections (neither has the JAX package's exporter), and
    a checkpoint without them would serve another model."""
    if cfg.vision.use_film or any(
            t is not None and t.film_llm_dim is not None
            for t in (cfg.vision.primary, cfg.vision.fused)):
        raise NotImplementedError(
            "export of a FiLM vision backbone: the reference's checkpoint "
            "layout has no names for the towers' film_scale/film_shift "
            "projections, so they would be lost; refusing to write it")
    out = qwen2_state_to_hf(_sub(state, "language_model."), cfg.llm,
                            prefix="language_model.model.")
    out.update(vit_state_to_timm(
        _sub(state, "vision_backbone.featurizer."), cfg.vision.primary,
        prefix="vision_backbone.featurizer."))
    if cfg.vision.fused is not None:
        out.update(vit_state_to_timm(
            _sub(state, "vision_backbone.fused_featurizer."),
            cfg.vision.fused, prefix="vision_backbone.fused_featurizer."))
    out.update({"projector." + k: v
                for k, v in _sub(state, "projector.").items()})
    out["action_queries.weight"] = state["action_queries"]
    return out


def head_state_to_torch(head: Mapping[str, torch.Tensor], num_blocks: int,
                        use_pro_version: bool,
                        prefix: str = "model.") -> StateDict:
    """``action_head`` names (prefix taken off) -> the reference's
    L1RegressionActionHead state dict (Pro or original blocks)."""
    block_names, hoisted_names = head_names(use_pro_version)
    p = prefix
    out = {}
    for dst, src in (("layer_norm1", "input_norm"), ("fc1", "fc_in"),
                     ("layer_norm2", "out_norm"), ("fc2", "fc_out")):
        for kind in ("weight", "bias"):
            out[f"{p}{dst}.{kind}"] = head[f"{src}.{kind}"]
    for i in range(num_blocks):
        b = f"{p}mlp_resnet_blocks.{i}."
        for kind in ("weight", "bias"):
            for n in block_names:
                out[f"{b}{n}.{kind}"] = head[f"blocks.{i}.{n}.{kind}"]
            out[f"{b}ffn.0.{kind}"] = head[f"blocks.{i}.ffn_norm.{kind}"]
            out[f"{b}ffn.1.{kind}"] = head[f"blocks.{i}.ffn_fc.{kind}"]
        out[b + "gating_factor"] = head[f"blocks.{i}.gating_factor"]
        for n in hoisted_names:
            out[f"{b}{n}.weight"] = head[f"{n}.kernel"][i].T
            out[f"{b}{n}.bias"] = head[f"{n}.bias"][i]
    return out


def _save_torch(sd: Mapping[str, torch.Tensor], path: Path) -> None:
    # each tensor in a storage of its own: torch.save writes whole storages
    torch.save({k: v.detach().cpu().contiguous().clone()
                for k, v in sd.items()}, path)


def export_checkpoint_dir(state: Mapping[str, torch.Tensor], cfg: VLAConfig,
                          out_dir, norm_stats: Optional[Dict] = None) -> Path:
    """Write a ``VLAModel`` state_dict (float, any device) as a
    reference-layout checkpoint directory."""
    backbone = vla_state_to_hf(state, cfg)  # refuses before any write
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    save_file(backbone, out_dir / "model.safetensors",
              metadata={"format": "pt"})
    _save_torch(head_state_to_torch(_sub(state, "action_head."),
                                    cfg.head.num_blocks,
                                    cfg.head.use_pro_version),
                out_dir / "action_head--0_checkpoint.pt")
    proprio = _sub(state, "proprio_projector.")
    if proprio:
        _save_torch(proprio, out_dir / "proprio_projector--0_checkpoint.pt")
    if norm_stats is not None:
        (out_dir / "dataset_statistics.json").write_text(
            json.dumps(norm_stats, indent=2))
    write_config_json(cfg, out_dir, norm_stats=norm_stats)
    return out_dir


def write_config_json(cfg: VLAConfig, out_dir,
                      norm_stats: Optional[Dict] = None) -> Path:
    """A reference-style config.json with the lossless ``vla_adapter_tpu``
    block (the JAX package's key, so that either package reads the
    other's exports)."""
    llm = cfg.llm
    if isinstance(llm, PhiConfig):
        text_config = {
            "model_type": "phi",
            "vocab_size": llm.vocab_size,
            "hidden_size": llm.hidden_size,
            "num_hidden_layers": llm.num_layers,
            "num_attention_heads": llm.num_heads,
            "intermediate_size": llm.intermediate_size,
            "layer_norm_eps": llm.layer_norm_eps,
            "partial_rotary_factor": llm.partial_rotary_factor,
            "rope_theta": llm.rope_theta,
            "tie_word_embeddings": False,
        }
    else:
        text_config = {
            "model_type": "qwen2",
            "vocab_size": llm.vocab_size,
            "hidden_size": llm.hidden_size,
            "num_hidden_layers": llm.num_layers,
            "num_attention_heads": llm.num_heads,
            "num_key_value_heads": llm.num_kv_heads,
            "intermediate_size": llm.intermediate_size,
            "rms_norm_eps": llm.rms_norm_eps,
            "rope_theta": llm.rope_theta,
            "head_dim": llm.head_dim,
            "tie_word_embeddings": llm.tie_word_embeddings,
        }
    doc = {
        "model_type": "openvla",
        "n_action_bins": cfg.n_action_bins,
        "text_config": text_config,
        "vla_adapter_tpu": vla_config_to_dict(cfg),
    }
    if norm_stats is not None:
        doc["norm_stats"] = norm_stats
    out = Path(out_dir) / "config.json"
    out.write_text(json.dumps(doc, indent=2))
    return out
