"""Checkpoint directory -> a ready Predictor, without JAX (counterpart of
vla_adapter_tpu/weights/load.py).

The reference's released layout (its finetune.py and eval loaders):
  <ckpt_dir>/
    config.json                               OpenVLAConfig, with norm_stats
    model*.safetensors | pytorch_model*.bin   HF export, LoRA merged
    action_head--<step>_checkpoint.pt
    proprio_projector--<step>_checkpoint.pt
    dataset_statistics.json                   for unnormalization
    vocab.json / merges.txt / tokenizer_config.json

:func:`load_vla` reads all of it into the port's ``Predictor``; safetensors
go through the port's own reader (``weights/safetensors_io.py``), ``.pt``
and ``.bin`` files through ``torch.load(weights_only=True)``. Checkpoints
are local directories only: there is no hub download.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from vla_adapter_torch.core.config import (
    Qwen2Config,
    VLAConfig,
    vla_config_from_dict,
)
from vla_adapter_torch.data.tokenization import load_qwen_tokenizer
from vla_adapter_torch.infer.predict import SERVING_RUNTIME, Predictor
from vla_adapter_torch.models.registry import get_vision_backbone
from vla_adapter_torch.weights.convert import (
    StateDict,
    action_head_state_from_torch,
    mlp_projector_state_from_torch,
    strip_prefix,
    vla_state_from_hf,
)
from vla_adapter_torch.weights.safetensors_io import load_file


def load_torch_file(path) -> StateDict:
    """A ``.pt``/``.bin`` state dict on the CPU (``weights_only``), a
    ``state_dict`` wrapper unwrapped and DDP's ``module.`` prefix
    stripped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return strip_prefix(sd, "module.")


def load_safetensors_dir(ckpt_dir) -> StateDict:
    """Every ``*.safetensors`` shard of a directory, as one dict."""
    out: StateDict = {}
    for shard in sorted(Path(ckpt_dir).glob("*.safetensors")):
        out.update(load_file(shard))
    return out


def _find_one(ckpt_dir, pattern: str) -> Optional[Path]:
    """The one file matching ``pattern``, None if there is none; several
    raise (the reference's loaders demand exactly one)."""
    matches = sorted(Path(ckpt_dir).glob(pattern))
    if len(matches) > 1:
        raise ValueError(f"several files match {pattern}: {matches}")
    return matches[0] if matches else None


def load_hf_backbone_state_dict(ckpt_dir) -> StateDict:
    """The HF-layout backbone: the safetensors shards if there are any,
    else ``pytorch_model*.bin`` (or, lacking those, every ``*.pt``)."""
    ckpt_dir = Path(ckpt_dir)
    if list(ckpt_dir.glob("*.safetensors")):
        return load_safetensors_dir(ckpt_dir)
    files = (sorted(ckpt_dir.glob("pytorch_model*.bin"))
             or sorted(ckpt_dir.glob("*.pt")))
    if not files:
        raise FileNotFoundError(f"no model weights found in {ckpt_dir}")
    sd: StateDict = {}
    for path in files:
        sd.update(load_torch_file(path))
    return sd


def vla_config_from_checkpoint(ckpt_dir) -> VLAConfig:
    """The VLAConfig of a checkpoint: the lossless ``vla_adapter_tpu``
    block of config.json where either package's exporter wrote one, else
    the HF ``text_config`` and the registry's ``vision_backbone_id``."""
    doc = json.loads((Path(ckpt_dir) / "config.json").read_text())
    if "vla_adapter_tpu" in doc:
        return vla_config_from_dict(doc["vla_adapter_tpu"])
    tc = doc["text_config"]
    if tc.get("model_type") == "phi":
        raise NotImplementedError("a Phi language model is not ported yet")
    llm = Qwen2Config(
        vocab_size=tc["vocab_size"],
        hidden_size=tc["hidden_size"],
        num_layers=tc["num_hidden_layers"],
        num_heads=tc["num_attention_heads"],
        num_kv_heads=tc["num_key_value_heads"],
        intermediate_size=tc["intermediate_size"],
        rms_norm_eps=tc["rms_norm_eps"],
        rope_theta=tc["rope_theta"],
        head_dim=tc.get("head_dim",
                        tc["hidden_size"] // tc["num_attention_heads"]),
        tie_word_embeddings=tc.get("tie_word_embeddings", True),
    )
    return VLAConfig(vision=get_vision_backbone(doc["vision_backbone_id"]),
                     llm=llm, n_action_bins=doc.get("n_action_bins", 256))


def load_vla_state(ckpt_dir, cfg: VLAConfig) -> StateDict:
    """The whole ``VLAModel`` state_dict (backbone, head and, if its file
    is there, the proprio projector) from a checkpoint directory, on the
    CPU, in the checkpoint's dtypes."""
    ckpt_dir = Path(ckpt_dir)
    state = vla_state_from_hf(load_hf_backbone_state_dict(ckpt_dir), cfg)
    head_file = _find_one(ckpt_dir, "action_head--*checkpoint.pt")
    if head_file is None:
        raise FileNotFoundError(f"no action head checkpoint in {ckpt_dir}")
    head = action_head_state_from_torch(load_torch_file(head_file),
                                        cfg.head.num_blocks,
                                        cfg.head.use_pro_version)
    state.update({"action_head." + k: v for k, v in head.items()})
    pp_file = _find_one(ckpt_dir, "proprio_projector--*checkpoint.pt")
    if pp_file is not None:
        pp = mlp_projector_state_from_torch(load_torch_file(pp_file))
        state.update({"proprio_projector." + k: v for k, v in pp.items()})
    return state


def load_norm_stats(ckpt_dir) -> Dict:
    """dataset_statistics.json, else config.json's norm_stats."""
    ckpt_dir = Path(ckpt_dir)
    stats = ckpt_dir / "dataset_statistics.json"
    if stats.exists():
        return json.loads(stats.read_text())
    doc = json.loads((ckpt_dir / "config.json").read_text())
    if "norm_stats" not in doc:
        raise ValueError(f"no normalization statistics in {ckpt_dir}")
    return doc["norm_stats"]


def resolve_checkpoint(path) -> Path:
    """A local checkpoint directory; anything else raises (there is no hub
    download)."""
    p = Path(path)
    if not p.is_dir():
        raise FileNotFoundError(f"{str(path)!r} is not a local checkpoint "
                                "directory")
    return p


def load_vla(ckpt_dir, cfg: Optional[VLAConfig] = None,
             tokenize: Optional[Callable[[str], List[int]]] = None,
             device: str = "cuda", int8: bool = False,
             act_int8: bool = False, w8a8_impl: str = "auto",
             cuda_graph: Optional[bool] = None, rt=None,
             center_crop: bool = True):
    """Checkpoint directory -> ``infer.predict.Predictor`` (the
    reference's get_vla, action head, proprio projector and statistics in
    one). The weights are read from the files once and moved to ``device``
    once, where the int8 tiers quantize them. ``tokenize`` (text -> ids)
    defaults to the checkpoint's Qwen tokenizer (needs ``transformers``)."""
    ckpt_dir = resolve_checkpoint(ckpt_dir)
    cfg = cfg or vla_config_from_checkpoint(ckpt_dir)
    if tokenize is None:
        tok = load_qwen_tokenizer(str(ckpt_dir))
        tokenize = lambda text: tok(text, add_special_tokens=True).input_ids  # noqa: E731
    return Predictor(cfg=cfg, params=load_vla_state(ckpt_dir, cfg),
                     tokenize=tokenize, norm_stats=load_norm_stats(ckpt_dir),
                     rt=rt or SERVING_RUNTIME, center_crop=center_crop,
                     device=device, int8=int8, act_int8=act_int8,
                     w8a8_impl=w8a8_impl, cuda_graph=cuda_graph)
