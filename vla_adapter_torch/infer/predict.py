"""Serving: predict_action (counterpart of vla_adapter_tpu/infer/predict.py).

A request is host preprocessing (prompt ids, the image pipeline as uint8,
proprio normalization), ONE model forward on the device under
``torch.inference_mode()`` with the pixels normalized there, and host-side
unnormalization of the action chunk. The float (bf16) forward only: the
int8 and w8a8 tiers are not ported yet.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from vla_adapter_torch.core.config import VLAConfig
from vla_adapter_torch.data.image_processing import (
    image_processor_for,
    prepare_image,
)
from vla_adapter_torch.data.normalization import normalize, unnormalize
from vla_adapter_torch.data.transform import inference_ids
from vla_adapter_torch.models.layers import Runtime
from vla_adapter_torch.models.vla import VLAModel

SERVING_RUNTIME = Runtime(dtype=torch.bfloat16, param_dtype=torch.bfloat16)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; "cuda" raises without a card
    rather than running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return device


@dataclass
class Predictor:
    """Action predictor over one model.

    params: the model's state_dict (e.g. ``weights.from_jax_params``);
    its tensors are moved to ``device`` in ``rt.param_dtype`` and used in
    place (tensors already there are shared, not copied).
    norm_stats: the checkpoint's per-dataset statistics; ``unnorm_key``
    picks the dataset.
    """

    cfg: VLAConfig
    params: Mapping[str, torch.Tensor]
    tokenize: Callable[[str], List[int]]
    norm_stats: Dict[str, Dict]
    rt: Runtime = SERVING_RUNTIME
    center_crop: bool = True
    device: str = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        model = VLAModel(self.cfg, self.rt, device="meta")
        state = {k: v.to(self.device, self.rt.param_dtype)
                 for k, v in self.params.items()}
        model.load_state_dict(state, strict=True, assign=True)
        self.model = model.eval()
        self.params = self.model.state_dict()
        self.image_processor = image_processor_for(self.cfg.vision)
        mean, std = self.image_processor.norm_constants()
        self._pix_mean = torch.from_numpy(mean).to(self.device)
        self._pix_std = torch.from_numpy(std).to(self.device)

    def with_runtime(self, rt: Runtime) -> "Predictor":
        """A Predictor over the same weight tensors with another runtime
        (e.g. ``attn_impl="plain"``); param_dtype must match to share."""
        return dataclasses.replace(self, params=self.params, rt=rt,
                                   device=str(self.device))

    def _resolve_unnorm_key(self, unnorm_key: Optional[str]) -> str:
        if unnorm_key is None:
            if len(self.norm_stats) != 1:
                raise ValueError(f"several datasets in norm_stats; pass "
                                 f"unnorm_key from {sorted(self.norm_stats)}")
            return next(iter(self.norm_stats))
        if unnorm_key not in self.norm_stats:
            raise KeyError(f"{unnorm_key!r} not in {sorted(self.norm_stats)}")
        return unnorm_key

    def predict_action(self, images: Sequence[np.ndarray], instruction: str,
                       proprio: Optional[np.ndarray] = None,
                       unnorm_key: Optional[str] = None) -> np.ndarray:
        """images: uint8 HWC (third-person first, then wrists). Returns the
        unnormalized (num_actions_chunk, action_dim) chunk."""
        return self.predict_action_batch(
            [images], [instruction], None if proprio is None else [proprio],
            unnorm_key)[0]

    def preprocess(self, images: Sequence[np.ndarray], instruction: str,
                   proprio: Optional[np.ndarray] = None,
                   unnorm_key: Optional[str] = None) -> Dict[str, np.ndarray]:
        """Host work for one request: prompt ids, uint8 pixels, proprio."""
        cfg = self.cfg
        key = self._resolve_unnorm_key(unnorm_key)
        ids, plen, valid = inference_ids(cfg, self.tokenize, instruction)
        crop = 0.9 if self.center_crop else None
        size = cfg.vision.primary.image_size
        pixels = np.stack([
            self.image_processor.geom_only(
                prepare_image(img, size=size, center_crop_scale=crop))
            for img in images])
        row = {"ids": ids, "plen": plen, "valid": valid, "pixels": pixels}
        if cfg.use_proprio and proprio is not None:
            row["proprio"] = normalize(
                np.asarray(proprio, np.float32),
                self.norm_stats[key]["proprio"],
                cfg.constants.normalization_type)
        return row

    @torch.inference_mode()
    def _forward(self, ids, plen, valid, pixels, proprio) -> torch.Tensor:
        dev = self.device
        pixels = torch.from_numpy(pixels).to(dev).float() / 255.0
        pixels = ((pixels - self._pix_mean) / self._pix_std).to(self.rt.dtype)
        return self.model(
            torch.from_numpy(ids).to(dev, torch.long),
            torch.from_numpy(plen).to(dev, torch.long),
            torch.from_numpy(valid).to(dev),
            pixels,
            None if proprio is None else torch.from_numpy(proprio).to(dev),
        )["actions"]

    def normalized_actions(self, rows: Sequence[Dict[str, np.ndarray]]
                           ) -> np.ndarray:
        """Stack preprocessed rows and run one forward: the model's
        normalized (B, chunk, action_dim) actions as fp32 numpy."""
        n_proprio = sum("proprio" in r for r in rows)
        if n_proprio and n_proprio != len(rows):
            raise ValueError(f"{n_proprio}/{len(rows)} rows carry proprio: a "
                             "batch must be all-proprio or none")
        proprio = (np.stack([r["proprio"] for r in rows])
                   if n_proprio and self.cfg.use_proprio else None)
        actions = self._forward(
            np.stack([r["ids"] for r in rows]),
            np.asarray([r["plen"] for r in rows], np.int32),
            np.stack([r["valid"] for r in rows]),
            np.stack([r["pixels"] for r in rows]),
            proprio)
        return actions.float().cpu().numpy()

    def predict_action_rows(self, rows: Sequence[Dict[str, np.ndarray]],
                            unnorm_key: Optional[str] = None) -> np.ndarray:
        """Stack preprocessed rows, run one forward, unnormalize."""
        key = self._resolve_unnorm_key(unnorm_key)
        return unnormalize(self.normalized_actions(rows),
                           self.norm_stats[key]["action"],
                           self.cfg.constants.normalization_type)

    def predict_action_batch(
        self,
        images_batch: Sequence[Sequence[np.ndarray]],
        instructions: Sequence[str],
        proprio_batch: Optional[Sequence[np.ndarray]] = None,
        unnorm_key: Optional[str] = None,
    ) -> np.ndarray:
        """Batched requests: (B, num_actions_chunk, action_dim)."""
        rows = [self.preprocess(images_batch[i], instructions[i],
                                None if proprio_batch is None
                                else proprio_batch[i], unnorm_key)
                for i in range(len(instructions))]
        return self.predict_action_rows(rows, unnorm_key)
