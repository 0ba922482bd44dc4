"""Serving: predict_action (counterpart of vla_adapter_tpu/infer/predict.py).

A request is host preprocessing (prompt ids, the image pipeline as uint8,
proprio normalization), ONE model forward on the device under
``torch.inference_mode()`` with the pixels normalized there, and host-side
unnormalization of the action chunk. ``device_normalize=False`` normalizes
the pixels on the host instead (fp32 rows); ``enable_preprocess_pool`` runs
the image pipeline in a process pool (``data/image_processing.PixelPool``),
as a server does.

Three serving tiers over the same checkpoint: bf16 (the default), weight-
only int8 (``int8=True``) and w8a8 (``act_int8=True``), the last with three
backends over one set of int8 tensors: "fused" (kernels B2/B3 for the
MLPs) and "dense" (every w8a8 matmul through kernel B4), picked per batch
by "auto", and "mega" (batch 1 only: each decoder layer from the attention
core on as kernel B6), which "auto" never picks.

On the card the forward is captured once per (backend, batch size, proprio
present) as a CUDA graph and replayed (``infer/graph.py``), the port's
counterpart of the JAX Predictor's ``jax.jit``; ``cuda_graph=False`` runs
it eagerly, as the CPU always does.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from vla_adapter_torch.core.config import VLAConfig
from vla_adapter_torch.data.image_processing import (
    PixelPool,
    image_processor_for,
    prepare_image,
)
from vla_adapter_torch.data.normalization import normalize, unnormalize
from vla_adapter_torch.data.transform import inference_ids
from vla_adapter_torch.infer.graph import CARD_LOCK, GraphedForward
from vla_adapter_torch.models.layers import Runtime, resolve_w8a8_impl
from vla_adapter_torch.models.quantize import quantize_state_dict
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

    params: the model's state_dict (e.g. ``weights.from_jax_params``),
    float or already quantized; float tensors are moved to ``device`` in
    ``rt.param_dtype`` and used in place (tensors already there are shared,
    not copied).
    norm_stats: the checkpoint's per-dataset statistics; ``unnorm_key``
    picks the dataset.
    int8: weight-only int8 serving; every Dense/BatchedDense weight is
    quantized per output channel on ``device`` at construction and no
    float copy of it is kept.
    act_int8: w8a8 serving (implies int8): activations are quantized per
    token and the products run int8 x int8 -> int32 (kernels B2-B5).
    w8a8_impl: "auto" (per batch, :func:`resolve_w8a8_impl`), "fused",
    "dense" (the JAX package's "xla": every w8a8 matmul on its own) or
    "mega" (batch 1 only; a larger batch raises ValueError). The backends
    share one set of int8 tensors.
    cuda_graph: run the forward as one CUDA graph per (backend, batch,
    proprio present), captured at that key's first request (None: on the
    card yes, on the CPU no; True on the CPU raises ValueError). False
    runs it eagerly, launch by launch.
    device_normalize: ship uint8 pixels and normalize them on the device
    (True), or normalize them on the host (``ImageProcessor.__call__``) and
    ship fp32 (False): the same fp32 arithmetic either side.
    """

    cfg: VLAConfig
    params: Mapping[str, torch.Tensor]
    tokenize: Callable[[str], List[int]]
    norm_stats: Dict[str, Dict]
    rt: Runtime = SERVING_RUNTIME
    center_crop: bool = True
    device: str = "cuda"
    int8: bool = False
    act_int8: bool = False
    w8a8_impl: str = "auto"
    cuda_graph: Optional[bool] = None
    device_normalize: bool = True

    def __post_init__(self):
        self.device = resolve_device(self.device)
        on_card = self.device.type == "cuda"
        if self.cuda_graph and not on_card:
            raise ValueError(f"cuda_graph=True needs a CUDA device, not "
                             f"{self.device}")
        self.cuda_graph = on_card if self.cuda_graph is None \
            else self.cuda_graph
        if self.int8 or self.act_int8:
            self.rt = dataclasses.replace(
                self.rt, weights_int8=True,
                act_int8=self.act_int8 or self.rt.act_int8)
        # from here on the runtime decides (an int8 rt may come with
        # already quantized params and both flags False)
        self.int8, self.act_int8 = self.rt.weights_int8, self.rt.act_int8
        if not self.act_int8:
            if self.w8a8_impl not in ("auto", self.rt.w8a8_impl):
                raise ValueError(f"w8a8_impl={self.w8a8_impl!r} needs w8a8 "
                                 "serving: pass act_int8=True")
            self.w8a8_impl = self.rt.w8a8_impl
        impls = ((self.w8a8_impl,) if self.w8a8_impl != "auto"
                 else ("fused", "dense"))
        self._models = {}
        for impl in impls:
            rt = dataclasses.replace(self.rt, w8a8_impl=impl)
            model = VLAModel(self.cfg, rt, device="meta")
            if not self._models:
                self.params = self._device_state(model.state_dict())
            model.load_state_dict(self.params, strict=True, assign=True)
            self._models[impl] = model.eval()
        self.model = self._model_for_batch(1)
        self.image_processor = image_processor_for(self.cfg.vision)
        mean, std = self.image_processor.norm_constants()
        self._pix_mean = torch.from_numpy(mean).to(self.device)
        self._pix_std = torch.from_numpy(std).to(self.device)
        self.graphs = (GraphedForward(self._device_forward, self.device)
                       if self.cuda_graph else None)
        self._pixel_pool: Optional[PixelPool] = None

    def _device_state(self, expected) -> Dict[str, torch.Tensor]:
        """``params`` on the device as the model expects them: int8
        weights quantized there (or passed through), float tensors in
        rt.param_dtype."""
        state = quantize_state_dict(self.params, expected, self.device)
        return {k: v if k.endswith((".weight_q", ".weight_scale"))
                else v.to(self.device, self.rt.param_dtype)
                for k, v in state.items()}

    def _impl_for_batch(self, batch: int) -> str:
        """The backend that serves a batch: "auto" picks per batch, "mega"
        refuses more than one row."""
        if len(self._models) > 1:
            return resolve_w8a8_impl("auto", batch)
        impl = next(iter(self._models))
        if self._models[impl].rt.mega and batch > 1:
            raise ValueError(f"w8a8_impl='mega' serves one request at a time,"
                             f" got a batch of {batch}: use 'fused', 'dense' "
                             "or 'auto'")
        return impl

    def _model_for_batch(self, batch: int) -> VLAModel:
        return self._models[self._impl_for_batch(batch)]

    def graph_key(self, batch: int, proprio: bool) -> Tuple[str, int, bool]:
        """(backend, batch, proprio present): the key of the CUDA graph that
        serves such a forward, resolved before anything is captured."""
        return (self._impl_for_batch(batch), batch,
                bool(proprio and self.cfg.use_proprio))

    def with_runtime(self, rt: Runtime, w8a8_impl: Optional[str] = None,
                     cuda_graph: Optional[bool] = None) -> "Predictor":
        """A Predictor over the same weight tensors with another runtime
        (e.g. ``kernels="plain"``) and, if given, another w8a8 backend or
        graph setting; its graphs are its own. param_dtype and the int8
        tier must match to share."""
        return dataclasses.replace(
            self, params=self.params, rt=rt, device=str(self.device),
            int8=False, act_int8=False,
            w8a8_impl=self.w8a8_impl if w8a8_impl is None else w8a8_impl,
            cuda_graph=self.cuda_graph if cuda_graph is None else cuda_graph)

    def enable_preprocess_pool(self, workers: int = 4) -> None:
        """Run each request's image pipeline in a pool of ``workers``
        processes, so that concurrent requests preprocess on several cores
        instead of taking turns under one interpreter lock (a server calls
        this through ``ActionServer(preprocess_workers=N)``; whoever calls
        it closes ``_pixel_pool``)."""
        self._pixel_pool = PixelPool(workers)

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
        """Host work for one request: prompt ids, pixels (uint8, or fp32
        normalized under ``device_normalize=False``), proprio."""
        cfg = self.cfg
        key = self._resolve_unnorm_key(unnorm_key)
        ids, plen, valid = inference_ids(cfg, self.tokenize, instruction)
        crop = 0.9 if self.center_crop else None
        size = cfg.vision.primary.image_size
        if self._pixel_pool is not None:
            pixels = self._pixel_pool.run(images, size, crop,
                                          self.image_processor,
                                          self.device_normalize)
        else:
            proc = (self.image_processor.geom_only if self.device_normalize
                    else self.image_processor)
            pixels = np.stack([
                proc(prepare_image(img, size=size, center_crop_scale=crop))
                for img in images])
        row = {"ids": ids, "plen": plen, "valid": valid, "pixels": pixels}
        if cfg.use_proprio and proprio is not None:
            row["proprio"] = normalize(
                np.asarray(proprio, np.float32),
                self.norm_stats[key]["proprio"],
                cfg.constants.normalization_type)
        return row

    def _device_forward(self, ids, plen, valid, pixels, proprio
                        ) -> torch.Tensor:
        """The forward from device tensors (uint8 pixels are normalized
        here, fp32 ones were on the host): fp32 normalized actions. The
        graphs capture exactly this."""
        model = self._model_for_batch(ids.shape[0])
        if pixels.dtype == torch.uint8:
            pixels = (pixels.float() / 255.0 - self._pix_mean) / self._pix_std
        return model(ids, plen, valid, pixels.to(self.rt.dtype),
                     proprio)["actions"].float()

    @torch.inference_mode()
    def _forward(self, ids, plen, valid, pixels, proprio) -> np.ndarray:
        if self.graphs is not None:
            key = self.graph_key(ids.shape[0], proprio is not None)
            return self.graphs(key, ids, plen, valid, pixels, proprio)
        dev = self.device
        with CARD_LOCK if dev.type == "cuda" else contextlib.nullcontext():
            return self._device_forward(
                torch.from_numpy(ids).to(dev, torch.long),
                torch.from_numpy(plen).to(dev, torch.long),
                torch.from_numpy(valid).to(dev, torch.int32),
                torch.from_numpy(pixels).to(dev),
                None if proprio is None
                else torch.from_numpy(proprio).to(dev, torch.float32),
            ).cpu().numpy()

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
        return self._forward(
            np.stack([r["ids"] for r in rows]),
            np.asarray([r["plen"] for r in rows], np.int32),
            np.stack([r["valid"] for r in rows]),
            np.stack([r["pixels"] for r in rows]),
            proprio)

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
        self._model_for_batch(len(instructions))  # refuses before any work
        rows = [self.preprocess(images_batch[i], instructions[i],
                                None if proprio_batch is None
                                else proprio_batch[i], unnorm_key)
                for i in range(len(instructions))]
        return self.predict_action_rows(rows, unnorm_key)
