"""Host-side image preprocessing for serving (copy of the serving part of
vla_adapter_tpu/data/image_processing.py).

:func:`prepare_image` is the eval-time parity step: JPEG round-trip and
lanczos3 resize to the policy size (TF when installed, else PIL), optional
center crop. :class:`ImageProcessor` applies each tower's geometry
("resize-naive", bicubic) and stacks the towers' channels: uint8 (H, W, 3*T)
from :meth:`~ImageProcessor.geom_only`, normalized on the device with
:meth:`~ImageProcessor.norm_constants`.

Both are identities on a uint8 (size, size, 3) image without a crop, and
then import neither TF nor PIL.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import numpy as np

# The normalization constants stored in released checkpoints
# (bf16-quantized ImageNet stats for DINOv2; 0.5s for SigLIP).
DINO_MEAN = (0.484375, 0.455078125, 0.40625)
DINO_STD = (0.228515625, 0.2236328125, 0.224609375)
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)


def _tf():
    try:
        import tensorflow as tf
    except ImportError:
        return None
    tf.config.set_visible_devices([], "GPU")
    return tf


def prepare_image(image: np.ndarray, size: int = 224,
                  center_crop_scale: Optional[float] = None) -> np.ndarray:
    """uint8 HWC -> uint8 (size, size, 3): JPEG round-trip + lanczos3 resize
    (skipped at the policy size), then an optional center crop of
    ``center_crop_scale`` of the area, resized back."""
    if tuple(image.shape) == (size, size, 3) and center_crop_scale is None:
        return image
    tf = _tf()
    if tf is not None:
        t = tf.convert_to_tensor(image)
        if tuple(image.shape) != (size, size, 3):
            t = tf.io.decode_jpeg(tf.io.encode_jpeg(t))
            t = tf.image.resize(t, (size, size), method="lanczos3",
                                antialias=True)
            t = tf.cast(tf.clip_by_value(tf.round(t), 0, 255), tf.uint8)
        if center_crop_scale is not None:
            f = tf.image.convert_image_dtype(t, tf.float32)
            r = tf.clip_by_value(
                tf.sqrt(tf.constant(center_crop_scale, tf.float32)), 0, 1)
            y0 = (1 - r) / 2
            boxes = tf.stack([y0, y0, y0 + r, y0 + r])[None]
            f = tf.image.crop_and_resize(f[None], boxes, [0], (size, size))[0]
            f = tf.clip_by_value(f, 0.0, 1.0)
            t = tf.image.convert_image_dtype(f, tf.uint8, saturate=True)
        return t.numpy()
    from PIL import Image  # no JPEG round-trip: close, not bit-identical

    if tuple(image.shape) != (size, size, 3):
        image = np.asarray(
            Image.fromarray(image).resize((size, size), Image.LANCZOS))
    if center_crop_scale is not None:
        r = np.sqrt(center_crop_scale)
        h, w = image.shape[:2]
        ch, cw = int(h * r), int(w * r)
        y0, x0 = (h - ch) // 2, (w - cw) // 2
        image = np.asarray(Image.fromarray(
            image[y0:y0 + ch, x0:x0 + cw]).resize((size, size), Image.LANCZOS))
    return image


@dataclass
class TowerSpec:
    size: int = 224
    mean: Tuple[float, float, float] = DINO_MEAN
    std: Tuple[float, float, float] = DINO_STD


@dataclass
class ImageProcessor:
    """Per-tower "resize-naive" geometry (bicubic), channel-stacked."""

    towers: Sequence[TowerSpec] = field(default_factory=lambda: (
        TowerSpec(mean=DINO_MEAN, std=DINO_STD),
        TowerSpec(mean=SIGLIP_MEAN, std=SIGLIP_STD),
    ))

    @staticmethod
    def _geom(image: np.ndarray, size: int) -> np.ndarray:
        if image.shape[:2] == (size, size):
            return image  # a scale-1 bicubic resample returns its input
        from PIL import Image

        return np.asarray(Image.fromarray(image).resize((size, size),
                                                        Image.BICUBIC))

    def geom_only(self, image: np.ndarray) -> np.ndarray:
        """uint8 (H, W, 3) RGB -> uint8 (S, S, 3*T), normalization deferred
        to the device."""
        image = np.asarray(image, np.uint8)
        if image.ndim != 3 or image.shape[2] != 3:
            raise ValueError(f"expected an RGB (H, W, 3) image, got "
                             f"{image.shape}")
        return np.concatenate([self._geom(image, s.size)
                               for s in self.towers], axis=-1)

    def norm_constants(self) -> Tuple[np.ndarray, np.ndarray]:
        """Channel-stacked (3*T,) fp32 mean and std for geom_only output."""
        mean = np.concatenate([np.asarray(s.mean, np.float32)
                               for s in self.towers])
        std = np.concatenate([np.asarray(s.std, np.float32)
                              for s in self.towers])
        return mean, std


def image_processor_for(vision_cfg) -> ImageProcessor:
    """A processor matching a FusedVisionConfig (tower count and size)."""
    towers = [TowerSpec(size=vision_cfg.primary.image_size,
                        mean=DINO_MEAN, std=DINO_STD)]
    if vision_cfg.fused is not None:
        towers.append(TowerSpec(size=vision_cfg.fused.image_size,
                                mean=SIGLIP_MEAN, std=SIGLIP_STD))
    return ImageProcessor(towers=tuple(towers))
