"""Host-side image preprocessing for serving (copy of the serving part of
vla_adapter_tpu/data/image_processing.py).

:func:`prepare_image` is the eval-time parity step: JPEG round-trip and
lanczos3 resize to the policy size (TF when installed, else PIL), then an
optional center crop that :func:`center_crop` computes in numpy to
``tf.image.crop_and_resize``'s own arithmetic, with or without TF.
:class:`ImageProcessor` applies each tower's geometry ("resize-naive",
bicubic) and stacks the towers' channels: uint8 (H, W, 3*T) from
:meth:`~ImageProcessor.geom_only`, normalized on the device with
:meth:`~ImageProcessor.norm_constants`, or fp32 normalized on the host by
calling the processor.

A uint8 (size, size, 3) image needs neither TF nor PIL, cropped or not.

:class:`PixelPool` runs :func:`pool_pixels` in ``spawn`` worker processes
that import numpy and this module only (no ``torch``, no CUDA).
"""

from __future__ import annotations

import contextlib
import os
import threading
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import numpy as np

# The normalization constants stored in released checkpoints
# (bf16-quantized ImageNet stats for DINOv2; 0.5s for SigLIP).
DINO_MEAN = (0.484375, 0.455078125, 0.40625)
DINO_STD = (0.228515625, 0.2236328125, 0.224609375)
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)

_F32 = np.float32


def _tf():
    try:
        import tensorflow as tf
    except ImportError:
        return None
    tf.config.set_visible_devices([], "GPU")
    return tf


def _resize_to_policy(image: np.ndarray, size: int) -> np.ndarray:
    """JPEG round-trip + lanczos3 resize (TF), else a lanczos resize (PIL:
    no JPEG round-trip, close, not bit-identical)."""
    tf = _tf()
    if tf is not None:
        t = tf.io.decode_jpeg(tf.io.encode_jpeg(tf.convert_to_tensor(image)))
        t = tf.image.resize(t, (size, size), method="lanczos3",
                            antialias=True)
        return tf.cast(tf.clip_by_value(tf.round(t), 0, 255),
                       tf.uint8).numpy()
    try:
        from PIL import Image
    except ImportError as err:
        raise ImportError(
            f"resizing a {image.shape} image to the policy size {size} needs "
            "tensorflow or PIL, and neither is installed; images already at "
            f"({size}, {size}, 3) need neither") from err
    return np.asarray(Image.fromarray(image).resize((size, size),
                                                    Image.LANCZOS))


def _bilinear_axis(n_in: int, n_out: int, y1: np.float32, y2: np.float32):
    """crop_and_resize's source coordinates along one axis, in float32:
    (lower index, upper index, lerp weight) per output position."""
    scale = (y2 - y1) * _F32(n_in - 1) / _F32(n_out - 1)
    c = y1 * _F32(n_in - 1) + np.arange(n_out).astype(_F32) * scale
    lo = np.floor(c)
    return lo.astype(np.int64), np.ceil(c).astype(np.int64), c - lo


def center_crop(image: np.ndarray, scale: float, size: int) -> np.ndarray:
    """uint8 (H, W, 3) -> uint8 (size, size, 3): the center box of
    ``scale`` of the area, resampled bilinearly, as the reference's
    ``tf.image.crop_and_resize`` path computes it: pixels to float32 times
    float32(1/255), the box ``[y0, y0, y0 + r, y0 + r]`` with ``r =
    clip(sqrt(scale), 0, 1)``, the kernel's float32 lerps, a clip to
    [0, 1], then ``convert_image_dtype``'s saturating ``x * 255.5``
    truncated to uint8."""
    h, w = image.shape[:2]
    f = image.astype(_F32) * _F32(1.0 / 255.0)
    r = np.clip(np.sqrt(_F32(scale)), _F32(0), _F32(1))
    y1 = (_F32(1) - r) / _F32(2)
    y2 = y1 + r
    top, bottom, y_lerp = _bilinear_axis(h, size, y1, y2)
    left, right, x_lerp = _bilinear_axis(w, size, y1, y2)
    x_lerp = x_lerp[None, :, None]
    rows_t, rows_b = f[top], f[bottom]
    upper = rows_t[:, left] + (rows_t[:, right] - rows_t[:, left]) * x_lerp
    lower = rows_b[:, left] + (rows_b[:, right] - rows_b[:, left]) * x_lerp
    out = upper + (lower - upper) * y_lerp[:, None, None]
    out = np.clip(out, _F32(0), _F32(1)) * _F32(255.5)
    return np.clip(out, _F32(0), _F32(255)).astype(np.uint8)


def prepare_image(image: np.ndarray, size: int = 224,
                  center_crop_scale: Optional[float] = None) -> np.ndarray:
    """uint8 HWC -> uint8 (size, size, 3): JPEG round-trip + lanczos3 resize
    (skipped at the policy size), then an optional center crop of
    ``center_crop_scale`` of the area, resized back (:func:`center_crop`)."""
    if tuple(image.shape) != (size, size, 3):
        image = _resize_to_policy(image, size)
    if center_crop_scale is not None:
        image = center_crop(image, center_crop_scale, size)
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

    @staticmethod
    def _rgb(image: np.ndarray) -> np.ndarray:
        image = np.asarray(image, np.uint8)
        if image.ndim != 3 or image.shape[2] != 3:
            raise ValueError(f"expected an RGB (H, W, 3) image, got "
                             f"{image.shape}")
        return image

    def __call__(self, image: np.ndarray) -> np.ndarray:
        """uint8 (H, W, 3) RGB -> fp32 (S, S, 3*T), normalized here on the
        host: (x / 255 - mean) / std per tower, in float32."""
        image = self._rgb(image)
        chans = []
        for spec in self.towers:
            arr = np.asarray(self._geom(image, spec.size), _F32) / 255.0
            chans.append((arr - np.asarray(spec.mean, _F32))
                         / np.asarray(spec.std, _F32))
        return np.concatenate(chans, axis=-1)

    def geom_only(self, image: np.ndarray) -> np.ndarray:
        """uint8 (H, W, 3) RGB -> uint8 (S, S, 3*T), normalization deferred
        to the device."""
        image = self._rgb(image)
        return np.concatenate([self._geom(image, s.size)
                               for s in self.towers], axis=-1)

    def norm_constants(self) -> Tuple[np.ndarray, np.ndarray]:
        """Channel-stacked (3*T,) fp32 mean and std for geom_only output."""
        mean = np.concatenate([np.asarray(s.mean, _F32)
                               for s in self.towers])
        std = np.concatenate([np.asarray(s.std, _F32)
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


def pool_pixels(images: Sequence[np.ndarray], size: int,
                crop_scale: Optional[float], processor: ImageProcessor,
                geom_only: bool) -> np.ndarray:
    """One request's pixel pipeline, a top-level function so that a process
    pool can run it outside the serving process's interpreter lock: uint8
    (n, S, S, 3*T) with ``geom_only``, else the host-normalized fp32."""
    prepped = [prepare_image(img, size=size, center_crop_scale=crop_scale)
               for img in images]
    f = processor.geom_only if geom_only else processor
    return np.stack([f(p) for p in prepped])


_SPAWN_ENV_LOCK = threading.Lock()


@contextlib.contextmanager
def spawn_without_accelerator():
    """Hide every CUDA device from the processes spawned inside this block
    (``CUDA_VISIBLE_DEVICES=""``), so that a child that imported ``torch``
    all the same could not initialise CUDA on the card. The parent's CUDA
    context, made earlier, is unaffected. Serialized under a lock:
    ``os.environ`` is process-global."""
    key = "CUDA_VISIBLE_DEVICES"
    with _SPAWN_ENV_LOCK:
        saved = os.environ.get(key)
        os.environ[key] = ""
        try:
            yield
        finally:
            if saved is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = saved


def _pool_worker_init(barrier, started) -> None:
    """Rendezvous so that no worker takes a task before every worker is up.
    A worker respawned after start-up (the original died mid-task) skips
    the rendezvous: ``started`` is set once the warm-up probe returned.
    The workers import numpy and this module only; TF or PIL load at the
    first image that is not at the policy size."""
    if barrier is not None and not (started is not None and started.is_set()):
        try:
            barrier.wait(timeout=300)
        except threading.BrokenBarrierError:
            pass


class PixelPool:
    """Process pool for :func:`pool_pixels`.

    ``spawn`` children: clean interpreters with no CUDA device visible.
    Construction blocks until every worker is up (an initializer barrier
    and one probe task), so the first real request does not wait for a
    worker to start: create the pool at server start and keep it for the
    server's lifetime; :meth:`close` ends the workers."""

    def __init__(self, workers: int = 4, task_timeout_s: float = 120.0):
        import multiprocessing as mp

        self.task_timeout_s = task_timeout_s
        ctx = mp.get_context("spawn")
        barrier = ctx.Barrier(workers)
        started = ctx.Event()
        with spawn_without_accelerator():
            self._pool = ctx.Pool(workers, initializer=_pool_worker_init,
                                  initargs=(barrier, started))
        dummy = [np.zeros((8, 8, 3), np.uint8)]
        self._pool.apply_async(pool_pixels, (
            dummy, 8, None, ImageProcessor(towers=(TowerSpec(size=8),)),
            True)).get(timeout=300)
        started.set()

    def run(self, images, size, crop_scale, processor, geom_only
            ) -> np.ndarray:
        # a bounded get(): a worker killed mid-task loses its result, and
        # the request thread must not wait for it forever
        return self._pool.apply_async(
            pool_pixels, (list(images), size, crop_scale, processor,
                          geom_only)).get(timeout=self.task_timeout_s)

    def close(self) -> None:
        self._pool.terminate()
        self._pool.join()
