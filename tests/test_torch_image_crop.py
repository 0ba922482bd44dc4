"""The port's center crop (numpy, ``data/image_processing.py:center_crop``)
against the JAX package's ``prepare_image``, which crops through
``tf.image.crop_and_resize`` and ``convert_image_dtype``: bit for bit at
the flagship's 224 px on random and smooth images, and through the whole
``prepare_image`` for images that first need the JPEG round-trip and
resize (TF on both sides). Without TF and PIL the port still crops an
image at the policy size, and asks for either to resize one that is not.
"""

import sys

import numpy as np
import pytest

from vla_adapter_tpu.data import image_processing as jimg
from vla_adapter_torch.data import image_processing as timg

tf = pytest.importorskip("tensorflow")


def _images(seed, n=6, size=224):
    """Random images and smooth ones (ramps and blobs), whose bilinear
    samples land near the rounding points of the uint8 conversion."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i % 2 == 0:
            img = rng.integers(0, 256, size=(size, size, 3), dtype=np.uint8)
        else:
            steps = rng.integers(0, 3, size=(size, size, 3))
            img = np.clip(np.cumsum(steps, axis=1), 0, 255).astype(np.uint8)
        out.append(img)
    return out


def _tf_center_crop(image, scale, size):
    """The JAX package's crop, TF ops as its prepare_image runs them."""
    f = tf.image.convert_image_dtype(tf.convert_to_tensor(image), tf.float32)
    r = tf.clip_by_value(tf.sqrt(tf.constant(scale, tf.float32)), 0, 1)
    y0 = (1 - r) / 2
    boxes = tf.stack([y0, y0, y0 + r, y0 + r])[None]
    f = tf.image.crop_and_resize(f[None], boxes, [0], (size, size))[0]
    f = tf.clip_by_value(f, 0.0, 1.0)
    return tf.image.convert_image_dtype(f, tf.uint8, saturate=True).numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_prepare_image_crop_matches_jax_at_224(seed):
    for img in _images(seed):
        want = jimg.prepare_image(img, size=224, center_crop_scale=0.9)
        got = timg.prepare_image(img, size=224, center_crop_scale=0.9)
        assert got.dtype == np.uint8 and got.shape == (224, 224, 3)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scale", [0.5, 0.81, 0.95, 1.0])
def test_center_crop_matches_tf_at_other_scales(scale):
    for img in _images(2, n=2):
        np.testing.assert_array_equal(timg.center_crop(img, scale, 224),
                                      _tf_center_crop(img, scale, 224))


@pytest.mark.parametrize("shape", [(256, 256, 3), (180, 240, 3)],
                         ids=["square", "wide"])
def test_prepare_image_resize_then_crop_matches_jax(shape):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, size=shape, dtype=np.uint8)
    for crop in (None, 0.9):
        np.testing.assert_array_equal(
            timg.prepare_image(img, size=224, center_crop_scale=crop),
            jimg.prepare_image(img, size=224, center_crop_scale=crop))


def test_policy_size_needs_neither_tf_nor_pil(monkeypatch):
    # the port never imports TensorFlow; PIL only for the JPEG round trip
    monkeypatch.setitem(sys.modules, "tensorflow", None)  # import tf fails
    monkeypatch.setitem(sys.modules, "PIL", None)  # import PIL fails
    img = _images(4, n=1, size=28)[0]
    np.testing.assert_array_equal(
        timg.prepare_image(img, size=28, center_crop_scale=0.9),
        _tf_center_crop(img, 0.9, 28))
    with pytest.raises(ImportError, match="needs PIL"):
        timg.prepare_image(img[:20], size=28)
