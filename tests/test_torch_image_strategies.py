"""The port's image strategies against the JAX package's, on the CPU.

``ImageProcessor(resize_strategy=...)`` in "letterbox" (the default grey
fill and another one) and "resize-crop", and "resize-naive" beside them,
on seeded uint8 images that are wide, tall, odd-sized and square, for a
one-tower (CLIP-like) and a two-tower (DINOv2 + SigLIP-like) layout: the
host-normalized float32 pixels and ``geom_only``'s uint8 pixels equal the
JAX package's bit for bit (both resample with PIL, the same filter). An
unknown strategy raises in both packages.
"""

import numpy as np
import pytest

from vla_adapter_tpu.data import image_processing as jimg
from vla_adapter_torch.core.config import FusedVisionConfig
from vla_adapter_torch.data import image_processing as timg

IMAGES = {"wide": (23, 61), "tall": (57, 19), "odd": (37, 45),
          "square": (40, 40)}
STRATEGIES = [("letterbox", None), ("letterbox", (0, 64, 255)),
              ("resize-crop", None), ("resize-naive", None)]


def _layouts(mod):
    return {
        "one-tower": (mod.TowerSpec(size=24, mean=mod.SIGLIP_MEAN,
                                    std=mod.SIGLIP_STD),),
        "two-tower": (mod.TowerSpec(size=28, mean=mod.DINO_MEAN,
                                    std=mod.DINO_STD),
                      mod.TowerSpec(size=28, mean=mod.SIGLIP_MEAN,
                                    std=mod.SIGLIP_STD)),
    }


def _processors(layout, strategy, fill):
    kw = {"resize_strategy": strategy}
    if fill is not None:
        kw["letterbox_fill"] = fill
    return (jimg.ImageProcessor(towers=_layouts(jimg)[layout], **kw),
            timg.ImageProcessor(towers=_layouts(timg)[layout], **kw))


@pytest.mark.parametrize("image", sorted(IMAGES))
@pytest.mark.parametrize("layout", ["one-tower", "two-tower"])
@pytest.mark.parametrize("strategy, fill", STRATEGIES,
                         ids=["letterbox", "letterbox-fill", "resize-crop",
                              "resize-naive"])
def test_strategy_matches_jax_bit_for_bit(image, layout, strategy, fill):
    h, w = IMAGES[image]
    rng = np.random.default_rng(h * 100 + w)
    img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    jproc, tproc = _processors(layout, strategy, fill)
    got, want = tproc(img), jproc(img)
    sizes = [t.size for t in tproc.towers]
    assert got.dtype == np.float32 and got.shape == (
        sizes[0], sizes[0], 3 * len(sizes))
    assert np.array_equal(got, want)
    geom = tproc.geom_only(img)
    assert geom.dtype == np.uint8
    assert np.array_equal(geom, jproc.geom_only(img))
    mean, std = tproc.norm_constants()
    assert np.array_equal(mean, jproc.norm_constants()[0])
    assert np.array_equal(std, jproc.norm_constants()[1])


def test_letterbox_fills_the_padding_and_keeps_the_image():
    """A wide image under letterbox: the rows above and below the image
    are the fill, and the default fill is the JAX package's grey."""
    img = np.full((10, 40, 3), 200, np.uint8)
    proc = timg.ImageProcessor(towers=(timg.TowerSpec(size=40),),
                               resize_strategy="letterbox",
                               letterbox_fill=(0, 64, 255))
    geom = proc.geom_only(img)
    assert (geom[0] == (0, 64, 255)).all() and (geom[-1] == (0, 64, 255)).all()
    assert (geom[20] == 200).all()
    assert timg.ImageProcessor().letterbox_fill == \
        jimg.ImageProcessor().letterbox_fill
    # the VLA's processor stays resize-naive, as the JAX one does
    assert timg.image_processor_for(FusedVisionConfig()).resize_strategy \
        == "resize-naive"


def test_unknown_strategy_raises_in_both():
    img = np.zeros((20, 30, 3), np.uint8)
    jproc, tproc = _processors("two-tower", "pad-and-pray", None)
    with pytest.raises(ValueError, match="unknown resize strategy"):
        jproc(img)
    with pytest.raises(ValueError, match="unknown resize strategy"):
        tproc(img)
    with pytest.raises(ValueError, match="unknown resize strategy"):
        tproc.geom_only(img)
