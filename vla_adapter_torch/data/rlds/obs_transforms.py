"""Frame-level observation transforms in numpy (counterpart of
vla_adapter_tpu/data/rlds/obs_transforms.py, which runs them on
``tf.image``).

* :func:`decode_and_resize`: JPEG/PNG bytes decoded with PIL to
  ``tf.io.decode_image``'s pixels (an empty string becomes zeros), then
  :func:`resize_image`: lanczos3 with antialiasing computed to
  ``tf.image.resize(method="lanczos3", antialias=True)``'s own arithmetic
  (TF's scale-and-translate: per-axis weight spans, the kernel widened by
  1/scale when downsampling, rows then columns, float32 sums in source
  order), rounded half to even and clipped to uint8.
* :func:`augment`: the recipe's augmentations per camera, each split into
  a draw of its parameters (from a generator seeded per frame, per camera
  and per op, as the JAX version seeds its stateless draws) and an apply
  function that computes ``tf.image``'s arithmetic: crop and resize,
  brightness, contrast, saturation and hue (the last two through HSV).
  TF's stateless random draws themselves cannot be reproduced here: the
  parameters follow the same distributions, not the same values.
"""

from __future__ import annotations

import functools
import io
from typing import Dict, Sequence, Tuple, Union

import numpy as np

F32 = np.float32
_PI = F32(3.14159265359)
_LANCZOS_RADIUS = F32(3.0)


# --- lanczos3 resize (TF's scale_and_translate) -------------------------

@functools.lru_cache(maxsize=1)
def _libm_sinf():
    """The C library's ``sinf``, which TF's kernel calls (numpy's float32
    sin rounds differently in the last place)."""
    import ctypes
    import ctypes.util

    sinf = ctypes.CDLL(ctypes.util.find_library("m")).sinf
    sinf.restype = ctypes.c_float
    sinf.argtypes = [ctypes.c_float]
    return sinf


def _sinf(a: np.ndarray) -> np.ndarray:
    sinf = _libm_sinf()
    return np.array([sinf(float(v)) for v in a.ravel()],
                    F32).reshape(a.shape)


def _lanczos3(x: np.ndarray) -> np.ndarray:
    """TF's LanczosKernelFunc(3) in float32."""
    x = np.abs(x).astype(F32)
    a = _PI * x
    s1 = _sinf(a)
    s2 = _sinf(a / _LANCZOS_RADIUS)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = _LANCZOS_RADIUS * s1 * s2 / (_PI * _PI * x * x)
    w = np.where(x.astype(np.float64) <= 1e-3, F32(1), w)
    return np.where(x > _LANCZOS_RADIUS, F32(0), w).astype(F32)


@functools.lru_cache(maxsize=64)
def resize_spans(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(starts (out,), weights (out, span)) of one axis, as TF's
    ComputeSpansCore computes them with antialiasing and no translation:
    the weights of each output position summed in source order and
    normalized by their sum; empty spans (samples outside the source) are
    all zero."""
    scale = F32(out_size) / F32(in_size)
    inv_scale = F32(1.0 / np.float64(scale))
    kernel_scale = max(inv_scale, F32(1.0))
    reach = _LANCZOS_RADIUS * kernel_scale
    span = min(2 * int(np.ceil(reach)) + 1, in_size)
    one_over_kernel_scale = F32(1.0) / kernel_scale

    sample = (np.arange(out_size).astype(F32) + F32(0.5)) * inv_scale
    inside = (sample >= 0) & (sample <= F32(in_size))
    start = np.clip(np.ceil(sample - reach - F32(0.5)), 0, in_size - 1)
    end = np.clip(np.floor(sample + reach - F32(0.5)), 0, in_size - 1) + 1
    start, end = start.astype(np.int64), end.astype(np.int64)
    k = np.arange(span)[None, :]
    valid = (k < (end - start)[:, None]) & inside[:, None]
    pos = (start[:, None] + k).astype(F32) + F32(0.5) - sample[:, None]
    raw = np.where(valid, _lanczos3(pos * one_over_kernel_scale), F32(0))
    total = np.zeros(out_size, F32)
    for j in range(span):  # float32, in source order
        total = total + raw[:, j]
    ok = np.abs(total) >= F32(1000.0) * np.finfo(F32).tiny
    with np.errstate(divide="ignore"):
        inv_total = F32(1.0) / total
    weights = np.where(ok[:, None], raw * inv_total[:, None], F32(0))
    return np.where(inside, start, 0), weights.astype(F32)


def _resample_rows(x: np.ndarray, out_size: int) -> np.ndarray:
    """Axis 0 of float32 ``x`` resampled: each output row the sum of its
    span's rows times their weights, added in source order."""
    n = x.shape[0]
    starts, weights = resize_spans(n, out_size)
    shape = (out_size,) + (1,) * (x.ndim - 1)
    acc = np.zeros((out_size,) + x.shape[1:], F32)
    for j in range(weights.shape[1]):
        term = x[np.minimum(starts + j, n - 1)]
        term *= weights[:, j].reshape(shape)
        acc += term
    return acc


def resize_lanczos3(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """(H, W, C) -> float32 (size[0], size[1], C), as
    ``tf.image.resize(image, size, "lanczos3", antialias=True)``: the rows,
    then the columns (resampled as the rows of the transpose)."""
    x = _resample_rows(np.asarray(image).astype(F32), int(size[0]))
    x = np.ascontiguousarray(x.swapaxes(0, 1))
    return np.ascontiguousarray(_resample_rows(x, int(size[1])).swapaxes(0, 1))


def resize_image(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """uint8 -> lanczos3 (antialiased) -> round half to even, clip ->
    uint8."""
    out = np.round(resize_lanczos3(image, size))
    return np.clip(out, 0, 255).astype(np.uint8)


# --- decoding -----------------------------------------------------------
#
# tf.io.decode_image decodes a JPEG with libjpeg's fast integer IDCT and
# "fancy" (triangle-filter) chroma upsampling. PIL's decoder takes the fast
# IDCT only in its draft mode, which also turns fancy upsampling off; so
# the planes are decoded in draft mode as YCbCr, the chroma planes taken at
# their coded resolution, upsampled with libjpeg's fancy filters and
# converted to RGB with its fixed-point tables, here in numpy.

_SCALEBITS = 16
_ONE_HALF = 1 << (_SCALEBITS - 1)


def _fix(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


_CENTERED = np.arange(256, dtype=np.int64) - 128
_CR_R = (_fix(1.40200) * _CENTERED + _ONE_HALF) >> _SCALEBITS
_CB_B = (_fix(1.77200) * _CENTERED + _ONE_HALF) >> _SCALEBITS
_CR_G = -_fix(0.71414) * _CENTERED
_CB_G = -_fix(0.34414) * _CENTERED + _ONE_HALF


def _edge_shift(x: np.ndarray, axis: int, step: int) -> np.ndarray:
    """``x`` moved one sample along ``axis`` (+1: the previous sample,
    -1: the next), the edge sample repeated."""
    n = x.shape[axis]
    idx = np.clip(np.arange(n) - step, 0, n - 1)
    return np.take(x, idx, axis=axis)


def _fancy_h2v1(x: np.ndarray) -> np.ndarray:
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int64)
    out[:, 0::2] = (3 * x + _edge_shift(x, 1, 1) + 1) >> 2
    out[:, 1::2] = (3 * x + _edge_shift(x, 1, -1) + 2) >> 2
    out[:, 0], out[:, -1] = x[:, 0], x[:, -1]
    return out


def _fancy_h1v2(x: np.ndarray) -> np.ndarray:
    out = np.empty((2 * x.shape[0], x.shape[1]), np.int64)
    out[0::2] = (3 * x + _edge_shift(x, 0, 1) + 1) >> 2
    out[1::2] = (3 * x + _edge_shift(x, 0, -1) + 2) >> 2
    return out


def _fancy_h2v2(x: np.ndarray) -> np.ndarray:
    out = np.empty((2 * x.shape[0], 2 * x.shape[1]), np.int64)
    for row, step in ((0, 1), (1, -1)):  # the row above, then below
        cs = 3 * x + _edge_shift(x, 0, step)
        half = np.empty_like(out[0::2])
        half[:, 0::2] = (3 * cs + _edge_shift(cs, 1, 1) + 8) >> 4
        half[:, 1::2] = (3 * cs + _edge_shift(cs, 1, -1) + 7) >> 4
        half[:, 0] = (4 * cs[:, 0] + 8) >> 4
        half[:, -1] = (4 * cs[:, -1] + 7) >> 4
        out[row::2] = half
    return out


def _decode_jpeg(img) -> np.ndarray:
    """A PIL JPEG (mode "L" or YCbCr-coded "RGB") decoded as TF decodes
    it (see above)."""
    if img.mode == "L":
        img.draft("L", None)
        img.decoderconfig = (1, 1)  # scale 1, draft: the fast IDCT
        return np.asarray(img, np.uint8)[..., None]
    layers = img.layer
    h_max = max(l[1] for l in layers)
    v_max = max(l[2] for l in layers)
    img.draft("YCbCr", None)
    img.decoderconfig = (1, 1)
    ycc = np.asarray(img).astype(np.int64)
    height, width = ycc.shape[:2]
    planes = [ycc[..., 0]]
    for ci in (1, 2):
        hf, vf = h_max // layers[ci][1], v_max // layers[ci][2]
        p = ycc[::vf, ::hf, ci]  # the coded plane (draft replicates it)
        if (hf, vf) == (2, 2) and p.shape[1] > 2:
            p = _fancy_h2v2(p)
        elif (hf, vf) == (2, 1) and p.shape[1] > 2:
            p = _fancy_h2v1(p)
        elif (hf, vf) == (1, 2):
            p = _fancy_h1v2(p)
        else:
            p = np.repeat(np.repeat(p, vf, 0), hf, 1)
        planes.append(p[:height, :width])
    y, cb, cr = planes
    rgb = np.stack([y + _CR_R[cr],
                    y + ((_CB_G[cb] + _CR_G[cr]) >> _SCALEBITS),
                    y + _CB_B[cb]], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def decode_image(data: bytes) -> np.ndarray:
    """JPEG/PNG/GIF bytes -> uint8 (H, W, C) with the file's channels (the
    first frame of an animation), as ``tf.io.decode_image(...,
    expand_animations=False)`` gives them. PIL is imported here."""
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    if img.format == "JPEG" and (img.mode == "L" or (
            img.mode == "RGB" and len(getattr(img, "layer", ())) == 3)):
        return _decode_jpeg(img)
    img.seek(0)
    if img.mode == "1":
        img = img.convert("L")
    elif img.mode == "P":
        img = img.convert("RGBA" if "transparency" in img.info else "RGB")
    elif img.mode not in ("L", "LA", "RGB", "RGBA"):
        img = img.convert("RGB")
    arr = np.asarray(img, np.uint8)
    return arr[..., None] if arr.ndim == 2 else arr


def decode_and_resize(
    obs: Dict,
    resize_size: Union[Tuple[int, int], Dict[str, Tuple[int, int]]],
) -> Dict:
    image_names = {k[len("image_"):] for k in obs if k.startswith("image_")}
    if isinstance(resize_size, tuple):
        resize_size = {n: resize_size for n in image_names}
    for name in image_names:
        image = obs[f"image_{name}"]
        if isinstance(image, bytes):  # encoded; empty: a padding camera
            image = (np.zeros((*resize_size.get(name, (1, 1)), 3), np.uint8)
                     if len(image) == 0 else decode_image(image))
        if name in resize_size:
            image = resize_image(image, resize_size[name])
        obs[f"image_{name}"] = image
    return obs


# --- augmentation: apply functions (tf.image's arithmetic) --------------

def crop_and_resize(image: np.ndarray, y: int, x: int, h: int, w: int
                    ) -> np.ndarray:
    """float32 crop [y:y+h, x:x+w], resized back to the image's size by
    lanczos3 (``tf.image.crop_to_bounding_box`` then ``tf.image.resize``)."""
    crop = image[y:y + h, x:x + w]
    return resize_lanczos3(crop, image.shape[:2])


def adjust_brightness(image: np.ndarray, delta: float) -> np.ndarray:
    return (image + F32(delta)).astype(F32)


def _channel_means(image: np.ndarray) -> np.ndarray:
    """Per-channel mean as TF's AdjustContrastOpV2 sums it: the pixel rows
    folded in halves (the right half onto the left) until one remains,
    then times float32(1 / pixels)."""
    c = image.shape[-1]
    flat = image.reshape(-1, c).astype(F32)
    n = remaining = flat.shape[0]
    total, first = flat, True
    while True:
        right = remaining // 2
        left = remaining - right
        if first:
            folded = total[:left].copy()
            folded[:right] = total[left:left + right] + total[:right]
            total, first = folded, False
        else:
            total[:right] = total[:right] + total[left:left + right]
        remaining = left
        if remaining <= 1:
            break
    return total[0] * (F32(1.0) / F32(n))


def adjust_contrast(image: np.ndarray, factor: float) -> np.ndarray:
    """``mean + factor * (x - mean)`` per channel, in float32."""
    mean = _channel_means(image)
    return (mean + F32(factor) * (image - mean)).astype(F32)


def _rgb_to_hsv(r, g, b):
    vv = np.maximum(r, np.maximum(g, b))
    rng = vv - np.minimum(r, np.minimum(g, b))
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.where(vv > 0, rng / vv, F32(0))
        norm = F32(1.0) / (F32(6.0) * rng)
        # the two later branches add a double constant, then round to float
        hh = np.where(
            r == vv, norm * (g - b),
            np.where(g == vv,
                     (norm * (b - r)).astype(np.float64) + 2.0 / 6.0,
                     (norm * (r - g)).astype(np.float64) + 4.0 / 6.0)
        ).astype(F32)
    hh = np.where(rng <= 0, F32(0), hh)
    hh = np.where(hh < 0, hh + F32(1), hh)
    return hh.astype(F32), s.astype(F32), vv


def _hsv_to_rgb(h, s, v):
    c = s * v
    m = v - c
    dh = h * F32(6)
    cat = dh.astype(np.int64)
    fmodu = dh.copy()
    while (fmodu <= 0).any():
        fmodu = np.where(fmodu <= 0, fmodu + F32(2), fmodu)
    while (fmodu >= 2).any():
        fmodu = np.where(fmodu >= 2, fmodu - F32(2), fmodu)
    x = c * (F32(1) - np.abs(fmodu - F32(1)))
    zero = np.zeros_like(c)
    table = {0: (c, x, zero), 1: (x, c, zero), 2: (zero, c, x),
             3: (zero, x, c), 4: (x, zero, c), 5: (c, zero, x)}
    rr, gg, bb = zero, zero, zero
    for k, (tr, tg, tb) in table.items():
        sel = cat == k
        rr, gg, bb = (np.where(sel, tr, rr), np.where(sel, tg, gg),
                      np.where(sel, tb, bb))
    return rr + m, gg + m, bb + m


def adjust_saturation(image: np.ndarray, factor: float) -> np.ndarray:
    """RGB -> HSV, s scaled by ``factor`` and clamped to [0, 1], -> RGB
    (TF's AdjustSaturationOp, float32)."""
    r, g, b = (image[..., i].astype(F32) for i in range(3))
    h, s, v = _rgb_to_hsv(r, g, b)
    s = np.minimum(F32(1), np.maximum(F32(0), s * F32(factor)))
    return np.stack(_hsv_to_rgb(h, s, v), axis=-1).astype(F32)


def adjust_hue(image: np.ndarray, delta: float) -> np.ndarray:
    """Hue in [0, 6) from the channel order, shifted by ``6 * delta`` and
    wrapped, back to RGB with the same min and max (TF's AdjustHueOp,
    float32)."""
    r, g, b = (image[..., i].astype(F32) for i in range(3))
    rg = r < g
    vmax = np.where(rg, np.where(b < r, g, np.where(b > g, b, g)),
                    np.where(b < g, r, np.where(b > r, b, r)))
    vmid = np.where(rg, np.where(b < r, r, np.where(b > g, g, b)),
                    np.where(b < g, g, np.where(b > r, r, b)))
    vmin = np.where(rg, np.where(b < r, b, r),
                    np.where(b < g, b, g))
    cat = np.where(rg, np.where(b < r, 1, np.where(b > g, 3, 2)),
                   np.where(b < g, 0, np.where(b > r, 4, 5)))
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = (vmid - vmin) / (vmax - vmin)
    h = cat.astype(F32) + np.where(cat % 2 == 0, ratio, F32(1) - ratio)
    h = np.where(vmax == vmin, F32(0), h).astype(F32)
    h = h + F32(delta) * F32(6)
    while (h < 0).any():
        h = np.where(h < 0, h + F32(6), h)
    while (h >= 6).any():
        h = np.where(h >= 6, h - F32(6), h)
    hcat = h.astype(np.int64)
    hr = h - hcat.astype(F32)
    hr = np.where(hcat % 2 == 0, hr, F32(1) - hr)
    mid = vmin + hr * (vmax - vmin)
    table = {0: (vmax, mid, vmin), 1: (mid, vmax, vmin),
             2: (vmin, vmax, mid), 3: (vmin, mid, vmax),
             4: (mid, vmin, vmax)}
    rr, gg, bb = vmax, vmin, mid  # category 5 and the default
    for k, (tr, tg, tb) in table.items():
        sel = hcat == k
        rr, gg, bb = (np.where(sel, tr, rr), np.where(sel, tg, gg),
                      np.where(sel, tb, bb))
    return np.stack([rr, gg, bb], axis=-1).astype(F32)


# --- augmentation: draws ------------------------------------------------

def _uniform(seed: Sequence[int], lo: float, hi: float) -> F32:
    """One float32 draw from [lo, hi) of a generator seeded by ``seed``
    (``lo`` itself when the range is empty, as the JAX version's
    ``lo + 1e-9`` upper bound makes it)."""
    if not hi > lo:
        return F32(lo)
    return F32(np.random.default_rng([int(s) for s in seed]).uniform(lo, hi))


def draw_crop(seed: Sequence[int], shape: Tuple[int, int], scale, ratio
              ) -> Tuple[int, int, int, int]:
    """(y, x, h, w) of a random resized crop: area ``scale`` and aspect
    ``ratio`` drawn uniformly, the size rounded and capped at the image's,
    the corner uniform; in float32 as the JAX version computes them."""
    seed = np.asarray(seed, np.int64)
    s = _uniform(seed, scale[0], scale[1])
    r = _uniform(seed + 100, ratio[0], ratio[1])
    h, w = F32(shape[0]), F32(shape[1])
    ch = np.minimum(np.round(h * np.sqrt(s / r)), h)
    cw = np.minimum(np.round(w * np.sqrt(s * r)), w)
    y = _uniform(seed + 200, 0.0, max(float(h - ch), 1e-9))
    x = _uniform(seed + 300, 0.0, max(float(w - cw), 1e-9))
    return int(y), int(x), int(ch), int(cw)


def _augment_one(image: np.ndarray, seed: np.ndarray, **kwargs) -> np.ndarray:
    image = image.astype(F32) / F32(255.0)
    for i, op in enumerate(kwargs["augment_order"]):
        # the op index strided by 1000, the camera offsets being +1, +2
        op_seed = seed + 1000 * (i + 1)
        if op == "random_resized_crop":
            cfg = kwargs["random_resized_crop"]
            image = crop_and_resize(image, *draw_crop(
                op_seed, image.shape[:2], cfg["scale"], cfg["ratio"]))
        elif op == "random_brightness":
            d = kwargs["random_brightness"][0]
            image = adjust_brightness(image, _uniform(op_seed, -d, d))
        elif op == "random_contrast":
            lo, hi = kwargs["random_contrast"]
            image = adjust_contrast(image, _uniform(op_seed, lo, hi))
        elif op == "random_saturation":
            lo, hi = kwargs["random_saturation"]
            image = adjust_saturation(image, _uniform(op_seed, lo, hi))
        elif op == "random_hue":
            d = kwargs["random_hue"][0]
            image = adjust_hue(image, _uniform(op_seed, -d, d))
        else:
            raise ValueError(f"unknown augmentation {op!r}")
    image = np.clip(image, F32(0), F32(1))
    return np.round(image * F32(255.0)).astype(np.uint8)


def augment(obs: Dict, seed: Sequence[int], augment_kwargs: Dict) -> Dict:
    """The augmentations of ``augment_kwargs`` (one dict for every camera,
    or one per camera name) on each camera image that is not padding,
    camera i (in sorted order) seeded ``seed + i``."""
    seed = np.asarray(seed, np.int64)
    image_names = sorted(k[len("image_"):] for k in obs
                         if k.startswith("image_"))
    if "augment_order" in augment_kwargs:
        augment_kwargs = {n: augment_kwargs for n in image_names}
    for i, name in enumerate(image_names):
        if name not in augment_kwargs:
            continue
        if not bool(obs.get("pad_mask_dict", {}).get(f"image_{name}", True)):
            continue
        obs[f"image_{name}"] = _augment_one(obs[f"image_{name}"], seed + i,
                                            **augment_kwargs[name])
    return obs
