"""w8a8 comparisons across the two packages that allow one int8 rounding
flip, and only where it is shown.

Both packages quantize each activation row as round(x / scale) half to
even. Their fp32 activations agree to a few ulps, so an element whose x /
scale lies that close to a half level can round one way in one package and
the other way in the other; one int8 level of one token then moves that
request's actions by a visible amount downstream. :func:`assert_close_up_to_one_flip`
accepts such a difference only when it reproduces it: the port run again
with one near-tie rounding taken the other way must agree with the
reference in every request within the tolerance. A port that is wrong
anywhere else cannot pass.

All the port's CPU activation quantizations go through
``ops/w8a8_matmul.py:quantize_rows`` (the plain w8a8 matmul, the plain
fused MLPs, the plain megalayer), which is where the flip is made. Both
packages quantize one input once per consumer (the q, k and v projections
of a layer's normed input each quantize it): a flip of that input is a
flip in every consumer, so calls that repeat the input just before them
count as one quantization and flip together.
"""

import contextlib
import itertools

import numpy as np

from vla_adapter_torch.ops import fused_mlp, megalayer, w8a8_matmul

_MODULES = (w8a8_matmul, fused_mlp, megalayer)
_QUANTIZE = w8a8_matmul.quantize_rows
# An element that rounds the other way across packages lies within this
# fraction of an int8 level of a half level (fp32 activations a few ulps
# apart, times up to 127 levels: ~1e-4).
MAX_TIE = 1e-3


@contextlib.contextmanager
def _quantize_with(fn):
    saved = [m.quantize_rows for m in _MODULES]
    for m in _MODULES:
        m.quantize_rows = fn
    try:
        yield
    finally:
        for m, f in zip(_MODULES, saved):
            m.quantize_rows = f


def _same(x, y):
    return y is not None and x.shape == y.shape and bool((x == y).all())


def _ties(x, scale):
    """Each element's distance from a half level, in int8 levels."""
    t = (x.float() / scale).abs()
    return (t - t.floor() - 0.5).abs()


def near_ties(run, count: int):
    """The ``count`` activation elements nearest a half level over one
    ``run()``: [(distance in levels, quantization call, flat index)]."""
    found = []
    calls = itertools.count()
    last = [None]

    def recording(x):
        xq, scale = _QUANTIZE(x)
        call = next(calls)
        if last[0] is None or not _same(x, last[0]):
            d = _ties(x, scale).flatten()
            vals, idx = d.topk(min(count, d.numel()), largest=False)
            found.extend((float(v), call, int(i))
                         for v, i in zip(vals.tolist(), idx.tolist()))
        last[0] = x.detach().clone()
        return xq, scale

    with _quantize_with(recording):
        run()
    return sorted(found)[:count]


@contextlib.contextmanager
def flipped(call: int, index: int):
    """The port's activation quantization with element ``index`` of the
    ``call``-th quantization rounded to the other side of its half level,
    there and in the calls right after it that quantize the same input."""
    calls = itertools.count()
    target = [None]

    def flipping(x):
        xq, scale = _QUANTIZE(x)
        n = next(calls)
        if n == call:
            target[0] = x.detach().clone()
        elif not _same(x, target[0]):
            target[0] = None
        if target[0] is not None:
            k = x.shape[-1]
            t = float(x.reshape(-1)[index].float()
                      / scale.reshape(-1)[index // k])
            q = xq.reshape(-1).clone()
            q[index] += 1 if t > int(q[index]) else -1
            xq = q.view_as(xq)
        return xq, scale

    with _quantize_with(flipping):
        yield


def _off(got, want, atol, rtol):
    """Requests (leading axis) with an element outside atol + rtol|want|."""
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want) - (atol + rtol * np.abs(want))
    return (err > 0).reshape(len(got), -1).any(-1)


def assert_close_up_to_one_flip(run, want, atol, rtol=0.0, tries=8):
    """``run()`` (the port, actions with requests on the leading axis)
    within atol/rtol of ``want`` in every request, or else equal to it so
    after one activation rounding that lay within MAX_TIE of a half level
    is taken the other way. Returns the flip made, (call, index), or None."""
    got = run()
    off = _off(got, want, atol, rtol)
    if not off.any():
        return None
    assert off.sum() == 1, ("more than one request off", off)
    for dist, call, index in near_ties(run, tries):
        assert dist < MAX_TIE, (
            "no rounding within MAX_TIE of a half level reproduces the "
            "reference", dist, np.abs(np.asarray(got) - want).max())
        with flipped(call, index):
            if not _off(run(), want, atol, rtol).any():
                return call, index
    raise AssertionError(("no single rounding flip reproduces the "
                          "reference", off))
