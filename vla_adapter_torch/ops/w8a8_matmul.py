"""W8A8 matmul: per-token activation quantization and the int8 product
with the rank-1 dequant in one hand-written CUDA kernel, and their plain
versions.

Counterpart of ``vla_adapter_tpu/ops/pallas_matmul.py``: ``w8a8_matmul``
(kernel B4) and ``w8a8_matmul_stacked`` (kernel B5), and of what the JAX
Dense computes around them, ``models/layers.py:_w8a8_fwd_math``
(``quantize_rows`` then the product). The function is

    xq, rs = quantize_rows(x)
    y = out_dtype(float32(xq @ W^T) * rs * col_scale)

with W int8 in the PyTorch ``(out, in)`` layout (N, K), the int32 product
exact, and the two float32 products taken in that order and rounded once.
``csrc/w8a8_matmul.cu`` computes it with ``mma.sync`` int8 tensor-core
products. :func:`w8a8_linear` gives it the float x and the kernel
quantizes the rows itself (what the models call on the card);
:func:`w8a8_matmul` and :func:`w8a8_matmul_stacked` keep the JAX B4/B5
signatures (xq and rs given) and run the same kernel with the quantization
step off. One kernel serves a flat weight (B4), one layer of a ``(L, N, K)``
stack (B5 as the JAX function has it), and the head's ``BatchedDense``,
where layer ``l`` of x meets layer ``l`` of the stack.

On a CPU tensor the wrappers return the plain versions
(:func:`w8a8_linear_reference`, :func:`w8a8_matmul_reference`); a CUDA
tensor always goes to the kernel, or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from vla_adapter_torch.ops import cuda_lib

KERNEL_NAME = "w8a8_matmul"
STACKED_KERNEL_NAME = "w8a8_matmul_stacked"
SOURCE = "w8a8_matmul.cu"
_OUT_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_X_DTYPES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
# The kernel's split over K at M <= 32 adds int32 partials into a scratch
# that it leaves zeroed, and its CTAs exchange their rows' slice maxima
# there: one per device, made (and zeroed) once at first use, outside any
# CUDA graph capture. Calls on one device run in stream order, so they
# share it.
_PART_CAP = 1 << 20   # int32 partials: layers * M * N
_COUNT_CAP = 1 << 14  # int32 counters and maxima: layers * (ceil(N / 64) + 64)
_SCRATCH: dict = {}


def quantize_rows(x: torch.Tensor):
    """Symmetric per-row int8 quantization over the last axis, bit for bit
    the JAX package's ``quantize_rows``: x float (..., K) -> (xq int8,
    row_scale float32 (..., 1)) with x ~ xq * row_scale. The scale is
    ``max(absmax, 1e-8) / 127`` (a division, as JAX and the CUDA kernels
    compute it), the rounding half to even."""
    xf = x.float()
    # 127 as a device tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which rounds some scales an ulp away
    d127 = torch.full((), 127.0, device=xf.device)
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / d127
    xq = torch.round(xf / scale).clamp_(-127, 127).to(torch.int8)
    return xq, scale


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The exact integer product a @ b^T of int8 (..., M, K) and (..., N, K)
    as a float32-convertible tensor: int32 on the CPU; float64 on the card,
    which has no int32 matmul (exact: |sum| <= 127^2 K < 2^53)."""
    if a.device.type == "cpu":
        return torch.matmul(a.int(), b.int().transpose(-1, -2))
    return torch.matmul(a.double(), b.double().transpose(-1, -2))


def w8a8_matmul_reference(xq, rs, w, ws, *, out_dtype=torch.bfloat16,
                          layer: Optional[int] = None) -> torch.Tensor:
    """Plain version. xq (M, K) int8 and rs (M, 1) f32 against w (N, K)
    int8 and ws (N,) f32; or against layer ``layer`` of w (L, N, K), ws
    (L, N); or xq (L, M, K), rs (L, M, 1) against every layer of the stack.
    Returns (M, N) or (L, M, N) in out_dtype."""
    if layer is not None:
        w, ws = w[layer], ws[layer]
    acc = int_matmul(xq, w).float()
    return (acc * rs * ws.float().unsqueeze(-2)).to(out_dtype)


def w8a8_linear_reference(x, w, ws, *, out_dtype=torch.bfloat16,
                          layer: Optional[int] = None) -> torch.Tensor:
    """Plain version of :func:`w8a8_linear`: :func:`quantize_rows` then
    :func:`w8a8_matmul_reference`."""
    xq, rs = quantize_rows(x)
    return w8a8_matmul_reference(xq, rs, w, ws, out_dtype=out_dtype,
                                 layer=layer)


def _lib() -> ctypes.CDLL:
    lib = cuda_lib.load_library(SOURCE)
    fn = lib.vla_w8a8_matmul
    if not fn.argtypes:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, ll, ll, ll, ll, ll, i,
                       i, p, p, ll, ll, p]
        fn.restype = ctypes.c_int
    return lib


def _scratch(device: torch.device):
    """The device's split-K scratch (partials, counters), zeroed once."""
    key = device.index if device.index is not None \
        else torch.cuda.current_device()
    if key not in _SCRATCH:
        _SCRATCH[key] = (
            torch.zeros(_PART_CAP, dtype=torch.int32, device=device),
            torch.zeros(_COUNT_CAP, dtype=torch.int32, device=device))
    return _SCRATCH[key]


def _launch(name, x, rs, w, ws, out_dtype, layer0: int,
            batched: bool) -> torch.Tensor:
    """One launch: x (M, K) against weight layer ``layer0`` or, batched,
    x (L, M, K) row block z against weight layer z for every z. x is int8
    with its row scales rs, or float (rs None) and quantized inside."""
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"{name}: out_dtype {out_dtype} not in "
                        f"{list(_OUT_DTYPES)}")
    if (x.dtype not in _X_DTYPES or (x.dtype == torch.int8) != (rs is not None)
            or w.dtype != torch.int8):
        raise TypeError(f"{name}: x {x.dtype} (int8 with row scales, or "
                        f"bf16/f32) and w {w.dtype} (int8)")
    m, k = x.shape[-2:]
    n = w.shape[-2]
    if w.shape[-1] != k or k % 16 or n % 2:
        raise ValueError(f"{name}: K={k} (weight {tuple(w.shape)}) must "
                         f"match and be a multiple of 16, N={n} even")
    for t in (x, rs, w, ws):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name}: operands on {t.device} and "
                             f"{x.device}")
    layers = w.shape[0] if batched else 1
    if m <= 32 and k > 512 and layers * m * n > _PART_CAP:
        raise ValueError(f"{name}: {layers} x {m} x {n} int32 partials "
                         f"exceed the split-K scratch ({_PART_CAP})")
    x, w = x.contiguous(), w.contiguous()
    if rs is not None:
        rs = rs.float().contiguous()
    ws = ws.float().contiguous()
    out = torch.empty((layers, m, n) if batched else (m, n),
                      dtype=out_dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        part, count = _scratch(x.device)
        err = lib.vla_w8a8_matmul(
            x.data_ptr(), None if rs is None else rs.data_ptr(),
            w.data_ptr(), ws.data_ptr(), out.data_ptr(), m, n, k, layer0,
            layers, m * k * batched, m * batched, n * k, n, m * n * batched,
            _X_DTYPES[x.dtype], _OUT_DTYPES[out_dtype], part.data_ptr(),
            count.data_ptr(), _PART_CAP, _COUNT_CAP,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {err})")
    cuda_lib.count_launch(name)
    return out


def _check_device(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")


def w8a8_matmul(xq: torch.Tensor, rs: torch.Tensor, w: torch.Tensor,
                ws: torch.Tensor, *, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Kernel B4. xq (M, K) int8, rs (M, 1) f32, w (N, K) int8 in the
    ``(out, in)`` layout, ws (N,) f32 -> (M, N) out_dtype (bf16 or f32).
    K % 16 == 0, N even."""
    if xq.device.type == "cpu":
        return w8a8_matmul_reference(xq, rs, w, ws, out_dtype=out_dtype)
    _check_device(KERNEL_NAME, xq)
    if xq.dim() != 2 or w.dim() != 2 or rs.shape != (xq.shape[0], 1) \
            or ws.shape != (w.shape[0],):
        raise ValueError(f"{KERNEL_NAME}: shapes xq {tuple(xq.shape)} rs "
                         f"{tuple(rs.shape)} w {tuple(w.shape)} ws "
                         f"{tuple(ws.shape)}")
    return _launch(KERNEL_NAME, xq, rs, w, ws, out_dtype, 0, False)


def w8a8_matmul_stacked(xq: torch.Tensor, rs: torch.Tensor, w: torch.Tensor,
                        ws: torch.Tensor, *, layer: Optional[int] = None,
                        out_dtype=torch.bfloat16) -> torch.Tensor:
    """Kernel B5 against a stack w (L, N, K) int8, ws (L, N) f32.

    With ``layer``: xq (M, K), rs (M, 1) against that layer -> (M, N), as
    the JAX ``w8a8_matmul_stacked``. Without: xq (L, M, K), rs (L, M, 1),
    row block l against layer l, all layers in one launch -> (L, M, N) (the
    head's ``BatchedDense``)."""
    if xq.device.type == "cpu":
        return w8a8_matmul_reference(xq, rs, w, ws, out_dtype=out_dtype,
                                     layer=layer)
    _check_device(STACKED_KERNEL_NAME, xq)
    num_l, n, _ = w.shape
    if ws.shape != (num_l, n):
        raise ValueError(f"{STACKED_KERNEL_NAME}: ws {tuple(ws.shape)} for "
                         f"w {tuple(w.shape)}")
    if layer is not None:
        if xq.dim() != 2 or rs.shape != (xq.shape[0], 1) \
                or not 0 <= layer < num_l:
            raise ValueError(f"{STACKED_KERNEL_NAME}: xq {tuple(xq.shape)} "
                             f"rs {tuple(rs.shape)} layer {layer} of {num_l}")
        return _launch(STACKED_KERNEL_NAME, xq, rs, w, ws, out_dtype,
                       int(layer), False)
    if xq.dim() != 3 or xq.shape[0] != num_l \
            or rs.shape != (num_l, xq.shape[1], 1):
        raise ValueError(f"{STACKED_KERNEL_NAME}: xq {tuple(xq.shape)} rs "
                         f"{tuple(rs.shape)} for {num_l} layers")
    return _launch(STACKED_KERNEL_NAME, xq, rs, w, ws, out_dtype, 0, True)


def w8a8_linear(x: torch.Tensor, w: torch.Tensor, ws: torch.Tensor, *,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """The w8a8 product from the float activations, the JAX Dense's
    ``_w8a8_fwd_math``: ``quantize_rows(x)`` and kernel B4 in one launch.

    x (M, K) bf16 or f32 against w (N, K) int8, ws (N,) f32 -> (M, N)
    (launches counted as ``w8a8_matmul``); or x (L, M, K) against a stack
    w (L, N, K), ws (L, N), row block l against layer l -> (L, M, N)
    (counted as ``w8a8_matmul_stacked``). K % 16 == 0, N even."""
    if x.device.type == "cpu":
        return w8a8_linear_reference(x, w, ws, out_dtype=out_dtype)
    stacked = x.dim() == 3
    name = STACKED_KERNEL_NAME if stacked else KERNEL_NAME
    _check_device(name, x)
    if x.dim() not in (2, 3) or w.dim() != x.dim() \
            or ws.shape != w.shape[:-1] \
            or (stacked and x.shape[0] != w.shape[0]):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)} w "
                         f"{tuple(w.shape)} ws {tuple(ws.shape)}")
    return _launch(name, x, None, w, ws, out_dtype, 0, stacked)
