"""W8A8 matmul: per-token activation quantization, the hand-written CUDA
kernel for the int8 product, and its plain version.

Counterpart of ``vla_adapter_tpu/ops/pallas_matmul.py``: ``w8a8_matmul``
(kernel B4) and ``w8a8_matmul_stacked`` (kernel B5), and of the JAX
package's ``models/layers.py:quantize_rows``. The function is

    y = out_dtype(float32(xq @ W^T) * row_scale * col_scale)

with xq int8 (M, K), W int8 in the PyTorch ``(out, in)`` layout (N, K), the
int32 product exact, and the two float32 products taken in that order and
rounded once. ``csrc/w8a8_matmul.cu`` computes it with ``mma.sync`` int8
tensor-core products; one kernel serves a flat weight (B4), one layer of a
``(L, N, K)`` stack (B5 as the JAX function has it), and the head's
``BatchedDense``, where layer ``l`` of x meets layer ``l`` of the stack.

:func:`quantize_rows` (the activation quantization before the product)
stays plain PyTorch, as XLA computes it outside the Pallas kernel in JAX.

On a CPU tensor the wrappers return :func:`w8a8_matmul_reference`; a CUDA
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


def _lib() -> ctypes.CDLL:
    lib = cuda_lib.load_library(SOURCE)
    fn = lib.vla_w8a8_matmul
    if not fn.argtypes:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, ll, ll, ll, ll, ll, i, p]
        fn.restype = ctypes.c_int
    return lib


def _launch(name, xq, rs, w, ws, out_dtype, layer0: int,
            batched: bool) -> torch.Tensor:
    """One launch: xq (M, K) against weight layer ``layer0`` or, batched,
    xq (L, M, K) row block z against weight layer z for every z."""
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"{name}: out_dtype {out_dtype} not in "
                        f"{list(_OUT_DTYPES)}")
    if xq.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"{name}: xq and w must be int8, got {xq.dtype}, "
                        f"{w.dtype}")
    m, k = xq.shape[-2:]
    n = w.shape[-2]
    if w.shape[-1] != k or k % 16 or n % 2:
        raise ValueError(f"{name}: K={k} (weight {tuple(w.shape)}) must "
                         f"match and be a multiple of 16, N={n} even")
    for t in (xq, rs, w, ws):
        if t.device != xq.device:
            raise ValueError(f"{name}: operands on {t.device} and "
                             f"{xq.device}")
    xq, w = xq.contiguous(), w.contiguous()
    rs = rs.float().contiguous()
    ws = ws.float().contiguous()
    layers = w.shape[0] if batched else 1
    out = torch.empty((layers, m, n) if batched else (m, n),
                      dtype=out_dtype, device=xq.device)
    lib = _lib()
    with torch.cuda.device(xq.device):
        err = lib.vla_w8a8_matmul(
            xq.data_ptr(), rs.data_ptr(), w.data_ptr(), ws.data_ptr(),
            out.data_ptr(), m, n, k, layer0, layers,
            m * k * batched, m * batched, n * k, n, m * n * batched,
            _OUT_DTYPES[out_dtype],
            torch.cuda.current_stream(xq.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {err})")
    cuda_lib.LAUNCHES[name] += 1
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
