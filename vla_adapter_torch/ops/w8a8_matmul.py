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
``csrc/w8a8_matmul.cu`` computes it on the int8 tensor cores, by the
branch :func:`w8a8_plan` picks per shape: above 32 rows "hopper", 128 x
128 tiles of ``wgmma`` fed by TMA through an mbarrier ring (float x first
quantized per row by a pre-pass kernel, a launch of its own counted as
``w8a8_quantize``); up to 32 rows "narrow", ``mma.sync`` with the weight
on the tile's wide side and K split over CTAs. :func:`w8a8_linear` gives
the kernel the float x (what the models call on the card);
:func:`w8a8_matmul` and :func:`w8a8_matmul_stacked` keep the JAX B4/B5
signatures (xq and rs given) and skip the quantization. One kernel serves
a flat weight (B4), one layer of a ``(L, N, K)`` stack (B5 as the JAX
function has it), the head's ``BatchedDense``, where layer ``l`` of x
meets layer ``l`` of the stack, and one x against every layer.

On a CPU tensor the wrappers return the plain versions
(:func:`w8a8_linear_reference`, :func:`w8a8_matmul_reference`); a CUDA
tensor always goes to the kernel, or raises.

Split K (the "tensor" mesh axis, ``parallel/tensor.py``): the xq entry
with ``out_dtype=torch.int32`` writes the int32 accumulator with no
dequant (launches counted as ``w8a8_matmul_int32``), so the ranks' partial
products over their slices of K add exactly before one dequant. The
kernel reads 16-byte rows, so a K that is not a multiple of 16 is
zero-padded: the weight once (:func:`pad_k`), x as it is quantized
(:func:`quantize_to`, against row scales that may come from the whole K).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from vla_adapter_torch.ops import cuda_lib

KERNEL_NAME = "w8a8_matmul"
STACKED_KERNEL_NAME = "w8a8_matmul_stacked"
INT32_KERNEL_NAME = "w8a8_matmul_int32"
# the Hopper branch's quantization pre-pass on float x (a launch of its own)
QUANT_KERNEL_NAME = "w8a8_quantize"
SOURCE = "w8a8_matmul.cu"
_OUT_DTYPES = {torch.bfloat16: 0, torch.float32: 1, torch.int32: 2}
_X_DTYPES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
_DTYPE_NAMES = {torch.int8: "int8", torch.bfloat16: "bf16",
                torch.float32: "f32", torch.int32: "int32"}
# The kernel's split over K at M <= 32 adds int32 partials into a scratch
# that it leaves zeroed, and its CTAs exchange their rows' slice maxima
# there: one per device, made (and zeroed) once at first use, outside any
# CUDA graph capture. Calls on one device run in stream order, so they
# share it.
_PART_CAP = 1 << 20   # int32 partials: layers * M * N
_COUNT_CAP = 1 << 14  # int32 counters and maxima: layers * (ceil(N / 64) + 64)
_SCRATCH: dict = {}

# The plan (:func:`w8a8_plan`). SMS: an H100 SXM's, the default where no
# card is asked. MAX_SMEM: the shared memory a block may use.
SMS = 132
MAX_SMEM = 232448
# Above 32 rows every call takes the Hopper branch (TMA + wgmma): it was
# faster than the mma.sync design it replaced at every shape timed
# (csrc/w8a8_matmul.cu's header).
HOPPER_ROWS = 128        # rows of x per tile (two warpgroups of 64)
HOPPER_COLS = 128        # columns of W per tile
HOPPER_STEP = 128        # bytes of K per ring stage
HOPPER_GROUP = 8         # row tiles walked together (L2 reuse)
# The narrow kernel's variants, (n8 tiles of rows, 64-byte k steps a
# slice), and the CTAs of each resident on one SM while it quantizes: the
# least an H100 gave for bf16 or f32 x (vla_w8a8_narrow_per_sm); on the
# card the wrapper asks the card (card_plan).
NARROW_VARIANTS = ((1, 16), (1, 8), (2, 8), (4, 8))
NARROW_PER_SM = (2, 3, 2, 2)
_BRANCH_CODES = {"narrow": 0, "hopper": 1}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _narrow_variant(m: int, k: int) -> tuple:
    if m <= 8:
        return (1, 16) if k <= 1024 else (1, 8)
    return (2, 8) if m <= 16 else (4, 8)


def _hopper_plan(m: int, n: int, k: int, layers: int, x_dtype,
                 sms: int) -> dict:
    """The Hopper branch: 128 x 128 tiles, as many ring stages as shared
    memory holds, a persistent grid of at most one CTA per SM; float x
    quantized by a pre-pass first."""
    tiles = _cdiv(m, HOPPER_ROWS) * _cdiv(n, HOPPER_COLS) * layers
    stage = (HOPPER_ROWS + HOPPER_COLS) * HOPPER_STEP
    stages = (MAX_SMEM - 1024) // (stage + 16)
    ctas = min(tiles, sms)
    return {"branch": "hopper", "block_m": HOPPER_ROWS,
            "block_n": HOPPER_COLS, "stages": stages, "group": HOPPER_GROUP,
            "tiles": tiles, "ctas": ctas, "waves": tiles / ctas,
            "smem_bytes": 1024 + stages * (stage + 16),
            "prepass": x_dtype != torch.int8}


@functools.lru_cache(maxsize=None)
def w8a8_plan(m: int, n: int, k: int, layers: int = 1,
              x_dtype=torch.bfloat16, out_dtype=torch.bfloat16,
              sms: int = SMS, narrow_per_sm: tuple = NARROW_PER_SM, *,
              branch: Optional[str] = None) -> dict:
    """How ``csrc/w8a8_matmul.cu`` runs one call (cached per shape: do not
    modify the result): x (layers or 1, M, K) of ``x_dtype`` (int8 with
    row scales, or bf16/f32 quantized inside) against ``layers`` weight
    layers (N, K), out in ``out_dtype``, on ``sms`` SMs.

    * "narrow" (M <= 32): mma.sync with the weight on the tile's 16-row
      side, K split over CTAs (``splits``). A quantizing split over more
      than two slices needs all its CTAs resident (``narrow_per_sm`` per
      SM, by variant of NARROW_VARIANTS); one that would not be (Phi-2's
      lm_head at M = 1) takes the Hopper branch.
    * "hopper": TMA + wgmma (:func:`_hopper_plan`), every other call;
      ``prepass``: float x goes through the quantization pre-pass first (a
      launch counted as QUANT_KERNEL_NAME).

    ``branch`` forces one (to time the branches against each other).
    Raises on a shape the kernels do not take: K % 16, an odd N, an int32
    output from float x."""
    if min(m, n, k, layers) < 1 or k % 16 or n % 2:
        raise ValueError(f"w8a8_plan: (M, N, K, layers) = {(m, n, k, layers)}"
                         f"; K must be a multiple of 16, N even")
    if x_dtype not in _X_DTYPES or out_dtype not in _OUT_DTYPES or (
            out_dtype == torch.int32 and x_dtype != torch.int8):
        raise TypeError(f"w8a8_plan: x {x_dtype}, out {out_dtype}")
    if branch not in (None, "narrow", "hopper"):
        raise ValueError(f"w8a8_plan: branch {branch!r}")
    base = {"m": m, "n": n, "k": k, "layers": layers,
            "x_dtype": _DTYPE_NAMES[x_dtype],
            "out_dtype": _DTYPE_NAMES[out_dtype]}
    if branch == "narrow" or (branch is None and m <= 32):
        tiles, steps = _narrow_variant(m, k)
        splits = _cdiv(_cdiv(k, 64), steps)
        ctas = _cdiv(n, 64) * splits
        per_sm = narrow_per_sm[NARROW_VARIANTS.index((tiles, steps))]
        if (branch == "narrow" or x_dtype == torch.int8 or splits <= 2
                or ctas <= per_sm * sms):
            slice_ = min(_cdiv(k, 64), steps) * 64
            return {**base, "branch": "narrow", "tiles": tiles,
                    "steps": steps, "splits": splits, "ctas": ctas * layers,
                    "smem_bytes": 8 * tiles * (slice_ + 16)
                    + (16 * tiles + 1) * 4, "prepass": False}
    return {**base, **_hopper_plan(m, n, k, layers, x_dtype, sms)}


def plan_codes(plan: dict) -> tuple:
    """The plan as the C entry point reads it (``Branch`` in the source)."""
    b = plan["branch"]
    if b == "narrow":
        rest = (plan["tiles"], plan["steps"])
    else:
        rest = (plan["block_n"], plan["stages"], plan["group"], plan["ctas"])
    return (_BRANCH_CODES[b], *rest) + (0,) * (7 - len(rest))


def plan_launches(plan: dict, name: str) -> dict:
    """Kernel launches of one call of ``plan`` counted as ``name``: the
    product, and the pre-pass where the plan has one."""
    return {QUANT_KERNEL_NAME: 1, name: 1} if plan["prepass"] else {name: 1}


def quantize_rows(x: torch.Tensor):
    """Symmetric per-row int8 quantization over the last axis, bit for bit
    the JAX package's ``quantize_rows``: x float (..., K) -> (xq int8,
    row_scale float32 (..., 1)) with x ~ xq * row_scale. The scale is
    ``max(absmax, 1e-8) / 127`` (a division, as JAX and the CUDA kernels
    compute it), the rounding half to even."""
    scale = row_scale(x.float().abs().amax(dim=-1, keepdim=True))
    return quantize_to(x, scale), scale


def row_scale(absmax: torch.Tensor) -> torch.Tensor:
    """The int8 row scale of a row's absmax: ``max(absmax, 1e-8) / 127``."""
    # 127 as a device tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which rounds some scales an ulp away
    d127 = torch.full((), 127.0, device=absmax.device)
    return absmax.float().clamp_min(1e-8) / d127


def padded_k(k: int) -> int:
    """The K the kernel reads: ``k`` rounded up to a multiple of 16."""
    return -(-k // 16) * 16


def pad_k(w: torch.Tensor) -> torch.Tensor:
    """``w`` (..., K) zero-padded to (..., :func:`padded_k` (K)); ``w``
    itself (contiguous) when K is a multiple of 16."""
    k = w.shape[-1]
    if padded_k(k) == k:
        return w.contiguous()
    return torch.nn.functional.pad(w, (0, padded_k(k) - k))


def quantize_to(x: torch.Tensor, scale: torch.Tensor,
                width: Optional[int] = None) -> torch.Tensor:
    """x float (..., K) quantized against the row scales ``scale`` (...,
    1): ``clip(round_half_even(x / scale), -127, 127)`` as int8 (...,
    width), zeros past K (``width`` >= K; default K)."""
    x = x.float()
    if width is not None and width != x.shape[-1]:
        x = torch.nn.functional.pad(x, (0, width - x.shape[-1]))  # 0 / s
    return torch.round(x / scale).clamp_(-127, 127).to(torch.int8)


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
    Returns (M, N) or (L, M, N) in out_dtype; with out_dtype int32 the
    exact product itself (rs and ws unread, may be None)."""
    if layer is not None:
        w = w[layer]
    if out_dtype == torch.int32:
        return int_matmul(xq, w).to(torch.int32)
    if layer is not None:
        ws = ws[layer]
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
                       i, p, p, ll, ll, ctypes.POINTER(ctypes.c_int), p, p,
                       p]
        fn.restype = ctypes.c_int
        lib.vla_w8a8_narrow_per_sm.argtypes = [i, i, i, i]
        lib.vla_w8a8_narrow_per_sm.restype = ctypes.c_int
        lib.vla_w8a8_map_encode_ns.argtypes = [p, i, i, i, i]
        lib.vla_w8a8_map_encode_ns.restype = ctypes.c_double
        lib.vla_w8a8_quantize.argtypes = [p, p, p, ll, i, i, p]
        lib.vla_w8a8_quantize.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def narrow_occupancy(x_dtype, out_dtype) -> tuple:
    """The card's CTAs of each narrow variant (NARROW_VARIANTS) resident
    on one SM while quantizing x of ``x_dtype`` into ``out_dtype``."""
    lib = _lib()
    return tuple(lib.vla_w8a8_narrow_per_sm(
        t, s, _X_DTYPES[x_dtype], _OUT_DTYPES[out_dtype])
        for t, s in NARROW_VARIANTS)


def card_plan(m: int, n: int, k: int, layers: int, x_dtype, out_dtype,
              device) -> dict:
    """:func:`w8a8_plan` for the card ``device``: its SMs and, quantizing,
    its narrow occupancy."""
    per_sm = (narrow_occupancy(x_dtype, out_dtype)
              if x_dtype != torch.int8 and m <= 32 else NARROW_PER_SM)
    return w8a8_plan(m, n, k, layers, x_dtype, out_dtype,
                     cuda_lib.sm_count(device), per_sm)


def map_encode_ns(m: int, n: int, k: int, reps: int = 10000) -> float:
    """Host ns to encode the Hopper branch's two tensor maps of an (M, K)
    x and an (N, K) weight: what each launch of that branch adds."""
    dummy = torch.empty(16, dtype=torch.uint8, device="cuda")
    return _lib().vla_w8a8_map_encode_ns(dummy.data_ptr(), m, n, k, reps)


def w8a8_quantize(x: torch.Tensor):
    """The Hopper branch's quantization pre-pass alone (what
    :func:`w8a8_linear` launches before that branch's product): x (..., K)
    bf16 or f32 -> (xq int8 (..., K), row scales f32 (..., 1)), bit for bit
    :func:`quantize_rows` (its plain version, which a CPU tensor gets).
    K % 16 == 0. Launches counted as QUANT_KERNEL_NAME."""
    if x.device.type == "cpu":
        return quantize_rows(x)
    _check_device(QUANT_KERNEL_NAME, x)
    if x.dtype not in (torch.bfloat16, torch.float32) or x.shape[-1] % 16:
        raise ValueError(f"{QUANT_KERNEL_NAME}: x {x.dtype} "
                         f"{tuple(x.shape)}: bf16 or f32, K % 16 == 0")
    x = x.contiguous()
    k = x.shape[-1]
    rows = x.numel() // k
    xq = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    rs = torch.empty((*x.shape[:-1], 1), dtype=torch.float32,
                     device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().vla_w8a8_quantize(
            x.data_ptr(), xq.data_ptr(), rs.data_ptr(), rows, k,
            _X_DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{QUANT_KERNEL_NAME}: x {tuple(x.shape)} "
                           f"{x.dtype}: the kernel was refused (cudaError "
                           f"{err})")
    cuda_lib.count_launch(QUANT_KERNEL_NAME)
    return xq, rs


def _scratch(device: torch.device):
    """The device's split-K scratch (partials, counters), zeroed once."""
    key = device.index if device.index is not None \
        else torch.cuda.current_device()
    if key not in _SCRATCH:
        _SCRATCH[key] = (
            torch.zeros(_PART_CAP, dtype=torch.int32, device=device),
            torch.zeros(_COUNT_CAP, dtype=torch.int32, device=device))
    return _SCRATCH[key]


def _launch(name, x, rs, w, ws, out_dtype, layer0: int, layers: int,
            plan: Optional[dict] = None) -> torch.Tensor:
    """One call: x (M, K) against weight layer ``layer0`` (``layers`` 1),
    or against each of ``layers`` weight layers from ``layer0`` (shared
    x), or x (layers, M, K) row block z against weight layer z. x is int8
    with its row scales rs, or float (rs None) and quantized inside. The
    branch is :func:`card_plan`'s unless ``plan`` is given (to time one
    branch against another). Raises where the kernel refuses: nothing
    falls back to another branch."""
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"{name}: out_dtype {out_dtype} not in "
                        f"{list(_OUT_DTYPES)}")
    raw = out_dtype == torch.int32
    if (x.dtype not in _X_DTYPES or w.dtype != torch.int8
            or (raw and x.dtype != torch.int8)
            or (not raw and (x.dtype == torch.int8) != (rs is not None))):
        raise TypeError(f"{name}: x {x.dtype} (int8 with row scales, or "
                        f"bf16/f32; int8 for an int32 output) and w "
                        f"{w.dtype} (int8)")
    if raw:
        rs = ws = None
    m, k = x.shape[-2:]
    n = w.shape[-2]
    if w.shape[-1] != k or k % 16 or n % 2:
        raise ValueError(f"{name}: K={k} (weight {tuple(w.shape)}) must "
                         f"match and be a multiple of 16, N={n} even")
    for t in (x, rs, w, ws):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name}: operands on {t.device} and "
                             f"{x.device}")
    per_layer = x.dim() == 3
    if plan is None:
        plan = card_plan(m, n, k, layers, x.dtype, out_dtype, x.device)
    if (plan["branch"] == "narrow" and plan["splits"] > 1
            and layers * m * n > _PART_CAP):
        raise ValueError(f"{name}: {layers} x {m} x {n} int32 partials "
                         f"exceed the split-K scratch ({_PART_CAP})")
    x, w = x.contiguous(), w.contiguous()
    if rs is not None:
        rs = rs.float().contiguous()
    if ws is not None:
        ws = ws.float().contiguous()
    out = torch.empty((layers, m, n) if layers > 1 or per_layer else (m, n),
                      dtype=out_dtype, device=x.device)
    xq_buf = rs_buf = None
    if plan["prepass"]:
        rows = (layers if per_layer else 1) * m
        xq_buf = torch.empty((rows, k), dtype=torch.int8, device=x.device)
        rs_buf = torch.empty(rows, dtype=torch.float32, device=x.device)
    codes = (ctypes.c_int * 8)(*plan_codes(plan))
    lib = _lib()
    with torch.cuda.device(x.device):
        part, count = _scratch(x.device)
        err = lib.vla_w8a8_matmul(
            x.data_ptr(), None if rs is None else rs.data_ptr(),
            w.data_ptr(), None if ws is None else ws.data_ptr(),
            out.data_ptr(), m, n, k, layer0, layers, m * k * per_layer,
            m * per_layer, n * k, n, m * n, _X_DTYPES[x.dtype],
            _OUT_DTYPES[out_dtype], part.data_ptr(), count.data_ptr(),
            _PART_CAP, _COUNT_CAP, codes,
            None if xq_buf is None else xq_buf.data_ptr(),
            None if rs_buf is None else rs_buf.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{name}: (M, N, K) = ({m}, {n}, {k}) x {layers} layers, "
            f"x {x.dtype}, out {out_dtype}, plan {plan}: the kernel was "
            f"refused (cudaError {err})")
    for kernel in plan_launches(plan, INT32_KERNEL_NAME if raw else name):
        cuda_lib.count_launch(kernel)
    return out


def _check_device(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")


def w8a8_matmul(xq: torch.Tensor, rs: Optional[torch.Tensor],
                w: torch.Tensor, ws: Optional[torch.Tensor], *,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """Kernel B4. xq (M, K) int8, rs (M, 1) f32, w (N, K) int8 in the
    ``(out, in)`` layout, ws (N,) f32 -> (M, N) out_dtype (bf16 or f32);
    or, out_dtype int32, the exact int32 product xq @ w^T (rs and ws
    unread, may be None). K % 16 == 0 (:func:`pad_k`), N even."""
    if xq.device.type == "cpu":
        return w8a8_matmul_reference(xq, rs, w, ws, out_dtype=out_dtype)
    _check_device(KERNEL_NAME, xq)
    raw = out_dtype == torch.int32
    if xq.dim() != 2 or w.dim() != 2 \
            or (not raw and (rs.shape != (xq.shape[0], 1)
                             or ws.shape != (w.shape[0],))):
        raise ValueError(f"{KERNEL_NAME}: shapes xq {tuple(xq.shape)} w "
                         f"{tuple(w.shape)}, rs and ws for "
                         f"out_dtype {out_dtype}")
    return _launch(KERNEL_NAME, xq, rs, w, ws, out_dtype, 0, 1)


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
                       int(layer), 1)
    if xq.dim() != 3 or xq.shape[0] != num_l \
            or rs.shape != (num_l, xq.shape[1], 1):
        raise ValueError(f"{STACKED_KERNEL_NAME}: xq {tuple(xq.shape)} rs "
                         f"{tuple(rs.shape)} for {num_l} layers")
    return _launch(STACKED_KERNEL_NAME, xq, rs, w, ws, out_dtype, 0, num_l)


def w8a8_linear(x: torch.Tensor, w: torch.Tensor, ws: torch.Tensor, *,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """The w8a8 product from the float activations, the JAX Dense's
    ``_w8a8_fwd_math``: ``quantize_rows(x)`` and kernel B4 (one launch, or
    two on the Hopper branch: its quantization pre-pass, then the product).

    x (M, K) bf16 or f32 against w (N, K) int8, ws (N,) f32 -> (M, N)
    (launches counted as ``w8a8_matmul``); or against a stack w (L, N, K),
    ws (L, N): x (L, M, K), row block l against layer l, or one x (M, K)
    against every layer -> (L, M, N) (counted as ``w8a8_matmul_stacked``).
    K % 16 == 0, N even."""
    if x.device.type == "cpu":
        return w8a8_linear_reference(x, w, ws, out_dtype=out_dtype)
    stacked = w.dim() == 3
    name = STACKED_KERNEL_NAME if stacked else KERNEL_NAME
    _check_device(name, x)
    if x.dim() not in (2, 3) or w.dim() not in (2, 3) \
            or ws.shape != w.shape[:-1] or x.dim() > w.dim() \
            or (x.dim() == 3 and x.shape[0] != w.shape[0]):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)} w "
                         f"{tuple(w.shape)} ws {tuple(ws.shape)}")
    return _launch(name, x, None, w, ws, out_dtype, 0,
                   w.shape[0] if stacked else 1)
