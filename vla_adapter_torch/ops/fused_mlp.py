"""Fused w8a8 MLPs: the hand-written CUDA kernel and its plain version.

Counterpart of ``vla_adapter_tpu/ops/pallas_fused_mlp.py``:
``w8a8_gated_mlp_stacked`` (kernel B2, the Qwen2 MLP
``silu(x @ gate) * (x @ up) @ down``) and ``w8a8_mlp_stacked`` (kernel B3,
the ViT and projector MLPs ``act(x @ fc1 + b1) @ fc2 + b2``), which share
one kernel body and here share ``csrc/fused_mlp_w8a8.cu``.

x is quantized per token once; every ``block_f``-wide panel of the hidden
dim F gets its int8 up product(s), dequantization, bias and activation; the
panel of h is re-quantized per (token, panel) and its int8 down product,
scaled by the panel's row scale, summed in float32 in panel order; the
per-channel down scale (and bias) come last. ``block_f = 512`` belongs to
the numerics, not the tiling. ``gelu`` is the TPU kernel's erf by A&S
7.1.26, not the exact erf.

Weights are int8 in the PyTorch ``(out, in)`` layout: fc1/gate/up (F, K),
fc2/down (D, F), scales (F,) / (D,) float32, unpadded (a ragged F such as
so400m's 4304 is masked inside the kernel). The JAX functions take one
layer of an (L, K, F) stack; the port keeps each layer's weights in its own
module, so the functions here take one layer's weights.

The kernel (``csrc/fused_mlp_w8a8.cu``, its walk in
``csrc/w8a8_mlp_wgmma.cuh``) runs a persistent grid that takes work items
from an atomic ticket: quantization items (64-row tile) write xq and the
row scales to a scratch, up items (64-row tile, panel, slice of K) hq and
hs, down items (128-row tile, 128 output columns, group of panels) sum the
panels in order. Its products are int8 ``wgmma`` on operands that TMA
brings in, at every K. :func:`mlp_plan` gives the split and the grid for a
shape: above :data:`DECODE_ROWS` rows one slice and one group; at a decode
step's rows the up items split K (their exact int32 partials meet by
atomics) and the down items split the panels (their float terms are summed
in panel order by the last to arrive), so that every SM streams weights.
:func:`mlp_work_items` lists the items in ticket order, as the kernel
takes them, and :func:`up_item_steps` the ring steps of one up item.

:func:`fused_mlp_reference` repeats the arithmetic in plain PyTorch. The
wrappers take it only for a CPU tensor; a CUDA tensor always goes to the
kernel, or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from vla_adapter_torch.ops import cuda_lib
from vla_adapter_torch.ops.w8a8_matmul import int_matmul, quantize_rows

GATED_KERNEL_NAME = "w8a8_gated_mlp"
KERNEL_NAME = "w8a8_mlp"
SOURCE = "fused_mlp_w8a8.cu"
BLOCK_F = 512
ACTIVATIONS = ("silu", "gelu", "gelu_tanh", "quick_gelu")
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

# The kernel's tiling (csrc/w8a8_mlp_wgmma.cuh): rows per quantization and
# up item, rows per down item, output columns per down item (and panel
# columns per up stage), bytes of k per ring step; the rows at and below
# which a call is a decode step (K and panels split); H100 SXM SMs (the
# default; the wrapper passes the device's count) and shared memory per
# block.
ROW_TILE = 64
DOWN_ROW_TILE = 128
COL_TILE = 128
K_STEP = 128
DECODE_ROWS = 32
SMS = 132
BLOCK_SMEM = 232448
# The ticket and the ready counters live in a per-device int32 scratch that
# the kernels leave zeroed (B6 takes 2 + 4 ceil(M / 32) of them).
COUNTER_CAP = 1 << 16
# The up items' split sums, (2, M, F) int32, in a per-device scratch the
# kernel leaves zeroed: a decode step splits K where they fit.
SUMS_CAP = 1 << 20
_COUNTERS: dict = {}
_SUMS: dict = {}


def _round_up(n: int, to: int) -> int:
    return -(-n // to) * to


def ring_stages(gated: bool) -> int:
    """Ring stages (csrc/w8a8_mlp_wgmma.cuh:ring_stages): 4 of 40 KB for
    the gated MLP (64 rows of xq, 128 of W1 and of Wu), 5 of 32 KB for the
    plain one (a down step, 128 rows of hq and of W2, is the larger)."""
    return 4 if gated else 5


def smem_bytes(gated: bool) -> int:
    """Shared memory of a CTA (csrc/w8a8_mlp_wgmma.cuh:smem_bytes): the
    alignment slack, the ring, the staged hq tile (64 x 512 bytes), the
    staged column vectors (3 x 512 floats), the two warpgroups' row
    maxima, the barriers, the item ids and a flag."""
    stage = max(ROW_TILE * K_STEP + (2 if gated else 1) * COL_TILE * K_STEP,
                (DOWN_ROW_TILE + COL_TILE) * K_STEP)
    stages = ring_stages(gated)
    return 1024 + stages * stage + ROW_TILE * BLOCK_F + 4 * 3 * BLOCK_F \
        + 2 * ROW_TILE * 4 + 8 * (2 * stages + 4) + 16


def _slice(steps: int, parts: int) -> int:
    """Steps a part when ``steps`` are split into at most ``parts``, every
    part non-empty."""
    return -(-steps // max(1, min(steps, parts)))


@functools.lru_cache(maxsize=None)
def mlp_plan(m: int, k: int, f: int, d: int, *, gated: bool,
             block_f: int = BLOCK_F, sms: int = SMS) -> dict:
    """How ``csrc/fused_mlp_w8a8.cu`` runs one MLP on ``sms`` SMs (cached
    per shape: do not modify the result): the row tiles (64 rows for the
    quantization of x and the up items, 128 for the down items), the panel
    split (panels, the last one's real columns), the column tile of the
    down items, the up items' K slices (128-byte steps a slice) and the
    down items' panel groups (panels a group), the items of each kind, the
    persistent grid (CTAs, one per SM, and items per CTA as "waves"), the
    ring's stages, shared memory per CTA and the counters the launch takes. At
    :data:`DECODE_ROWS` rows or fewer the slices and groups are cut so that
    each kind has about one item per SM."""
    panels = -(-f // block_f)
    k_steps = -(-k // K_STEP)
    row_tiles = -(-m // ROW_TILE)
    down_tiles = -(-m // DOWN_ROW_TILE)
    col_tiles = -(-d // COL_TILE)
    up_slice, down_slice = k_steps, panels
    if m <= DECODE_ROWS:
        if 2 * m * f <= SUMS_CAP:
            up_slice = _slice(k_steps, -(-sms // (row_tiles * panels)))
        down_slice = _slice(panels, -(-sms // (down_tiles * col_tiles)))
    up_splits = -(-k_steps // up_slice)
    down_splits = -(-panels // down_slice)
    counts = {"quant_items": row_tiles,
              "up_items": panels * row_tiles * up_splits,
              "down_items": down_tiles * col_tiles * down_splits}
    items = sum(counts.values())
    ctas = min(items, sms)
    return {"row_tile": ROW_TILE, "row_tiles": row_tiles, "panels": panels,
            "panel_width": block_f,
            "last_panel_columns": f - (panels - 1) * block_f,
            "down_row_tile": DOWN_ROW_TILE, "down_row_tiles": down_tiles,
            "col_tile": COL_TILE, "col_tiles": col_tiles, "k": k,
            "k_steps": k_steps, "up_slice": up_slice,
            "up_splits": up_splits, "down_slice": down_slice,
            "down_splits": down_splits, **counts,
            "stages": ring_stages(gated),
            "ctas": ctas, "waves": items / ctas,
            "smem_bytes": smem_bytes(gated),
            "counters": 2 + row_tiles * (1 + 2 * panels)
            + down_tiles * col_tiles}


def mlp_work_items(plan: dict) -> list:
    """The work items of a plan in ticket order, as the kernel decodes its
    tickets: ("quant", row tile), then ("up", row tile, panel, (first, end)
    128-byte K step) panel by panel, each panel's row tiles and their
    slices in order, then ("down", 128-row tile, column tile, the panels it
    reads in the order it sums them), each tile's groups in order."""
    items = [("quant", t) for t in range(plan["quant_items"])]
    us, sl = plan["up_splits"], plan["up_slice"]
    per_panel = plan["row_tiles"] * us
    for u in range(plan["up_items"]):
        r, split = u % per_panel, u % us
        items.append(("up", r // us, u // per_panel,
                      (split * sl, min(plan["k_steps"], (split + 1) * sl))))
    ds, dsl = plan["down_splits"], plan["down_slice"]
    for u in range(plan["down_items"]):
        tile, split = u // ds, u % ds
        items.append(("down", tile // plan["col_tiles"],
                      tile % plan["col_tiles"],
                      tuple(range(split * dsl,
                                  min(plan["panels"], (split + 1) * dsl)))))
    return items


def up_item_steps(plan: dict, panel: int, k_range=None) -> list:
    """The ring steps of an up item of ``panel`` over ``k_range`` (its
    first and end 128-byte K step; all of K when None), in order, as
    ``csrc/w8a8_mlp_wgmma.cuh:producer`` issues them: (first column of F,
    columns, first byte of K, bytes) of each step's W1 (and Wu) tile and
    its 64 rows of xq over the same K window; the 128-column chunks of the
    panel in order, each over the slice's steps. Columns past F and bytes
    past K arrive as zeros."""
    lo, hi = (0, plan["k_steps"]) if k_range is None else k_range
    f0 = panel * plan["panel_width"]
    width = (plan["last_panel_columns"] if panel == plan["panels"] - 1
             else plan["panel_width"])
    return [(f0 + c, min(COL_TILE, width - c), ks * K_STEP,
             min(K_STEP, plan["k"] - ks * K_STEP))
            for c in range(0, width, COL_TILE) for ks in range(lo, hi)]


def _sigmoid(x):
    return torch.reciprocal(1.0 + torch.exp(-x))


def _erf_as(x):
    """erf by Abramowitz & Stegun 7.1.26, op for op the TPU kernel's."""
    s = torch.sign(x)
    a = x.abs()
    t = torch.reciprocal(1.0 + 0.3275911 * a)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return s * (1.0 - poly * torch.exp(-a * a))


def kernel_activation(name: str):
    """The fused kernel's activations in float32, in the TPU kernel's
    order of operations (``_kernel_activation``)."""
    if name == "silu":
        return lambda x: x * _sigmoid(x)
    if name == "gelu":
        return lambda x: 0.5 * x * (1.0 + _erf_as(x * (2.0 ** -0.5)))
    if name == "gelu_tanh":
        c = 0.7978845608028654  # sqrt(2 / pi)
        return lambda x: x * (0.5 * (1.0 + torch.tanh(
            c * (x + 0.044715 * (x * x * x)))))
    if name == "quick_gelu":
        return lambda x: x * _sigmoid(1.702 * x)
    raise ValueError(f"unknown activation {name!r}: expected one of "
                     f"{ACTIVATIONS}")


def fused_mlp_reference(x, w1, s1, w2, s2, *, up_q=None, up_scale=None,
                        b1=None, b2=None, act: str, out_dtype=None,
                        block_f: int = BLOCK_F) -> torch.Tensor:
    """Plain version: x (M, K) float; w1 (F, K) int8, s1 (F,); optional
    up_q (F, K), up_scale (F,) (the gated form); w2 (D, F), s2 (D,);
    b1 (F,), b2 (D,) or None. Returns (M, D) in out_dtype (x's dtype if
    None)."""
    act_fn = kernel_activation(act)
    xq, rs = quantize_rows(x)
    acc = None
    for f0 in range(0, w1.shape[0], block_f):
        cols = slice(f0, f0 + block_f)
        g = int_matmul(xq, w1[cols]).float() * rs * s1[cols].float()
        if b1 is not None:
            g = g + b1[cols].float()
        h = act_fn(g)
        if up_q is not None:
            h = h * (int_matmul(xq, up_q[cols]).float() * rs
                     * up_scale[cols].float())
        hq, hs = quantize_rows(h)
        part = int_matmul(hq, w2[:, cols]).float() * hs
        acc = part if acc is None else acc + part
    out = acc * s2.float()
    if b2 is not None:
        out = out + b2.float()
    return out.to(x.dtype if out_dtype is None else out_dtype)


def _lib() -> ctypes.CDLL:
    lib = cuda_lib.load_library(SOURCE)
    fn = lib.vla_fused_mlp_w8a8
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 17 + [i] * 10 + [p]
        fn.restype = ctypes.c_int
    return lib


def scratch(device: torch.device, sizes):
    """One uint8 tensor for this call holding buffers of the given byte
    sizes, each at a 256-byte boundary: (tensor, their addresses). Keep
    the tensor until the kernel is launched."""
    offsets = [0]
    for size in sizes[:-1]:
        offsets.append(offsets[-1] + _round_up(size, 256))
    buf = torch.empty(offsets[-1] + sizes[-1], dtype=torch.uint8,
                      device=device)
    return buf, [buf.data_ptr() + o for o in offsets]


def _zeroed(store: dict, cap: int, device: torch.device) -> torch.Tensor:
    key = device.index if device.index is not None \
        else torch.cuda.current_device()
    if key not in store:
        store[key] = torch.zeros(cap, dtype=torch.int32, device=device)
    return store[key]


def counters(device: torch.device, needed: int) -> torch.Tensor:
    """The device's ticket and ready counters (zeroed once, at first use,
    outside any CUDA graph capture; the kernels leave them zeroed). Calls
    on one device run in stream order, so they share it."""
    if needed > COUNTER_CAP:
        raise ValueError(f"{needed} counters exceed the scratch's "
                         f"{COUNTER_CAP}: too many rows")
    return _zeroed(_COUNTERS, COUNTER_CAP, device)


def split_sums(device: torch.device) -> torch.Tensor:
    """The device's zeroed int32 scratch of :data:`SUMS_CAP` entries for
    the up items' split sums (zeroed once, at first use; the kernel leaves
    it zeroed)."""
    return _zeroed(_SUMS, SUMS_CAP, device)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def launch_plan(name: str, m: int, k: int, f: int, d: int, *, gated: bool,
                block_f: int = BLOCK_F, sms: int = SMS) -> dict:
    """:func:`mlp_plan`, or a ValueError naming the shape where its
    counters exceed the scratch's :data:`COUNTER_CAP` (about 1.2 million
    rows at Qwen2's F)."""
    plan = mlp_plan(m, k, f, d, gated=gated, block_f=block_f, sms=sms)
    if plan["counters"] > COUNTER_CAP:
        raise ValueError(
            f"{name}: M={m}, K={k}, F={f}, D={d} needs {plan['counters']} "
            f"ready counters; the scratch has {COUNTER_CAP}")
    return plan


def _launch(name, x, w1, s1, up_q, up_scale, b1, w2, s2, b2, act, out_dtype,
            block_f, plan: Optional[dict] = None) -> torch.Tensor:
    """Launch the kernel on :func:`mlp_plan`'s plan for the card, or on
    ``plan`` (another plan of the same shape, with other slices or groups:
    ``mlp_compare.py --variants``)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if act not in ACTIVATIONS:
        raise ValueError(f"{name}: unknown activation {act!r}")
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.dtype not in _DTYPES or out_dtype != x.dtype:
        raise TypeError(f"{name}: x and out must both be bf16 or both f32, "
                        f"got {x.dtype} -> {out_dtype}")
    m, k = x.shape
    f, d = w1.shape[0], w2.shape[0]
    weights = [w1, w2] + ([up_q] if up_q is not None else [])
    if any(w.dtype != torch.int8 for w in weights):
        raise TypeError(f"{name}: weights must be int8")
    if w1.shape != (f, k) or w2.shape != (d, f) or (
            up_q is not None and up_q.shape != (f, k)):
        raise ValueError(f"{name}: x {tuple(x.shape)} w1 {tuple(w1.shape)} "
                         f"w2 {tuple(w2.shape)}")
    if k % 16 or f % 16 or d % 2 or block_f % 64 \
            or not 0 < block_f <= BLOCK_F:
        raise ValueError(f"{name}: K={k} and F={f} must be multiples of 16, "
                         f"D={d} even, block_f={block_f} a multiple of 64 "
                         "up to 512")
    vecs = [s1, s2, up_scale, b1, b2]
    operands = [x] + weights + [v for v in vecs if v is not None]
    if any(t.device != x.device for t in operands):
        raise ValueError(f"{name}: operands on more than one device")
    x = x.contiguous()
    w1, w2 = w1.contiguous(), w2.contiguous()
    up_q = None if up_q is None else up_q.contiguous()
    s1, s2, up_scale, b1, b2 = (None if v is None else v.float().contiguous()
                                for v in vecs)
    if plan is None:
        plan = launch_plan(name, m, k, f, d, gated=up_q is not None,
                           block_f=block_f, sms=cuda_lib.sm_count(x.device))
    panels = plan["panels"]
    mpad = _round_up(m, DOWN_ROW_TILE)
    count = counters(x.device, plan["counters"])
    sums = split_sums(x.device) if plan["up_splits"] > 1 else None
    out = torch.empty((m, d), dtype=out_dtype, device=x.device)
    terms = 4 * panels * m * d if plan["down_splits"] > 1 else 16
    buf, (xq, rs, hq, hs, terms) = scratch(x.device, [
        m * k, 4 * mpad, m * panels * _round_up(block_f, K_STEP),
        4 * panels * mpad, terms])
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.vla_fused_mlp_w8a8(
            x.data_ptr(), w1.data_ptr(), s1.data_ptr(), _ptr(up_q),
            _ptr(up_scale), _ptr(b1), w2.data_ptr(), s2.data_ptr(), _ptr(b2),
            out.data_ptr(), xq, rs, hq, hs, _ptr(sums), terms,
            count.data_ptr(), m, k, f, d, block_f, ACTIVATIONS.index(act),
            _DTYPES[x.dtype], plan["ctas"], plan["up_slice"],
            plan["down_slice"], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {err})")
    cuda_lib.count_launch(name)
    return out


def w8a8_gated_mlp(x, gate_q, gate_scale, up_q, up_scale, down_q,
                   down_scale, *, act: str = "silu", out_dtype=None,
                   block_f: int = BLOCK_F) -> torch.Tensor:
    """Kernel B2: act(x @ gate^T) * (x @ up^T) @ down^T, all w8a8.
    x (M, K); gate_q/up_q (F, K) int8, scales (F,); down_q (D, F), (D,)."""
    if x.device.type == "cpu":
        return fused_mlp_reference(
            x, gate_q, gate_scale, down_q, down_scale, up_q=up_q,
            up_scale=up_scale, act=act, out_dtype=out_dtype, block_f=block_f)
    return _launch(GATED_KERNEL_NAME, x, gate_q, gate_scale, up_q, up_scale,
                   None, down_q, down_scale, None, act, out_dtype, block_f)


def w8a8_mlp(x, fc1_q, fc1_scale, fc1_bias, fc2_q, fc2_scale, fc2_bias, *,
             act: str = "gelu", out_dtype=None,
             block_f: int = BLOCK_F) -> torch.Tensor:
    """Kernel B3: act(x @ fc1^T + b1) @ fc2^T + b2, all w8a8. x (M, K);
    fc1_q (F, K) int8, fc1_scale (F,), fc1_bias (F,) or None; fc2_q (D, F),
    fc2_scale (D,), fc2_bias (D,) or None."""
    if x.device.type == "cpu":
        return fused_mlp_reference(
            x, fc1_q, fc1_scale, fc2_q, fc2_scale, b1=fc1_bias, b2=fc2_bias,
            act=act, out_dtype=out_dtype, block_f=block_f)
    return _launch(KERNEL_NAME, x, fc1_q, fc1_scale, None, None, fc1_bias,
                   fc2_q, fc2_scale, fc2_bias, act, out_dtype, block_f)
