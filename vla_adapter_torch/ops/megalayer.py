"""One batch-1 Qwen2 decoder layer from the attention core on: the
hand-written CUDA kernel (B6) and its plain version.

Counterpart of ``vla_adapter_tpu/ops/pallas_megalayer.py:
w8a8_qwen2_layer_stacked``, the whole-layer kernel of the ``"mega"`` w8a8
backend. From the layer input x (M, D), the roped q (M, H, Dh), k and v
(M, Hkv, Dh) of one sequence and the key validity:

    ctx = attention(q, k, v, valid)                B1's numerics, in x's dtype
    o   = w8a8 o-projection of ctx                 per-token quantization over
                                                   the whole H*Dh row
    xa  = x.dtype(x + o)                           the residual, rounded once
    h2  = xa * rsqrt(mean(xa^2) + eps) * norm2     float32, not rounded
    out = x.dtype(xa + gated_mlp(h2))              B2's per-(token, 512-panel)
                                                   w8a8 MLP, float32 out

Every row attends to all M rows: two sequences in one call would attend to
each other, so the model calls it once per sequence at batch 1 only.

The kernel runs a persistent grid that takes work items in dependency
order from an atomic ticket: attention (kv head, up to 8 units of 16 rows
of one query head), o-projection (32-row tile, 128 columns), RMSNorm2 and
the quantization of h2 (32-row tile), then the gated MLP's up and down
items of ``csrc/w8a8_mlp.cuh``'s ``mma.sync`` walk, which B6 alone runs
(its tiles and shared memory are described here).
:func:`megalayer_plan` gives the items and the grid for a shape and
:func:`megalayer_work_items` the items in ticket order. A warp keeps its
16 x M attention scores in shared memory, so M is at most
:data:`MAX_TOKENS`.

Weights are one layer's, int8 in the PyTorch ``(out, in)`` layout: o_q
(D, H*Dh), gate_q / up_q (F, D), down_q (D, F), with float32 scales. The
JAX function takes one layer of an (L, in, out) stack padded to a multiple
of 128 in F; zero padding changes nothing, so the port keeps F unpadded and
masks the last panel.

:func:`megalayer_reference` repeats the arithmetic in plain PyTorch from
the plain versions of kernels B1, B4 and B2. :func:`w8a8_qwen2_layer` takes
it only for a CPU tensor; a CUDA tensor always goes to the kernel, or
raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from vla_adapter_torch.ops import cuda_lib
from vla_adapter_torch.ops.attention_kernel import attention_reference
from vla_adapter_torch.ops import fused_mlp
from vla_adapter_torch.ops.fused_mlp import BLOCK_F, fused_mlp_reference
from vla_adapter_torch.ops.w8a8_matmul import int_matmul, quantize_rows

KERNEL_NAME = "w8a8_qwen2_layer"
SOURCE = "megalayer_w8a8.cu"
HEAD_DIMS = (16, 32, 64, 128)
# The o-projection sums H*Dh int8 x int8 products in int32 and converts
# once; the TPU kernel sums per-head partials in float32. The two agree
# while every sum stays below 2^24, which |sum| <= H*Dh*127^2 guarantees.
_EXACT_SUM = 2 ** 24
_KEY_TILE = 64
# The attention stage keeps one warp's 16 x M fp32 scores (4 KB per 64
# keys) beside a two-slot K/V ring in a block's shared memory: up to 3072
# tokens at every head dim the kernel takes.
MAX_TOKENS = 3072


# The MLP walk of csrc/w8a8_mlp.cuh: rows per up item (and per norm and
# o-projection item), rows per down item, output columns per down item (and
# panel columns per up-item chunk), bytes of k per ring step, warps per CTA
# and ring slots (two weights a step); shared memory per block on an H100.
ROW_TILE = 32
DOWN_ROW_TILE = 64
COL_TILE = 128
K_STEP = 128
WARPS = 8
RING_DEPTH = 4
BLOCK_SMEM = 232448


def _mlp_split(m: int, f: int, d: int, block_f: int) -> dict:
    panels = -(-f // block_f)
    return {"row_tile": ROW_TILE, "row_tiles": -(-m // ROW_TILE),
            "panels": panels, "panel_width": block_f,
            "last_panel_columns": f - (panels - 1) * block_f,
            "down_row_tile": DOWN_ROW_TILE,
            "down_row_tiles": -(-m // DOWN_ROW_TILE), "col_tile": COL_TILE,
            "col_tiles": -(-d // COL_TILE)}


def _mlp_smem_bytes(kpad: int, panels: int) -> int:
    """csrc/w8a8_mlp.cuh:mlp_smem_bytes of the gated walk with its rows of
    xq resident: 32 rows of xq, the ring (a slot holds an up step, 128 rows
    of W1 and of Wu, or a down step, 64 rows of hq and 128 of W2), the down
    item's panel scales, the cross-warp absmax and the row scales."""
    slot = max(2 * COL_TILE * K_STEP, (DOWN_ROW_TILE + COL_TILE) * K_STEP)
    return ROW_TILE * kpad + RING_DEPTH * slot \
        + 4 * (DOWN_ROW_TILE * panels + WARPS * ROW_TILE + ROW_TILE)


def _mlp_work_items(plan: dict) -> list:
    """The MLP's work items of a plan in ticket order: ("up", row tile,
    panel) for every panel of every 32-row tile, then ("down", 64-row tile,
    column tile, the panels in the order it sums them)."""
    items = [("up", t // plan["panels"], t % plan["panels"])
             for t in range(plan["up_items"])]
    order = tuple(range(plan["panels"]))
    return items + [("down", t // plan["col_tiles"], t % plan["col_tiles"],
                     order) for t in range(plan["down_items"])]


def _attention_smem(warps: int, m: int, dh: int) -> int:
    """csrc/attention_core.cuh:smem_bytes: two ring slots (64 keys in rows
    of dh + 8 bf16, their valid flags), then each warp's scores."""
    slot = _KEY_TILE * (dh + 8) * 2 + 4 * _KEY_TILE
    return 2 * slot + warps * -(-m // _KEY_TILE) * _KEY_TILE * 64


@functools.lru_cache(maxsize=None)
def megalayer_plan(m: int, d: int, heads: int, kv_heads: int, dh: int,
                   f: int, *, block_f: int = BLOCK_F,
                   sms: int = fused_mlp.SMS) -> dict:
    """How ``csrc/megalayer_w8a8.cu`` runs one layer on ``sms`` SMs (cached
    per shape: do not modify the result): the attention items and their
    warps (the most, up to 8, whose scores fit beside the MLP stages in one
    block's shared memory), the o-projection items (32-row tile, 128
    columns), the norm items (32-row tile), the MLP's up and down items
    (32-row tile, panel; 64-row tile, 128 columns), the persistent grid
    (one CTA per SM) and shared memory per CTA."""
    plan = _mlp_split(m, f, d, block_f)
    kpad = max(fused_mlp._round_up(heads * dh, K_STEP),
               fused_mlp._round_up(d, K_STEP))
    mlp = _mlp_smem_bytes(kpad, plan["panels"])
    units = heads // kv_heads * -(-m // 16)  # of each kv head
    warps = 0
    for w in range(1, min(WARPS, units) + 1):
        if max(mlp, _attention_smem(w, m, dh)) + 16 <= BLOCK_SMEM:
            warps = w
    if not warps:
        raise ValueError(f"{KERNEL_NAME}: M={m}, D={d}, F={f}: the stages "
                         "do not fit one block's shared memory")
    smem = max(mlp, _attention_smem(warps, m, dh)) + 16
    counts = {"attention_items": kv_heads * -(-units // warps),
              "oproj_items": plan["row_tiles"] * plan["col_tiles"],
              "norm_items": plan["row_tiles"],
              "up_items": plan["row_tiles"] * plan["panels"],
              "down_items": plan["down_row_tiles"] * plan["col_tiles"]}
    items = sum(counts.values())
    ctas = min(items, sms)
    return {**plan, "attention_warps": warps,
            "attention_units": kv_heads * units, **counts, "ctas": ctas,
            "ctas_per_sm": 1, "waves": items / ctas, "smem_bytes": smem}


def megalayer_work_items(plan: dict, heads: int, kv_heads: int) -> list:
    """The work items of a plan in ticket order, as the kernel decodes its
    tickets: ("attention", kv head, [(query head, first row), ...] of its
    warps), ("oproj", row tile, column tile), ("norm", row tile), then the
    MLP's up and down items."""
    groups = heads // kv_heads
    warps = plan["attention_warps"]
    units = plan["attention_units"] // kv_heads  # of each kv head
    items = []
    for t in range(plan["attention_items"]):
        kvh, i = t % kv_heads, t // kv_heads
        items.append(("attention", kvh, [
            (kvh * groups + u % groups, 16 * (u // groups))
            for u in range(i * warps, min((i + 1) * warps, units))]))
    items += [("oproj", t // plan["col_tiles"], t % plan["col_tiles"])
              for t in range(plan["oproj_items"])]
    items += [("norm", t) for t in range(plan["norm_items"])]
    return items + _mlp_work_items(plan)


def megalayer_reference(x, q, k, v, valid, norm2, o_q, o_scale, gate_q,
                        gate_scale, up_q, up_scale, down_q, down_scale, *,
                        eps: float, block_f: int = BLOCK_F) -> torch.Tensor:
    """Plain version. x (M, D); q (M, H, Dh); k, v (M, Hkv, Dh); valid (M,)
    nonzero for real keys or None; norm2 (D,); o_q (D, H*Dh) int8 with
    o_scale (D,); gate_q, up_q (F, D) with (F,) scales; down_q (D, F) with
    down_scale (D,). Returns (M, D) in x.dtype."""
    m, heads, dh = q.shape
    ctx = attention_reference(
        q.transpose(0, 1)[None], k.transpose(0, 1)[None],
        v.transpose(0, 1)[None], None if valid is None else valid[None])
    ctx = ctx[0].transpose(0, 1).reshape(m, heads * dh).to(x.dtype)
    cq, scale = quantize_rows(ctx)
    o = int_matmul(cq, o_q).float() * scale * o_scale.float()
    xa = (x.float() + o).to(x.dtype).float()
    h2 = xa * torch.rsqrt(xa.square().mean(-1, keepdim=True) + eps) \
        * norm2.float()
    mlp = fused_mlp_reference(h2, gate_q, gate_scale, down_q, down_scale,
                              up_q=up_q, up_scale=up_scale, act="silu",
                              out_dtype=torch.float32, block_f=block_f)
    return (xa + mlp).to(x.dtype)


def _lib() -> ctypes.CDLL:
    lib = cuda_lib.load_library(SOURCE)
    fn = lib.vla_w8a8_qwen2_layer
    if not fn.argtypes:
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        fn.argtypes = [p] * 22 + [i] * 7 + [ll] * 6 + [f, f, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def _check_qkv(name: str, t: torch.Tensor) -> None:
    if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1]) \
            or t.data_ptr() % 16:
        raise ValueError(f"{KERNEL_NAME}: {name} needs a contiguous head dim, "
                         f"strides that are multiples of 8 and a 16-byte "
                         f"aligned start, got strides {t.stride()}")


def _launch(x, q, k, v, valid, norm2, o_q, o_scale, gate_q, gate_scale, up_q,
            up_scale, down_q, down_scale, eps, block_f) -> torch.Tensor:
    name = KERNEL_NAME
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    m, d = x.shape
    _, heads, dh = q.shape
    hkv = k.shape[1]
    f = gate_q.shape[0]
    if any(t.dtype != torch.bfloat16 for t in (x, q, k, v)):
        raise TypeError(f"{name}: x, q, k and v must be bfloat16 on the card")
    if any(w.dtype != torch.int8 for w in (o_q, gate_q, up_q, down_q)):
        raise TypeError(f"{name}: weights must be int8")
    if q.shape[0] != m or k.shape != (m, hkv, dh) or v.shape != k.shape \
            or heads % hkv or o_q.shape != (d, heads * dh) \
            or gate_q.shape != (f, d) or up_q.shape != (f, d) \
            or down_q.shape != (d, f) \
            or (valid is not None and valid.shape != (m,)):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)} q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)} o "
                         f"{tuple(o_q.shape)} gate {tuple(gate_q.shape)} down "
                         f"{tuple(down_q.shape)}")
    if dh not in HEAD_DIMS or d % 16 or f % 16 or block_f % 64 \
            or not 0 < block_f <= BLOCK_F:
        raise ValueError(f"{name}: head dim {dh} must be one of {HEAD_DIMS}, "
                         f"D={d} and F={f} multiples of 16, block_f={block_f} "
                         "a multiple of 64 up to 512")
    if m > MAX_TOKENS:
        raise ValueError(f"{name}: M={m} tokens: the attention scores of "
                         f"one warp fit shared memory up to {MAX_TOKENS}")
    if heads * dh * 127 * 127 >= _EXACT_SUM:
        raise ValueError(f"{name}: H*Dh = {heads * dh} is too wide for an "
                         "exact float32 sum of the o-projection")
    vecs = [norm2, o_scale, gate_scale, up_scale, down_scale]
    operands = [q, k, v, o_q, gate_q, up_q, down_q] + vecs + (
        [] if valid is None else [valid])
    if any(t.device != x.device for t in operands):
        raise ValueError(f"{name}: operands on more than one device")
    for label, t in (("q", q), ("k", k), ("v", v)):
        _check_qkv(label, t)
    x = x.contiguous()
    o_q, gate_q, up_q, down_q = (w.contiguous()
                                 for w in (o_q, gate_q, up_q, down_q))
    norm2, o_scale, gate_scale, up_scale, down_scale = (
        t.float().contiguous() for t in vecs)
    if valid is not None:
        valid = valid.to(torch.int32).contiguous()
    plan = megalayer_plan(m, d, heads, hkv, dh, f, block_f=block_f,
                          sms=cuda_lib.sm_count(x.device))
    panels = plan["panels"]
    count = fused_mlp.counters(x.device, 2 + 4 * plan["row_tiles"])
    out = torch.empty_like(x)
    # ctx (M, H*Dh) and xa (M, D) bf16, xq (M, round128(D)) int8, rs (M)
    # f32, hq (M, panels * round128(block_f)) int8, hs (M, panels) f32
    buf, (ctx, xa, xq, rs, hq, hs) = fused_mlp.scratch(x.device, [
        2 * m * heads * dh, 2 * m * d,
        m * fused_mlp._round_up(d, K_STEP), 4 * m,
        m * panels * fused_mlp._round_up(block_f, K_STEP),
        4 * m * panels])
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.vla_w8a8_qwen2_layer(
            x.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if valid is None else valid.data_ptr(), norm2.data_ptr(),
            o_q.data_ptr(), o_scale.data_ptr(), gate_q.data_ptr(),
            gate_scale.data_ptr(), up_q.data_ptr(), up_scale.data_ptr(),
            down_q.data_ptr(), down_scale.data_ptr(), out.data_ptr(),
            ctx, xa, xq, rs, hq, hs, count.data_ptr(),
            m, d, heads, hkv, dh, f, block_f,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), dh ** -0.5, eps,
            plan["attention_warps"], plan["ctas"],
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {err})")
    cuda_lib.count_launch(name)
    return out


def w8a8_qwen2_layer(x, q, k, v, valid: Optional[torch.Tensor], norm2, o_q,
                     o_scale, gate_q, gate_scale, up_q, up_scale, down_q,
                     down_scale, *, eps: float,
                     block_f: int = BLOCK_F) -> torch.Tensor:
    """Kernel B6: one Qwen2 decoder layer of one sequence from the attention
    core on. Arguments as :func:`megalayer_reference`; q, k and v may be
    strided views (the head dim contiguous). On the card bf16 only."""
    if x.device.type == "cpu":
        return megalayer_reference(
            x, q, k, v, valid, norm2, o_q, o_scale, gate_q, gate_scale, up_q,
            up_scale, down_q, down_scale, eps=eps, block_f=block_f)
    return _launch(x, q, k, v, valid, norm2, o_q, o_scale, gate_q, gate_scale,
                   up_q, up_scale, down_q, down_scale, eps, block_f)
