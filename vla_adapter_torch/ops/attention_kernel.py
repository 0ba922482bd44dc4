"""Fused attention and its backward: the hand-written CUDA kernels and
their plain versions.

Counterpart of ``vla_adapter_tpu/ops/pallas_attention.py:fused_attention``.
The kernel (``csrc/fused_attention.cu``) computes fp32 scores from bf16
q/k, an additive 0 / -2e9 key bias from ``valid``, an optional causal mask,
probabilities ``exp(s - max)`` rounded to bf16 *unnormalised* before
``p @ v``, and the 1/l normalisation (l summed from the rounded p) applied
to the output. It computes each score once and keeps a warp's 16 x S score
block in shared memory (the "one-pass" branch); :func:`attention_plan`
chooses the CTA size per shape, and the "two-pass" branch (scores
recomputed) only where not even one warp's block fits.

:func:`attention_reference` repeats that arithmetic in plain PyTorch. The
CPU tests and CPU runs use it; :func:`fused_attention` takes it only for a
tensor on the CPU. A CUDA tensor always goes to the kernel, or raises.

When training, the forward also returns each row's log-sum-exp
(``return_lse=True``): ``lse = m + log(sum exp(s - m))`` in fp32 over the
unrounded exponentials, which the backward reads.

The backward (B1-bwd, ``csrc/attention_bwd.cu``; the JAX package has no
backward kernel: its ``_attention_bwd`` is ``jax.vjp(xla_attention)``)
computes dq, dk and dv of :func:`xla_attention_reference`, the plain twin
of the JAX package's ``xla_attention`` (exact fp32 softmax, p rounded to
bf16 only for the p @ v product), from the forward's lse: three kernels,
each row's D (:func:`attention_bwd_d_reference` is its plain version),
dq, then dk and dv. :func:`attention_bwd` launches them on a CUDA tensor
and takes :func:`attention_bwd_reference` (autograd through the twin) on
a CPU tensor.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from vla_adapter_torch.ops import cuda_lib

NEG_INF = -2.0e9  # the Pallas kernel's large negative (no inf - inf NaNs)
KERNEL_NAME = "fused_attention"
_SOURCE = "fused_attention.cu"
BWD_KERNEL_NAME = "attention_bwd"
BWD_SOURCE = "attention_bwd.cu"
# each backward launches three kernels: D (each row's sum of p * dp), dq,
# then dk and dv
BWD_KERNELS = ("d", "dq", "dkdv")
BWD_LAUNCHES_PER_CALL = len(BWD_KERNELS)
_MAX_HEAD_DIM = 128

# H100 SXM: SMs (the default; the wrapper passes the device's count),
# shared memory per SM (228 KB, 1 KB of it reserved per block) and per
# block (227 KB), as the kernel's launch assumes them. The shared memory
# layout below is the one csrc/fused_attention.cu:smem_bytes sizes, which
# refuses a launch that would not fit.
_SMS = 132
_SM_SMEM = 233472
_BLOCK_SMEM = 232448
_KEY_TILE = 64
_MAX_WARPS = 8


@functools.lru_cache(maxsize=None)
def attention_plan(batch: int, heads: int, kv_heads: int, seq: int,
                   dim: int, sms: int = _SMS) -> dict:
    """How ``csrc/fused_attention.cu`` runs a shape on ``sms`` SMs
    (cached per shape: do not modify the result): the branch
    ("one-pass": each warp's 16 x S fp32 scores stay in shared memory;
    "two-pass": recomputed, where not even one warp's block fits), warps
    per CTA (units of 16 query rows of one head of a kv group), the grid's
    CTAs, CTAs per SM, waves and shared memory per CTA.

    Among the CTA sizes whose score block fits, it takes the one with the
    fewest rounds of CTAs on the busiest SM, then the fewest warps run
    there in all, then the most warps per CTA (fewer re-reads of K/V from
    L2). Registers are taken as <= 128 per thread. (On an H100 a second
    round cost far more than a second warp on a sub-partition: at the
    Qwen2 shape, 112 CTAs of 5 warps took 28 us, 140 of 4 took 45.)"""
    dp = -(-dim // 16) * 16
    tiles = -(-seq // _KEY_TILE)
    tile_bytes = _KEY_TILE * (dp + 8) * 2
    slot = tile_bytes + 4 * _KEY_TILE  # a K or V tile and its valid flags
    units = (heads // kv_heads) * -(-seq // 16)

    def occupancy(warps, smem):
        ctas = batch * kv_heads * -(-units // warps)
        per_sm = min(_SM_SMEM // (smem + 1024), 64 // warps, 16 // warps, 32)
        return ctas, per_sm

    best = None
    for warps in range(1, min(_MAX_WARPS, units) + 1):
        smem = 2 * slot + warps * tiles * 4096
        if smem > _BLOCK_SMEM:
            break
        ctas, per_sm = occupancy(warps, smem)
        busiest = -(-ctas // sms)  # CTAs the busiest SM runs
        key = (-(-busiest // per_sm), busiest * warps, -warps)
        if best is None or key < best[0]:
            best = (key, warps, smem)
    if best is None:  # K and V of a tile in each of the two slots
        branch, warps, smem = "two-pass", 4, 2 * (slot + tile_bytes)
    else:
        branch, (_, warps, smem) = "one-pass", best
    ctas, per_sm = occupancy(warps, smem)
    return {"branch": branch, "warps": warps, "ctas": ctas,
            "ctas_per_sm": per_sm, "waves": ctas / (sms * per_sm),
            "smem_bytes": smem}


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Plain version. q (B, H, S, D); k, v (B, Hkv, S, D); valid (B, S)
    nonzero for real tokens (None = all). Returns (B, H, S, D) in q.dtype,
    and with ``return_lse`` also each row's fp32 log-sum-exp (B, H, S) of
    the masked scores (about -2e9 for a row with no valid key)."""
    b, h, s, d = q.shape
    groups = h // k.shape[1]
    if sm_scale is None:
        sm_scale = d ** -0.5
    kx = k.repeat_interleave(groups, dim=1).float()
    vx = v.repeat_interleave(groups, dim=1)
    scores = torch.matmul(q.float(), kx.transpose(-1, -2)) * sm_scale
    if valid is not None:
        bias = torch.where(valid > 0, 0.0, NEG_INF).to(torch.float32)
        scores = scores + bias[:, None, None, :]
    if causal:
        pos = torch.arange(s, device=q.device)
        scores = torch.where(pos[None, :] <= pos[:, None], scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    p = e.to(v.dtype)                              # unnormalised, rounded
    l = p.float().sum(dim=-1, keepdim=True)
    out = torch.matmul(p.float(), vx.float()) / l  # deferred normalisation
    if return_lse:
        return out.to(q.dtype), (m + torch.log(e.sum(dim=-1, keepdim=True)))[..., 0]
    return out.to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = cuda_lib.load_library(_SOURCE)
    fn = lib.vla_fused_attention_bf16
    if not fn.argtypes:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([p] * 6 + [i] * 5 + [ll] * 15
                       + [ctypes.c_float, i, i, i, p])
        fn.restype = ctypes.c_int
    return lib


def _check_operand(name: str, t: torch.Tensor,
                   who: str = KERNEL_NAME) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{who}: {name} must be bfloat16, got {t.dtype}")
    if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1]):
        raise ValueError(
            f"{who}: {name} needs a contiguous head dim and strides that "
            f"are multiples of 8, got {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{who}: {name} is not 16-byte aligned")


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    return_lse: bool = False,
):
    """q (B, H, S, D); k, v (B, Hkv, S, D) with H % Hkv == 0; valid (B, S).

    On a CUDA tensor this launches the kernel (bf16, D % 8 == 0, D <= 128;
    any layout whose head dim is contiguous). The output is (B, H, S, D)
    viewed over a (B, S, H, D) buffer, so ``out.transpose(1, 2)`` is
    contiguous for the model's (B, S, H*D) projections. With
    ``return_lse`` it returns ``(out, lse)``, lse (B, H, S) float32 (the
    same launch; the output's bits do not change). On a CPU tensor it
    returns :func:`attention_reference`."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, valid, causal=causal,
                                   sm_scale=sm_scale, return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    b, h, s, d = q.shape
    hkv = k.shape[1]
    if k.shape != (b, hkv, s, d) or v.shape != k.shape or h % hkv:
        raise ValueError(f"fused_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if d % 8 or d > _MAX_HEAD_DIM or s < 1:
        raise ValueError(f"fused_attention: head dim {d} must be a multiple "
                         f"of 8 and <= {_MAX_HEAD_DIM}; seq {s} >= 1")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"fused_attention: {name} on {t.device}")
        _check_operand(name, t)
    if valid is not None:
        if valid.shape != (b, s) or valid.device != q.device:
            raise ValueError(f"fused_attention: valid {tuple(valid.shape)} "
                             f"on {valid.device}")
        valid = valid.to(torch.int32).contiguous()
    if sm_scale is None:
        sm_scale = d ** -0.5
    out = torch.empty((b, s, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if return_lse else None)
    plan = attention_plan(b, h, hkv, s, d, cuda_lib.sm_count(q.device))
    lib = _lib()
    with torch.cuda.device(q.device):  # the launch goes to the current device
        err = lib.vla_fused_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if valid is None else valid.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, h, hkv, s, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], 0 if valid is None else valid.stride(0),
            *((0, 0) if lse is None else lse.stride()[:2]),
            float(sm_scale), int(causal), plan["warps"],
            int(plan["branch"] == "one-pass"),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_attention: kernel launch failed "
                           f"(cudaError {err})")
    cuda_lib.count_launch(KERNEL_NAME)
    return (out, lse) if return_lse else out


# ---------------------------------------------------------------------------
# The backward (B1-bwd)

# csrc/attention_bwd.cu: CTAs of a producer warpgroup and kWarpgroups
# consumer warpgroups (64 rows each), __launch_bounds__ of (384, 1): 168
# registers a thread at launch; a TMA ring of Smem::kStages stages
_BWD_WARPGROUPS = 2
_BWD_THREADS = (_BWD_WARPGROUPS + 1) * 128
_BWD_REGS = 168
# dk/dv: both warpgroups of a CTA on one key block, items split between
# them, from this many items (query tiles of the kv head's group) on
_BWD_SPLIT_ITEMS = 16


def _bwd_chunk(dp: int) -> int:
    """TMA column chunk (bf16) of a tile of head dim ``dp``: the widest
    swizzle row (128, 64 or 32 bytes) that divides it."""
    return 64 if dp % 64 == 0 else 32 if dp % 32 == 0 else 16


@functools.lru_cache(maxsize=None)
def attention_bwd_plan(batch: int, heads: int, kv_heads: int, seq: int,
                       dim: int, sms: int = _SMS) -> dict:
    """How ``csrc/attention_bwd.cu`` runs a shape on ``sms`` SMs (cached:
    do not modify the result): 64-row tiles of the head dim padded to a
    multiple of 16 in TMA chunks of ``chunk`` bf16 (``swizzle_bytes``),
    through a ring of ``stages``; the D and dq kernels' CTAs (two
    warpgroups of 64 query rows each); the dk/dv kernel's (two key blocks of
    64 keys, or with ``dkdv_split`` one, its ``dkdv_items`` q/dO tiles
    split between the two); the shared memory a CTA takes and the CTAs an
    SM holds, the fewer of what its shared memory and its registers allow;
    waves of each grid. No per-row storage, so no limit on S."""
    dp = -(-dim // 16) * 16
    tile_bytes = _KEY_TILE * dp * 2
    stages = 4
    row_tiles = -(-seq // _KEY_TILE)
    smem = (2 * _BWD_WARPGROUPS * tile_bytes + stages * (2 * tile_bytes + 1024)
            + 8 * (2 * stages + 1) + 1024 + row_tiles * _KEY_TILE // 8)
    if smem > _BLOCK_SMEM:
        raise ValueError(f"attention_bwd: head dim {dim} at seq {seq} does "
                         f"not fit")
    per_sm = min(_SM_SMEM // (smem + 1024),
                 65536 // (_BWD_THREADS * _BWD_REGS))
    groups = heads // kv_heads
    items = groups * row_tiles
    split = items >= _BWD_SPLIT_ITEMS
    rows_ctas = batch * kv_heads * -(-items // _BWD_WARPGROUPS)
    dkdv_ctas = batch * kv_heads * (row_tiles if split else
                                    -(-row_tiles // _BWD_WARPGROUPS))
    chunk = _bwd_chunk(dp)
    return {"chunk": chunk, "swizzle_bytes": 2 * chunk, "stages": stages,
            "warpgroups": _BWD_WARPGROUPS, "smem_bytes": smem,
            "ctas_per_sm": per_sm, "d_ctas": rows_ctas, "dq_ctas": rows_ctas,
            "dq_waves": rows_ctas / (sms * per_sm), "dkdv_ctas": dkdv_ctas,
            "dkdv_waves": dkdv_ctas / (sms * per_sm), "dkdv_items": items,
            "dkdv_split": split}


def xla_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain twin of the JAX package's ``xla_attention`` in (B, H, S, D)
    layout: fp32 scores from the inputs' values, masked by a select to
    NEG_INF, an fp32 softmax, p rounded to the input dtype for p @ v
    (fp32 accumulation). A row with no valid key averages v over all S
    keys. The function whose gradient B1-bwd computes."""
    b, h, s, d = q.shape
    groups = h // k.shape[1]
    if sm_scale is None:
        sm_scale = d ** -0.5
    kx = k.repeat_interleave(groups, dim=1)
    vx = v.repeat_interleave(groups, dim=1)
    scores = torch.matmul(q.float(), kx.float().transpose(-1, -2)) * sm_scale
    mask = None
    if valid is not None:
        mask = (valid != 0)[:, None, None, :]
    if causal:
        pos = torch.arange(s, device=q.device)
        tril = (pos[None, :] <= pos[:, None])[None, None]
        mask = tril if mask is None else mask & tril
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.matmul(p.to(q.dtype).float(), vx.float())
    return out.to(q.dtype)


def attention_bwd_d_reference(q, k, v, valid, dout, *, causal: bool = False,
                              sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of B1-bwd's kernel 1: each row's D = sum_k p * dp,
    (B, H, S) fp32, with p the fp32 softmax of :func:`xla_attention_reference`
    and dp = dout . v^T rounded to the input dtype, the term the vjp of
    the softmax subtracts (``ds = p * (dp - D)``)."""
    b, h, s, d = q.shape
    groups = h // k.shape[1]
    if sm_scale is None:
        sm_scale = d ** -0.5
    kx = k.repeat_interleave(groups, dim=1).float()
    vx = v.repeat_interleave(groups, dim=1).float()
    scores = torch.matmul(q.float(), kx.transpose(-1, -2)) * sm_scale
    mask = None
    if valid is not None:
        mask = (valid != 0)[:, None, None, :]
    if causal:
        pos = torch.arange(s, device=q.device)
        tril = (pos[None, :] <= pos[:, None])[None, None]
        mask = tril if mask is None else mask & tril
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    dp = torch.matmul(dout.float(), vx.transpose(-1, -2)).to(q.dtype).float()
    return (p * dp).sum(-1)


def attention_bwd_reference(q, k, v, valid, dout, *, causal: bool = False,
                            sm_scale: Optional[float] = None, lse=None):
    """Plain version of B1-bwd: (dq, dk, dv) of
    :func:`xla_attention_reference` at ``dout`` by autograd (the JAX
    package's ``jax.vjp(xla_attention)``). q, dout (B, H, S, D); k, v
    (B, Hkv, S, D). ``lse`` (the kernel's residual) is not needed: it
    recomputes the forward."""
    with torch.enable_grad():
        qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = xla_attention_reference(qs, ks, vs, valid, causal=causal,
                                      sm_scale=sm_scale)
        return torch.autograd.grad(out, (qs, ks, vs), dout)


def _bwd_lib() -> ctypes.CDLL:
    lib = cuda_lib.load_library(BWD_SOURCE)
    fn = lib.vla_attention_bwd_bf16
    if not fn.argtypes:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([p] * 10 + [i] * 5 + [ll] * 24
                       + [ctypes.c_float, i, i, i, p])
        fn.restype = ctypes.c_int
    return lib


def attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid: Optional[torch.Tensor],
    dout: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    lse: Optional[torch.Tensor] = None,
    kernels=BWD_KERNELS,
    stats: Optional[torch.Tensor] = None,
):
    """B1-bwd: (dq, dk, dv) of attention at the output gradient ``dout``.
    q, dout (B, H, S, D); k, v (B, Hkv, S, D); valid (B, S) or None;
    ``lse`` (B, H, S) float32, the forward's row log-sum-exp
    (``fused_attention(..., return_lse=True)``).
    ``kernels`` (a subset of :data:`BWD_KERNELS`) and ``stats`` (the
    (2, B, H, S64) float32 scratch of the row statistics, S64 = S rounded
    up to a multiple of 64) are for timing one kernel alone on the
    statistics an earlier call left in ``stats``.

    On a CUDA tensor this launches the three kernels of
    ``csrc/attention_bwd.cu`` (bf16, the layouts and limits of
    :func:`fused_attention`, any S), after running the forward with its
    statistics when ``lse`` is not given; dq comes out as
    (B, H, S, D) viewed over a (B, S, H, D) buffer, dk and dv likewise
    over (B, S, Hkv, D), so each ``.transpose(1, 2)`` is contiguous for
    the projections' backward. On a CPU tensor it returns
    :func:`attention_bwd_reference`."""
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, valid, dout, causal=causal,
                                       sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention_bwd: unsupported device {q.device}")
    b, h, s, d = q.shape
    hkv = k.shape[1]
    if (k.shape != (b, hkv, s, d) or v.shape != k.shape
            or dout.shape != q.shape or h % hkv):
        raise ValueError(f"attention_bwd: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} dout "
                         f"{tuple(dout.shape)}")
    if d % 8 or d > _MAX_HEAD_DIM or s < 1:
        raise ValueError(f"attention_bwd: head dim {d} must be a multiple "
                         f"of 8 and <= {_MAX_HEAD_DIM}; seq {s} >= 1")
    if valid is not None:
        if valid.shape != (b, s) or valid.device != q.device:
            raise ValueError(f"attention_bwd: valid {tuple(valid.shape)} "
                             f"on {valid.device}")
        valid = valid.to(torch.int32).contiguous()
    if sm_scale is None:
        sm_scale = d ** -0.5
    if lse is None:
        lse = fused_attention(q, k, v, valid, causal=causal,
                              sm_scale=sm_scale, return_lse=True)[1]
    if lse.shape != (b, h, s) or lse.dtype != torch.float32 or (
            lse.stride(-1) != 1):
        raise ValueError(f"attention_bwd: lse {tuple(lse.shape)} "
                         f"{lse.dtype} must be float32 (B, H, S) with "
                         f"contiguous rows")
    for name, t in (("q", q), ("k", k), ("v", v), ("dout", dout),
                    ("lse", lse)):
        if t.device != q.device:
            raise ValueError(f"attention_bwd: {name} on {t.device}")
        if name != "lse":
            _check_operand(name, t, BWD_KERNEL_NAME)
    dev = q.device
    dq = torch.empty((b, s, h, d), dtype=q.dtype, device=dev).transpose(1, 2)
    dk, dv = (torch.empty((b, s, hkv, d), dtype=q.dtype,
                          device=dev).transpose(1, 2) for _ in range(2))
    s_pad = -(-s // _KEY_TILE) * _KEY_TILE
    if stats is None:
        stats = torch.empty((2, b, h, s_pad), dtype=torch.float32, device=dev)
    if (stats.shape != (2, b, h, s_pad) or stats.dtype != torch.float32
            or not stats.is_contiguous() or stats.device != dev):
        raise ValueError(f"attention_bwd: stats {tuple(stats.shape)}")
    mask = sum(1 << BWD_KERNELS.index(name) for name in set(kernels))
    plan = attention_bwd_plan(b, h, hkv, s, d, cuda_lib.sm_count(dev))
    lib = _bwd_lib()
    with torch.cuda.device(dev):
        err = lib.vla_attention_bwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(),
            None if valid is None else valid.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), b, h, hkv, s, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *dout.stride()[:3], *lse.stride()[:2],
            *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
            0 if valid is None else valid.stride(0), float(sm_scale),
            int(causal), int(plan["dkdv_split"]), mask,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention_bwd: kernel launch failed "
                           f"(cudaError {err})")
    for _ in set(kernels):
        cuda_lib.count_launch(BWD_KERNEL_NAME)
    return dq, dk, dv
