"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--out FILE] [--profile]

Phases, in order; any failure exits non-zero:

1. build: compile every CUDA kernel of the serving and training paths
   from ``vla_adapter_torch/csrc`` with nvcc (sm_90a), one nvcc per
   source, all started together, and print ptxas' register and spill
   lines.
2. attention kernel vs plain: at the shapes one serving forward gives it
   (Qwen2 14/2 heads, S=640, D=64, key padding, and causal; DINOv2 16
   heads, S=261, D=64; so400m 16 heads, S=256, D=72; for B=1 and B=2),
   print the kernel's plan (branch, warps and CTAs, CTAs per SM, waves;
   every serving shape must take the one-pass branch), hold the kernel
   against its plain PyTorch version and time the kernel, the plain
   version and ``scaled_dot_product_attention`` (a yardstick only: the
   port never calls it).
3. w8a8 kernels vs plain: at the shapes one w8a8 serving forward gives
   them (derived from ``VLAConfig()`` by :func:`w8a8_shapes`, B=1 and B=4):
   the fused MLPs (Qwen2; DINOv2, so400m, projector), the w8a8 matmul at
   every distinct non-MLP shape, the head's stacked matmul, and (B=1) the
   whole-decoder-layer kernel of the "mega" backend at the Qwen2 layer with
   the prompt's key padding. Each fused MLP and the layer kernel first
   print their plan (the 32-row tile, the panel split, the work items, the
   persistent grid's CTAs and waves; :func:`mlp_plan`, :func:`megalayer_plan`).
   The matmuls must equal their plain versions bit for bit, the fused MLPs
   agree within :func:`mlp_tolerance` (whether they are bit for bit is
   recorded), the layer kernel within :func:`check_megalayer`. The matmul is held both
   as the models call it (``w8a8_linear``: float x, the quantization
   inside) and with x quantized beforehand (``w8a8_matmul``, the JAX
   B4/B5 signature), bit for bit, in both output dtypes. Times: kernel,
   plain version, for the matmuls also the xq entry, the two-step chain
   (``quantize_rows`` then the xq entry), the kernel with L2 flushed
   before each call, and ``torch._int_mm`` (the int8 product alone, a
   yardstick: the port never calls it; at M <= 16, which it refuses, on x
   zero-padded to 24 rows); for the layer kernel the same layer through
   the "fused" backend's launches (B1, the o-projection, the norm, B2).
4. quantizer: the on-card weight quantizer against the JAX package's numpy
   ``quantize_kernel`` (copied below) on flagship weight matrices, bit for
   bit.
5. flagship bf16 forward: ``VLAConfig()`` at full width and depth (DINOv2-L
   + so400m @224, 2 images, Qwen2.5-0.5B, a 24-block Pro head, 640 LLM
   tokens), random bf16 weights from a seeded CUDA generator, served
   through ``Predictor`` (on the card a CUDA graph per key, replayed):
   predict_action (B=1) and predict_action_batch (B=4), with launch counts
   read around exactly those requests. The same rows then go through the
   plain attention for an end-to-end comparison.
6. flagship w8a8 forward: ``Predictor(act_int8=True)`` over the same
   weights quantized on the card, each backend ("fused", "dense", "auto"
   at B=1 and B=4; "mega" at B=1, where a B=4 call must raise) driven with
   the launch counts reset before and read after it and checked against
   the counts :func:`w8a8_shapes` derives; actions against the all-plain
   path and against bf16 (mega also against fused); then
   ``Predictor(int8=True)`` (weight-only) once.
7. CUDA graphs (:func:`phase_graph`): every tier replayed against its
   eager forward, bit for bit and launch for launch, over requests whose
   prompt lengths and images differ; capture time per key and each pool's
   bytes; a crossover in turns on the same rows (eager and graph for every
   tier at B=1; bf16, int8, fused and dense under graphs at B=2 and 4).
8. checkpoint (:func:`phase_checkpoint`): the flagship exported with the
   port's exporter and loaded back with ``load_vla`` (no JAX), bit for
   bit in weights and in bf16 and w8a8 "fused" actions; export and load
   timed.

9. the /act server (:func:`phase_server`): the port's ``ActionServer``
   with the dynamic batcher (max_batch=16, max_wait_ms=4) over the
   flagship in bf16 and w8a8 "auto", with the reference's center crop.
   The buckets no earlier phase runs (B=8 and 16; "auto" serves them with
   "dense") first: B1 at their attention shapes and B4/B5 at their w8a8
   matmuls against the plain versions (B4/B5 bit for bit), and each
   tier's B=8 and B=16 forwards against the all-plain path, within the
   bounds of phases 5-6. Then every bucket's graph (1-16) warmed; one
   request alone and one
   coalesced batch bit for bit against the Predictor; ``run_load`` at 1, 4
   and 16 closed-loop clients for a fixed window each (one JSON line per
   tier and client count: requests/s, actions/s, p50/p90/p99 ms, realized
   batch sizes, errors), and a bf16 server with ``preprocess_workers=4``
   at 16.
10. the original VLA-Adapter model (:func:`phase_original_film`):
   ``VLAConfig()`` with the original head and FiLM towers at full width
   and depth, every tier checked as phases 5-7 check the flagship (launch
   counts from :func:`w8a8_shapes`, graphs against eager bit for bit,
   kernel path against plain, quantized tiers against bf16 and
   ``forward_error_report``), B=1 latency in turns, B4 and B5 at the new
   call sites against their plain versions, and the checkpoint round trip
   of the original head without FiLM (the exporter refuses FiLM).

11. the finetune path (:func:`phase_train`): the attention backward
   kernel (B1-bwd) against its plain version at the training shapes of
   micro-batch 16 (LLM with the dummy batch's key padding, DINOv2,
   so400m; a causal case, a GQA case at S = 37 with empty rows, and
   S = 4000): its plan, dq/dk/dv within ``ATTENTION_BWD_RTOL``, a rerun bit
   for bit, and its time (and each of its three kernels' alone) beside the
   plain version's, SDPA's backward (the yardstick) and the bound, and
   B1's forward with and without its lse output; the straight-through
   w8a8 product (forward and dx) bit
   for bit with its plain version at every frozen-base shape; then
   ``train.loop.finetune`` of the flagship recipe ("vla-adapter+libero-
   spatial": LoRA r=64 over the int8 base, remat of the towers and the
   decoder) at batch 16 for 10 steps over one repeated dummy batch with a
   checkpoint every 5, the main path: falling finite losses, frozen
   tensors unchanged and trainable ones moved bit for bit, the launches
   of B1, B1-bwd and B4 per step as :func:`expected_train_launches`
   derives them, s/step, samples/s and peak memory; one step through the
   kernels against the plain versions (:func:`kernel_vs_plain_step`);
   accumulation over 2 micro-batches with a bf16 carry and bf16 moments;
   a resume from the step-5 checkpoint whose losses equal the unbroken
   run's bit for bit; and a float-base run merged
   (``weights.merge.merge_checkpoint``), exported, loaded with
   ``load_vla`` and served under a CUDA graph within phase 5's bound of
   the trained LoRA model.

Phases 9 and 10 took 100 s on an NVIDIA H100 80GB HBM3 at 700 W beside
110 s for phases 1-8 (their per-phase seconds are printed; phase 9's
kernel checks at B=8 and 16 about 20 s of it). To hold the whole run near
twice phases 1-8 alone, phase 7 times 6 rounds at B=1
and 4 at B=2 and B=4 (were 8 and 6), and phase 9 measures 4 s windows and
runs its preprocess-pool server for bf16 only.

With ``--profile`` phase 7 also profiles one B=1 request per tier, eager
and replayed, and checks that the eager w8a8 tiers launch at least 3,000
fewer kernels per request than before the quantization moved inside B4
(``KERNELS_PER_REQUEST_BEFORE``); phase 11 profiles the third step of its
main finetune run (device ms by kernel group, :class:`ProfiledStep`).

Prints the card's name and power limit, one JSON line per kernel shape, a
``{"kernels": [...]}`` line (each kernel's ``launches`` on the bf16 or w8a8
flagship path, B1-bwd's on the train path, and ``launches_by_path`` for
every path), and as its last
line
``{"ok": true, "device": {...}}``. Exits non-zero without CUDA, and when
the ``vla_adapter_torch`` package beside this script is missing.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published dense peaks (NVIDIA data sheet): bf16 tensor-core
# rate and HBM3 bandwidth; a power limit below 700 W lowers what is reached.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12

SOURCES = ("fused_attention.cu", "w8a8_matmul.cu", "fused_mlp_w8a8.cu",
           "megalayer_w8a8.cu", "attention_bwd.cu")

# kernel vs plain: bf16 output of |out| < 4, the two differ in fp32
# summation order and exp rounding, so by about one bf16 ulp (2^-6 at 2-4).
KERNEL_ATOL = 2e-2
# the attention backward kernel (B1-bwd) vs its plain version (autograd
# through the twin of xla_attention), per output, max |kernel - plain| over
# max |plain|: the kernel rounds ds to bf16 for its dq/dk products (the
# plain version keeps it fp32 into an fp32 product), sums dk/dv of a GQA
# group in fp32 (the plain version rounds each head's to bf16 first) and
# sums in another order, each a relative 2^-9 per term, well inside 1e-2.
ATTENTION_BWD_RTOL = 1e-2
# flagship, kernel vs plain attention, normalized actions: 73 attention
# calls in bf16 through 24+23+26 random-weight layers and a 24-block head.
FLAGSHIP_ACTIONS_ATOL = 1e-1
# flagship w8a8, kernel path vs all-plain path, normalized actions: the
# w8a8 kernels equal their plain versions bit for bit, but the attention
# kernel's bf16 differences (0.027 in the bf16 forward) reach per-token
# int8 quantizations downstream, where one bf16 ulp of an activation near
# its row's absmax is as large as an int8 step and flips roundings.
W8A8_ACTIONS_ATOL = 0.3
# the whole-layer kernel (B6) vs its plain version, bf16 output: it sums
# the attention and RMSNorm2 in another order and takes the card's expf, so
# a bf16 ulp of the context or a float ulp of h2 can flip an int8 rounding
# of the o-projection or MLP input, which moves its row by a fraction of an
# int8 step through one more projection. Every output within four bf16 ulps
# of its row's largest output, at most 10% of the rows with an output more
# than two ulps of its own size away (an H100 read 0.9% of the row maximum
# and 6.1% of the rows at the Qwen2 layer, M=640).
MEGALAYER_ROW_ULPS = 4
MEGALAYER_ROW_SHARE = 0.10
# w8a8 (and weight-only int8) vs bf16 on the same weights, normalized
# actions, max abs over the chunk (the JAX package's forward_error_report
# quantity): a quarter of the [-1, 1] action range. The random flagship
# reads 0.16-0.20 here (PERF.md); beyond 0.5 a quantized tier no longer
# serves the same policy.
QUANTIZED_VS_BF16_LIMIT = 0.5

INSTRUCTION = "put both the alphabet soup and the tomato sauce in the basket"
# prompts of other lengths, so that a graph's replays see other prompt
# lengths (and other images) than the request it was captured at
GRAPH_INSTRUCTIONS = (INSTRUCTION, "pick up the black bowl",
                      "open the top drawer and put the bowl inside")

# Kernels per profiled B=1 request before the activation quantization
# moved inside kernel B4 (PERF.md: measured on an NVIDIA H100 80GB HBM3 at
# 700 W): each w8a8 tier must launch at least KERNELS_SAVED fewer (~10
# eager launches of quantize_rows per w8a8 matmul).
KERNELS_PER_REQUEST_BEFORE = {"w8a8 fused": 7807, "w8a8 dense": 9723,
                           "w8a8 mega": 7279}
KERNELS_SAVED = 3000
# A write of this many bytes evicts the 50 MB L2 between timed calls.
L2_FLUSH_BYTES = 64 << 20


def numpy_quantize_kernel(kernel: np.ndarray):
    """The JAX package's numpy ``quantize_kernel`` (models/quantize.py), the
    reference for the port's on-card weight quantizer: (..., in, out)
    float -> int8 and the float32 per-out-channel scale."""
    k = np.asarray(kernel, np.float32)
    absmax = np.max(np.abs(k), axis=-2, keepdims=True)
    scale = (absmax * np.float32(1.0 / 127.0)).astype(np.float32)
    scale = np.where(scale == 0, 1.0, scale)
    q = np.clip(np.round(k / scale), -127, 127).astype(np.int8)
    return q, np.squeeze(scale, axis=-2)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


def _event_ms(run, rounds: int) -> float:
    import torch

    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Device time of one call: ``reps`` calls captured in a CUDA graph and
    replayed, so host launch overhead leaves no gaps between them; median
    over ``rounds`` replays of CUDA-event time, divided by ``reps``."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    return _event_ms(graph.replay, rounds) / reps


def eager_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Time per call of ``reps`` back-to-back eager calls: the device time
    or the host's launch time, whichever is longer."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()

    return _event_ms(run, rounds) / reps


def kernel_ms(fn, reps: int = 10) -> float:
    """Device time of one call as torch.profiler sees it: the durations of
    every kernel ``reps`` calls launch, summed, over ``reps``. For a call a
    CUDA graph cannot capture (SDPA's masked backward through cuDNN), with
    no host time in it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / reps / 1e3


def device_ms_cold(fn, reps: int = 20, rounds: int = 5) -> float:
    """:func:`device_ms` with L2 flushed before each call: a 64 MB write
    precedes every call in the graph, and the time of the writes alone is
    subtracted. In the forward a weight arrives cold from HBM."""
    import torch

    scratch = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def flushed():
        scratch.fill_(1)
        fn()

    return (device_ms(flushed, reps, rounds)
            - device_ms(lambda: scratch.fill_(1), reps, rounds))


def attention_bound_ms(b, h, hkv, s, d, valid, causal):
    """Least time for one call: max(FLOPs / bf16 peak, bytes / HBM rate).
    FLOPs count the (query, valid key) pairs these inputs need (4 h d per
    pair: q.k and p.v); bytes count q, k, v, o and valid once each."""
    key_ok = valid.astype(np.int64)
    if causal:
        pairs = int(np.cumsum(key_ok, axis=1).sum())
    else:
        pairs = int(s * key_ok.sum())
    flops = 4 * h * d * pairs
    nbytes = 2 * (2 * b * h * s * d + 2 * b * hkv * s * d) + 4 * valid.size
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes"), flops, nbytes


def attention_shapes(cfg, tokenize, batches=(1, 2)):
    """(name, forward batch, batch, heads, kv heads, seq, head dim, key
    valid, causal, launches per forward) for serving forwards of each of
    ``batches``; the towers see 2 images per request."""
    from vla_adapter_torch.data.transform import inference_ids

    _, _, text_valid = inference_ids(cfg, tokenize, INSTRUCTION)
    mm_valid = np.concatenate([text_valid[:1], np.ones(cfg.num_patches,
                                                       np.int32),
                               text_valid[1:]])
    llm, dino, siglip = cfg.llm, cfg.vision.primary, cfg.vision.fused
    n_img = cfg.vision.num_images
    shapes = []
    for b in batches:
        valid = np.tile(mm_valid, (b, 1))
        s_llm = valid.shape[1]
        shapes += [
            ("llm", b, b, llm.num_heads, llm.num_kv_heads, s_llm, llm.head_dim,
             valid, False, llm.num_layers),
            ("llm_causal", b, b, llm.num_heads, llm.num_kv_heads, s_llm,
             llm.head_dim, valid, True, 0),
            ("dinov2", b, b * n_img, dino.num_heads, dino.num_heads,
             dino.num_patches + dino.num_prefix_tokens, dino.head_dim, None,
             False, dino.resolved_feature_layer + 1),
            ("so400m", b, b * n_img, siglip.num_heads, siglip.num_heads,
             siglip.num_patches + siglip.num_prefix_tokens, siglip.head_dim,
             None, False, siglip.resolved_feature_layer + 1),
        ]
    return shapes


def phase_kernel_vs_plain(shapes):
    import torch
    import torch.nn.functional as F

    from vla_adapter_torch.ops.attention_kernel import (
        attention_plan,
        attention_reference,
        fused_attention,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    records = []
    for name, fwd_b, b, h, hkv, s, d, valid_np, causal, per_fwd in shapes:
        plan = attention_plan(b, h, hkv, s, d, sms)
        if plan["branch"] != "one-pass":
            raise AssertionError(f"{name} b={b}: serving shape on the "
                                 f"{plan['branch']} branch: {plan}")
        q = torch.randn(b, h, s, d, generator=gen, device=dev).bfloat16()
        k = torch.randn(b, hkv, s, d, generator=gen, device=dev).bfloat16()
        v = torch.randn(b, hkv, s, d, generator=gen, device=dev).bfloat16()
        valid = (None if valid_np is None
                 else torch.from_numpy(valid_np).to(dev))
        got = fused_attention(q, k, v, valid, causal=causal)
        want = attention_reference(q, k, v, valid, causal=causal)
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"{name} b={b}: kernel output not finite")
        rows = (torch.ones(b, s, dtype=torch.bool, device=dev)
                if valid is None else valid.bool())
        err = float((got.float() - want.float()).abs()
                    .transpose(1, 2)[rows].max())
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"{name} b={b}: kernel vs plain max abs "
                                 f"err {err} > {KERNEL_ATOL}")
        # SDPA yardstick: GQA expanded outside the timed call, the same mask
        kx = k.repeat_interleave(h // hkv, dim=1)
        vx = v.repeat_interleave(h // hkv, dim=1)
        mask = None
        if valid is not None:
            mask = valid.bool()[:, None, None, :]
            if causal:
                mask = mask & torch.ones(s, s, dtype=torch.bool,
                                         device=dev).tril()
        def kernel():
            fused_attention(q, k, v, valid, causal=causal)

        ms = device_ms(kernel)
        host_ms = eager_ms(kernel)
        plain_ms = device_ms(lambda: attention_reference(
            q, k, v, valid, causal=causal), reps=5)
        lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
            q, kx, vx, attn_mask=mask))
        key_valid = (np.ones((b, s), np.int32) if valid_np is None
                     else valid_np)
        bound, bound_by, flops, nbytes = attention_bound_ms(
            b, h, hkv, s, d, key_valid, causal)
        rec = {"shape": name, "forward_batch": fwd_b, "batch": b,
               "heads": h, "kv_heads": hkv,
               "seq": s, "head_dim": d, "causal": causal,
               "launches_per_forward": per_fwd,
               "max_abs_err": err, "ms": ms, "eager_ms": host_ms,
               "plain_ms": plain_ms,
               "sdpa_ms": lib_ms, "bound_ms": bound, "bound_by": bound_by,
               "flops": flops, "bytes": nbytes, "plan": plan}
        print("attention_shape " + json.dumps(rec), flush=True)
        records.append(rec)
    return records


def attention_bwd_shapes(cfg, batch: int, seed: int):
    """(name, batch, heads, kv heads, seq, head dim, key valid, causal,
    calls per micro-batch) of the backward at the flagship finetune's
    micro-batch: the LLM with the dummy batch's key padding, the towers
    (2 images per sample), and three checks off the main path: the LLM
    shape causal, GQA at a sequence not a multiple of 16 whose first row
    has no valid key, and the LLM's heads at S = 4000 (no per-row storage,
    so no length limit), batch 1 with its last 500 keys padded."""
    from vla_adapter_torch.data.dummy import make_dummy_batch

    tv = make_dummy_batch(cfg, batch, np.random.default_rng(seed))[
        "text_valid"]
    mm_valid = np.concatenate([tv[:, :1], np.ones((batch, cfg.num_patches),
                                                  np.int32), tv[:, 1:]], 1)
    llm, dino, siglip = cfg.llm, cfg.vision.primary, cfg.vision.fused
    n_img = cfg.vision.num_images
    s_llm = mm_valid.shape[1]
    odd = np.ones((2, 37), np.int32)
    odd[0, :5] = 0
    odd[0, 30:] = 0
    long = np.ones((1, 4000), np.int32)
    long[0, 3500:] = 0
    return [
        ("llm", batch, llm.num_heads, llm.num_kv_heads, s_llm, llm.head_dim,
         mm_valid, False, llm.num_layers),
        ("dinov2", batch * n_img, dino.num_heads, dino.num_heads,
         dino.num_patches + dino.num_prefix_tokens, dino.head_dim, None,
         False, dino.resolved_feature_layer + 1),
        ("so400m", batch * n_img, siglip.num_heads, siglip.num_heads,
         siglip.num_patches + siglip.num_prefix_tokens, siglip.head_dim,
         None, False, siglip.resolved_feature_layer + 1),
        ("llm_causal", batch, llm.num_heads, llm.num_kv_heads, s_llm,
         llm.head_dim, mm_valid, True, 0),
        ("gqa_s37_d72", 2, 14, 2, 37, 72, odd, False, 0),
        ("llm_s4000", 1, llm.num_heads, llm.num_kv_heads, 4000, llm.head_dim,
         long, False, 0),
    ]


def attention_bwd_bound_ms(b, h, hkv, s, d, valid, causal):
    """Least time for one backward: five products of 2 h d operations per
    (query, valid key) pair (the recomputed q.k, dv, dp, dq, dk) at the
    bf16 peak, or q, k, v, dO read and dq, dk, dv written once at the HBM
    rate, whichever is longer."""
    key_ok = valid.astype(np.int64)
    pairs = (int(np.cumsum(key_ok, axis=1).sum()) if causal
             else int(s * key_ok.sum()))
    flops = 10 * h * d * pairs
    nbytes = 2 * (3 * b * h * s * d + 4 * b * hkv * s * d) + 4 * valid.size
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes"), flops, nbytes


def phase_attention_bwd(shapes, card: str):
    """B1-bwd against its plain version at each shape: the plan, the
    relative error of dq, dk, dv, a rerun bit for bit, and the times of the
    kernel (its three launches together, and each alone on the row
    statistics of an earlier call), the plain version, SDPA's backward (the
    yardstick, GQA expanded before the call; the port never calls it: its
    kernels' device time, and eagerly, host launches included) and the
    bound; B1's forward with and without its lse output beside it."""
    import torch
    import torch.nn.functional as F

    from vla_adapter_torch.ops import cuda_lib
    from vla_adapter_torch.ops.attention_kernel import (
        BWD_KERNELS,
        attention_bwd,
        attention_bwd_plan,
        attention_bwd_reference,
        fused_attention,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    records = []
    for name, b, h, hkv, s, d, valid_np, causal, per_step in shapes:
        plan = attention_bwd_plan(b, h, hkv, s, d, cuda_lib.sm_count(dev))
        print(f"attention_bwd plan {name}: {json.dumps(plan)}", flush=True)

        def randn(*shape):
            return torch.randn(*shape, generator=gen, device=dev).bfloat16()

        # the model's layout: (B, S, H, D) buffers seen as (B, H, S, D)
        q, dout = (randn(b, s, h, d).transpose(1, 2) for _ in range(2))
        k, v = (randn(b, s, hkv, d).transpose(1, 2) for _ in range(2))
        valid = (None if valid_np is None
                 else torch.from_numpy(valid_np).to(dev))
        got = attention_bwd(q, k, v, valid, dout, causal=causal)
        again = attention_bwd(q, k, v, valid, dout, causal=causal)
        want = attention_bwd_reference(q, k, v, valid, dout, causal=causal)
        torch.cuda.synchronize()
        errs = {}
        for gname, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
            if not torch.isfinite(g.float()).all():
                raise AssertionError(f"attention_bwd {name}: {gname} not "
                                     f"finite")
            if not torch.equal(g, a):
                raise AssertionError(f"attention_bwd {name}: {gname} "
                                     f"differs between two runs")
            scale = float(w.float().abs().max())
            errs[gname] = float((g.float() - w.float()).abs().max()) / max(
                scale, 1e-30)
            if not errs[gname] <= ATTENTION_BWD_RTOL:
                raise AssertionError(
                    f"attention_bwd {name}: {gname} max |kernel - plain| / "
                    f"max |plain| = {errs[gname]} > {ATTENTION_BWD_RTOL}")
        # the training path's call: the forward's lse given
        lse = fused_attention(q, k, v, valid, causal=causal,
                              return_lse=True)[1]
        stats = torch.empty((2, b, h, -(-s // 64) * 64), dtype=torch.float32,
                            device=dev)
        ms = device_ms(lambda: attention_bwd(q, k, v, valid, dout,
                                             causal=causal, lse=lse,
                                             stats=stats))
        split_ms = {kn: device_ms(lambda kn=kn: attention_bwd(
            q, k, v, valid, dout, causal=causal, lse=lse, stats=stats,
            kernels=(kn,))) for kn in BWD_KERNELS}
        fwd_ms = device_ms(lambda: fused_attention(q, k, v, valid,
                                                   causal=causal))
        fwd_lse_ms = device_ms(lambda: fused_attention(
            q, k, v, valid, causal=causal, return_lse=True))
        plain_ms = eager_ms(lambda: attention_bwd_reference(
            q, k, v, valid, dout, causal=causal), reps=3, rounds=3)
        # SDPA's backward: forward once outside the timed calls
        qx = q.detach().requires_grad_(True)
        kx = k.repeat_interleave(h // hkv, dim=1).detach().requires_grad_(True)
        vx = v.repeat_interleave(h // hkv, dim=1).detach().requires_grad_(True)
        mask = None
        if valid is not None:
            mask = valid.bool()[:, None, None, :]
        if causal:
            tril = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
            mask = tril if mask is None else mask & tril
        out = F.scaled_dot_product_attention(qx, kx, vx, attn_mask=mask)

        def sdpa_bwd():
            return torch.autograd.grad(out, (qx, kx, vx), dout,
                                       retain_graph=True)

        lib_ms = kernel_ms(sdpa_bwd)
        lib_eager_ms = eager_ms(sdpa_bwd, reps=5, rounds=3)
        key_valid = (np.ones((b, s), np.int32) if valid_np is None
                     else valid_np)
        bound, bound_by, flops, nbytes = attention_bwd_bound_ms(
            b, h, hkv, s, d, key_valid, causal)
        rec = {"card": card, "shape": name, "batch": b, "heads": h,
               "kv_heads": hkv, "seq": s, "head_dim": d, "causal": causal,
               "calls_per_micro_batch": per_step, "rel_err": errs,
               "max_abs_err": max(float((g.float() - w.float()).abs().max())
                                  for g, w in zip(got, want)),
               "deterministic": True, "ms": ms, "split_ms": split_ms,
               "fwd_ms": fwd_ms, "fwd_lse_ms": fwd_lse_ms,
               "plain_ms": plain_ms, "sdpa_bwd_ms": lib_ms,
               "sdpa_bwd_eager_ms": lib_eager_ms,
               "ratio_to_sdpa_bwd": ms / lib_ms, "bound_ms": bound,
               "bound_by": bound_by, "flops": flops, "bytes": nbytes,
               "plan": plan}
        print("attention_bwd_shape " + json.dumps(rec), flush=True)
        records.append(rec)
    return records


def ste_shapes(cfg, batch: int):
    """Distinct (M, in, out) of the frozen base's w8a8 matmuls at the
    finetune's micro-batch (the towers see 2 images per sample)."""
    from vla_adapter_torch.core.config import TrainConfig
    from vla_adapter_torch.models.vla import VLAModel
    from vla_adapter_torch.train.loop import build_runtime

    rt = build_runtime(TrainConfig(model=cfg, base_int8=True))
    model = VLAModel(cfg, rt, device="meta")
    v, n_img = cfg.vision, cfg.vision.num_images
    rows = {"featurizer": batch * n_img * (v.primary.num_patches
                                           + v.primary.num_prefix_tokens),
            "language_model": batch * (cfg.num_patches + cfg.max_text_tokens),
            "projector": batch * cfg.num_patches}
    if v.fused is not None:
        rows["fused_featurizer"] = batch * n_img * (
            v.fused.num_patches + v.fused.num_prefix_tokens)
    shapes = set()
    for name, mod in model.named_modules():
        if getattr(mod, "ste", False):
            owner = next(o for o in ("fused_featurizer", "featurizer",
                                     "language_model", "projector")
                         if o in name.split("."))
            shapes.add((owner, rows[owner], mod.in_features, mod.features))
    return sorted(shapes)


def phase_ste(shapes, card: str):
    """The straight-through w8a8 product on the card (kernel B4 forward,
    and B4 on the transposed int8 weight for dx) against its plain version
    at the frozen base's shapes: forward and dx bit for bit; the backward
    timed (eager, one B4 launch and two elementwise passes)."""
    import torch

    from vla_adapter_torch.models.layers import W8A8STE

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    records = []
    for owner, m, k, n in shapes:
        x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
        dy = torch.randn(m, n, generator=gen, device=dev).bfloat16()
        wq = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                           dtype=torch.int8)
        ws = torch.rand(n, generator=gen, device=dev) * 0.01 + 1e-3
        wqt = wq.t().contiguous()
        got, want = [], []
        for kernels, out in (("kernel", got), ("plain", want)):
            xr = x.detach().requires_grad_(True)
            y = W8A8STE.apply(xr, wq, ws, wqt, kernels)
            (dx,) = torch.autograd.grad(y, xr, dy)
            out += [y, dx]
        torch.cuda.synchronize()
        for what, g, w in zip(("forward", "dx"), got, want):
            if not (torch.isfinite(g.float()).all() and torch.equal(g, w)):
                raise AssertionError(
                    f"STE {owner} ({m}, {k}->{n}) {what}: kernel differs from "
                    f"plain by {float((g.float() - w.float()).abs().max())}")

        def backward(kernels):
            xr = x.detach().requires_grad_(True)
            y = W8A8STE.apply(xr, wq, ws, wqt, kernels)
            return lambda: torch.autograd.grad(y, xr, dy, retain_graph=True)

        rec = {"card": card, "shape": owner, "m": m, "in": k, "out": n,
               "forward_bitwise": True, "dx_bitwise": True,
               "dx_ms": eager_ms(backward("kernel"), reps=5, rounds=3),
               "dx_plain_ms": eager_ms(backward("plain"), reps=2, rounds=2)}
        print("ste_shape " + json.dumps(rec), flush=True)
        records.append(rec)
    return records


def expected_train_launches(model) -> dict:
    """Kernel launches per micro-batch of the finetune, from the training
    model: B1 on every attention layer, twice where its stack ("vit",
    "llm") recomputes; B1-bwd's three kernels once per attention layer; B4
    once per frozen w8a8 matmul in the forward, again where it recomputes,
    and once more for dx, except where no gradient reaches the matmul's
    input (the first tower block's q/k/v read the patch embeddings, which
    train nothing)."""
    from vla_adapter_torch.models.qwen2 import Qwen2Attention
    from vla_adapter_torch.models.vit import ViTAttention, ViTBlock
    from vla_adapter_torch.ops import w8a8_matmul
    from vla_adapter_torch.ops.attention_kernel import (
        BWD_KERNEL_NAME,
        BWD_LAUNCHES_PER_CALL,
        KERNEL_NAME,
    )

    rt = model.rt
    attn = b4 = 0
    for name, mod in model.named_modules():
        stack = ("llm" if name.startswith("language_model") else
                 "vit" if name.startswith("vision_backbone") else None)
        twice = 2 if stack and rt.remat_policy_of(stack) else 1
        if isinstance(mod, (Qwen2Attention, ViTAttention)):
            attn += twice
        if getattr(mod, "ste", False):
            b4 += twice + 1
    for tower in model.vision_backbone.children():
        block0 = tower.blocks[0]
        assert isinstance(block0, ViTBlock)
        b4 -= sum(p.ste for p in (block0.attn.q_proj, block0.attn.k_proj,
                                  block0.attn.v_proj))
    layers = sum(isinstance(m, (Qwen2Attention, ViTAttention))
                 for m in model.modules())
    return {KERNEL_NAME: attn,
            BWD_KERNEL_NAME: BWD_LAUNCHES_PER_CALL * layers,
            w8a8_matmul.KERNEL_NAME: b4}


def _check_train_launches(launches, per_micro, micro_batches, what):
    want = {k: v * micro_batches for k, v in per_micro.items()}
    got = {k: launches.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, derived {want}")
    extra = {k: v for k, v in launches.items() if k not in want and v}
    if extra:
        raise AssertionError(f"{what}: other kernels launched: {extra}")


# kernel path vs plain path, one finetune step of the flagship from the
# same weights, batch and noise. The loss is held to 0.5%, five times the
# 0.09% read on an H100. The VLM's gradients (LoRA pairs of the LLM and
# both towers, the projector) are taken under one upstream gradient, a
# seeded normal draw at the head's input (the hidden states it reads), so
# that the random-init 24-block head is out of their loop; each must reach
# a cosine of VLM_GRAD_COSINE with the plain path's. On an H100 they read
# 0.9969-0.9989; with the kernel path's attention backward missing the
# softmax's rowsum(dp * p) term (tests/torch_faults.py) the lowest read
# 0.40, with it missing the GQA sum 0.59, and the check failed. The
# head's own gradients pass through no kernel (its attention is plain, its
# matmuls float); they see the kernels only through the head's input, and
# in bf16 they are dominated by rounding: on an H100 the plain path
# against itself with its pixels scaled by 1 + 2^-8 (one bf16 ulp) read a
# cosine of 0.23 for block 0's q_proj. They are held only to that spread:
# the plain path's own cosine under the perturbation, less
# HEAD_GRAD_COSINE_MARGIN.
TRAIN_LOSS_RTOL = 5e-3
VLM_GRAD_COSINE = 0.99
HEAD_GRAD_COSINE_MARGIN = 0.1
PIXEL_PERTURBATION = 1.0 + 2.0 ** -8


def train_config(seed: int):
    """The flagship recipe's TrainConfig at micro-batch 16, 10 steps,
    a checkpoint every 5."""
    from vla_adapter_torch.core.experiments import get_experiment

    tcfg = get_experiment("vla-adapter+libero-spatial").to_train_config()
    return dataclasses.replace(
        tcfg, batch_size=16, save_freq=5, log_freq=100, seed=seed,
        optim=dataclasses.replace(tcfg.optim, max_steps=10))


HEAD_GRAD_NAMES = ("action_head.blocks.0.q_proj.weight",
                   "action_head.fc_in.weight")
VLM_GRAD_NAMES = (
    "language_model.layers.0.self_attn.q_proj.lora_a",
    "language_model.layers.0.self_attn.q_proj.lora_b",
    "language_model.layers.23.mlp.down_proj.lora_b",
    "projector.fc1.lora_b",
    *(f"vision_backbone.featurizer.blocks.{i}.mlp.fc1.lora_b"
      for i in (1, 11, 21)),
    *(f"vision_backbone.fused_featurizer.blocks.{i}.attn.v_proj.lora_b"
      for i in (1, 12, 25)))


def kernel_vs_plain_step(tcfg, init, batch, dev, head_names=HEAD_GRAD_NAMES,
                         vlm_names=VLM_GRAD_NAMES) -> dict:
    """The first step's loss and gradients through the kernels, through
    their plain versions, and through the plain versions with the input
    pixels scaled by ``PIXEL_PERTURBATION``, from the same weights
    (``init``) and noise: ``head_names`` from the loss, ``vlm_names``
    from one seeded upstream gradient at the head's input. Returns the
    losses, and each gradient's max |kernel - plain| over max |plain| and
    cosines kernel/plain and perturbed/plain (1 where both are zero: a
    lora_a's gradient at the first step, its lora_b being 0)."""
    import torch

    from vla_adapter_torch.models.layers import prepare_ste_
    from vla_adapter_torch.models.vla import VLAModel
    from vla_adapter_torch.train import step as tstep
    from vla_adapter_torch.train.loop import build_runtime
    from vla_adapter_torch.train.partition import mark_trainable_

    grads, loss, upstream = {}, {}, None
    for path, kernels, scale in (("plain", "plain", 1.0),
                                 ("kernel", "kernel", 1.0),
                                 ("perturbed", "plain", PIXEL_PERTURBATION)):
        device_batch = tstep.to_device(batch, dev)
        device_batch["pixel_values"] = device_batch["pixel_values"] * scale
        m = VLAModel(tcfg.model, build_runtime(tcfg, kernels), device="meta")
        m.load_state_dict(init, strict=True, assign=True)
        mark_trainable_(m, tcfg.lora.enabled)
        prepare_ste_(m)
        params = dict(m.named_parameters())
        out = m(**{k: device_batch[k] for k in tstep.MODEL_INPUTS
                   if k in device_batch}, train=True,
                generator=tstep.noise_generator(tcfg.seed, 0, 0, dev),
                return_hidden_states=True)
        lval = tstep.l1_action_loss(out["actions"],
                                    device_batch["actions"])[0]
        hidden = out["hidden_states"]
        if upstream is None:
            upstream = torch.randn(hidden.shape, device=dev, generator=(
                torch.Generator(device=dev).manual_seed(tcfg.seed)))
        gs = torch.autograd.grad(lval, [params[n] for n in head_names],
                                 retain_graph=True)
        gs += torch.autograd.grad((hidden.float() * upstream).sum(),
                                  [params[n] for n in vlm_names])
        loss[path] = lval.item()
        grads[path] = {n: g.float() for n, g in
                       zip(head_names + vlm_names, gs)}
        del m, params, out, lval, hidden, gs
        torch.cuda.empty_cache()

    def cosine(g, w):
        if not (g.any() or w.any()):
            return 1.0
        return float((g * w).sum() / (g.norm() * w.norm()).clamp_min(1e-30))

    out = {"loss": loss, "head_grads": list(head_names),
           "vlm_grads": list(vlm_names), "grad_rel_err": {},
           "grad_cosine": {}, "grad_cosine_perturbed": {}}
    for n in head_names + vlm_names:
        g, w = grads["kernel"][n], grads["plain"][n]
        out["grad_rel_err"][n] = float((g - w).abs().max()) / max(
            float(w.abs().max()), 1e-30)
        out["grad_cosine"][n] = cosine(g, w)
        out["grad_cosine_perturbed"][n] = cosine(grads["perturbed"][n], w)
    return out


def check_kernel_vs_plain(rec) -> None:
    loss = rec["loss"]
    if abs(loss["kernel"] - loss["plain"]) > TRAIN_LOSS_RTOL * abs(
            loss["plain"]):
        raise AssertionError(f"kernel vs plain loss: {loss}")
    cos = rec["grad_cosine"]
    for n in rec["vlm_grads"]:
        if not cos[n] >= VLM_GRAD_COSINE:
            raise AssertionError(f"kernel vs plain gradient of {n} under "
                                 f"the upstream at the head's input: "
                                 f"cosine {cos[n]} < {VLM_GRAD_COSINE}")
    for n in rec["head_grads"]:
        floor = rec["grad_cosine_perturbed"][n] - HEAD_GRAD_COSINE_MARGIN
        if not cos[n] >= floor:
            raise AssertionError(f"kernel vs plain gradient of {n}: cosine "
                                 f"{cos[n]} < {floor}")


# device time of one finetune step by kernel, in the groups PERF.md reads
TRAIN_PROFILE_GROUPS = (
    ("B1-bwd D", ("attn_bwd_rows_kernel<", ", true>")),
    ("B1-bwd dq", ("attn_bwd_rows_kernel<", ", false>")),
    ("B1-bwd dk/dv", ("attn_bwd_dkdv_kernel",)),
    ("B1", ("fused_attention_kernel",)),
    ("B4 dx", ("w8a8_", "<float")),
    ("B4 forward", ("w8a8_",)),
    ("GEMMs (LoRA, head, float products)", ("gemm",)),
    ("GEMMs (LoRA, head, float products)", ("nvjet",)),
    ("GEMMs (LoRA, head, float products)", ("cutlass",)),
    ("optimizer", ("multi_tensor",)),
    ("elementwise and reductions", ("elementwise",)),
    ("elementwise and reductions", ("reduce",)),
)


class ProfiledStep:
    """An endless iterator over one batch that profiles one finetune step
    (torch.profiler, CUDA activity): started at the fetch of step
    ``step``'s batch and stopped at the next fetch, each after a device
    sync, so the window holds that step's device work. ``summary`` then
    holds the device ms by kernel group and the largest kernels."""

    def __init__(self, batch, step: int):
        self.batch, self.step, self.fetches = batch, step, 0
        self.prof, self.summary = None, None

    def __iter__(self):
        return self

    def __next__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        fetch, self.fetches = self.fetches, self.fetches + 1
        if fetch == self.step:
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        elif fetch == self.step + 1 and self.prof is not None:
            torch.cuda.synchronize()
            self.prof.__exit__(None, None, None)
            self.summary = self._summarize()
        return self.batch

    def _summarize(self):
        from torch.autograd import DeviceType

        by_name = collections.Counter()
        for e in self.prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] += e.time_range.elapsed_us() / 1e3
        groups = collections.Counter()
        for name, ms in by_name.items():
            low = name.lower()
            group = next((g for g, keys in TRAIN_PROFILE_GROUPS
                          if all(k.lower() in low for k in keys)), "other")
            groups[group] += ms
        return {"step_index": self.step,
                "device_busy_ms": sum(by_name.values()),
                "kernels": len(by_name), "by_group_ms": dict(groups),
                "top": [[n[:90], ms] for n, ms in by_name.most_common(15)]}


def _train_run(tcfg, batch, steps, root, data_iter=None, **kw):
    """finetune over one repeated batch (or ``data_iter``), launches
    counted around it."""
    import itertools

    import torch

    from vla_adapter_torch.ops import cuda_lib
    from vla_adapter_torch.train.loop import finetune

    tcfg = dataclasses.replace(tcfg, run_root_dir=str(root))
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state = finetune(tcfg, data_iter=data_iter or itertools.repeat(batch),
                     max_steps=steps, device="cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
    memory = {"max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
              "resident_before_bytes": resident}
    return state, launches, wall, memory


def phase_train(cfg, card: str, seed: int, profile: bool = False):
    """The finetune path on the flagship (phase 11; see the module
    docstring); with ``profile``, the main run's third step under
    torch.profiler. Returns (record, launches of the main run, B1-bwd
    records)."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from vla_adapter_torch.data.dummy import make_dummy_batch
    from vla_adapter_torch.data.normalization import dataset_statistics
    from vla_adapter_torch.data.tokenization import MockTokenizer
    from vla_adapter_torch.infer.predict import Predictor
    from vla_adapter_torch.models.layers import Runtime
    from vla_adapter_torch.models.vla import VLAModel
    from vla_adapter_torch.train.checkpoints import (
        find_resume_checkpoint,
        load_params,
    )
    from vla_adapter_torch.train.loop import build_runtime, initial_state
    from vla_adapter_torch.train.partition import mark_trainable_
    from vla_adapter_torch.weights.export import export_checkpoint_dir
    from vla_adapter_torch.weights.load import load_vla
    from vla_adapter_torch.weights.merge import merge_checkpoint

    dev = "cuda"
    tcfg = train_config(seed)
    batch_size = tcfg.batch_size
    if tcfg.model != cfg:
        raise AssertionError("the recipe does not train VLAConfig()")
    batch = make_dummy_batch(cfg, batch_size, np.random.default_rng(seed))
    rec = {"card": card, "batch_size": batch_size, "seconds": {}}
    t_last = [time.perf_counter()]

    def lap(name):  # wall seconds of each step group of the phase
        now = time.perf_counter()
        rec["seconds"][name], t_last[0] = now - t_last[0], now

    # 1. B1-bwd against plain at the training shapes
    bwd_records = phase_attention_bwd(
        attention_bwd_shapes(cfg, batch_size, seed), card)
    # 2. the STE product
    lap("1 attention_bwd")
    rec["ste"] = phase_ste(ste_shapes(cfg, batch_size), card)
    lap("2 ste")

    root = Path(tempfile.mkdtemp(prefix="vla_train_"))
    try:
        # 3. the flagship finetune over the int8 base: the main path
        rt = build_runtime(tcfg)
        model = VLAModel(cfg, rt, device="meta")
        per_micro = expected_train_launches(model)
        init = initial_state(tcfg, rt, dev)
        trainable_names = set(mark_trainable_(model, tcfg.lora.enabled))
        profiled = ProfiledStep(batch, 2) if profile else None
        state, launches, wall, memory = _train_run(
            tcfg, batch, 10, root / "main", data_iter=profiled, rt=rt)
        if profiled is not None:
            if profiled.summary is None:
                raise AssertionError("the profiled finetune step never ran")
            rec["profile"] = dict(profiled.summary, card=card)
            print("train_profile " + json.dumps(rec["profile"]), flush=True)
        losses = [h["loss"] for h in state.history]
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"finetune losses {losses}")
        _check_train_launches(launches, per_micro, 10, "finetune")
        final = state.model.state_dict()
        changed = [k for k, v in init.items()
                   if k not in trainable_names and not torch.equal(final[k], v)]
        still = [k for k in trainable_names if torch.equal(final[k], init[k])]
        if changed or still:
            raise AssertionError(f"frozen tensors changed: {changed[:5]}; "
                                 f"trainable tensors that did not move: "
                                 f"{still[:5]}")
        ste_bytes = sum(m.weight_qt.numel() for m in state.model.modules()
                        if getattr(m, "ste", False))
        step_s = statistics.median(h["step_time"] for h in state.history[2:])
        main = {"losses": losses, "median_s_per_step_3_10": step_s,
                "samples_per_s": batch_size / step_s, "wall_s": wall,
                **memory,
                "launches": launches, "launches_per_step_derived": per_micro,
                "trainable_tensors": len(trainable_names),
                "trainable_params": sum(init[k].numel()
                                        for k in trainable_names),
                "transposed_int8_copy_bytes": ste_bytes,
                "frozen_unchanged": True, "trainable_moved": True}
        print("train_main " + json.dumps(dict(main, card=card)), flush=True)
        rec["main"] = main
        main_losses = losses
        del state, final
        shutil.rmtree(root / "main")
        torch.cuda.empty_cache()

        lap("3 finetune")

        # 4. kernel against plain, one step's loss and named grads
        step4 = kernel_vs_plain_step(tcfg, init, batch, dev)
        print("train_kernel_vs_plain " + json.dumps(dict(step4, card=card)),
              flush=True)
        check_kernel_vs_plain(step4)
        rec["kernel_vs_plain"] = step4
        lap("4 kernel_vs_plain")

        # 5. accumulation: 2 micro-batches, bf16 carry and moments
        acfg = dataclasses.replace(
            tcfg, grad_accumulation_steps=2, accum_dtype="bfloat16",
            optim=dataclasses.replace(tcfg.optim, moments_dtype="bfloat16"))
        abatch = make_dummy_batch(cfg, batch_size,
                                  np.random.default_rng(seed), accum_steps=2)
        state, launches, wall, _ = _train_run(acfg, abatch, 3,
                                              root / "accum")
        alosses = [h["loss"] for h in state.history]
        if not np.isfinite(alosses).all():
            raise AssertionError(f"accumulation losses {alosses}")
        _check_train_launches(launches, per_micro, 6, "accumulation")
        mu = next(iter(state.opt_state["mu"].values()))
        if mu.dtype != torch.bfloat16:
            raise AssertionError(f"moments stored in {mu.dtype}")
        rec["accumulation"] = {"losses": alosses, "launches": launches,
                               "wall_s": wall}
        print("train_accumulation " + json.dumps(dict(rec["accumulation"],
                                                     card=card)), flush=True)
        del state
        shutil.rmtree(root / "accum")
        torch.cuda.empty_cache()

        lap("5 accumulation")

        # 6. resume: 5 steps, then on to 10 from the step-5 checkpoint
        _train_run(tcfg, batch, 5, root / "resume")
        ckpt = find_resume_checkpoint(root / "resume" / tcfg.run_id)
        meta = json.loads((ckpt / "meta.json").read_text())
        state = _train_run(tcfg, batch, 10, root / "resume",
                           resume=True)[0]
        steps = [h["step"] for h in state.history]
        rlosses = [h["loss"] for h in state.history]
        if meta != {"step": 5} or steps != list(range(5, 10)):
            raise AssertionError(f"resume: checkpoint {meta}, steps {steps}")
        if rlosses != main_losses[5:]:
            raise AssertionError(f"resumed losses {rlosses} != the unbroken "
                                 f"run's {main_losses[5:]}")
        rec["resume"] = {"checkpoint_meta": meta, "losses": rlosses,
                         "bitwise_equal_to_unbroken": True}
        print("train_resume " + json.dumps(dict(rec["resume"], card=card)),
              flush=True)
        del state
        shutil.rmtree(root / "resume")
        torch.cuda.empty_cache()

        lap("6 resume")

        # 7. train -> merge -> export -> load_vla -> Predictor, float base
        fcfg = dataclasses.replace(tcfg, base_int8=False)
        state = _train_run(fcfg, batch, 3, root / "float")[0]
        trained = {k: v.detach().clone() for k, v in
                   state.model.state_dict().items()}
        del state
        torch.cuda.empty_cache()
        ckpt = find_resume_checkpoint(root / "float" / fcfg.run_id)
        merged = load_params(merge_checkpoint(ckpt, root / "merged",
                                              fcfg.lora.scale, device=dev))
        srng = np.random.default_rng(seed)
        stats = {"libero_spatial": dataset_statistics(
            srng.uniform(-1, 1, size=(1000, 7)),
            proprio=srng.normal(size=(1000, 8)),
            action_mask=[True] * 6 + [False])}
        export_checkpoint_dir(merged, cfg, root / "export", norm_stats=stats)
        del merged
        tok = MockTokenizer()
        tokenize = lambda t: tok(t).input_ids  # noqa: E731
        served = load_vla(root / "export", tokenize=tokenize,
                          center_crop=False, device=dev)
        lora_rt = Runtime(dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                          lora_rank=fcfg.lora.rank,
                          lora_scale=fcfg.lora.scale)
        lora_pred = Predictor(cfg=cfg, params=trained, tokenize=tokenize,
                              norm_stats=stats, rt=lora_rt, center_crop=False,
                              device=dev, cuda_graph=False)
        rows = [served.preprocess(im, INSTRUCTION, p)
                for im, p in _requests(cfg, srng, 4)]
        got = served.normalized_actions(rows)
        want = lora_pred.normalized_actions(rows)
        diff = float(np.abs(got - want).max())
        if not (served.cuda_graph and np.isfinite(got).all()
                and got.shape == (4, cfg.constants.num_actions_chunk,
                                  cfg.constants.action_dim)
                and diff <= FLAGSHIP_ACTIONS_ATOL):
            raise AssertionError(f"merged model serves actions {diff} from "
                                 f"the trained LoRA model's")
        rec["merge_serve"] = {"max_abs_diff_normalized": diff,
                              "cuda_graph": served.cuda_graph}
        print("train_merge_serve " + json.dumps(dict(rec["merge_serve"],
                                                    card=card)), flush=True)
        del served, lora_pred, trained, init
        torch.cuda.empty_cache()
        lap("7 merge_serve")
        print("train_seconds " + json.dumps(rec["seconds"]), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return rec, rec["main"]["launches"], bwd_records


def attention_bwd_kernel_summary(records, launches):
    """B1-bwd's entry: per-call times and bounds of phase 11 summed over
    the calls of one micro-batch of 16 (24 LLM + 23 DINOv2 + 26 so400m
    calls, three kernel launches each), with each kernel's share."""
    from vla_adapter_torch.ops.attention_kernel import (
        BWD_KERNEL_NAME,
        BWD_KERNELS,
        BWD_LAUNCHES_PER_CALL,
    )

    main = [r for r in records if r["calls_per_micro_batch"]]

    def total(key):
        return sum(r[key] * r["calls_per_micro_batch"] for r in main)

    ops = sum(r["flops"] * r["calls_per_micro_batch"] for r in main)
    nbytes = sum(r["bytes"] * r["calls_per_micro_batch"] for r in main)
    t_ops, t_bytes = ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return [{
        "name": BWD_KERNEL_NAME, "route": "cuda",
        "source": "vla_adapter_torch/csrc/attention_bwd.cu",
        "replaces": "vla_adapter_tpu/ops/attention.py:100",
        "launches": launches.get(BWD_KERNEL_NAME, 0),
        "max_abs_err": max(r["max_abs_err"] for r in records),
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": total("sdpa_bwd_ms"),
        "split_ms": {kn: sum(r["split_ms"][kn] * r["calls_per_micro_batch"]
                             for r in main) for kn in BWD_KERNELS},
        "library_eager_ms": total("sdpa_bwd_eager_ms"),
        "per": f"sum over the {sum(r['calls_per_micro_batch'] for r in main)}"
               f" calls ({BWD_LAUNCHES_PER_CALL} kernel launches each) of one "
               "micro-batch of 16 (SDPA's backward on k and v expanded to "
               "every query head: its kernels' device time, and eager)",
    }]


def build_flagship(seed: int):
    import torch

    from vla_adapter_torch.core.config import VLAConfig
    from vla_adapter_torch.data.normalization import dataset_statistics
    from vla_adapter_torch.data.tokenization import MockTokenizer
    from vla_adapter_torch.infer.predict import SERVING_RUNTIME, Predictor
    from vla_adapter_torch.models.layers import init_random_
    from vla_adapter_torch.models.vla import VLAModel

    cfg = VLAConfig()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = init_random_(VLAModel(cfg, SERVING_RUNTIME, device="cuda"), gen)
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(seed)
    stats = {"libero_spatial": dataset_statistics(
        rng.uniform(-1, 1, size=(1000, 7)), proprio=rng.normal(size=(1000, 8)),
        action_mask=[True] * 6 + [False])}
    tok = MockTokenizer()
    predictor = Predictor(cfg=cfg, params=model.state_dict(),
                          tokenize=lambda t: tok(t).input_ids,
                          norm_stats=stats, center_crop=False, device="cuda")
    return cfg, predictor, n_params, rng


def phase_flagship(predictor, rng, card: str):
    import torch

    from vla_adapter_torch.ops import cuda_lib

    cfg = predictor.cfg
    size = cfg.vision.primary.image_size

    def request():
        images = [rng.integers(0, 256, size=(size, size, 3), dtype=np.uint8)
                  for _ in range(cfg.vision.num_images)]
        return images, rng.normal(size=cfg.constants.proprio_dim)

    requests = [request() for _ in range(11)]
    batch = [request() for _ in range(4)]
    per_forward = (cfg.llm.num_layers
                   + cfg.vision.primary.resolved_feature_layer + 1
                   + cfg.vision.fused.resolved_feature_layer + 1)

    # --- the main path: launch counts around exactly these requests ---
    cuda_lib.reset_launches()
    chunk_s, outs = [], []
    for images, proprio in requests:
        t0 = time.perf_counter()
        outs.append(predictor.predict_action(images, INSTRUCTION, proprio))
        chunk_s.append(time.perf_counter() - t0)
    batch_s = []  # the first batch pays its one-time set-up (the capture)
    for _ in range(2):
        t0 = time.perf_counter()
        out_b = predictor.predict_action_batch(
            [im for im, _ in batch], [INSTRUCTION] * 4, [p for _, p in batch])
        batch_s.append(time.perf_counter() - t0)
    launches = dict(cuda_lib.LAUNCHES)
    forwards = len(requests) + 2

    for a in outs:
        if a.shape != (8, 7) or not np.isfinite(a).all():
            raise AssertionError(f"predict_action gave {a.shape}, finite="
                                 f"{np.isfinite(a).all()}")
    if out_b.shape != (4, 8, 7) or not np.isfinite(out_b).all():
        raise AssertionError(f"predict_action_batch gave {out_b.shape}")
    if launches.get("fused_attention", 0) != per_forward * forwards:
        raise AssertionError(f"attention launches {launches}, expected "
                             f"{per_forward} x {forwards} forwards")

    # --- the same rows with the attention forced to the plain version ---
    rows = [predictor.preprocess(im, INSTRUCTION, p) for im, p in batch]
    kernel_actions = predictor.normalized_actions(rows)
    plain = predictor.with_runtime(
        dataclasses.replace(predictor.rt, kernels="plain"))
    plain_actions = plain.normalized_actions(rows)
    if cuda_lib.LAUNCHES["fused_attention"] != launches["fused_attention"] \
            + per_forward:
        raise AssertionError("the plain runtime launched the kernel")
    diff = float(np.abs(kernel_actions - plain_actions).max())
    if not diff <= FLAGSHIP_ACTIONS_ATOL:
        raise AssertionError(f"flagship kernel vs plain attention: max abs "
                             f"diff of normalized actions {diff}")
    plain_s = []
    for images, proprio in requests[:4]:
        t0 = time.perf_counter()
        plain.predict_action(images, INSTRUCTION, proprio)
        plain_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()

    timed = chunk_s[1:]  # the first request pays one-time set-up
    rec = {"card": card, "requests_b1": len(requests),
           "b1_ms_median": 1e3 * statistics.median(timed),
           "b1_ms_min": 1e3 * min(timed), "b1_ms_max": 1e3 * max(timed),
           "b1_first_ms": 1e3 * chunk_s[0],
           "b4_first_ms": 1e3 * batch_s[0], "b4_ms": 1e3 * batch_s[1],
           "b4_ms_per_chunk": 1e3 * batch_s[1] / 4,
           "b1_plain_attention_ms_median": 1e3 * statistics.median(plain_s),
           "attention_launches": launches.get("fused_attention", 0),
           "forwards": forwards, "launches_per_forward": per_forward,
           "max_abs_diff_normalized_actions_kernel_vs_plain": diff,
           "max_abs_normalized_action": float(np.abs(kernel_actions).max()),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    print("flagship " + json.dumps(rec), flush=True)
    return rec, launches


def profile_request(predictor, rows, label: str):
    """One B=1 forward of ``rows`` (forward, copy back, unnormalization)
    under torch.profiler: the device's busy time (sum of kernel durations
    on the card) against the request's host wall time, and the kernels
    that take most of it. For a Predictor that serves through CUDA graphs
    also the device time of one bare replay of its graph (CUDA events);
    where the profiler sees no kernel inside the graph, that time stands
    for the busy time, and the line says so."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    predictor.predict_action_rows(rows)  # builds, or captures the graph
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predictor.predict_action_rows(rows)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name[:60]] += e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    rec = {"tier": label, "mode": "graph" if predictor.graphs else "eager",
           "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_kernels": len(kernels),
           "attention_kernel_ms": sum(v for k, v in by_name.items()
                                      if "fused_attention" in k),
           "w8a8_kernel_ms": {name: sum(v for k, v in by_name.items()
                                        if name in k)
                              for name in ("fused_mlp_kernel",
                                           "w8a8_wide_kernel",
                                           "w8a8_narrow_kernel",
                                           "megalayer_kernel")},
           "top": [[k, v] for k, v in by_name.most_common(10)]}
    if predictor.graphs:
        key = predictor.graph_key(len(rows), "proprio" in rows[0])
        graph = predictor.graphs.captures[key].graph
        rec["replay_event_ms"] = _event_ms(graph.replay, 5)
        if not kernels:
            rec["device_busy_ms"] = rec["replay_event_ms"]
            rec["note"] = ("the profiler saw no kernel inside the graph: "
                           "device_busy_ms is the CUDA-event time of a bare "
                           "replay")
    rec["device_idle_share"] = 1 - rec["device_busy_ms"] / wall_ms
    print("profile " + json.dumps(rec), flush=True)
    return rec


def kernel_summary(records, launches):
    """One entry per kernel: sums over the launches of one B=1 forward
    (24 Qwen2 + 23 DINOv2 + 26 so400m calls) of the per-call times and
    bounds measured in phase 2; max_abs_err is the worst over all shapes."""
    from vla_adapter_torch.ops.attention_kernel import KERNEL_NAME

    fwd = [r for r in records if r["forward_batch"] == 1]

    def total(key):
        return sum(r[key] * r["launches_per_forward"] for r in fwd)

    ops = sum(r["flops"] * r["launches_per_forward"] for r in fwd)
    nbytes = sum(r["bytes"] * r["launches_per_forward"] for r in fwd)
    t_ops, t_bytes = ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return [{
        "name": KERNEL_NAME, "route": "cuda",
        "source": "vla_adapter_torch/csrc/fused_attention.cu",
        "replaces": "vla_adapter_tpu/ops/pallas_attention.py:108",
        "launches": launches.get(KERNEL_NAME, 0),
        "max_abs_err": max(r["max_abs_err"] for r in records),
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": total("sdpa_ms"),
        "per": f"sum over the {sum(r['launches_per_forward'] for r in fwd)}"
               " launches of one B=1 serving forward",
    }]


def w8a8_shapes(cfg, tokenize, min_dim: int = 256, batches=(1, 4)):
    """Every w8a8 kernel call of one serving forward, for each of
    ``batches`` (B=1 and B=4 unless given), as
    dicts: kernel, shape name(s), forward batch, dims and launches per
    forward under the "fused" backend (for an MLP also ``dense_matmuls``,
    the w8a8 matmuls it becomes under "dense"), and at B=1 the decoder
    layer of the "mega" backend with its launches under "mega". Widths
    below ``min_dim`` (``Runtime.act_int8_min_dim``) take the weight-only
    upcast, as the models gate them; matmuls of one shape are merged.
    FiLM towers add two matmuls per block on each image's language vector;
    the original head's blocks keep three (q, o, ffn), their self stream's
    K/V being weight-only slices of the head's stacks, which (like the Pro
    head's four) run as two stacked launches per stream."""
    from vla_adapter_torch.data.transform import inference_ids
    from vla_adapter_torch.ops import fused_mlp, megalayer, w8a8_matmul

    _, _, text_valid = inference_ids(cfg, tokenize, INSTRUCTION)
    s_llm = len(text_valid) + cfg.num_patches
    mm_valid = np.concatenate([text_valid[:1], np.ones(cfg.num_patches,
                                                       np.int32),
                               text_valid[1:]])
    llm, head, consts = cfg.llm, cfg.head, cfg.constants
    d, hd = llm.hidden_size, llm.num_heads * llm.head_dim
    kv = llm.num_kv_heads * llm.head_dim
    towers = [("dinov2", cfg.vision.primary), ("so400m", cfg.vision.fused)]
    n_img = cfg.vision.num_images
    shapes = []
    for b in batches:
        mats = {}

        def mm(name, m, k, n, per):
            if min(k, n) >= min_dim:
                rec = mats.setdefault((b * m, k, n), {
                    "kernel": w8a8_matmul.KERNEL_NAME, "shape": [],
                    "forward_batch": b, "m": b * m, "k": k, "n": n,
                    "launches_per_forward": 0})
                rec["shape"].append(name)
                rec["launches_per_forward"] += per

        def mlp(name, m, k, f, dd, act, gated, per):
            if min(k, f, dd) >= min_dim:
                shapes.append({
                    "kernel": (fused_mlp.GATED_KERNEL_NAME if gated
                               else fused_mlp.KERNEL_NAME),
                    "shape": [name], "forward_batch": b, "m": b * m, "k": k,
                    "f": f, "d": dd, "act": act, "gated": gated,
                    "launches_per_forward": per,
                    "dense_matmuls": (3 if gated else 2) * per})

        n_llm = llm.num_layers
        if b == 1:  # "mega" serves batch 1 only
            shapes.append({
                "kernel": megalayer.KERNEL_NAME, "shape": ["qwen2_layer"],
                "forward_batch": 1, "m": s_llm, "k": d,
                "heads": llm.num_heads, "kv_heads": llm.num_kv_heads,
                "head_dim": llm.head_dim, "f": llm.intermediate_size,
                "key_valid": mm_valid.tolist(),
                "launches_per_forward": n_llm})
        mm("qwen2_q", s_llm, d, hd, n_llm)
        mm("qwen2_k_v", s_llm, d, kv, 2 * n_llm)
        mm("qwen2_o", s_llm, hd, d, n_llm)
        mlp("qwen2_mlp", s_llm, d, llm.intermediate_size, d, "silu", True,
            n_llm)
        for name, v in towers:
            if v is None:
                continue
            tokens = n_img * (v.num_patches + v.num_prefix_tokens)
            layers = v.resolved_feature_layer + 1
            mm(f"{name}_q_k_v_out", tokens, v.hidden_size, v.hidden_size,
               4 * layers)
            mlp(f"{name}_mlp", tokens, v.hidden_size, v.mlp_dim,
                v.hidden_size, v.mlp_activation, False, layers)
            if cfg.vision.use_film and v.film_llm_dim is not None:
                # film_scale and film_shift on each image's language vector
                mm(f"{name}_film", n_img, v.film_llm_dim, v.hidden_size,
                   2 * layers)
        e = cfg.vision.embed_dim
        if cfg.vision.fused is not None:  # FusedProjector
            mlp("projector_fc1_fc2", cfg.num_patches, e, 4 * e, d, "gelu",
                False, 1)
            mm("projector_fc3", cfg.num_patches, d, d, 1)
        else:
            mlp("projector_fc1_fc2", cfg.num_patches, e, d, d, "gelu",
                False, 1)
        if cfg.use_proprio:
            mm("proprio_fc1", 1, consts.proprio_dim, d, 1)
            mm("proprio_fc2", 1, d, d, 1)
        chunk, hh = consts.num_actions_chunk, head.hidden_dim
        mm("head_fc_in", chunk, consts.action_dim * d, hh, 1)
        if head.use_pro_version:
            mm("head_q_kself_vself_o_ffn", chunk, hh, hh,
               5 * head.num_blocks)
        else:  # the self stream's K/V: the stacks' slices, weight-only
            mm("head_q_o_ffn", chunk, hh, hh, 3 * head.num_blocks)
        mm("head_fc_out", chunk, hh, consts.action_dim, 1)
        shapes += list(mats.values())
        adapter = consts.num_action_query_tokens + int(cfg.use_proprio)
        for name, m in (("head_k_v_adapter", adapter),
                        ("head_k_v_task", cfg.num_patches)):
            if min(d, hh) >= min_dim:
                shapes.append({
                    "kernel": w8a8_matmul.STACKED_KERNEL_NAME, "shape": [name],
                    "forward_batch": b, "layers": head.num_blocks, "m": b * m,
                    "k": d, "n": hh, "launches_per_forward": 2})
    return shapes


def dense_shapes(shapes):
    """The w8a8 calls of ``shapes`` as the "dense" backend makes them: each
    fused MLP becomes its matmuls (fc1, and up where gated: K -> F; fc2:
    F -> D), merged with the matmuls of the same rows and dims; the stacked
    ones stay; the decoder-layer kernel ("mega" only) goes."""
    from vla_adapter_torch.ops import megalayer, w8a8_matmul

    out, mats = [], {}
    for sh in shapes:
        if sh["kernel"] == megalayer.KERNEL_NAME:
            continue
        if sh["kernel"] == w8a8_matmul.STACKED_KERNEL_NAME:
            out.append(sh)
            continue
        if "f" in sh:
            name = sh["shape"][0].removesuffix("_fc1_fc2")
            parts = [([f"{name}_fc1"], sh["k"], sh["f"]),
                     ([f"{name}_fc2"], sh["f"], sh["d"])]
            if sh["gated"]:
                parts.append(([f"{name}_up"], sh["k"], sh["f"]))
        else:
            parts = [(sh["shape"], sh["k"], sh["n"])]
        for names, k, n in parts:
            rec = mats.setdefault((sh["forward_batch"], sh["m"], k, n), {
                "kernel": w8a8_matmul.KERNEL_NAME, "shape": [],
                "forward_batch": sh["forward_batch"], "m": sh["m"], "k": k,
                "n": n, "launches_per_forward": 0})
            rec["shape"] += names
            rec["launches_per_forward"] += sh["launches_per_forward"]
    return list(mats.values()) + out


def expected_w8a8_launches(shapes, impl: str, batch: int = 1) -> dict:
    """Launches of each w8a8 kernel in one forward of ``batch`` (1 or 4)
    under a backend."""
    from vla_adapter_torch.ops import fused_mlp, megalayer, w8a8_matmul

    counts = collections.Counter()
    for sh in shapes:
        if sh["forward_batch"] != batch:
            continue
        if sh["kernel"] == megalayer.KERNEL_NAME:
            if impl == "mega":  # one launch per layer, the o-proj inside
                counts[sh["kernel"]] += sh["launches_per_forward"]
                counts[w8a8_matmul.KERNEL_NAME] -= sh["launches_per_forward"]
        elif impl == "mega" and sh["kernel"] == fused_mlp.GATED_KERNEL_NAME:
            continue  # the Qwen2 MLP runs inside the layer kernel
        elif "f" in sh and impl == "dense":
            counts[w8a8_matmul.KERNEL_NAME] += sh["dense_matmuls"]
        else:
            counts[sh["kernel"]] += sh["launches_per_forward"]
    return dict(counts)


def w8a8_bound(sh, xq_input: bool = False):
    """(bound ms, bound_by, ops, bytes) of one call: int8 ops over the int8
    tensor-core peak against x, the int8 weights, scales, biases and the
    bf16 output, each counted once, over the HBM rate. A matmul reads x as
    bf16 (the entry with the quantization inside), or with ``xq_input``
    the int8 xq and its f32 row scales (the JAX B4/B5 signature)."""
    m, k = sh["m"], sh["k"]
    if "f" in sh:
        f, d = sh["f"], sh["d"]
        ops = 2 * m * k * f * (2 if sh["gated"] else 1) + 2 * m * f * d
        nbytes = (2 * m * k + k * f * (2 if sh["gated"] else 1) + f * d
                  + 4 * (2 * f + d) + (0 if sh["gated"] else 4 * (f + d))
                  + 2 * m * d)
    else:
        n, layers = sh["n"], sh.get("layers", 1)
        ops = 2 * layers * m * k * n
        x_bytes = m * k + 4 * m if xq_input else 2 * m * k
        nbytes = layers * (x_bytes + n * k + 4 * n + 2 * m * n)
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_HBM_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", ops, nbytes)


def megalayer_bound(sh):
    """(bound ms, bound_by, ops, bytes) of one call of the layer kernel.
    Operations: bf16 attention over the pairs of rows and valid keys this
    prompt has (4 H Dh per pair: q.k and p.v) at the bf16 peak, plus the
    int8 o-projection and gated MLP, 2 M (H Dh D + 3 D F), at the int8 peak,
    the two summed (both run on the tensor cores). Bytes: the int8 weights,
    their scales, the norm weight, x, q, k, v, the key validity and the
    output, each once."""
    m, d, f = sh["m"], sh["k"], sh["f"]  # k: the layer's width D
    hd, kvd = sh["heads"] * sh["head_dim"], sh["kv_heads"] * sh["head_dim"]
    pairs = m * int(sum(sh["key_valid"]))
    flops = 4 * hd * pairs
    int_ops = 2 * m * (hd * d + 3 * d * f)
    nbytes = (hd * d + 3 * d * f + 4 * (3 * d + 2 * f)
              + 2 * (2 * m * d + m * hd + 2 * m * kvd) + 4 * m)
    t_ops = flops / PEAK_BF16_FLOPS + int_ops / PEAK_INT8_OPS
    t_bytes = nbytes / PEAK_HBM_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops + int_ops,
            nbytes)


def check_megalayer(got, want) -> dict:
    """The layer kernel against its plain version (bf16): the largest error
    as a share of its row's largest output, the rows with an output more
    than two bf16 ulps of its own size away, and whether both hold their
    bounds (MEGALAYER_ROW_ULPS, MEGALAYER_ROW_SHARE)."""
    import torch

    err = (got.float() - want.float()).abs()
    row_max = want.float().abs().amax(dim=-1, keepdim=True)
    beyond = (err > 2 * 2.0 ** -7 * want.float().abs()).any(dim=-1)
    rec = {"max_abs_err": float(err.max()),
           "max_err_over_row_max": float((err / row_max).max()),
           "rows_beyond_2ulp": int(beyond.sum()), "rows": int(got.shape[0])}
    rec["within_bound"] = bool(
        torch.isfinite(got.float()).all()
        and rec["max_err_over_row_max"] <= MEGALAYER_ROW_ULPS * 2.0 ** -7
        and rec["rows_beyond_2ulp"] <= MEGALAYER_ROW_SHARE * rec["rows"])
    return rec


def megalayer_record(sh, randn, weight):
    """The layer kernel at one shape against its plain version, timed, with
    the same layer through the "fused" backend's launches as a yardstick."""
    import torch

    from vla_adapter_torch.ops import megalayer
    from vla_adapter_torch.ops.attention_kernel import fused_attention
    from vla_adapter_torch.ops.fused_mlp import w8a8_gated_mlp
    from vla_adapter_torch.ops.w8a8_matmul import w8a8_linear

    m, d, f = sh["m"], sh["k"], sh["f"]  # k: the layer's width D
    h, hkv, dh = sh["heads"], sh["kv_heads"], sh["head_dim"]
    eps = 1e-6
    x = randn(m, d).bfloat16()
    # q, k, v as views of one projection's output, as the model hands them
    qkv = randn(m, (h + 2 * hkv) * dh).bfloat16()
    q = qkv[:, :h * dh].view(m, h, dh)
    k = qkv[:, h * dh:(h + hkv) * dh].view(m, hkv, dh)
    v = qkv[:, (h + hkv) * dh:].view(m, hkv, dh)
    valid = torch.tensor(sh["key_valid"], dtype=torch.int32, device=x.device)
    n2 = 1.0 + 0.2 * randn(d)
    (oq, os_), (gq, gs), (uq, us), (dq, ds) = (
        weight(d, h * dh), weight(f, d), weight(f, d), weight(d, f))
    args = (x, q, k, v, valid, n2, oq, os_, gq, gs, uq, us, dq, ds)

    def kernel():
        return megalayer.w8a8_qwen2_layer(*args, eps=eps)

    def plain():
        return megalayer.megalayer_reference(*args, eps=eps)

    def fused_chain():
        ctx = fused_attention(q.transpose(0, 1)[None], k.transpose(0, 1)[None],
                              v.transpose(0, 1)[None], valid[None])
        xa = x + w8a8_linear(ctx[0].transpose(0, 1).reshape(m, h * dh), oq,
                             os_)
        xf = xa.float()
        h2 = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
              * n2).bfloat16()
        return xa + w8a8_gated_mlp(h2, gq, gs, uq, us, dq, ds)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    rec = dict(sh)
    del rec["key_valid"]
    rec.update(check_megalayer(got, want), valid_keys=int(valid.sum()),
               bitwise_equal=bool(torch.equal(got, want)))
    if not rec["within_bound"]:
        raise AssertionError(f"{sh['kernel']} vs plain: {rec}")
    bound, bound_by, ops, nbytes = megalayer_bound(sh)
    rec.update(ms=device_ms(kernel), plain_ms=device_ms(plain, reps=5),
               fused_chain_ms=device_ms(fused_chain), library_ms=None,
               bound_ms=bound, bound_by=bound_by, ops=ops, bytes=nbytes)
    return rec


def mlp_tolerance(want, h_max: float, w2, s2) -> tuple:
    """The fused MLP kernel against its plain version, bf16 output: every
    output within one int8 step of h through the down projection (the
    panel scale is at most h_max / 127, times the largest |w2| * s2) plus
    two bf16 ulps of the largest output, which covers an int8 rounding of h
    that flips where the card's expf/tanhf and PyTorch's land an ulp apart;
    and at most 2% of the rows (a flip moves its row only) differ by more
    than two bf16 ulps of an output. Returns (max abs err bound, row
    share)."""
    step = h_max / 127.0 * float((w2.float().abs() * s2[:, None]).max())
    return step + 2 * 2.0 ** -7 * float(want.float().abs().max()), 0.02


def _int_mm_ms(xq, w):
    """torch._int_mm (the int8 x int8 -> int32 product alone, no dequant)
    on the same operands, a loop over the layers of a stack; where it
    refuses M <= 16, on xq zero-padded to 24 rows. Returns (ms, padded)."""
    import torch

    m = xq.shape[-2]
    if m <= 16:
        xq = torch.cat([xq, xq.new_zeros(*xq.shape[:-2], 24 - m,
                                         xq.shape[-1])], dim=-2)
    if xq.dim() == 2:
        return device_ms(lambda: torch._int_mm(xq, w.t())), m <= 16
    return device_ms(lambda: [torch._int_mm(xq[i], w[i].t())
                              for i in range(xq.shape[0])]), m <= 16


def matmul_record(sh, randn, weight):
    """The w8a8 matmul at one shape: the entry the models call
    (``w8a8_linear``, float x, the quantization inside) and the xq entry
    (``w8a8_matmul``/``_stacked``) against their plain versions, bit for
    bit in both output dtypes; times of both, of the two-step chain
    (``quantize_rows`` then the xq entry), of the plain version, of the
    kernel with L2 flushed before each call, and of ``torch._int_mm``."""
    import torch

    from vla_adapter_torch.ops import w8a8_matmul as ops

    m, k, n, layers = sh["m"], sh["k"], sh["n"], sh.get("layers")
    lead = () if layers is None else (layers,)
    x = randn(*lead, m, k).bfloat16()
    x[..., 3] *= 20.0                  # an outlier column
    x[..., min(1, m - 1), :] = 0.0     # an all-zero row: scale 1e-8 / 127
    w, ws = weight(n, k, layers)
    xq, rs = ops.quantize_rows(x)
    xq_entry = ops.w8a8_matmul if layers is None else ops.w8a8_matmul_stacked
    worst, exact = 0.0, True
    for out_dtype in (torch.bfloat16, torch.float32):
        want = ops.w8a8_linear_reference(x, w, ws, out_dtype=out_dtype)
        for got in (ops.w8a8_linear(x, w, ws, out_dtype=out_dtype),
                    xq_entry(xq, rs, w, ws, out_dtype=out_dtype)):
            torch.cuda.synchronize()
            worst = max(worst, float((got.float() - want.float())
                                     .abs().max()))
            exact = exact and torch.equal(got, want)
    rec = dict(sh)
    rec.update(max_abs_err=worst, bitwise_equal=exact)
    if not exact:
        raise AssertionError(f"{sh['kernel']} {sh['shape']} B="
                             f"{sh['forward_batch']}: not bit-exact with "
                             f"its plain version: {rec}")

    def kernel():
        return ops.w8a8_linear(x, w, ws)

    def chain():
        return xq_entry(*ops.quantize_rows(x), w, ws)

    lib_ms, padded = _int_mm_ms(xq, w)
    bound, bound_by, ops_n, nbytes = w8a8_bound(sh)
    rec.update(ms=device_ms(kernel), cold_ms=device_ms_cold(kernel),
               xq_ms=device_ms(lambda: xq_entry(xq, rs, w, ws)),
               chain_ms=device_ms(chain),
               plain_ms=device_ms(lambda: ops.w8a8_linear_reference(
                   x, w, ws), reps=5),
               int_mm_ms=lib_ms, int_mm_padded_to_24_rows=padded,
               bound_ms=bound, bound_by=bound_by, ops=ops_n, bytes=nbytes,
               xq_bound_ms=w8a8_bound(sh, xq_input=True)[0])
    return rec


def phase_w8a8_kernels(shapes):
    """Each w8a8 kernel at each shape against its plain version, timed."""
    import torch

    from vla_adapter_torch.models.quantize import quantize_weight
    from vla_adapter_torch.ops import fused_mlp, megalayer
    from vla_adapter_torch.ops.w8a8_matmul import int_matmul, quantize_rows

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def weight(n, k, layers=None):  # lecun-normal, quantized on the card
        lead = () if layers is None else (layers,)
        return quantize_weight(randn(*lead, n, k) / k ** 0.5)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    records = []
    for sh in shapes:
        if sh["kernel"] == megalayer.KERNEL_NAME:
            plan = megalayer.megalayer_plan(
                sh["m"], sh["k"], sh["heads"], sh["kv_heads"],
                sh["head_dim"], sh["f"], sms=sms)
            print(f"plan {sh['kernel']} {sh['shape']} B={sh['forward_batch']}"
                  f" " + json.dumps(plan), flush=True)
            rec = megalayer_record(sh, randn, weight)
            rec["plan"] = plan
            print("w8a8_shape " + json.dumps(rec), flush=True)
            records.append(rec)
            continue
        if "f" not in sh:
            rec = matmul_record(sh, randn, weight)
            print("w8a8_shape " + json.dumps(rec), flush=True)
            records.append(rec)
            continue
        m, k = sh["m"], sh["k"]
        f, d, act = sh["f"], sh["d"], sh["act"]
        plan = fused_mlp.mlp_plan(m, k, f, d, gated=sh["gated"], sms=sms)
        print(f"plan {sh['kernel']} {sh['shape']} B={sh['forward_batch']} "
              + json.dumps(plan), flush=True)
        rec = dict(sh, plan=plan)
        x = randn(m, k).bfloat16()
        w1, s1 = weight(f, k)
        w2, s2 = weight(d, f)
        up = weight(f, k) if sh["gated"] else (None, None)
        b1 = None if sh["gated"] else 0.02 * randn(f)
        b2 = None if sh["gated"] else 0.02 * randn(d)
        if sh["gated"]:
            def kernel():
                return fused_mlp.w8a8_gated_mlp(x, w1, s1, *up, w2, s2,
                                                act=act)
        else:
            def kernel():
                return fused_mlp.w8a8_mlp(x, w1, s1, b1, w2, s2, b2,
                                          act=act)

        def plain():
            return fused_mlp.fused_mlp_reference(
                x, w1, s1, w2, s2, up_q=up[0], up_scale=up[1], b1=b1,
                b2=b2, act=act)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        xq, rs = quantize_rows(x)
        g = int_matmul(xq, w1).float() * rs * s1
        h = fused_mlp.kernel_activation(act)(g if b1 is None else g + b1)
        if sh["gated"]:
            h = h * (int_matmul(xq, up[0]).float() * rs * up[1])
        bound_err, row_share = mlp_tolerance(want, float(h.abs().max()),
                                             w2, s2)
        err = (got.float() - want.float()).abs()
        flipped = (err > 2 * 2.0 ** -7 * want.float().abs()).any(dim=-1)
        rec.update(max_abs_err=float(err.max()), err_bound=bound_err,
                   rows_beyond_2ulp=int(flipped.sum()), bitwise_equal=bool(
                       torch.equal(got, want)))
        if not (torch.isfinite(got.float()).all()
                and rec["max_abs_err"] <= bound_err
                and float(flipped.float().mean()) <= row_share):
            raise AssertionError(f"{sh['kernel']} {sh['shape']} B="
                                 f"{sh['forward_batch']}: {rec}")
        bound, bound_by, ops, nbytes = w8a8_bound(sh)
        rec.update(ms=device_ms(kernel), plain_ms=device_ms(plain, reps=5),
                   int_mm_ms=None, bound_ms=bound, bound_by=bound_by,
                   ops=ops, bytes=nbytes)
        print("w8a8_shape " + json.dumps(rec), flush=True)
        records.append(rec)
    return records


def phase_quantizer(params):
    """The on-card weight quantizer (what ``Predictor(int8=...)`` runs)
    against the numpy ``quantize_kernel`` on flagship weights, bit for
    bit."""
    from vla_adapter_torch.models.quantize import quantize_kernel

    names = ["language_model.layers.0.mlp.gate_proj.weight",
             "language_model.layers.0.self_attn.q_proj.weight",
             "vision_backbone.featurizer.blocks.0.mlp.fc1.weight",
             "vision_backbone.fused_featurizer.blocks.0.mlp.fc2.weight",
             "projector.fc1.weight", "action_head.fc_in.weight",
             "action_head.k_task.kernel"]
    checked = []
    for name in names:
        w = params[name]
        # the port's Dense weight is (out, in); a BatchedDense kernel and
        # the numpy quantizer's input are (..., in, out)
        in_axis = -2 if name.endswith(".kernel") else -1
        q, s = quantize_kernel(w, in_axis=in_axis)
        host = w.float().cpu().numpy()
        if in_axis == -1:
            host = np.swapaxes(host, -1, -2)
        want_q, want_s = numpy_quantize_kernel(host)
        got_q = q.cpu().numpy()
        if in_axis == -1:
            got_q = np.swapaxes(got_q, -1, -2)
        if not (np.array_equal(got_q, want_q) and np.array_equal(
                s.cpu().numpy().view(np.int32), want_s.view(np.int32))):
            raise AssertionError(f"on-card quantizer differs from numpy on "
                                 f"{name}")
        checked.append([name, list(w.shape)])
    print("quantizer " + json.dumps({"bit_exact": checked}), flush=True)
    return checked


def _requests(cfg, rng, n):
    size = cfg.vision.primary.image_size
    return [([rng.integers(0, 256, size=(size, size, 3), dtype=np.uint8)
              for _ in range(cfg.vision.num_images)],
             rng.normal(size=cfg.constants.proprio_dim)) for _ in range(n)]


def _serve(pred, requests, batch):
    """B=1 requests one by one, then the batch twice unless ``batch`` is
    empty (the first pays the B=4 key's one-time set-up): (per-request
    seconds, the second batch's seconds or None), the outputs checked."""
    chunk_s = []
    for images, proprio in requests:
        t0 = time.perf_counter()
        out = pred.predict_action(images, INSTRUCTION, proprio)
        chunk_s.append(time.perf_counter() - t0)
        if out.shape != (8, 7) or not np.isfinite(out).all():
            raise AssertionError(f"predict_action gave {out.shape}, finite="
                                 f"{np.isfinite(out).all()}")
    if not batch:
        return chunk_s, None
    for _ in range(2):
        t0 = time.perf_counter()
        out_b = pred.predict_action_batch([im for im, _ in batch],
                                          [INSTRUCTION] * len(batch),
                                          [p for _, p in batch])
        batch_s = time.perf_counter() - t0
    if out_b.shape != (len(batch), 8, 7) or not np.isfinite(out_b).all():
        raise AssertionError(f"predict_action_batch gave {out_b.shape}")
    return chunk_s, batch_s


def _latency(chunk_s, batch_s, n_batch):
    timed = chunk_s[1:]  # the first request pays one-time set-up
    rec = {"b1_ms_median": 1e3 * statistics.median(timed),
           "b1_ms_min": 1e3 * min(timed), "b1_ms_max": 1e3 * max(timed),
           "b1_first_ms": 1e3 * chunk_s[0]}
    if batch_s is not None:
        rec.update(b4_ms=1e3 * batch_s, b4_ms_per_chunk=1e3 * batch_s / n_batch)
    return rec


def _per_row_actions(pred, rows):
    """Normalized actions of each row served alone (B=1), stacked."""
    return np.concatenate([pred.normalized_actions([r]) for r in rows])


def phase_w8a8(bf16_pred, shapes, rng, card: str):
    """The w8a8 main path: Predictor(act_int8=True) over the bf16
    predictor's weights, quantized on the card; each backend driven at B=1
    (and, but for "mega", B=4) between a reset and a read of the launch
    counts."""
    import torch

    from vla_adapter_torch.infer.predict import Predictor
    from vla_adapter_torch.models.layers import resolve_w8a8_impl
    from vla_adapter_torch.ops import attention_kernel, cuda_lib

    cfg = bf16_pred.cfg
    n_llm = cfg.llm.num_layers
    attn_per_forward = (n_llm
                        + cfg.vision.primary.resolved_feature_layer + 1
                        + cfg.vision.fused.resolved_feature_layer + 1)
    kernels = sorted({sh["kernel"] for sh in shapes})
    common = dict(cfg=cfg, params=bf16_pred.params,
                  tokenize=bf16_pred.tokenize, norm_stats=bf16_pred.norm_stats,
                  center_crop=False, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    auto = Predictor(act_int8=True, **common)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    backends = {"fused": auto.with_runtime(auto.rt, w8a8_impl="fused"),
                "dense": auto.with_runtime(auto.rt, w8a8_impl="dense"),
                "auto": auto,
                "mega": auto.with_runtime(auto.rt, w8a8_impl="mega")}
    requests, batch = _requests(cfg, rng, 6), _requests(cfg, rng, 4)
    rec = {"card": card, "quantize_on_card_s": quantize_s,
           "int8_bytes": sum(v.numel() for v in auto.params.values()
                             if v.dtype == torch.int8)}
    launches = collections.Counter()
    for name, pred in backends.items():
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launches()
        b1_only = name == "mega"
        chunk_s, batch_s = _serve(pred, requests, [] if b1_only else batch)
        counts = dict(cuda_lib.LAUNCHES)
        impls = [resolve_w8a8_impl(pred.w8a8_impl, 1)] * len(requests)
        if not b1_only:
            impls += [resolve_w8a8_impl(pred.w8a8_impl, len(batch))] * 2
        want = collections.Counter()
        for impl in impls:
            want.update(expected_w8a8_launches(shapes, impl))
            want[attention_kernel.KERNEL_NAME] += (
                attn_per_forward - (n_llm if impl == "mega" else 0))
        if {k: v for k, v in counts.items() if v} != \
                {k: v for k, v in want.items() if v}:
            raise AssertionError(f"w8a8 {name}: launches {counts}, expected "
                                 f"{dict(want)}")
        launches.update(counts)
        rec[name] = {"impl_b1": impls[0], "impl_b4": impls[-1],
                     **_latency(chunk_s, batch_s, len(batch)),
                     "launches": counts, "forwards": len(impls),
                     "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    for kernel in kernels:
        if not launches[kernel]:
            raise AssertionError(f"{kernel} was never launched on the w8a8 "
                                 f"main path")
    # "mega" refuses a batch before it runs anything
    before = dict(cuda_lib.LAUNCHES)
    try:
        backends["mega"].predict_action_batch(
            [im for im, _ in batch], [INSTRUCTION] * len(batch),
            [p for _, p in batch])
    except ValueError as err:
        rec["mega"]["b4_refused"] = str(err)
    else:
        raise AssertionError("w8a8 mega served a batch of 4")
    if dict(cuda_lib.LAUNCHES) != before:
        raise AssertionError("w8a8 mega launched kernels for a refused batch")

    # --- outside the counted runs: actions against plain and bf16 ---
    rows = [bf16_pred.preprocess(im, INSTRUCTION, p) for im, p in batch]
    a_bf16 = bf16_pred.normalized_actions(rows)

    def against_plain(name, act):
        pred = backends[name]
        a_kernel = act(pred, rows)
        plain = pred.with_runtime(dataclasses.replace(pred.rt,
                                                      kernels="plain"))
        before = dict(cuda_lib.LAUNCHES)
        a_plain = act(plain, rows)
        if any(cuda_lib.LAUNCHES[k] != before.get(k, 0) for k in kernels):
            raise AssertionError(f"the plain {name} runtime launched a w8a8 "
                                 f"kernel")
        return a_kernel, float(np.abs(a_kernel - a_plain).max())

    for name in ("fused", "dense"):
        a_kernel, vs_plain = against_plain(
            name, lambda pred, r: pred.normalized_actions(r))
        vs_bf16 = np.abs(a_kernel - a_bf16)
        rec[name].update(
            max_abs_diff_normalized_actions_kernel_vs_plain=vs_plain,
            max_abs_diff_vs_bf16=float(vs_bf16.max()),
            mean_abs_diff_vs_bf16=float(vs_bf16.mean()))
    # mega serves one row at a time: every comparison row by row at B=1
    a_mega, vs_plain = against_plain("mega", _per_row_actions)
    vs_bf16 = np.abs(a_mega - _per_row_actions(bf16_pred, rows))
    rec["mega"].update(
        max_abs_diff_normalized_actions_kernel_vs_plain=vs_plain,
        max_abs_diff_vs_bf16=float(vs_bf16.max()),
        mean_abs_diff_vs_bf16=float(vs_bf16.mean()),
        max_abs_diff_vs_fused=float(np.abs(
            a_mega - _per_row_actions(backends["fused"], rows)).max()))
    rec["max_abs_normalized_action_bf16"] = float(np.abs(a_bf16).max())
    del backends, auto

    # --- the weight-only tier, once ---
    torch.cuda.reset_peak_memory_stats()
    int8 = Predictor(int8=True, **common)
    cuda_lib.reset_launches()
    chunk_s, batch_s = _serve(int8, requests[:4], batch)
    if dict(cuda_lib.LAUNCHES) != {attention_kernel.KERNEL_NAME:
                                   attn_per_forward * 6}:
        raise AssertionError(f"int8: launches {dict(cuda_lib.LAUNCHES)}")
    vs_bf16 = np.abs(int8.normalized_actions(rows) - a_bf16)
    rec["int8"] = {**_latency(chunk_s, batch_s, len(batch)),
                   "max_abs_diff_vs_bf16": float(vs_bf16.max()),
                   "mean_abs_diff_vs_bf16": float(vs_bf16.mean()),
                   "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    print("flagship_w8a8 " + json.dumps(rec), flush=True)
    for name in ("fused", "dense", "mega", "int8"):
        if name != "int8" and not (
                rec[name]["max_abs_diff_normalized_actions_kernel_vs_plain"]
                <= W8A8_ACTIONS_ATOL):
            raise AssertionError(f"w8a8 {name}: kernel vs plain actions "
                                 f"differ beyond {W8A8_ACTIONS_ATOL}")
        if not rec[name]["max_abs_diff_vs_bf16"] <= QUANTIZED_VS_BF16_LIMIT:
            raise AssertionError(f"{name} vs bf16 actions differ beyond "
                                 f"{QUANTIZED_VS_BF16_LIMIT}")
    return rec, dict(launches)


def _spread(seconds) -> dict:
    ms = [1e3 * t for t in seconds]
    return {"median_ms": statistics.median(ms), "min_ms": min(ms),
            "max_ms": max(ms), "n": len(ms)}


def _counted(pred, rows):
    """Normalized actions of one forward over ``rows`` and the kernel
    launches of exactly that forward."""
    import torch

    from vla_adapter_torch.ops import cuda_lib

    cuda_lib.reset_launches()
    out = pred.normalized_actions(rows)
    torch.cuda.synchronize()
    return out, {k: v for k, v in cuda_lib.LAUNCHES.items() if v}


def _in_turns(preds: dict, rows, rounds: int) -> dict:
    """Each Predictor serves ``rows`` once per round, the order rotated
    each round: {name: seconds per request}. Each is served once before,
    untimed (a graph is captured then)."""
    for pred in preds.values():
        pred.predict_action_rows(rows)
    names = list(preds)
    times = {name: [] for name in names}
    for i in range(rounds):
        shift = i % len(names)
        for name in names[shift:] + names[:shift]:
            t0 = time.perf_counter()
            preds[name].predict_action_rows(rows)
            times[name].append(time.perf_counter() - t0)
    return times


def phase_graph(bf16_pred, rng, card: str, profile: bool = False):
    """The forward as a CUDA graph (the default on the card) against the
    eager forward (``cuda_graph=False``) in every tier at full width:
    bf16, int8, w8a8 "fused", "dense" and "auto" at B=1 and B=4, "mega" at
    B=1. Over requests whose prompts (and prompt lengths) and images
    differ, the replayed normalized actions must equal the eager ones bit
    for bit, and the launches of each replayed request the eager ones.
    Records each key's warm-up and capture time and each pool's bytes, and
    times in turns on the same rows: eager against graph for every tier
    at B=1; bf16, int8, fused and dense at B=2 and B=4 under graphs."""
    import torch

    from vla_adapter_torch.infer.predict import Predictor

    cfg = bf16_pred.cfg
    common = dict(cfg=cfg, params=bf16_pred.params,
                  tokenize=bf16_pred.tokenize, norm_stats=bf16_pred.norm_stats,
                  center_crop=False, device="cuda")
    auto = Predictor(act_int8=True, **common)
    tiers = {"bf16": bf16_pred.with_runtime(bf16_pred.rt),
             "int8": Predictor(int8=True, **common),
             "fused": auto.with_runtime(auto.rt, w8a8_impl="fused"),
             "dense": auto.with_runtime(auto.rt, w8a8_impl="dense"),
             "auto": auto,
             "mega": auto.with_runtime(auto.rt, w8a8_impl="mega")}
    eager = {name: pred.with_runtime(pred.rt, cuda_graph=False)
             for name, pred in tiers.items()}
    rec = {"card": card, "tiers": {}}
    for name, pred in tiers.items():
        cell = {}
        for b in (1,) if name == "mega" else (1, 4):
            plens, launches = [], None
            for text in GRAPH_INSTRUCTIONS:
                rows = [pred.preprocess(im, text, p)
                        for im, p in _requests(cfg, rng, b)]
                want, want_n = _counted(eager[name], rows)
                got, got_n = _counted(pred, rows)
                if not (got.shape == (b, 8, 7) and np.isfinite(got).all()
                        and np.array_equal(got, want)):
                    raise AssertionError(
                        f"graph {name} B={b}: replayed actions differ from "
                        f"eager by {float(np.abs(got - want).max())}")
                if got_n != want_n:
                    raise AssertionError(f"graph {name} B={b}: launches "
                                         f"{got_n}, eager {want_n}")
                plens.append(int(rows[0]["plen"]))
                launches = got_n
            cell[f"b{b}"] = {"requests": len(GRAPH_INSTRUCTIONS),
                             "prompt_lens": plens, "bitwise_equal": True,
                             "launches_per_request": launches}
        cell.update(pred.graphs.stats())
        rec["tiers"][name] = cell
        print(f"graph {name} " + json.dumps(cell), flush=True)

    # --- in turns on the same rows ---
    rows1 = [bf16_pred.preprocess(im, INSTRUCTION, p)
             for im, p in _requests(cfg, rng, 1)]
    both = {f"{name} {mode}": (pred if mode == "graph" else eager[name])
            for name, pred in tiers.items() for mode in ("eager", "graph")}
    times = _in_turns(both, rows1, 6)
    rec["b1"] = {name: _spread(v) for name, v in times.items()}
    for name in tiers:
        rec["b1"][f"{name} graph"]["faster_than_eager_pairs"] = sum(
            g < e for g, e in zip(times[f"{name} graph"],
                                  times[f"{name} eager"]))
    for b, rounds in ((2, 4), (4, 4)):
        rows_b = [bf16_pred.preprocess(im, INSTRUCTION, p)
                  for im, p in _requests(cfg, rng, b)]
        times = _in_turns({name: tiers[name] for name in
                           ("bf16", "int8", "fused", "dense")}, rows_b, rounds)
        cell = {name: dict(_spread(v), chunks_per_s=b / statistics.median(v))
                for name, v in times.items()}
        cell["fused_faster_pairs"] = sum(
            f < d for f, d in zip(times["fused"], times["dense"]))
        rec[f"b{b}_graph"] = cell
    print("graph_crossover " + json.dumps(
        {k: rec[k] for k in ("b1", "b2_graph", "b4_graph")}), flush=True)

    if profile:
        rec["profiles"] = [profile_request(pred, rows1, name)
                           for name in tiers
                           for pred in (eager[name], tiers[name])]
        for prof in rec["profiles"]:
            before = KERNELS_PER_REQUEST_BEFORE.get(f"w8a8 {prof['tier']}")
            if prof["mode"] == "eager" and before:
                prof["kernels_saved"] = before - prof["device_kernels"]
                if prof["kernels_saved"] < KERNELS_SAVED:
                    raise AssertionError(
                        f"{prof['tier']}: {prof['device_kernels']} kernels "
                        f"per B=1 request, not {KERNELS_SAVED} fewer than "
                        f"{before}")
    del tiers, eager, both, auto
    torch.cuda.empty_cache()
    return rec


def phase_checkpoint(bf16_pred, rng, card: str):
    """Checkpoint loading without JAX at full width: the flagship's bf16
    weights exported with the port's ``export_checkpoint_dir`` into a
    temporary directory, loaded back on the card with ``load_vla`` (bf16,
    and w8a8 "fused" quantized on the card). The loaded state dict must
    equal the source's and the loaded Predictors' actions the source
    Predictors', bit for bit; the loaded Predictors are driven between a
    reset and a read of the launch counts. The directory is deleted."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from vla_adapter_torch.infer.predict import Predictor
    from vla_adapter_torch.ops import cuda_lib, fused_mlp, w8a8_matmul
    from vla_adapter_torch.ops.attention_kernel import KERNEL_NAME
    from vla_adapter_torch.weights.export import export_checkpoint_dir
    from vla_adapter_torch.weights.load import load_vla

    cfg = bf16_pred.cfg
    src_fused = Predictor(cfg=cfg, params=bf16_pred.params,
                          tokenize=bf16_pred.tokenize,
                          norm_stats=bf16_pred.norm_stats, center_crop=False,
                          device="cuda", act_int8=True, w8a8_impl="fused")
    rows = [bf16_pred.preprocess(im, INSTRUCTION, p)
            for im, p in _requests(cfg, rng, 4)]
    tmp = Path(tempfile.mkdtemp(prefix="vla_ckpt_"))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        export_checkpoint_dir(bf16_pred.params, cfg, tmp,
                              norm_stats=bf16_pred.norm_stats)
        export_s = time.perf_counter() - t0
        files = {f.name: f.stat().st_size for f in tmp.iterdir()}
        t0 = time.perf_counter()
        loaded = load_vla(tmp, tokenize=bf16_pred.tokenize, center_crop=False)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded_fused = load_vla(tmp, tokenize=bf16_pred.tokenize,
                                center_crop=False, act_int8=True,
                                w8a8_impl="fused")
        torch.cuda.synchronize()
        load_fused_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp)
    if set(loaded.params) != set(bf16_pred.params):
        raise AssertionError("loaded state dict has other keys: "
                             f"{set(loaded.params) ^ set(bf16_pred.params)}")
    differ = [k for k, v in bf16_pred.params.items()
              if not (loaded.params[k].dtype == v.dtype
                      and torch.equal(loaded.params[k], v))]
    if differ:
        raise AssertionError(f"loaded weights differ: {differ[:5]}")

    # --- the loaded path: its launch counts around exactly these calls ---
    cuda_lib.reset_launches()
    got = {"bf16": (loaded.predict_action_rows(rows),
                    loaded.predict_action_rows(rows[:1])),
           "fused": (loaded_fused.predict_action_rows(rows),
                     loaded_fused.predict_action_rows(rows[:1]))}
    torch.cuda.synchronize()
    launches = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
    for kernel in (KERNEL_NAME, w8a8_matmul.KERNEL_NAME,
                   w8a8_matmul.STACKED_KERNEL_NAME,
                   fused_mlp.GATED_KERNEL_NAME, fused_mlp.KERNEL_NAME):
        if not launches.get(kernel):
            raise AssertionError(f"{kernel} was never launched by the "
                                 f"loaded Predictors: {launches}")
    for name, src in (("bf16", bf16_pred), ("fused", src_fused)):
        want = (src.predict_action_rows(rows),
                src.predict_action_rows(rows[:1]))
        for g, w in zip(got[name], want):
            if not (np.isfinite(g).all() and np.array_equal(g, w)):
                raise AssertionError(f"loaded {name} actions differ from the "
                                     f"source's by {float(np.abs(g - w).max())}")
    rec = {"card": card, "export_s": export_s, "files": files,
           "checkpoint_bytes": sum(files.values()), "load_bf16_s": load_s,
           "load_w8a8_fused_s": load_fused_s, "state_dict_bitwise_equal": True,
           "actions_bitwise_equal": ["bf16", "fused"], "launches": launches}
    print("checkpoint " + json.dumps(rec), flush=True)
    del loaded, loaded_fused, src_fused
    torch.cuda.empty_cache()
    return rec


SERVER_CLIENTS = (1, 4, 16)
# the buckets that only the server runs: no earlier phase forwards them
SERVER_ONLY_BATCHES = (8, 16)
SERVER_WINDOW_S = 4.0
SERVER_WARMUP_S = 1.0


def _server_request(cfg, seed):
    rng = np.random.default_rng(seed)
    size = cfg.vision.primary.image_size
    return ([rng.integers(0, 256, size=(size, size, 3), dtype=np.uint8)
             for _ in range(cfg.vision.num_images)], INSTRUCTION,
            rng.normal(size=cfg.constants.proprio_dim).astype(np.float32))


def _check_served_exactly(pred, cfg, tier):
    """One request alone through the server equals ``predict_action`` on
    the same arrays; three requests that the batcher is made to coalesce
    (max_batch=3, a long max_wait_ms, sent in a known order) equal
    ``predict_action_rows`` on the same rows padded to the bucket of 4;
    both bit for bit."""
    import threading

    from vla_adapter_torch.serve.loadtest import post_act
    from vla_adapter_torch.serve.server import ActionServer

    server = ActionServer(pred, host="127.0.0.1", port=0, dynamic_batch=True,
                          max_batch=16, max_wait_ms=4.0)
    port = server.serve_background()
    try:
        req = _server_request(cfg, 900)
        got = post_act(f"http://127.0.0.1:{port}/act", *req, timeout=300)
    finally:
        server.shutdown()
    want = pred.predict_action(*req)
    if not (got.shape == (8, 7) and np.isfinite(got).all()
            and np.array_equal(got, want)):
        raise AssertionError(f"server {tier}: a single request differs from "
                             f"predict_action by "
                             f"{float(np.abs(got - want).max())}")
    server = ActionServer(pred, host="127.0.0.1", port=0, dynamic_batch=True,
                          max_batch=3, max_wait_ms=60_000.0)
    port = server.serve_background()
    reqs = [_server_request(cfg, 910 + i) for i in range(3)]
    out, errors = {}, []

    def call(i):
        try:
            out[i] = post_act(f"http://127.0.0.1:{port}/act", *reqs[i],
                              timeout=300)
        except Exception as err:  # noqa: BLE001 - reported below
            errors.append(err)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    try:
        for t in threads:
            t.start()
            time.sleep(0.5)  # enqueued in this order
        for t in threads:
            t.join(timeout=300)
        sizes = server.batcher.stats()["batch_sizes"]
    finally:
        server.shutdown()
    if errors or sizes != [3]:
        raise AssertionError(f"server {tier}: coalesced batch {sizes}, "
                             f"errors {errors}")
    rows = [pred.preprocess(*r) for r in reqs]
    want = pred.predict_action_rows(rows + rows[-1:])
    for i in range(3):
        if not np.array_equal(out[i], want[i]):
            raise AssertionError(
                f"server {tier}: coalesced row {i} differs from "
                f"predict_action_rows by {float(np.abs(out[i] - want[i]).max())}")
    return {"single_bitwise_equal": True, "coalesced_batch": sizes,
            "coalesced_bitwise_equal": True}


def _buckets_vs_plain(pred, cfg) -> dict:
    """The server-only buckets' forwards (their graphs replayed) against the
    all-plain path on the same center-cropped rows: the max abs diff of
    normalized actions per batch, within phase 5's bound (bf16) or phase
    6's (w8a8)."""
    plain = pred.with_runtime(dataclasses.replace(pred.rt, kernels="plain"),
                              cuda_graph=False)
    limit = W8A8_ACTIONS_ATOL if pred.act_int8 else FLAGSHIP_ACTIONS_ATOL
    out = {}
    for b in SERVER_ONLY_BATCHES:
        rows = [pred.preprocess(*_server_request(cfg, 930 + i))
                for i in range(b)]
        got = pred.normalized_actions(rows)
        if got.shape != (b, 8, 7) or not np.isfinite(got).all():
            raise AssertionError(f"B={b}: actions {got.shape}, finite="
                                 f"{np.isfinite(got).all()}")
        out[str(b)] = float(np.abs(got - plain.normalized_actions(rows)).max())
        if not out[str(b)] <= limit:
            raise AssertionError(f"B={b}: kernel vs plain actions differ by "
                                 f"{out[str(b)]} > {limit}")
    return {"max_abs_diff_normalized_actions_kernel_vs_plain": out,
            "limit": limit}


def _host_breakdown(pred, cfg, reps: int = 10) -> dict:
    """Median ms of what one B=1 request costs in the server process, part
    by part, outside the load: the JSON and base64 decoding of its payload,
    ``preprocess`` (prompt ids, the numpy center crop, proprio), and the
    forward on preprocessed rows with the copy back and unnormalization."""
    from vla_adapter_torch.serve.loadtest import act_payload
    from vla_adapter_torch.serve.server import decode_payload

    images, text, proprio = _server_request(cfg, 920)
    body = json.dumps(act_payload(images, text, proprio))
    row = pred.preprocess(images, text, proprio)

    def median_ms(fn):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)

    return {"payload_bytes": len(body),
            "decode_ms": median_ms(lambda: decode_payload(json.loads(body))),
            "preprocess_ms": median_ms(
                lambda: pred.preprocess(images, text, proprio)),
            "forward_ms": median_ms(lambda: pred.predict_action_rows([row]))}


def _load_line(server, tier, clients, workers, card):
    """run_load at ``clients`` closed-loop clients (in up to 4 spawned
    processes) against a running server: the JSON line of phase 9."""
    from vla_adapter_torch.serve.loadtest import run_load

    before = len(server.batcher.stats()["batch_sizes"])
    stats = run_load(f"http://127.0.0.1:{server.port}/act", clients,
                     SERVER_WINDOW_S, image_hw=224, proprio_dim=8,
                     instruction=INSTRUCTION, warmup_s=SERVER_WARMUP_S,
                     processes=min(clients, 4), action_shape=(8, 7))
    sizes = server.batcher.stats()["batch_sizes"][before:]
    rec = {"card": card, "tier": tier, "clients": clients,
           "preprocess_workers": workers,
           "requests_per_s": stats["requests_per_s"],
           "actions_per_s": 8 * stats["requests_per_s"],
           "latency_ms": stats["latency_ms"], "completed": stats["completed"],
           "errors": stats["errors"], "error_sample": stats["error_sample"],
           "window_s": stats["duration_s"],
           "batch_sizes": {str(k): v for k, v in sorted(
               collections.Counter(sizes).items())},
           "forwards": len(sizes)}
    graphs = server.predictor.graphs.stats()
    rec.update(graph_capture_s={k: v["capture_s"]
                                for k, v in graphs["keys"].items()},
               pool_bytes=graphs["pool_bytes"])
    print("server " + json.dumps(rec), flush=True)
    if rec["errors"] or not rec["completed"]:
        raise AssertionError(f"server {tier} at {clients} clients: "
                             f"{rec['errors']} errors, {rec['completed']} "
                             f"completed: {rec['error_sample']}")
    return rec


def phase_server(bf16_pred, card: str):
    """The /act server (path A): the port's ``ActionServer`` on 127.0.0.1
    with the dynamic batcher (max_batch=16, max_wait_ms=4), over the
    flagship in bf16 and in w8a8 "auto", with the reference's center crop
    (224 px images: no JPEG round-trip). Every bucket's graph (1, 2, 4, 8,
    16; "auto" serves 8 and 16 with "dense") is captured before the load.
    Then: one request alone and one coalesced batch, bit for bit against
    the Predictor; ``run_load`` at 1, 4 and 16 closed-loop clients for a
    fixed window each, every response a finite (8, 7) array, no error; a
    second server with ``preprocess_workers=4`` at 16 clients (bf16). The
    launch counts are read around the load of each tier. Before all this,
    the buckets only the server runs (``SERVER_ONLY_BATCHES``): B1 at their
    attention shapes, B4/B5 at the matmuls "auto" runs there ("dense"),
    each against its plain version, and each tier's forwards at those
    batches against the all-plain path (:func:`_buckets_vs_plain`)."""
    import torch

    from vla_adapter_torch.infer.predict import Predictor
    from vla_adapter_torch.models.layers import resolve_w8a8_impl
    from vla_adapter_torch.ops import (
        attention_kernel,
        cuda_lib,
        fused_mlp,
        w8a8_matmul,
    )
    from vla_adapter_torch.serve.loadtest import prewarm
    from vla_adapter_torch.serve.server import ActionServer

    cfg = bf16_pred.cfg
    common = dict(cfg=cfg, params=bf16_pred.params,
                  tokenize=bf16_pred.tokenize, norm_stats=bf16_pred.norm_stats,
                  center_crop=True, device="cuda")
    rec = {"card": card, "tiers": {}}
    if any(resolve_w8a8_impl("auto", b) != "dense"
           for b in SERVER_ONLY_BATCHES):
        raise AssertionError("auto no longer serves the server-only buckets "
                             "with dense: check its kernels there")
    rec["attention_records"] = phase_kernel_vs_plain(attention_shapes(
        cfg, bf16_pred.tokenize, batches=SERVER_ONLY_BATCHES))
    rec["w8a8_records"] = phase_w8a8_kernels(dense_shapes(w8a8_shapes(
        cfg, bf16_pred.tokenize, batches=SERVER_ONLY_BATCHES)))
    launches = collections.Counter()
    for tier in ("bf16", "auto"):
        pred = Predictor(act_int8=tier == "auto", **common)
        t0 = time.perf_counter()
        prewarm(pred, 16)
        warm_s = time.perf_counter() - t0
        cell = {"prewarm_s": warm_s, **_check_served_exactly(pred, cfg, tier),
                "buckets_vs_plain": _buckets_vs_plain(pred, cfg),
                "host": _host_breakdown(pred, cfg)}
        server = ActionServer(pred, host="127.0.0.1", port=0,
                              dynamic_batch=True, max_batch=16,
                              max_wait_ms=4.0)
        server.serve_background()
        try:
            cuda_lib.reset_launches()
            cell["load"] = [_load_line(server, tier, n, 0, card)
                            for n in SERVER_CLIENTS]
            counts = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
        finally:
            server.shutdown()
        if tier == "bf16":  # the image pipeline in 4 worker processes
            server = ActionServer(pred, host="127.0.0.1", port=0,
                                  dynamic_batch=True, max_batch=16,
                                  max_wait_ms=4.0, preprocess_workers=4)
            server.serve_background()
            try:
                cell["pool"] = _load_line(server, tier, 16, 4, card)
            finally:
                server.shutdown()
        graphs = pred.graphs.stats()
        if len(graphs["keys"]) != 5:
            raise AssertionError(f"server {tier}: graph keys "
                                 f"{sorted(graphs['keys'])}")
        need = {attention_kernel.KERNEL_NAME}
        if pred.act_int8:
            need |= {w8a8_matmul.KERNEL_NAME, w8a8_matmul.STACKED_KERNEL_NAME,
                     fused_mlp.KERNEL_NAME, fused_mlp.GATED_KERNEL_NAME}
        if not all(counts.get(k) for k in need):
            raise AssertionError(f"server {tier}: launches {counts}, every "
                                 f"one of {sorted(need)} expected")
        cell.update(launches=counts, graphs=graphs)
        launches.update(counts)
        rec["tiers"][tier] = cell
        print(f"server_{tier} " + json.dumps(
            {k: v for k, v in cell.items() if k not in ("load", "pool")}),
            flush=True)
        del pred, server
        torch.cuda.empty_cache()
    return rec, dict(launches)


def original_film_config():
    """``VLAConfig()`` with the original head (``use_pro_version=False``)
    and FiLM on both towers, conditioned on the LLM's 896-wide prompt
    embedding: full width, full depth."""
    from vla_adapter_torch.core.config import VLAConfig

    cfg = VLAConfig()
    d = cfg.llm.hidden_size
    v = cfg.vision
    return dataclasses.replace(
        cfg, head=dataclasses.replace(cfg.head, use_pro_version=False),
        vision=dataclasses.replace(
            v, use_film=True,
            primary=dataclasses.replace(v.primary, film_llm_dim=d),
            fused=dataclasses.replace(v.fused, film_llm_dim=d)))


def phase_original_film(bf16_pred, rng, card: str, seed: int):
    """The original VLA-Adapter model (path B) at full width and depth:
    random bf16 weights from a seeded CUDA generator, served in every tier
    (bf16; int8; w8a8 "fused", "dense", "auto" at B=1 and B=4; "mega" at
    B=1). Per tier: the launch counts around its requests against those
    :func:`w8a8_shapes` derives; each replayed graph against its eager
    forward, bit for bit; the kernel path against the all-plain path;
    each quantized tier against bf16 (``forward_error_report``'s quantity,
    and the function itself on the card); B=1 latency under graphs in
    turns. The kernels at the new call sites (B4 at FiLM's projections, B5
    at the original head's shared stacks) against their plain versions.
    The checkpoint round trip without FiLM, and the exporter's refusal of
    FiLM."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from vla_adapter_torch.infer.predict import SERVING_RUNTIME, Predictor
    from vla_adapter_torch.models.layers import (
        init_random_,
        resolve_w8a8_impl,
    )
    from vla_adapter_torch.models.quantize import forward_error_report
    from vla_adapter_torch.models.vla import VLAModel
    from vla_adapter_torch.ops import attention_kernel, cuda_lib, w8a8_matmul
    from vla_adapter_torch.weights.export import export_checkpoint_dir
    from vla_adapter_torch.weights.load import load_vla

    cfg = original_film_config()
    gen = torch.Generator(device="cuda").manual_seed(seed + 10)
    model = init_random_(VLAModel(cfg, SERVING_RUNTIME, device="cuda"), gen)
    params = model.state_dict()
    del model
    common = dict(cfg=cfg, params=params, tokenize=bf16_pred.tokenize,
                  norm_stats=bf16_pred.norm_stats, center_crop=False,
                  device="cuda")
    rec = {"card": card, "parameters": sum(v.numel() for v in params.values()),
           "film_parameters": sum(v.numel() for k, v in params.items()
                                  if ".film_" in k)}

    # --- the kernels at the new call sites ---
    shapes = w8a8_shapes(cfg, bf16_pred.tokenize)
    new_sites = [dict(sh, model="original_film") for sh in shapes
                 if any("film" in n for n in sh["shape"])
                 or sh["kernel"] == w8a8_matmul.STACKED_KERNEL_NAME]
    rec["kernel_records"] = phase_w8a8_kernels(new_sites)

    # --- every tier: launches, graph vs eager, kernel vs plain ---
    auto = Predictor(act_int8=True, **common)
    tiers = {"bf16": Predictor(**common), "int8": Predictor(int8=True,
                                                             **common),
             "fused": auto.with_runtime(auto.rt, w8a8_impl="fused"),
             "dense": auto.with_runtime(auto.rt, w8a8_impl="dense"),
             "auto": auto,
             "mega": auto.with_runtime(auto.rt, w8a8_impl="mega")}
    n_llm = cfg.llm.num_layers
    attn_per_forward = (n_llm + cfg.vision.primary.resolved_feature_layer + 1
                        + cfg.vision.fused.resolved_feature_layer + 1)
    rows4 = [tiers["bf16"].preprocess(im, INSTRUCTION, p)
             for im, p in _requests(cfg, rng, 4)]
    a_bf16 = tiers["bf16"].normalized_actions(rows4)
    a_bf16_rows = _per_row_actions(tiers["bf16"], rows4)
    launches = collections.Counter()
    rec["tiers"] = {}
    for name, pred in tiers.items():
        eager = pred.with_runtime(pred.rt, cuda_graph=False)
        cell = {}
        cuda_lib.reset_launches()
        want = collections.Counter()
        for b in (1,) if name == "mega" else (1, 4):
            impl = (resolve_w8a8_impl(pred.w8a8_impl, b) if pred.act_int8
                    else None)
            for text in GRAPH_INSTRUCTIONS:
                rows = [pred.preprocess(im, text, p)
                        for im, p in _requests(cfg, rng, b)]
                got = pred.normalized_actions(rows)
                with cuda_lib.recording():  # the yardstick's launches apart
                    ref = eager.normalized_actions(rows)
                if not (got.shape == (b, 8, 7) and np.isfinite(got).all()
                        and np.array_equal(got, ref)):
                    raise AssertionError(
                        f"original_film {name} B={b}: replayed actions "
                        f"differ from eager by {float(np.abs(got - ref).max())}")
                if impl is not None:
                    want.update(expected_w8a8_launches(shapes, impl, b))
                want[attention_kernel.KERNEL_NAME] += (
                    attn_per_forward - (n_llm if impl == "mega" else 0))
        counts = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
        if counts != {k: v for k, v in want.items() if v}:
            raise AssertionError(f"original_film {name}: launches {counts}, "
                                 f"expected {dict(want)}")
        launches.update(counts)
        cell["launches"] = counts
        cell["graphs"] = pred.graphs.stats()
        cell["graph_bitwise_equal"] = True
        # the kernel path against the all-plain path, and against bf16
        plain = pred.with_runtime(dataclasses.replace(pred.rt,
                                                      kernels="plain"),
                                  cuda_graph=False)
        act = (_per_row_actions if name == "mega"
               else (lambda p, r: p.normalized_actions(r)))
        a_kernel, a_plain = act(pred, rows4), act(plain, rows4)
        cell["max_abs_diff_kernel_vs_plain"] = float(
            np.abs(a_kernel - a_plain).max())
        bound = W8A8_ACTIONS_ATOL if pred.act_int8 else FLAGSHIP_ACTIONS_ATOL
        if not cell["max_abs_diff_kernel_vs_plain"] <= bound:
            raise AssertionError(f"original_film {name}: kernel vs plain "
                                 f"{cell['max_abs_diff_kernel_vs_plain']}")
        if name != "bf16":
            ref = a_bf16_rows if name == "mega" else a_bf16
            cell["max_abs_diff_vs_bf16"] = float(np.abs(a_kernel - ref).max())
            if not cell["max_abs_diff_vs_bf16"] <= QUANTIZED_VS_BF16_LIMIT:
                raise AssertionError(f"original_film {name} vs bf16: "
                                     f"{cell['max_abs_diff_vs_bf16']}")
        rec["tiers"][name] = cell
        print(f"original_film {name} " + json.dumps(cell), flush=True)
    for kernel in {sh["kernel"] for sh in shapes}:
        if not launches[kernel]:
            raise AssertionError(f"{kernel} never launched on the original "
                                 f"model's path")

    # --- forward_error_report on the card ---
    rec["forward_error_report"] = {
        tier: forward_error_report(cfg, params, act_int8=act, device="cuda")
        for tier, act in (("int8", False), ("w8a8", True))}
    for tier, rep in rec["forward_error_report"].items():
        if not rep["max_abs_action_diff"] <= QUANTIZED_VS_BF16_LIMIT:
            raise AssertionError(f"forward_error_report {tier}: {rep}")

    # --- B=1 under graphs, in turns ---
    rows1 = rows4[:1]
    times = _in_turns(tiers, rows1, 8)
    rec["b1_graph"] = {name: _spread(v) for name, v in times.items()}
    print("original_film_b1 " + json.dumps(rec["b1_graph"]), flush=True)
    del tiers, auto, eager, plain
    torch.cuda.empty_cache()

    # --- checkpoints: the original head without FiLM; FiLM refused ---
    cfg_plain = dataclasses.replace(cfg, vision=dataclasses.replace(
        cfg.vision, use_film=False,
        primary=dataclasses.replace(cfg.vision.primary, film_llm_dim=None),
        fused=dataclasses.replace(cfg.vision.fused, film_llm_dim=None)))
    state = {k: v for k, v in params.items() if ".film_" not in k}
    tmp = Path(tempfile.mkdtemp(prefix="vla_ckpt_"))
    try:
        try:
            export_checkpoint_dir(params, cfg, tmp / "film")
        except NotImplementedError as err:
            rec["film_export_refused"] = str(err)
        else:
            raise AssertionError("the exporter wrote a FiLM checkpoint")
        t0 = time.perf_counter()
        export_checkpoint_dir(state, cfg_plain, tmp / "ckpt",
                              norm_stats=bf16_pred.norm_stats)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = load_vla(tmp / "ckpt", tokenize=bf16_pred.tokenize,
                          center_crop=False)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp)
    differ = [k for k, v in state.items()
              if not (loaded.params[k].dtype == v.dtype
                      and torch.equal(loaded.params[k], v))]
    if set(loaded.params) != set(state) or differ:
        raise AssertionError(f"original head checkpoint: weights differ: "
                             f"{differ[:5]}")
    src = Predictor(cfg=cfg_plain, params=state, tokenize=bf16_pred.tokenize,
                    norm_stats=bf16_pred.norm_stats, center_crop=False,
                    device="cuda")
    got, want = loaded.predict_action_rows(rows4), src.predict_action_rows(rows4)
    if not (np.isfinite(got).all() and np.array_equal(got, want)):
        raise AssertionError("original head checkpoint: actions differ by "
                             f"{float(np.abs(got - want).max())}")
    rec["checkpoint"] = {"export_s": export_s, "load_bf16_s": load_s,
                         "state_dict_bitwise_equal": True,
                         "actions_bitwise_equal": True}
    print("original_film_checkpoint " + json.dumps(
        {k: rec[k] for k in ("checkpoint", "film_export_refused",
                             "forward_error_report")}), flush=True)
    del loaded, src, params, state
    torch.cuda.empty_cache()
    return rec, dict(launches)


def w8a8_kernel_summary(records, launches):
    """The kernels line's entries for the four w8a8 kernels: per-call
    times and bounds of phase 3 summed over the launches of one B=1 forward
    under the "fused" backend; max_abs_err is the worst over all shapes."""
    sources = {"w8a8_matmul": ("w8a8_matmul.cu",
                               "vla_adapter_tpu/ops/pallas_matmul.py:140"),
               "w8a8_matmul_stacked": ("w8a8_matmul.cu",
                                       "vla_adapter_tpu/ops/pallas_matmul.py:77"),
               "w8a8_gated_mlp": ("fused_mlp_w8a8.cu",
                                  "vla_adapter_tpu/ops/pallas_fused_mlp.py:152"),
               "w8a8_mlp": ("fused_mlp_w8a8.cu",
                            "vla_adapter_tpu/ops/pallas_fused_mlp.py:182")}
    out = []
    for name, (source, replaces) in sources.items():
        mine = [r for r in records if r["kernel"] == name]
        fwd = [r for r in mine if r["forward_batch"] == 1]

        def total(key, rows=fwd):
            return sum(r[key] * r["launches_per_forward"] for r in rows)

        ops, nbytes = total("ops"), total("bytes")
        t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_HBM_BYTES
        lib = [r for r in fwd if r.get("int_mm_ms") is not None]
        extra = ({key: total(key) for key in ("cold_ms", "xq_ms",
                                              "chain_ms")}
                 if fwd and "xq_ms" in fwd[0] else {})
        calls = sum(r["launches_per_forward"] for r in fwd)
        entry = {
            "name": name, "route": "cuda",
            "source": f"vla_adapter_torch/csrc/{source}",
            "replaces": replaces, "launches": launches.get(name, 0),
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": (total("int_mm_ms", lib)
                           if name == "w8a8_matmul" and lib else None),
            **extra,
            "per": f"sum over the {calls} launches of one B=1 forward "
                   "(fused backend)"}
        if entry["library_ms"] is not None:
            entry["library"] = (
                "torch._int_mm, the int8 product alone (no quantization, no "
                "dequant); at M <= 16, which it refuses, on x zero-padded "
                "to 24 rows")
        out.append(entry)
    return out


def megalayer_kernel_summary(records, launches):
    """The kernels line's entry for the layer kernel: its phase-3 per-call
    times and bound summed over the launches of one B=1 forward under the
    "mega" backend (one per decoder layer)."""
    from vla_adapter_torch.ops import megalayer

    (r,) = [r for r in records if r["kernel"] == megalayer.KERNEL_NAME]
    n = r["launches_per_forward"]
    return [{
        "name": megalayer.KERNEL_NAME, "route": "cuda",
        "source": f"vla_adapter_torch/csrc/{megalayer.SOURCE}",
        "replaces": "vla_adapter_tpu/ops/pallas_megalayer.py:178",
        "launches": launches.get(megalayer.KERNEL_NAME, 0),
        "max_abs_err": r["max_abs_err"], "ms": n * r["ms"],
        "plain_ms": n * r["plain_ms"], "bound_ms": n * r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None,
        "fused_chain_ms": n * r["fused_chain_ms"],
        "per": f"sum over the {n} launches of one B=1 forward (mega "
               "backend); fused_chain_ms: the same layers through the fused "
               "backend's launches"}]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the results as JSON here")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", action="store_true",
                        help="also profile one B=1 request per tier, eager "
                             "and replayed (torch.profiler)")
    args = parser.parse_args()

    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import vla_adapter_torch
    from vla_adapter_torch.ops import cuda_lib

    pkg = os.path.dirname(os.path.abspath(vla_adapter_torch.__file__))
    if os.path.dirname(pkg) != HERE:
        print(f"chip_smoke: vla_adapter_torch comes from {pkg}, not from "
              f"this checkout", file=sys.stderr)
        return 2
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    phase_s = {}
    t_start = time.perf_counter()

    def lap(name):  # wall seconds of each phase, printed and kept
        phase_s[name] = time.perf_counter() - t_start - sum(phase_s.values())
        print(f"phase {name}: {phase_s[name]:.1f} s", flush=True)

    # 1. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    cuda_lib.load_libraries(SOURCES)
    print(f"build: {', '.join(SOURCES)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for source in SOURCES:
        for line in cuda_lib.BUILD_LOGS.get(source, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {source}: " + line.strip(), flush=True)
    card = card_line()
    print(f"card: {card}", flush=True)
    lap("1 build")

    # 2. attention kernel vs plain at the main path's shapes
    cfg, predictor, n_params, rng = build_flagship(args.seed)
    print(f"flagship: {n_params / 1e9:.3f} B parameters in bf16", flush=True)
    records = phase_kernel_vs_plain(attention_shapes(cfg, predictor.tokenize))
    lap("2 attention")

    # 3. the w8a8 kernels vs plain at the w8a8 main path's shapes
    shapes = w8a8_shapes(cfg, predictor.tokenize)
    w8a8_records = phase_w8a8_kernels(shapes)
    (mega,) = [r for r in w8a8_records if "fused_chain_ms" in r]
    print(f"megalayer: {1e3 * mega['ms']:.1f} us per call, the fused "
          f"backend's launches of the same layer "
          f"{1e3 * mega['fused_chain_ms']:.1f} us", flush=True)
    lap("3 w8a8 kernels")

    # 4. the on-card weight quantizer
    quantizer = phase_quantizer(predictor.params)
    lap("4 quantizer")

    # 5. the bf16 flagship forward through Predictor
    flagship, launches = phase_flagship(predictor, rng, card)
    print(f"kernels launched on the bf16 main path: {sorted(launches)}",
          flush=True)
    lap("5 flagship bf16")

    # 6. the w8a8 and int8 flagship forwards through Predictor
    w8a8, w8a8_launches = phase_w8a8(predictor, shapes, rng, card)
    print(f"kernels launched on the w8a8 main path: {sorted(w8a8_launches)}",
          flush=True)
    lap("6 flagship w8a8")

    # 7. every tier as a CUDA graph against eager
    graphs = phase_graph(predictor, rng, card, profile=args.profile)
    lap("7 graphs")

    # 8. the flagship exported and loaded back without JAX
    checkpoint = phase_checkpoint(predictor, rng, card)
    lap("8 checkpoint")

    # 9. the /act server with dynamic batching (path A)
    server, server_launches = phase_server(predictor, card)
    print(f"kernels launched on the server path: {sorted(server_launches)}",
          flush=True)
    lap("9 server")

    # 10. the original head with FiLM towers, every tier (path B)
    original, original_launches = phase_original_film(predictor, rng, card,
                                                      args.seed)
    print(f"kernels launched on the original model's path: "
          f"{sorted(original_launches)}", flush=True)
    lap("10 original_film")

    # 11. the finetune path: B1-bwd, the STE product, the flagship finetune
    train, train_launches, bwd_records = phase_train(cfg, card, args.seed,
                                                     profile=args.profile)
    print(f"kernels launched on the train path: {sorted(train_launches)}",
          flush=True)
    lap("11 train")
    kernels = (kernel_summary(records, launches)
               + w8a8_kernel_summary(w8a8_records, w8a8_launches)
               + megalayer_kernel_summary(w8a8_records, w8a8_launches)
               + attention_bwd_kernel_summary(bwd_records, train_launches))
    paths = {"flagship_bf16": launches, "flagship_w8a8": w8a8_launches,
             "server": server_launches, "original_film": original_launches,
             "train": train_launches}
    for entry in kernels:
        entry["launches_by_path"] = {path: counts.get(entry["name"], 0)
                                     for path, counts in paths.items()}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "shapes": records,
                       "w8a8_shapes": w8a8_records, "quantizer": quantizer,
                       "flagship": flagship, "flagship_w8a8": w8a8,
                       "graph": graphs, "checkpoint": checkpoint,
                       "server": server, "original_film": original,
                       "train": train, "attention_bwd_shapes": bwd_records,
                       "kernels": kernels, "phase_s": phase_s}, f,
                      indent=1)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
