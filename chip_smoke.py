"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--out FILE]

Phases, in order; any failure exits non-zero:

1. build: compile every CUDA kernel of the serving path from
   ``vla_adapter_torch/csrc`` with nvcc (sm_90a) and print the card.
2. kernel vs plain: at the shapes one serving forward gives the attention
   kernel (Qwen2 14/2 heads, S=640, D=64, key padding, and causal; DINOv2
   16 heads, S=261, D=64; so400m 16 heads, S=256, D=72; for B=1 and B=2),
   hold the kernel against its plain PyTorch version and time the kernel,
   the plain version and ``scaled_dot_product_attention`` (a yardstick
   only: the port never calls it).
3. flagship forward: ``VLAConfig()`` at full width and depth (DINOv2-L +
   so400m @224, 2 images, Qwen2.5-0.5B, a 24-block Pro head, 640 LLM
   tokens), random bf16 weights from a seeded CUDA generator, served
   through ``Predictor``: predict_action (B=1) and predict_action_batch
   (B=4), with launch counts read around exactly those requests. The same
   rows then go through the plain attention for an end-to-end comparison.

Prints the card's name and power limit, one JSON line per kernel shape, a
``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``. Exits non-zero without CUDA, and when
the ``vla_adapter_torch`` package beside this script is missing.
"""

from __future__ import annotations

import argparse
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
PEAK_HBM_BYTES = 3.35e12

# kernel vs plain: bf16 output of |out| < 4, the two differ in fp32
# summation order and exp rounding, so by about one bf16 ulp (2^-6 at 2-4).
KERNEL_ATOL = 2e-2
# flagship, kernel vs plain attention, normalized actions: 73 attention
# calls in bf16 through 24+23+26 random-weight layers and a 24-block head.
FLAGSHIP_ACTIONS_ATOL = 1e-1

INSTRUCTION = "put both the alphabet soup and the tomato sauce in the basket"


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


def attention_shapes(cfg, tokenize):
    """(name, forward batch, batch, heads, kv heads, seq, head dim, key
    valid, causal, launches per forward) for B=1 and B=2 serving forwards;
    the towers see 2 images per request."""
    from vla_adapter_torch.data.transform import inference_ids

    _, _, text_valid = inference_ids(cfg, tokenize, INSTRUCTION)
    mm_valid = np.concatenate([text_valid[:1], np.ones(cfg.num_patches,
                                                       np.int32),
                               text_valid[1:]])
    llm, dino, siglip = cfg.llm, cfg.vision.primary, cfg.vision.fused
    n_img = cfg.vision.num_images
    shapes = []
    for b in (1, 2):
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
        attention_reference,
        fused_attention,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    records = []
    for name, fwd_b, b, h, hkv, s, d, valid_np, causal, per_fwd in shapes:
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
               "flops": flops, "bytes": nbytes}
        print("attention_shape " + json.dumps(rec), flush=True)
        records.append(rec)
    return records


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
    t0 = time.perf_counter()
    out_b = predictor.predict_action_batch(
        [im for im, _ in batch], [INSTRUCTION] * 4, [p for _, p in batch])
    batch_s = time.perf_counter() - t0
    launches = dict(cuda_lib.LAUNCHES)
    forwards = len(requests) + 1

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
        dataclasses.replace(predictor.rt, attn_impl="plain"))
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
           "b4_ms": 1e3 * batch_s, "b4_ms_per_chunk": 1e3 * batch_s / 4,
           "b1_plain_attention_ms_median": 1e3 * statistics.median(plain_s),
           "attention_launches": launches.get("fused_attention", 0),
           "forwards": forwards, "launches_per_forward": per_forward,
           "max_abs_diff_normalized_actions_kernel_vs_plain": diff,
           "max_abs_normalized_action": float(np.abs(kernel_actions).max()),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    print("flagship " + json.dumps(rec), flush=True)
    return rec, launches


def profile_request(predictor, rng):
    """One B=1 predict_action under torch.profiler: the device's busy time
    (sum of kernel durations on the card) against the request's host wall
    time, and the kernels that take most of it."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = predictor.cfg
    size = cfg.vision.primary.image_size
    images = [rng.integers(0, 256, size=(size, size, 3), dtype=np.uint8)
              for _ in range(cfg.vision.num_images)]
    proprio = rng.normal(size=cfg.constants.proprio_dim)
    predictor.predict_action(images, INSTRUCTION, proprio)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predictor.predict_action(images, INSTRUCTION, proprio)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name[:60]] += e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    rec = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1 - busy_ms / wall_ms,
           "device_kernels": len(kernels),
           "attention_kernel_ms": sum(v for k, v in by_name.items()
                                      if "fused_attention" in k),
           "top": [[k, v] for k, v in by_name.most_common(8)]}
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the results as JSON here")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", action="store_true",
                        help="also profile one B=1 request (torch.profiler)")
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

    # 1. build
    t0 = time.perf_counter()
    cuda_lib.load_library("fused_attention.cu")
    print(f"build: fused_attention.cu in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for line in cuda_lib.BUILD_LOGS.get("fused_attention.cu", "").splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas " + line.strip(), flush=True)
    card = card_line()
    print(f"card: {card}", flush=True)

    # 2. kernel vs plain at the main path's shapes
    cfg, predictor, n_params, rng = build_flagship(args.seed)
    print(f"flagship: {n_params / 1e9:.3f} B parameters in bf16", flush=True)
    records = phase_kernel_vs_plain(attention_shapes(cfg, predictor.tokenize))

    # 3. the flagship forward through Predictor
    flagship, launches = phase_flagship(predictor, rng, card)
    print(f"kernels launched on the main path: {sorted(launches)}", flush=True)
    profiled = profile_request(predictor, rng) if args.profile else None
    kernels = kernel_summary(records, launches)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "shapes": records, "flagship": flagship,
                       "profile": profiled, "kernels": kernels}, f, indent=1)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
