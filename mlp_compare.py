"""Kernels B2/B3 (``vla_adapter_torch/ops/fused_mlp.py``) on the card at the
shapes ``PERF.md`` lists for them: each call held against its plain version
(bit for bit reported, ``chip_smoke.py:mlp_tolerance``'s bound enforced),
then timed under CUDA-graph replay beside the plain version, the "dense"
chain and the bound.

    python3 mlp_compare.py                        # this tree, every shape
    python3 mlp_compare.py --trees parent_tree,.  # trees in turns: A B B A
    python3 mlp_compare.py --quick                # a few shapes: build, check
    python3 mlp_compare.py --shapes qwen2_b1,qwen2_m1  # named shapes only
    python3 mlp_compare.py --variants             # the plan's alternatives

The "dense" chain is the same MLP as the "dense" backend of
``models/layers.py`` runs it: kernel B4 (with its quantization pre-pass)
for gate and up or fc1, PyTorch's elementwise passes for the bias and the
activation, then B4 for down or fc2. It rounds h to bf16 and quantizes it
per row over all of F, so its output differs from B2/B3's: its time is a
yardstick only. ``--variants`` also times each shape on the plans the
kernel can take besides the default: no split of K or panels, and (at
more than 32 rows) the down items split over panel groups. Alternatives
in the source are timed as trees of their own with ``--trees``. With ``--trees``
each tree runs in a child process of its own (the package imported from
that directory), in the order A, B, B, A; ``parent_tree/`` is the parent
commit unpacked with ``git archive``. Prints one ``mlp_shape`` line per
shape and run and the card's name and power limit, and with ``--out
FILE`` writes everything there as JSON. Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

PEAK_INT8_OPS = 1979e12   # H100 SXM, dense int8 tensor-core peak
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3

# (name, M, K, F, D, activation, gated): the flagship's MLPs at B=1 and
# B=4, a w8a8 decode step's rows at 0.5B and 7B, the 7B and 13B zoo
# prefills, and the zoo's towers and projectors.
SHAPES = [
    ("qwen2_b1", 640, 896, 4864, 896, "silu", True),
    ("qwen2_b4", 2560, 896, 4864, 896, "silu", True),
    ("qwen2_m1", 1, 896, 4864, 896, "silu", True),
    ("qwen2_m2", 2, 896, 4864, 896, "silu", True),
    ("qwen2_m4", 4, 896, 4864, 896, "silu", True),
    ("llama2_7b_prefill", 857, 4096, 11008, 4096, "silu", True),
    ("llama2_7b_m1", 1, 4096, 11008, 4096, "silu", True),
    ("llama2_7b_m2", 2, 4096, 11008, 4096, "silu", True),
    ("llama2_7b_m4", 4, 4096, 11008, 4096, "silu", True),
    ("mistral_7b_prefill", 704, 4096, 14336, 4096, "silu", True),
    ("llama2_13b_prefill", 857, 5120, 13824, 5120, "silu", True),
    ("dinov2_b1", 522, 1024, 4096, 1024, "gelu", False),
    ("dinov2_b4", 2088, 1024, 4096, 1024, "gelu", False),
    ("so400m_b1", 512, 1152, 4304, 1152, "gelu_tanh", False),
    ("so400m_b4", 2048, 1152, 4304, 1152, "gelu_tanh", False),
    ("projector_b1", 512, 2176, 8704, 896, "gelu", False),
    ("projector_b4", 2048, 2176, 8704, 896, "gelu", False),
    ("clip_l_336", 577, 1024, 4096, 1024, "quick_gelu", False),
    ("so400m_384", 729, 1152, 4304, 1152, "gelu_tanh", False),
    ("gelu_mlp_projector", 576, 1024, 4096, 4096, "gelu", False),
    ("fused_projector", 729, 2176, 8704, 4096, "gelu", False),
]
QUICK = ["qwen2_b1", "qwen2_m1", "qwen2_m4", "so400m_b1", "llama2_7b_m2",
         "projector_b1"]


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


def device_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """One call's device time: ``reps`` calls captured in a CUDA graph,
    replayed; the median over ``rounds`` of CUDA-event time over reps."""
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
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(m, k, f, d, gated):
    """(ms, by): int8 operations over the int8 peak against bf16 x, the
    int8 weights, their scales, the biases and the bf16 output, each once,
    over HBM (``chip_smoke.py:w8a8_bound``)."""
    ops = 2 * m * k * f * (2 if gated else 1) + 2 * m * f * d
    nbytes = (2 * m * k + k * f * (2 if gated else 1) + f * d
              + 4 * (2 * f + d) + (0 if gated else 4 * (f + d)) + 2 * m * d)
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def tolerance(want, h_max, w2, s2):
    """``chip_smoke.py:mlp_tolerance``: one int8 step of h through the down
    projection plus two bf16 ulps of the largest output; at most 2% of the
    rows beyond two ulps of an output."""
    step = h_max / 127.0 * float((w2.float().abs() * s2[:, None]).max())
    return step + 2 * 2.0 ** -7 * float(want.float().abs().max()), 0.02


def variant_plans(fm, m, k, f, d, gated, sms):
    """(name, plan) of the plans besides the default a shape can take on a
    tree whose plan has slices: no split at all, and at more than 32 rows the down items split into about one group a
    panel where that gives more down items than SMs."""
    base = fm.mlp_plan(m, k, f, d, gated=gated, sms=sms)
    if "up_slice" not in base:
        return []
    out = []
    if base["up_splits"] > 1 or base["down_splits"] > 1:
        out.append(("no_split", dict(base, up_slice=base["k_steps"],
                                     up_splits=1,
                                     down_slice=base["panels"],
                                     down_splits=1)))
    if m > fm.DECODE_ROWS and base["down_items"] < sms:
        want = -(-sms // base["down_items"])
        sl = -(-base["panels"] // min(base["panels"], want))
        out.append((f"down_slice_{sl}", dict(
            base, down_slice=sl, down_splits=-(-base["panels"] // sl))))
    return out


def child(tree: str, names, variants: bool) -> list:
    """Check and time each shape with the package of ``tree``."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    import torch.nn.functional as F

    import vla_adapter_torch
    from vla_adapter_torch.models.quantize import quantize_weight
    from vla_adapter_torch.ops import cuda_lib
    from vla_adapter_torch.ops import fused_mlp as fm
    from vla_adapter_torch.ops.w8a8_matmul import (
        int_matmul,
        quantize_rows,
        w8a8_linear,
    )

    here = os.path.dirname(os.path.abspath(vla_adapter_torch.__file__))
    if not here.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {here}, not the package of {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("mlp_compare.py needs a CUDA card")
    dev = torch.device("cuda")
    sms = cuda_lib.sm_count(dev)
    t0 = time.perf_counter()
    fm._lib()
    print(f"built {fm.SOURCE} in {time.perf_counter() - t0:.1f} s", flush=True)
    if variants:
        print(cuda_lib.BUILD_LOGS.get(fm.SOURCE, ""), flush=True)
    dense_acts = {"silu": F.silu, "gelu": F.gelu,
                  "gelu_tanh": lambda v: F.gelu(v, approximate="tanh"),
                  "quick_gelu": lambda v: v * torch.sigmoid(1.702 * v)}
    records = []
    for name, m, k, f, d, act, gated in SHAPES:
        if names and name not in names:
            continue
        gen = torch.Generator(device=dev).manual_seed(m * 3 + f + k)

        def randn(*size):
            return torch.randn(size, generator=gen, device=dev)

        def weight(n, kk):
            return quantize_weight(randn(n, kk) / kk ** 0.5)

        x = randn(m, k).bfloat16()
        w1, s1 = weight(f, k)
        w2, s2 = weight(d, f)
        wu, su = weight(f, k) if gated else (None, None)
        b1 = None if gated else 0.02 * randn(f)
        b2 = None if gated else 0.02 * randn(d)
        kname = fm.GATED_KERNEL_NAME if gated else fm.KERNEL_NAME

        def call(plan=None):
            if plan is not None:
                return fm._launch(kname, x, w1, s1, wu, su, b1, w2, s2, b2,
                                  act, None, fm.BLOCK_F, plan=plan)
            if gated:
                return fm.w8a8_gated_mlp(x, w1, s1, wu, su, w2, s2, act=act)
            return fm.w8a8_mlp(x, w1, s1, b1, w2, s2, b2, act=act)

        def plain():
            return fm.fused_mlp_reference(x, w1, s1, w2, s2, up_q=wu,
                                          up_scale=su, b1=b1, b2=b2, act=act)

        def dense():
            g = w8a8_linear(x, w1, s1)
            if gated:
                h = F.silu(g) * w8a8_linear(x, wu, su)
            else:
                h = dense_acts[act](g + b1.bfloat16())
            out = w8a8_linear(h, w2, s2)
            return out if gated else out + b2.bfloat16()

        xq, rs = quantize_rows(x)
        g = int_matmul(xq, w1).float() * rs * s1
        h = fm.kernel_activation(act)(g if b1 is None else g + b1)
        if gated:
            h = h * (int_matmul(xq, wu).float() * rs * su)
        want = plain()

        def check(got, label):
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            limit, share = tolerance(want, float(h.abs().max()), w2, s2)
            flipped = (err > 2 * 2.0 ** -7 * want.float().abs()).any(dim=-1)
            ok = (bool(torch.isfinite(got.float()).all())
                  and float(err.max()) <= limit
                  and float(flipped.float().mean()) <= share)
            if not ok:
                raise AssertionError(
                    f"{name} ({label}): max err {float(err.max())} against "
                    f"{limit}, rows beyond 2 ulps {int(flipped.sum())}")
            return float(err.max()), bool(torch.equal(got, want))

        err, equal = check(call(), "kernel")
        again = call()
        torch.cuda.synchronize()
        ms_bound, by = bound(m, k, f, d, gated)
        rec = {"shape": name, "m": m, "k": k, "f": f, "d": d, "act": act,
               "gated": gated, "max_abs_err": err, "bitwise_equal": equal,
               "repeatable": bool(torch.equal(again, call())),
               "ms": device_ms(call), "plain_ms": device_ms(plain, reps=3),
               "dense_ms": device_ms(dense), "bound_ms": ms_bound,
               "bound_by": by,
               "plan": fm.mlp_plan(m, k, f, d, gated=gated, sms=sms)}
        if variants:
            for label, plan in variant_plans(fm, m, k, f, d, gated, sms):
                rec[f"{label}_err"], rec[f"{label}_equal"] = check(
                    call(plan), label)
                rec[f"{label}_ms"] = device_ms(lambda: call(plan))
        print("mlp_shape " + json.dumps(rec), flush=True)
        records.append(rec)
    return records


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", default=".",
                    help="comma-separated trees; two run in turns A B B A")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--out", help="also write the results as JSON here")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--shapes", default="",
                    help="comma-separated shape names (default: all)")
    args = ap.parse_args()
    names = QUICK if args.quick else [s for s in args.shapes.split(",")
                                      if s] or None
    if args.child:
        records = child(args.child, names, args.variants)
        with open(args.out, "w") as f:
            json.dump(records, f)
        return 0
    trees = args.trees.split(",")
    order = trees if len(trees) == 1 else [trees[0], trees[1], trees[1],
                                           trees[0]]
    card = card_line()
    print(card, flush=True)
    parts = tempfile.mkdtemp(prefix="mlp_compare_")
    runs = []
    for i, tree in enumerate(order):
        part = os.path.join(parts, f"run{i}.json")
        cmd = [sys.executable, os.path.abspath(__file__), "--child", tree,
               "--out", part]
        if args.quick:
            cmd.append("--quick")
        if args.shapes:
            cmd += ["--shapes", args.shapes]
        if args.variants and len(trees) == 1:
            cmd.append("--variants")
        print(f"run {i}: {tree}", flush=True)
        subprocess.run(cmd, check=True, timeout=1800)
        with open(part) as f:
            runs.append({"tree": tree, "records": json.load(f)})
    summary = []
    if len(trees) > 1:
        for rec in runs[0]["records"]:
            times = {t: [r["ms"] for run in runs if run["tree"] == t
                         for r in run["records"] if r["shape"] == rec["shape"]]
                     for t in trees}
            a, b = times[trees[0]], times[trees[1]]
            line = {"shape": rec["shape"], trees[0]: a, trees[1]: b,
                    "plain_ms": rec["plain_ms"], "dense_ms": rec["dense_ms"],
                    "bound_ms": rec["bound_ms"],
                    "speedup": statistics.mean(a) / statistics.mean(b),
                    "spread": max(max(a) - min(a), max(b) - min(b))}
            print("mlp_compare " + json.dumps(line), flush=True)
            summary.append(line)
    shutil.rmtree(parts)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "runs": runs, "summary": summary}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
