"""Kernel B4/B5 (``vla_adapter_torch/ops/w8a8_matmul.py``) on the card at
the shapes ``PERF.md`` lists for it: each call held bit for bit against its
plain version, then timed under CUDA-graph replay beside ``torch._int_mm``
(the int8 product alone) and the bound.

    python3 b4_compare.py                      # this tree, every branch
    python3 b4_compare.py --trees parent_tree,.  # trees in turns: A B B A
    python3 b4_compare.py --quick              # a few shapes: build, check
    python3 b4_compare.py --shapes fc3_b1,head_b8  # named shapes only

With ``--trees`` each tree runs in a child process of its own (the
package imported from that directory), in the order A, B, B, A, so that
two versions meet on one card and host; ``parent_tree/`` is the parent
commit unpacked with ``git archive``. On a tree whose wrapper has a plan
(``w8a8_plan``), each shape is also timed on each branch it can take
("hopper": TMA + wgmma; up to 32 rows "narrow": mma.sync), with float x
the pre-pass and the product alone too. Prints one ``b4_shape`` line
per shape and run and the card's name and power limit, and with
``--out FILE`` writes everything there as JSON. Needs a CUDA card;
imports no JAX.
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

# (name, M, K, N, layers, x dtype, out dtype): the B=1 and B=4 serving
# shapes (the "dense" backend's MLP matmuls among them), Phi-2's at its
# 136-row prompt, the server's B=8/16 "dense" matmuls, the 7B zoo's, the
# finetune's straight-through products at micro-batch 16 (forward on bf16
# x, dx on f32 dy * ws against the (in, out) weight) and the "tensor"
# axis's int32 split-K products.
SHAPES = [
    ("qwen2_q_o_b1", 640, 896, 896, 1, "bf16", "bf16"),
    ("dinov2_b1", 522, 1024, 1024, 1, "bf16", "bf16"),
    ("so400m_b1", 512, 1152, 1152, 1, "bf16", "bf16"),
    ("fc3_b1", 512, 896, 896, 1, "bf16", "bf16"),
    ("b5_task_b1", 512, 896, 896, 24, "bf16", "bf16"),
    ("b5_adapter_b1", 65, 896, 896, 24, "bf16", "bf16"),
    ("dense_qwen2_gate_up_b1", 640, 896, 4864, 1, "bf16", "bf16"),
    ("dense_qwen2_down_b1", 640, 4864, 896, 1, "bf16", "bf16"),
    ("dense_dinov2_fc1_b1", 522, 1024, 4096, 1, "bf16", "bf16"),
    ("dense_dinov2_fc2_b1", 522, 4096, 1024, 1, "bf16", "bf16"),
    ("dense_so400m_fc1_b1", 512, 1152, 4304, 1, "bf16", "bf16"),
    ("dense_so400m_fc2_b1", 512, 4304, 1152, 1, "bf16", "bf16"),
    ("dense_projector_fc1_b1", 512, 2176, 8704, 1, "bf16", "bf16"),
    ("dense_projector_fc2_b1", 512, 8704, 896, 1, "bf16", "bf16"),
    ("head_b8", 64, 896, 896, 1, "bf16", "bf16"),
    ("head_b16", 128, 896, 896, 1, "bf16", "bf16"),
    ("phi2_lm_head", 1, 2560, 51200, 1, "bf16", "bf16"),
    ("7b_qkvo_m1", 1, 4096, 4096, 1, "bf16", "bf16"),
    ("7b_lm_head_m4", 4, 4096, 32000, 1, "bf16", "bf16"),
    ("b5_adapter_b4", 260, 896, 896, 24, "bf16", "bf16"),
    ("phi2_qkvo", 136, 2560, 2560, 1, "bf16", "bf16"),
    ("phi2_fc1", 136, 2560, 10240, 1, "bf16", "bf16"),
    ("phi2_fc2", 136, 10240, 2560, 1, "bf16", "bf16"),
    ("qwen2_q_o_b4", 2560, 896, 896, 1, "bf16", "bf16"),
    ("dense_qwen2_gate_up_b4", 2560, 896, 4864, 1, "bf16", "bf16"),
    ("dinov2_b4", 2088, 1024, 1024, 1, "bf16", "bf16"),
    ("so400m_b4", 2048, 1152, 1152, 1, "bf16", "bf16"),
    ("fc3_b4", 2048, 896, 896, 1, "bf16", "bf16"),
    ("b5_task_b4", 2048, 896, 896, 24, "bf16", "bf16"),
    ("qwen2_gate_up_b8", 5120, 896, 4864, 1, "bf16", "bf16"),
    ("qwen2_gate_up_b16", 10240, 896, 4864, 1, "bf16", "bf16"),
    ("qwen2_down_b16", 10240, 4864, 896, 1, "bf16", "bf16"),
    ("qwen2_q_o_b16", 10240, 896, 896, 1, "bf16", "bf16"),
    ("projector_fc1_b16", 8192, 2176, 8704, 1, "bf16", "bf16"),
    ("b5_task_b16", 8192, 896, 896, 24, "bf16", "bf16"),
    ("7b_qkvo", 857, 4096, 4096, 1, "bf16", "bf16"),
    ("7b_lm_head", 857, 4096, 32000, 1, "bf16", "bf16"),
    ("ste_llm_kv", 10240, 896, 128, 1, "bf16", "bf16"),
    ("ste_llm_kv_dx", 10240, 128, 896, 1, "f32", "bf16"),
    ("ste_llm_gate_up_dx", 10240, 4864, 896, 1, "f32", "bf16"),
    ("ste_llm_down_dx", 10240, 896, 4864, 1, "f32", "bf16"),
    ("ste_dinov2_qkvo", 8352, 1024, 1024, 1, "bf16", "bf16"),
    ("ste_dinov2_fc1", 8352, 1024, 4096, 1, "bf16", "bf16"),
    ("ste_dinov2_fc2", 8352, 4096, 1024, 1, "bf16", "bf16"),
    ("ste_so400m_fc1", 8192, 1152, 4304, 1, "bf16", "bf16"),
    ("ste_so400m_fc2_dx", 8192, 1152, 4304, 1, "f32", "bf16"),
    ("ste_projector_fc2", 8192, 8704, 896, 1, "bf16", "bf16"),
    ("ste_projector_fc1_dx", 8192, 8704, 2176, 1, "f32", "bf16"),
    ("tensor_llm_o", 10240, 448, 896, 1, "int8", "int32"),
    ("tensor_llm_down", 10240, 2432, 896, 1, "int8", "int32"),
    ("tensor_so400m_fc2", 8192, 2160, 1152, 1, "int8", "int32"),
    ("tensor_4_k1088", 8192, 1088, 1152, 1, "int8", "int32"),
    ("tensor_projector_fc2", 8192, 4352, 896, 1, "int8", "int32"),
]
QUICK = ["qwen2_q_o_b1", "b5_task_b4", "qwen2_down_b16", "ste_llm_kv_dx",
         "ste_so400m_fc2_dx", "tensor_so400m_fc2", "tensor_4_k1088"]


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


def bound(m, k, n, layers, x_kind, out_kind):
    """(ms, by): int8 operations over the int8 peak against x (as given),
    the int8 weights, their scales and the output, each once, over HBM."""
    x_bytes = {"bf16": 2, "f32": 4, "int8": 1}[x_kind] * m * k
    if x_kind == "int8" and out_kind != "int32":
        x_bytes += 4 * m
    out_bytes = {"bf16": 2, "int32": 4}[out_kind] * m * n
    ops = 2 * layers * m * k * n
    nbytes = layers * (x_bytes + n * k + 4 * n + out_bytes)
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def branch_plans(ops, plan, x_dtype, out_dtype, sms):
    """(branch, plan) of each branch a shape can take: "hopper" (TMA +
    wgmma) and, where the card's plan takes it, "narrow" (mma.sync, K split
    over CTAs: up to 32 rows, its CTAs resident)."""
    return [(b, ops.w8a8_plan(plan["m"], plan["n"], plan["k"],
                              plan["layers"], x_dtype, out_dtype, sms,
                              branch=b))
            for b in ({"narrow", plan["branch"]} | {"hopper"}
                      if plan["branch"] == "narrow" else ("hopper",))]


def child(tree: str, names, branches: bool) -> list:
    """Check and time each shape with the package of ``tree``."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import vla_adapter_torch
    from vla_adapter_torch.ops import cuda_lib
    from vla_adapter_torch.ops import w8a8_matmul as ops

    here = os.path.dirname(os.path.abspath(vla_adapter_torch.__file__))
    if not here.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {here}, not the package of {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("b4_compare.py needs a CUDA card")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    ops._lib()
    build_s = time.perf_counter() - t0
    log = cuda_lib.BUILD_LOGS.get(ops.SOURCE, "")
    print(f"built {ops.SOURCE} in {build_s:.1f} s", flush=True)
    if branches:
        print(log, flush=True)
    planned = hasattr(ops, "w8a8_plan")
    if planned and branches:
        for x_dtype in (torch.bfloat16, torch.float32):
            print(f"narrow CTAs per SM, x {x_dtype}: "
                  f"{ops.narrow_occupancy(x_dtype, torch.bfloat16)}",
                  flush=True)
        for m, k, n in ((10240, 896, 4864), (640, 896, 896)):
            print(f"tensor maps, host ns per launch at {(m, k, n)}: "
                  f"{ops.map_encode_ns(m, n, k)}", flush=True)
    records = []
    for name, m, k, n, layers, x_kind, out_kind in SHAPES:
        if names and name not in names:
            continue
        gen = torch.Generator(device=dev).manual_seed(m + k + n + layers)
        lead = (layers,) if layers > 1 else ()
        x = torch.randn(*lead, m, k, generator=gen, device=dev)
        x[..., 3] *= 20.0
        x[..., min(1, m - 1), :] = 0.0
        w = torch.randint(-127, 128, (*lead, n, k), generator=gen,
                          device=dev, dtype=torch.int8)
        ws = torch.rand(*lead, n, generator=gen, device=dev) * 1e-2 + 1e-3
        raw = out_kind == "int32"
        if x_kind == "int8":
            xq, rs = ops.quantize_rows(x)
            args = (xq, None if raw else rs, w, None if raw else ws)
            out_dtype = torch.int32 if raw else torch.bfloat16
            entry = ops.w8a8_matmul if layers == 1 else ops.w8a8_matmul_stacked
            want = ops.w8a8_matmul_reference(*args, out_dtype=out_dtype)
        else:
            x = x.to(torch.bfloat16 if x_kind == "bf16" else torch.float32)
            args, out_dtype, entry = (x, w, ws), torch.bfloat16, ops.w8a8_linear
            want = ops.w8a8_linear_reference(*args, out_dtype=out_dtype)
            xq, _ = ops.quantize_rows(x)

        def call(plan=None):
            if plan is None:
                return entry(*args, out_dtype=out_dtype)
            kname = ops.KERNEL_NAME if layers == 1 else ops.STACKED_KERNEL_NAME
            if x_kind == "int8":
                return ops._launch(kname, args[0], args[1], w, args[3],
                                   out_dtype, 0, layers, plan=plan)
            return ops._launch(kname, x, None, w, ws, out_dtype, 0, layers,
                               plan=plan)

        got = call()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"{name}: kernel differs from plain by "
                f"{float((got.double() - want.double()).abs().max())}")
        ms_bound, by = bound(m, k, n, layers, x_kind, out_kind)
        if m <= 16:  # _int_mm takes more than 16 rows: zeros to 24
            xq = torch.cat([xq, xq.new_zeros(*xq.shape[:-2], 24 - m, k)], -2)
        if layers == 1:
            lib_ms = device_ms(lambda: torch._int_mm(xq, w.t()))
        else:
            lib_ms = device_ms(lambda: [torch._int_mm(xq[i], w[i].t())
                                        for i in range(layers)])
        rec = {"shape": name, "m": m, "k": k, "n": n, "layers": layers,
               "x": x_kind, "out": out_kind, "bitwise_equal": True,
               "ms": device_ms(call), "int_mm_ms": lib_ms,
               "bound_ms": ms_bound, "bound_by": by}
        if planned:
            rec["plan"] = ops.card_plan(m, n, k, layers, args[0].dtype,
                                        out_dtype, dev)
            if branches:
                for b, forced in branch_plans(ops, rec["plan"],
                                              args[0].dtype, out_dtype,
                                              cuda_lib.sm_count(dev)):
                    g = call(forced)
                    torch.cuda.synchronize()
                    if not torch.equal(g, want):
                        raise AssertionError(f"{name} on {b}: differs")
                    rec[f"{b}_ms"] = device_ms(lambda: call(forced))
                if x_kind != "int8":  # the product alone, on xq given,
                    # and the pre-pass alone
                    xq_, rs_ = ops.quantize_rows(x)
                    xq_entry = (ops.w8a8_matmul if layers == 1
                                else ops.w8a8_matmul_stacked)
                    rec["xq_ms"] = device_ms(lambda: xq_entry(xq_, rs_, w, ws))
                    rec["prepass_ms"] = device_ms(lambda: ops.w8a8_quantize(x))
        print("b4_shape " + json.dumps(rec), flush=True)
        records.append(rec)
    return records


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", default=".",
                    help="comma-separated trees; two run in turns A B B A")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--out", help="also write the results as JSON here")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--shapes", default="",
                    help="comma-separated shape names (default: all)")
    ap.add_argument("--no-branches", action="store_true")
    args = ap.parse_args()
    names = QUICK if args.quick else [s for s in args.shapes.split(",")
                                      if s] or None
    if args.child:
        records = child(args.child, names, not args.no_branches)
        with open(args.out, "w") as f:
            json.dump(records, f)
        return 0
    trees = args.trees.split(",")
    order = trees if len(trees) == 1 else [trees[0], trees[1], trees[1],
                                           trees[0]]
    card = card_line()
    print(card, flush=True)
    parts = tempfile.mkdtemp(prefix="b4_compare_")
    runs = []
    for i, tree in enumerate(order):
        part = os.path.join(parts, f"run{i}.json")
        cmd = [sys.executable, os.path.abspath(__file__), "--child", tree,
               "--out", part]
        if args.quick:
            cmd.append("--quick")
        if args.shapes:
            cmd += ["--shapes", args.shapes]
        if len(trees) > 1 or args.no_branches:
            cmd.append("--no-branches")
        print(f"run {i}: {tree}", flush=True)
        subprocess.run(cmd, check=True, timeout=1800)
        with open(part) as f:
            runs.append({"tree": tree, "records": json.load(f)})
    summary = []
    if len(trees) > 1:
        for rec in runs[0]["records"]:
            a = [r["ms"] for run in runs if run["tree"] == trees[0]
                 for r in run["records"] if r["shape"] == rec["shape"]]
            b = [r["ms"] for run in runs if run["tree"] == trees[1]
                 for r in run["records"] if r["shape"] == rec["shape"]]
            line = {"shape": rec["shape"], trees[0]: a, trees[1]: b,
                    "int_mm_ms": rec["int_mm_ms"],
                    "bound_ms": rec["bound_ms"],
                    "speedup": statistics.mean(a) / statistics.mean(b),
                    "spread": max(max(a) - min(a), max(b) - min(b))}
            print("b4_compare " + json.dumps(line), flush=True)
            summary.append(line)
    shutil.rmtree(parts)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "runs": runs, "summary": summary}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
