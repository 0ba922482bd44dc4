"""Kernel B1 (``vla_adapter_torch/ops/attention_kernel.py:fused_attention``)
on the card at every shape ``PERF.md`` lists for it: each call held against
its plain version within ``chip_smoke.KERNEL_ATOL`` on the rows of real
tokens, then timed under CUDA-graph replay beside
``scaled_dot_product_attention`` (a yardstick: the port never calls it) and
the bound.

    python3 b1_compare.py                        # this tree
    python3 b1_compare.py --trees parent_tree,.  # trees in turns: A B B A
    python3 b1_compare.py --variants             # also every feasible plan
    python3 b1_compare.py --shapes llm_b1,phi2   # named shapes only

The shapes are ``chip_smoke.py``'s phase-2 list: the flagship's serving
shapes at B = 1 and 2 (with a prompt's key padding), the 7B full-train
recipe's, and ``chip_smoke.B1_ROW_SHAPES``. With ``--trees`` each tree runs
in a child process of its own (the package imported from that directory),
in the order A, B, B, A, so that two versions meet on one card and host;
``parent_tree/`` is the parent commit unpacked with ``git archive``. With
``--variants`` (on a tree whose plan names its consumer warpgroups) each
shape is also timed at every other (warpgroups, keys a tile, stages,
turns) the kernel takes. Prints one ``b1_shape`` line per shape and run, a
``b1_compare`` line per shape across trees, and the card's name and power
limit; with ``--out FILE`` it writes everything there as JSON. Needs a
CUDA card; imports no JAX.
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

import numpy as np

import chip_smoke

# (name, batch, heads, kv heads, seq, head dim, padded keys, causal): the
# serving shapes of chip_smoke's phase 2 (VLAConfig(): Qwen2 14/2 heads of
# 64 over 640 tokens, DINOv2 over 261, so400m over 256 of D = 72, two
# images a request) and the 7B full-train recipe's LLM at 32 rows, then
# chip_smoke.B1_ROW_SHAPES
SHAPES = [
    ("llm_b1", 1, 14, 2, 640, 64, True, False),
    ("llm_causal_b1", 1, 14, 2, 640, 64, True, True),
    ("dinov2_b1", 2, 16, 16, 261, 64, False, False),
    ("so400m_b1", 2, 16, 16, 256, 72, False, False),
    ("llm_b2", 2, 14, 2, 640, 64, True, False),
    ("llm_causal_b2", 2, 14, 2, 640, 64, True, True),
    ("dinov2_b2", 4, 16, 16, 261, 64, False, False),
    ("so400m_b2", 4, 16, 16, 256, 72, False, False),
    ("llm_7b_full_train", 32, 32, 32, 384, 128, True, False),
] + list(chip_smoke.B1_ROW_SHAPES)


def inputs(shape, dev):
    import torch

    name, b, h, hkv, s, d, padded, causal = shape
    gen = torch.Generator(device=dev).manual_seed(b * 7919 + h * 31 + s + d)
    q = torch.randn(b, h, s, d, generator=gen, device=dev).bfloat16()
    k = torch.randn(b, hkv, s, d, generator=gen, device=dev).bfloat16()
    v = torch.randn(b, hkv, s, d, generator=gen, device=dev).bfloat16()
    valid_np = np.ones((b, s), np.int32)
    if padded:
        valid_np[0, s - s // 16:] = 0
    valid = torch.from_numpy(valid_np).to(dev) if padded else None
    return q, k, v, valid, valid_np


VARIED = ("warpgroups", "ctas_per_sm", "keys_per_tile", "stages", "turns")


def variants(ak, plan: dict) -> list:
    """Every plan beside ``plan`` that the kernel takes (by warpgroups,
    CTAs an SM, keys a tile, stages, turns), where the tree's wrapper
    launches a given plan."""
    if "warpgroups" not in plan or not hasattr(ak, "_launch"):
        return []
    out = []
    for wgs, per_sm, keys in ((1, 2, 64), (1, 2, 128), (1, 3, 64),
                              (2, 1, 64), (3, 1, 64)):
        for stages in (2, 3, 4):
            for turns in ((False, True) if wgs > 1 else (False,)):
                forced = dict(plan, warpgroups=wgs, ctas_per_sm=per_sm,
                              stages=stages, keys_per_tile=keys, turns=turns)
                if forced != plan and (per_sm < 3 or plan["dp"] <= 96):
                    out.append(forced)
    return out


def child(tree: str, names, with_variants: bool, library: bool) -> list:
    """Check and time each shape with the package of ``tree``."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    import torch.nn.functional as F

    import vla_adapter_torch
    from vla_adapter_torch.ops import attention_kernel as ak
    from vla_adapter_torch.ops import cuda_lib

    here = os.path.dirname(os.path.abspath(vla_adapter_torch.__file__))
    if not here.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {here}, not the package of {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("b1_compare.py needs a CUDA card")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    ak._lib()
    print(f"built {ak._SOURCE} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    if with_variants:
        print(cuda_lib.BUILD_LOGS.get(ak._SOURCE, ""), flush=True)
    sms = cuda_lib.sm_count(dev)
    records = []
    for shape in SHAPES:
        name, b, h, hkv, s, d, padded, causal = shape
        if names and name not in names:
            continue
        q, k, v, valid, valid_np = inputs(shape, dev)
        rows = valid_np.astype(bool)
        want = ak.attention_reference(q, k, v, valid, causal=causal)

        def err_of(got):
            torch.cuda.synchronize()
            if not torch.isfinite(got.float()).all():
                raise AssertionError(f"{name}: kernel output not finite")
            diff = (got.float() - want.float()).abs().transpose(1, 2)
            e = float(diff[torch.from_numpy(rows).to(dev)].max())
            if not e <= chip_smoke.KERNEL_ATOL:
                raise AssertionError(f"{name}: kernel vs plain max abs err "
                                     f"{e} > {chip_smoke.KERNEL_ATOL}")
            return e

        def call():
            return ak.fused_attention(q, k, v, valid, causal=causal)

        plan = ak.attention_plan(b, h, hkv, s, d, sms, *(
            (causal,) if hasattr(ak, "_launch") else ()))
        rec = {"shape": name, "batch": b, "heads": h, "kv_heads": hkv,
               "seq": s, "head_dim": d, "causal": causal, "plan": plan,
               "max_abs_err": err_of(call()),
               "ms": chip_smoke.device_ms(call)}
        if library:
            kx = k.repeat_interleave(h // hkv, dim=1)
            vx = v.repeat_interleave(h // hkv, dim=1)
            mask = None
            if valid is not None:
                mask = valid.bool()[:, None, None, :]
            if causal:
                tril = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
                mask = tril if mask is None else mask & tril
            rec["sdpa_ms"] = chip_smoke.device_ms(
                lambda: F.scaled_dot_product_attention(q, kx, vx,
                                                       attn_mask=mask))
            rec["bound_ms"], rec["bound_by"] = chip_smoke.attention_bound_ms(
                b, h, hkv, s, d, valid_np, causal)[:2]
        if with_variants:
            valid32 = None if valid is None else valid.to(torch.int32)
            rec["variants"] = []
            for forced in variants(ak, plan):
                def forced_call(forced=forced):
                    return ak._launch(q, k, v, valid32, causal, d ** -0.5,
                                      False, forced)
                try:
                    e = err_of(forced_call())
                except RuntimeError as exc:  # a plan the card refuses
                    rec["variants"].append({
                        key: forced[key] for key in VARIED} | {
                        "refused": str(exc)[:120]})
                    continue
                rec["variants"].append({
                    key: forced[key] for key in VARIED} | {
                    "max_abs_err": e,
                    "ms": chip_smoke.device_ms(forced_call)})
        print("b1_shape " + json.dumps(rec), flush=True)
        records.append(rec)
    return records


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", default=".",
                    help="comma-separated trees; two run in turns A B B A")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--library", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--out", help="also write the results as JSON here")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--shapes", default="",
                    help="comma-separated shape names (default: all)")
    args = ap.parse_args()
    names = [s for s in args.shapes.split(",") if s] or None
    if args.child:
        records = child(args.child, names, args.variants, args.library)
        with open(args.out, "w") as f:
            json.dump(records, f)
        return 0
    trees = args.trees.split(",")
    order = trees if len(trees) == 1 else [trees[0], trees[1], trees[1],
                                           trees[0]]
    card = chip_smoke.card_line()
    print(card, flush=True)
    parts = tempfile.mkdtemp(prefix="b1_compare_")
    runs = []
    for i, tree in enumerate(order):
        part = os.path.join(parts, f"run{i}.json")
        cmd = [sys.executable, os.path.abspath(__file__), "--child", tree,
               "--out", part]
        if i == 0:
            cmd.append("--library")
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
            times = {tree: [r["ms"] for run in runs if run["tree"] == tree
                            for r in run["records"]
                            if r["shape"] == rec["shape"]] for tree in trees}
            a, b = times[trees[0]], times[trees[1]]
            line = {"shape": rec["shape"], trees[0]: a, trees[1]: b,
                    "sdpa_ms": rec["sdpa_ms"], "bound_ms": rec["bound_ms"],
                    "speedup": statistics.mean(a) / statistics.mean(b),
                    "vs_sdpa": rec["sdpa_ms"] / statistics.mean(b),
                    "spread": max(max(a) - min(a), max(b) - min(b))}
            print("b1_compare " + json.dumps(line), flush=True)
            summary.append(line)
    shutil.rmtree(parts)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "runs": runs, "summary": summary}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
