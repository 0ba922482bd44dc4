"""Kernel B4/B5's plan (``ops/w8a8_matmul.py:w8a8_plan``) on the CPU: every
shape the main paths give the kernel has a branch and a plan the kernel
takes, the branch rules hold, and what the kernel refuses raises here
before any launch. The kernel itself runs only on the card
(``tests/test_torch_w8a8_cuda.py``); imports no JAX."""

import functools

import pytest
import torch

import chip_smoke
from vla_adapter_torch.core.config import VLAConfig
from vla_adapter_torch.data.tokenization import MockTokenizer
from vla_adapter_torch.ops import w8a8_matmul as ops

BF16, F32, INT8, INT32 = torch.bfloat16, torch.float32, torch.int8, torch.int32


@functools.lru_cache(maxsize=None)
def _serving_shapes(batches):
    tok = MockTokenizer()
    return chip_smoke.w8a8_shapes(VLAConfig(), lambda t: tok(t).input_ids,
                                  batches=batches)


def _calls(shapes):
    """(M, K, N, layers) of each B4/B5 call of ``shapes`` (w8a8_shapes or
    dense_shapes records)."""
    out = []
    for sh in shapes:
        if sh["kernel"] in (ops.KERNEL_NAME, ops.STACKED_KERNEL_NAME):
            out.append((sh["m"], sh["k"], sh["n"], sh.get("layers", 1)))
    return out


def _family(name):
    """(M, K, N, layers, x dtype, out dtype) of each call of a family."""
    cfg = VLAConfig()
    if name == "finetune":  # forward on bf16 x, dx on f32 dy * ws
        return [c for _, m, k, n in chip_smoke.ste_shapes(cfg, 16)
                for c in ((m, k, n, 1, BF16, BF16), (m, n, k, 1, F32, BF16))]
    if name == "serving":  # B=1 and B=4, fused and dense backends
        shapes = _serving_shapes((1, 4))
        return [(*c, BF16, BF16) for c in
                _calls(shapes) + _calls(chip_smoke.dense_shapes(shapes))]
    if name == "server_dense":  # the server's buckets 8 and 16
        return [(*c, BF16, BF16) for c in _calls(chip_smoke.dense_shapes(
            _serving_shapes((8, 16))))]
    if name == "split_k":  # the "tensor" axis's int32 partials
        return [(sh["m"], ops.padded_k(sh["k"]), sh["n"], 1, INT8, INT32)
                for sh in chip_smoke.tensor_b4_shapes(cfg, 16, 2)
                + chip_smoke.tensor_b4_shapes(cfg, 16, 4)]
    if name == "zoo_7b":  # q/k/v/o and lm_head widths, prompt and decode
        return [(m, k, n, 1, BF16, BF16) for m in (1, 2, 4, 857, 1714)
                for k, n in ((4096, 4096), (4096, 32000), (4096, 11008),
                             (11008, 4096))]
    if name == "phi2_decode":
        return [(*c, BF16, BF16) for c in _calls(
            chip_smoke.phi_b4_shapes(_phi(), 136)
            + chip_smoke.decode_shapes(cfg))]
    raise KeyError(name)


@functools.lru_cache(maxsize=None)
def _phi():
    from vla_adapter_torch.models.registry import get_llm_backbone

    return get_llm_backbone("phi-2-3b")


FAMILIES = ["finetune", "serving", "server_dense", "split_k", "zoo_7b",
            "phi2_decode"]


@pytest.mark.parametrize("family", FAMILIES)
def test_every_main_path_shape_has_a_plan_the_kernel_takes(family):
    calls = _family(family)
    assert calls
    for m, k, n, layers, x_dtype, out_dtype in calls:
        plan = ops.w8a8_plan(m, n, k, layers, x_dtype, out_dtype)
        assert plan["branch"] in ("narrow", "hopper"), plan
        assert (plan["m"], plan["n"], plan["k"], plan["layers"]) == (
            m, n, k, layers)
        assert plan["prepass"] == (plan["branch"] == "hopper"
                                   and x_dtype != INT8)
        assert plan["ctas"] >= 1
        codes = ops.plan_codes(plan)
        assert len(codes) == 8 and codes[0] in (0, 1)
        if plan["branch"] == "narrow":
            assert m <= 32 and (plan["tiles"], plan["steps"]) in \
                ops.NARROW_VARIANTS
        else:
            assert plan["block_n"] == 128 and plan["stages"] >= 2
            assert plan["smem_bytes"] <= ops.MAX_SMEM
            assert 1 <= plan["ctas"] <= ops.SMS


def test_finetune_and_server_bucket_16_take_the_hopper_branch():
    """Every finetune product (forward and dx) and every matmul of the
    server's bucket 16 runs on TMA + wgmma, float x through the
    pre-pass."""
    for m, k, n, layers, x_dtype, out_dtype in (
            _family("finetune") + [c for c in _family("server_dense")
                                   if c[0] >= 16 * 128]):
        plan = ops.w8a8_plan(m, n, k, layers, x_dtype, out_dtype)
        assert plan["branch"] == "hopper" and plan["prepass"], (m, k, n)
    for m, k, n, layers, x_dtype, out_dtype in _family("split_k"):
        plan = ops.w8a8_plan(m, n, k, layers, x_dtype, out_dtype)
        want = "narrow" if m <= 32 else "hopper"
        assert plan["branch"] == want and not plan["prepass"], (m, k, n)


@pytest.mark.parametrize("m", [1, 2, 4, 8, 16, 17, 32])
def test_up_to_32_rows_stay_narrow(m):
    """Proprio, the action head (M = 8 a request, B * 8 batched) and
    decode rows keep the narrow branch and its variant by M."""
    for k, n in ((896, 896), (6272, 896), (896, 7), (1040, 896)):
        n += n % 2
        plan = ops.w8a8_plan(m, n, k)
        assert plan["branch"] == "narrow", (m, k, n)
        want = (1, 16) if m <= 8 and k <= 1024 else (1, 8) if m <= 8 \
            else (2, 8) if m <= 16 else (4, 8)
        assert (plan["tiles"], plan["steps"]) == want


def test_a_narrow_split_that_cannot_be_resident_takes_the_hopper_branch():
    """A quantizing split over K needs all its CTAs resident at once:
    Phi-2's lm_head at M = 1 (800 column tiles x 5 slices) cannot be, and
    takes the Hopper branch; the head's fc_in (14 x 13) can; with xq given
    nothing is exchanged, so any split stays narrow."""
    assert ops.w8a8_plan(1, 51200, 2560)["branch"] == "hopper"
    fc_in = ops.w8a8_plan(8, 896, 6272)
    assert fc_in["branch"] == "narrow" and fc_in["splits"] == 13
    assert ops.w8a8_plan(8, 896, 6272, narrow_per_sm=(1, 1, 1, 1),
                         sms=100)["branch"] == "hopper"
    assert ops.w8a8_plan(1, 51200, 2560, x_dtype=INT8)["branch"] == "narrow"


@pytest.mark.parametrize("m", [33, 64, 65, 128, 136, 512, 640, 857, 10240])
def test_above_32_rows_every_call_takes_the_hopper_branch(m):
    """From the head at B=8 (64 rows) and the adapter stack (65) through
    the B=1 serving shapes (512-640), Phi-2's prompt (136) and the 7B
    prompt (857) to the finetune's micro-batch."""
    for k, n, layers in ((896, 896, 1), (896, 896, 24), (4096, 32000, 1),
                         (16, 2, 1)):
        plan = ops.w8a8_plan(m, n, k, layers)
        assert plan["branch"] == "hopper" and plan["prepass"]
        assert plan["tiles"] == -(-m // 128) * -(-n // 128) * layers


def test_hopper_tiles_stages_and_grid():
    """128 x 128 tiles, the ring as deep as shared memory holds (7 stages
    of 32 KB), a persistent grid of at most one CTA per SM."""
    kv = ops.w8a8_plan(10240, 128, 896)
    assert (kv["block_n"], kv["stages"], kv["tiles"], kv["ctas"]) == (
        128, 7, 80, 80)
    gate = ops.w8a8_plan(10240, 4864, 896)
    assert (gate["tiles"], gate["ctas"]) == (3040, ops.SMS)
    assert gate["waves"] == 3040 / ops.SMS and gate["group"] == 8
    assert gate["smem_bytes"] == 1024 + 7 * (32768 + 16) <= ops.MAX_SMEM
    stack = ops.w8a8_plan(8192, 896, 896, layers=24)
    assert stack["tiles"] == 64 * 7 * 24
    assert ops.w8a8_plan(8192, 896, 896, x_dtype=INT8)["prepass"] is False
    assert ops.w8a8_plan(8192, 896, 896, sms=100)["ctas"] == 100


def test_the_plan_is_cached_and_forced_branches_differ():
    a = ops.w8a8_plan(4096, 1024, 1024)
    assert ops.w8a8_plan(4096, 1024, 1024) is a
    assert ops.w8a8_plan(8, 896, 896, branch="hopper")["branch"] == \
        "hopper"
    assert ops.w8a8_plan(600, 896, 896, branch="narrow")["branch"] == \
        "narrow"
    assert ops.plan_launches(a, ops.KERNEL_NAME) == {
        ops.QUANT_KERNEL_NAME: 1, ops.KERNEL_NAME: 1}
    assert ops.plan_launches(ops.w8a8_plan(8, 896, 896),
                             ops.STACKED_KERNEL_NAME) == {
        ops.STACKED_KERNEL_NAME: 1}


@pytest.mark.parametrize("args,error", [
    ((64, 896, 40), ValueError),            # K % 16
    ((64, 895, 896), ValueError),           # odd N
    ((64, 896, 896, 0), ValueError),        # no layer
    ((0, 896, 896), ValueError),            # no row
    ((64, 896, 896, 1, BF16, INT32), TypeError),   # int32 from float x
    ((64, 896, 896, 1, torch.float16), TypeError),
], ids=["k16", "odd_n", "layers", "rows", "int32_float_x", "fp16"])
def test_unsupported_shapes_raise(args, error):
    with pytest.raises(error):
        ops.w8a8_plan(*args)
    with pytest.raises(ValueError):
        ops.w8a8_plan(64, 896, 896, branch="wide")
