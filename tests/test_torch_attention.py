"""The port's attention against the JAX package's Pallas kernel, on the CPU.

``attention_reference`` (the plain version of the CUDA kernel, which the
port runs on CPU tensors) must compute what
``vla_adapter_tpu/ops/pallas_attention.py:fused_attention`` computes; the
Pallas side runs in interpret mode as the JAX package's own tests run it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vla_adapter_tpu.ops.attention import xla_attention
from vla_adapter_tpu.ops.pallas_attention import fused_attention as jax_fused
from vla_adapter_torch.ops import cuda_lib
from vla_adapter_torch.ops.attention import dot_product_attention
from vla_adapter_torch.ops.attention_kernel import (
    KERNEL_NAME,
    attention_plan,
    attention_reference,
    fused_attention,
)

# (batch, heads, kv heads, seq, head dim, key padding, causal)
CASES = {
    "bidir_padded": (2, 4, 2, 40, 16, True, False),
    "causal": (2, 4, 2, 40, 16, True, True),
    "gqa_14_2": (1, 14, 2, 64, 64, True, False),
    "gqa_14_2_causal": (2, 14, 2, 48, 64, False, True),
    "head_dim_72": (2, 16, 16, 32, 72, False, False),
    "odd_seq_37": (2, 4, 2, 37, 16, True, True),
}


def _inputs(b, h, hkv, s, d, padded, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, s, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    valid = np.ones((b, s), np.int32)
    if padded:
        valid[0, s - s // 4:] = 0
    return q, k, v, valid


def _valid_rows(x: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """(B, H, S, D) -> the rows of real query tokens."""
    return x.transpose(0, 2, 1, 3)[valid.astype(bool)]


@pytest.mark.parametrize("case", CASES.values(), ids=list(CASES))
def test_reference_matches_pallas_fp32(case):
    """fp32: the bf16 rounding of p is the identity, so the two agree to
    fp32 summation order (atol = rtol = 1e-5, the JAX package's own
    tolerance for its kernel against XLA)."""
    b, h, hkv, s, d, padded, causal = case
    q, k, v, valid = _inputs(b, h, hkv, s, d, padded)
    want = np.asarray(jax_fused(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid),
        causal=causal, interpret=True))
    got = attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(valid), causal=causal).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(_valid_rows(got, valid),
                               _valid_rows(want, valid), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [False, True], ids=["bidir", "causal"])
def test_reference_matches_pallas_bf16(causal):
    """bf16 inputs: both round the unnormalised p to bf16 before p @ v and
    sum l from the rounded p. fp32 score sums in another order can flip a
    rounding of p by one bf16 ulp, and the bf16 output is one ulp of
    |out| <= ~3, so the bound is 2e-2."""
    q, k, v, valid = _inputs(2, 14, 2, 80, 64, True, seed=3)
    bf = jnp.bfloat16
    want = np.asarray(jax_fused(
        jnp.asarray(q, bf), jnp.asarray(k, bf), jnp.asarray(v, bf),
        jnp.asarray(valid), causal=causal, interpret=True).astype(jnp.float32))
    tb = torch.bfloat16
    got = attention_reference(
        torch.from_numpy(q).to(tb), torch.from_numpy(k).to(tb),
        torch.from_numpy(v).to(tb), torch.from_numpy(valid),
        causal=causal).float().numpy()
    np.testing.assert_allclose(_valid_rows(got, valid),
                               _valid_rows(want, valid), atol=2e-2, rtol=0)


def test_fully_masked_rows_stay_finite():
    q, k, v, _ = _inputs(1, 2, 1, 9, 8, False)
    valid = torch.zeros(1, 9, dtype=torch.int32)
    out = attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), valid)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("causal", [False, True], ids=["bidir", "causal"])
@pytest.mark.parametrize("seq", [9, 21])
def test_fully_masked_rows_match_xla_attention(seq, causal):
    """A batch row with no valid key at all, S not a multiple of 16: the
    plain version (which the CUDA kernel follows) averages V uniformly over
    the S keys, as the JAX package's ``xla_attention`` does (masked keys
    all take NEG_INF). The Pallas wrapper pads the keys to a block with
    valid = 0 and would average over the padded length: a divergence
    inside the JAX package that the port does not follow. fp32, 1e-5."""
    q, k, v, valid = _inputs(2, 4, 2, seq, 16, True, seed=seq)
    valid[1] = 0
    want = np.asarray(xla_attention(
        jnp.asarray(q.transpose(0, 2, 1, 3)),
        jnp.asarray(k.transpose(0, 2, 1, 3)),
        jnp.asarray(v.transpose(0, 2, 1, 3)), jnp.asarray(valid),
        causal=causal, sm_scale=16 ** -0.5)).transpose(0, 2, 1, 3)
    got = attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(valid), causal=causal).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    if not causal:  # the masked row is the mean of V over the S keys
        mean_v = np.repeat(v[1].mean(axis=1), 2, axis=0)[:, None, :]
        np.testing.assert_allclose(got[1], np.broadcast_to(
            mean_v, got[1].shape), atol=1e-5, rtol=1e-5)


def test_cpu_tensors_take_the_plain_version():
    """The wrapper runs the plain version on a CPU tensor and counts no
    launch; the (B, S, H, D) dispatcher gives the same result either way."""
    q, k, v, valid = (torch.from_numpy(a) for a in _inputs(2, 4, 2, 21, 16, True))
    before = cuda_lib.LAUNCHES[KERNEL_NAME]
    got = fused_attention(q, k, v, valid, causal=True)
    assert cuda_lib.LAUNCHES[KERNEL_NAME] == before
    assert torch.equal(got, attention_reference(q, k, v, valid, causal=True))
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    kern = dot_product_attention(t(q), t(k), t(v), valid, causal=True)
    plain = dot_product_attention(t(q), t(k), t(v), valid, causal=True,
                                  impl="plain")
    assert torch.equal(kern, plain)
    assert torch.equal(t(kern), got)
    with pytest.raises(ValueError):
        dot_product_attention(t(q), t(k), t(v), impl="sdpa")


def test_other_devices_are_refused():
    q = torch.empty(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="device"):
        fused_attention(q, q, q)


# (batch, heads, kv heads, seq, head dim): the serving shapes of one B=1 and
# one B=2 forward (Qwen2 14/2 heads, DINOv2 and so400m over 2 images each).
SERVING_SHAPES = [(1, 14, 2, 640, 64), (2, 14, 2, 640, 64),
                  (2, 16, 16, 261, 64), (4, 16, 16, 261, 64),
                  (2, 16, 16, 256, 72), (4, 16, 16, 256, 72)]


@pytest.mark.parametrize("shape", SERVING_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_serving_shapes_take_the_one_pass_branch(shape):
    """Every serving shape keeps its score block in shared memory, within
    the 227 KB a block may use, with a warp for every 16 query rows."""
    plan = attention_plan(*shape)
    assert plan["branch"] == "one-pass"
    assert 1 <= plan["warps"] <= 8 and plan["smem_bytes"] <= 232448
    b, h, _, s, _ = shape
    assert plan["ctas"] * plan["warps"] >= h * -(-s // 16) * b


def test_plan_qwen2_b1_fills_one_wave():
    """The Qwen2 call at B=1 runs in one wave (a grid of 64-row CTAs would
    be 140 CTAs of 4 warps on 132 SMs, 8 of them in a second wave)."""
    plan = attention_plan(1, 14, 2, 640, 64)
    assert plan["ctas"] <= 132 * plan["ctas_per_sm"]
    assert plan["waves"] >= 0.5


@pytest.mark.parametrize("seq,dim,branch", [
    (1, 16, "one-pass"), (2048, 128, "one-pass"), (3000, 128, "one-pass"),
    (3200, 128, "two-pass"), (4000, 64, "two-pass")])
def test_plan_branch_is_chosen_by_seq(seq, dim, branch):
    plan = attention_plan(1, 2, 1, seq, dim)
    assert plan["branch"] == branch
    assert plan["smem_bytes"] <= 232448
    assert plan["warps"] <= -(-seq // 16) * 2
