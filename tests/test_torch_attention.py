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
    attention_bwd_plan,
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
# one B=2 forward (Qwen2 14/2 heads, DINOv2 and so400m over 2 images each),
# and every other shape of PERF.md's B1 rows: the finetune's micro-batch
# of 16 (and each rank's heads at tensor 2), the 7B full-train recipe's,
# generation's prefill, Phi-2's, the 7B zoo's and the 384/336-px towers.
SERVING_SHAPES = [(1, 14, 2, 640, 64), (2, 14, 2, 640, 64),
                  (2, 16, 16, 261, 64), (4, 16, 16, 261, 64),
                  (2, 16, 16, 256, 72), (4, 16, 16, 256, 72),
                  (16, 14, 2, 640, 64), (32, 16, 16, 261, 64),
                  (32, 16, 16, 256, 72), (16, 7, 1, 640, 64),
                  (32, 32, 32, 384, 128), (1, 14, 2, 128, 64),
                  (4, 14, 2, 128, 64), (1, 32, 32, 136, 80),
                  (1, 32, 32, 857, 128), (4, 32, 32, 857, 128),
                  (1, 32, 8, 704, 128), (4, 32, 8, 704, 128),
                  (1, 32, 32, 96, 128), (1, 16, 16, 734, 64),
                  (1, 16, 16, 729, 72), (1, 16, 16, 577, 64)]
BLOCK_SMEM, SM_SMEM, SM_REGS = 232448, 233472, 65536


def _fits(plan) -> None:
    """The plan's CTAs fit an SM: shared memory a block and an SM may use,
    and the registers of the producer and consumer warpgroups."""
    assert plan["smem_bytes"] <= BLOCK_SMEM
    assert plan["ctas_per_sm"] * (plan["smem_bytes"] + 1024) <= SM_SMEM
    assert plan["ctas_per_sm"] * plan["threads"] * plan["launch_regs"] \
        <= SM_REGS
    assert 128 * (plan["producer_regs"] + plan["warpgroups"]
                  * plan["consumer_regs"]) \
        <= plan["threads"] * plan["launch_regs"]
    assert 2 <= plan["stages"] <= 4 and plan["warpgroups"] in (1, 2, 3)
    assert plan["ctas_per_sm"] < 3 or plan["dp"] <= 96


@pytest.mark.parametrize("shape", SERVING_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_serving_shapes_take_the_one_pass_branch(shape):
    """Every serving and training shape runs the kernel's one pass over
    the keys (the online softmax: no score stored) in a plan whose CTAs
    fit an SM's shared memory and registers, with a 64-row unit for every
    64 query rows of every head."""
    plan = attention_plan(*shape)
    _fits(plan)
    b, h, hkv, s, _ = shape
    assert "branch" not in plan
    assert plan["units"] == (h // hkv) * -(-s // 64)
    assert plan["ctas"] * plan["warpgroups"] >= b * hkv * plan["units"]


def test_plan_qwen2_b1_fills_one_wave():
    """The Qwen2 call at B=1 (140 query tiles of 64 rows) fills at least
    half of one wave of the card's 132 SMs and needs no second."""
    plan = attention_plan(1, 14, 2, 640, 64)
    assert plan["ctas"] <= 132 * plan["ctas_per_sm"]
    assert plan["waves"] >= 0.5
    assert plan["ctas"] * plan["warpgroups"] == 140


@pytest.mark.parametrize("seq,dim", [(1, 128), (3000, 128), (3200, 128),
                                     (4000, 128), (8192, 128)])
def test_plan_branch_is_chosen_by_seq(seq, dim):
    """No branch by S and no limit on it: at S = 1 and 8192 alike, the
    plan is the same design, fits, and only its grid grows with S."""
    plan = attention_plan(1, 2, 1, seq, dim)
    _fits(plan)
    assert "branch" not in plan
    assert plan["units"] == 2 * -(-seq // 64)
    assert plan["keys_per_tile"] == 64 and not plan["persistent"]


@pytest.mark.parametrize("dim,chunk", [(72, 16), (80, 16), (64, 64),
                                       (128, 64), (96, 32)])
def test_plan_takes_the_tma_chunk_of_the_head_dim(dim, chunk):
    """D = 72 (so400m, padded to 80) and D = 80 (Phi-2) take 16-wide
    swizzled column chunks, as B1-bwd's tiles do; 64 and 128 take 64."""
    plan = attention_plan(2, 16, 16, 256, dim)
    assert plan["chunk"] == chunk
    assert plan["chunk"] == attention_bwd_plan(2, 16, 16, 256, dim)["chunk"]
    _fits(plan)


def _grid_units(b, h, hkv, s, plan):
    """Each (batch, head, row tile) the kernel's grid runs, as
    csrc/fused_attention.cu maps a CTA (x, kv head, batch) and its
    warpgroup to a unit: the CTA's units follow on over (head of the kv
    group, row tile)."""
    groups, row_tiles, wgs = h // hkv, -(-s // 64), plan["warpgroups"]
    units = groups * row_tiles
    out = []
    for z in range(b):
        for y in range(hkv):
            for x in range(plan["ctas"] // (b * hkv)):
                for wg in range(min(wgs, units - x * wgs)):
                    unit = x * wgs + wg
                    out.append((z, y * groups + unit // row_tiles,
                                unit % row_tiles))
    return out


@pytest.mark.parametrize("shape", [(1, 14, 2, 640, 64), (2, 14, 2, 640, 64),
                                   (2, 16, 16, 261, 64), (3, 6, 2, 65, 16),
                                   (1, 32, 8, 704, 128)],
                         ids=lambda s: "x".join(map(str, s)))
def test_plan_grid_covers_every_query_tile_once(shape):
    b, h, hkv, s, d = shape
    plan = attention_plan(*shape)
    units = _grid_units(b, h, hkv, s, plan)
    assert len(units) == len(set(units))
    assert set(units) == {(z, hh, t) for z in range(b) for hh in range(h)
                          for t in range(-(-s // 64))}
