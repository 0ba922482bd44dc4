"""The CUDA attention kernel against its plain version, on the card.

Imports no JAX, so it also runs on a machine with only PyTorch and CUDA:
``python -m pytest tests/test_torch_attention_cuda.py -m cuda``. Without a
card every test here skips.
"""

import numpy as np
import pytest
import torch

from vla_adapter_torch.ops import cuda_lib
from vla_adapter_torch.ops.attention_kernel import (
    KERNEL_NAME,
    attention_plan,
    attention_reference,
    fused_attention,
)

pytestmark = pytest.mark.cuda

# bf16 output: the kernel and the plain version differ only in fp32
# summation order and exp rounding, i.e. by about one bf16 ulp of |out| <= 4.
ATOL = 2e-2

# (batch, heads, kv heads, seq, head dim, key padding, causal): the main
# path's LLM (bidirectional with padding, and causal; the finetune's
# micro-batch of 16 causal), DINOv2 and so400m shapes, Phi-2's D = 80,
# Mistral's GQA 32/8 at D = 128 (B = 4), plus an odd length.
SHAPES = [
    (1, 14, 2, 640, 64, True, False),
    (2, 14, 2, 640, 64, True, True),
    (16, 14, 2, 640, 64, True, True),
    (2, 16, 16, 261, 64, False, False),
    (4, 16, 16, 256, 72, False, False),
    (1, 32, 32, 136, 80, False, True),
    (4, 32, 8, 704, 128, True, True),
    (2, 4, 2, 37, 16, True, True),
]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(b, h, hkv, s, d, padded, dev, seed=0):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(b, h, s, d)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(b, hkv, s, d)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(b, hkv, s, d)).astype(np.float32))
    valid = np.ones((b, s), np.int32)
    if padded:
        valid[0, s - s // 5:] = 0
    return (q.to(dev, torch.bfloat16), k.to(dev, torch.bfloat16),
            v.to(dev, torch.bfloat16),
            torch.from_numpy(valid).to(dev) if padded else None)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_row_statistics_leave_the_output_bits(device, shape):
    """With the lse output (training) the kernel's output is bit for bit
    the serving launch's, and each row's lse is within 1e-6 of the plain
    version's, relative to max(|lse|, 1): rows with no valid key (about
    -2e9) included."""
    b, h, hkv, s, d, padded, causal = shape
    q, k, v, valid = _inputs(b, h, hkv, s, d, padded, device)
    if valid is not None:
        valid[-1] = 0  # a batch row with no valid key
    out = fused_attention(q, k, v, valid, causal=causal)
    out_t, lse = fused_attention(q, k, v, valid, causal=causal,
                                 return_lse=True)
    want = attention_reference(q, k, v, valid, causal=causal,
                               return_lse=True)[1]
    torch.cuda.synchronize()
    assert torch.equal(out, out_t)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    err = ((lse - want).abs() / want.abs().clamp_min(1.0)).max().item()
    assert err <= 1e-6, err


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain(device, shape):
    b, h, hkv, s, d, padded, causal = shape
    q, k, v, valid = _inputs(b, h, hkv, s, d, padded, device)
    before = cuda_lib.LAUNCHES[KERNEL_NAME]
    got = fused_attention(q, k, v, valid, causal=causal)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[KERNEL_NAME] == before + 1
    want = attention_reference(q, k, v, valid, causal=causal)
    assert torch.isfinite(got.float()).all()
    rows = torch.ones(b, s, dtype=torch.bool, device=device)
    if valid is not None:
        rows = valid.bool()
    diff = (got.float() - want.float()).abs().transpose(1, 2)[rows]
    assert diff.max().item() <= ATOL, diff.max().item()


@pytest.mark.parametrize("groups", [1, 7], ids=["mha", "gqa7"])
@pytest.mark.parametrize("dim", [16, 64, 72, 80, 128])
@pytest.mark.parametrize("seq", [1, 63, 64, 65, 261, 640, 1024, 2048, 4000,
                                 8192])
def test_kernel_matches_plain_across_shapes(device, seq, dim, groups):
    """One code path at every tile edge and at any length (no per-row
    storage, so no limit on S): batch row 0 has trailing key padding,
    batch row 1 none of its keys valid (its rows must stay finite); odd
    lengths run causal."""
    h, hkv = 2 * groups, 2
    causal = seq % 2 == 1
    q, k, v, _ = _inputs(2, h, hkv, seq, dim, False, device, seed=seq + dim)
    valid = torch.ones(2, seq, dtype=torch.int32, device=device)
    valid[0, seq - seq // 5:] = 0
    valid[1] = 0
    got = fused_attention(q, k, v, valid, causal=causal)
    want = attention_reference(q, k, v, valid, causal=causal)
    torch.cuda.synchronize()
    assert attention_plan(2, h, hkv, seq, dim)["smem_bytes"] <= 232448
    assert torch.isfinite(got.float()).all()
    rows = valid.bool()
    diff = (got.float() - want.float()).abs().transpose(1, 2)[rows]
    assert diff.max().item() <= ATOL, diff.max().item()


@pytest.mark.parametrize("causal", [False, True], ids=["bidir", "causal"])
@pytest.mark.parametrize("seq", [21, 261])
def test_fully_masked_rows_match_plain(device, seq, causal):
    """Rows of a batch row with no valid key, S not a multiple of 16: the
    kernel, like its plain version and the JAX package's xla_attention,
    averages V over the S keys (keys past S take -inf, masked keys -2e9);
    every row of it within ATOL of the plain version."""
    q, k, v, _ = _inputs(2, 14, 2, seq, 64, False, device, seed=seq)
    valid = torch.ones(2, seq, dtype=torch.int32, device=device)
    valid[0, seq - seq // 5:] = 0
    valid[1] = 0
    got = fused_attention(q, k, v, valid, causal=causal)
    want = attention_reference(q, k, v, valid, causal=causal)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    diff = (got[1].float() - want[1].float()).abs()
    assert diff.max().item() <= ATOL, diff.max().item()


def test_kernel_takes_model_layout(device):
    """(B, S, H, D) buffers viewed as (B, H, S, D), as the model passes."""
    q, k, v, valid = _inputs(2, 14, 2, 96, 64, True, device, seed=1)
    qs, ks, vs = (t.transpose(1, 2).contiguous().transpose(1, 2)
                  for t in (q, k, v))
    got = fused_attention(qs, ks, vs, valid)
    want = fused_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert got.transpose(1, 2).is_contiguous()


def test_kernel_rejects_what_it_does_not_take(device):
    q, k, v, _ = _inputs(1, 4, 2, 32, 16, False, device)
    with pytest.raises(TypeError):
        fused_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError):
        fused_attention(q[..., :12], k[..., :12], v[..., :12])
