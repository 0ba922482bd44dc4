"""The finetune path's kernels on the card: B1-bwd and the straight-through
w8a8 product against their plain versions, and a 3-step finetune of the
tiny VLA through the kernels against the same run through the plain
versions.

Imports no JAX (the card machine has none):
``python -m pytest tests/test_torch_train_cuda.py -m cuda``. Without a
card every test here skips.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

import vla_adapter_torch.core.config as tc
import vla_adapter_torch.core.constants as tk
from tests.torch_tiny import tiny_cfg
from vla_adapter_torch.data.dummy import make_dummy_batch
from vla_adapter_torch.models.layers import W8A8STE
from vla_adapter_torch.ops import cuda_lib, w8a8_matmul
from vla_adapter_torch.ops.attention_kernel import (
    BWD_KERNEL_NAME,
    BWD_LAUNCHES_PER_CALL,
    KERNEL_NAME,
    attention_bwd,
    attention_bwd_d_reference,
    attention_bwd_reference,
    fused_attention,
)
from vla_adapter_torch.train.loop import build_runtime, finetune

pytestmark = pytest.mark.cuda

# max |kernel - plain| / max |plain| per gradient: the kernel rounds ds to
# bf16 for its products and sums a GQA group's dk/dv in fp32 (the plain
# version rounds each head's first), each a relative 2^-9 per term.
BWD_RTOL = 1e-2

# (batch, heads, kv heads, seq, head dim, key padding, causal): the
# training shapes, odd lengths, one key (the vjp's dq and dk are exactly
# 0), 65 (one key in the last tile), long sequences (2048, 4000: no
# per-row storage), D = 16, 72 and 128, and GQA groups of 7 (the LLM's).
SHAPES = [
    (2, 14, 2, 640, 64, True, False),
    (2, 14, 2, 640, 64, True, True),
    (2, 16, 16, 261, 64, False, False),
    (2, 16, 16, 256, 72, False, False),
    (2, 4, 2, 37, 72, True, True),
    (3, 6, 3, 100, 16, True, False),
    (2, 4, 2, 1, 64, True, False),
    (2, 4, 2, 65, 128, True, True),
    (1, 14, 2, 2048, 64, True, True),
    (1, 4, 1, 4000, 72, True, False),
    (2, 7, 1, 300, 128, True, True),
]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", SHAPES, ids=[
    "llm", "llm_causal", "dinov2", "so400m", "odd37_d72", "gqa_s100",
    "s1", "s65_d128", "s2048_causal", "s4000_d72", "gqa7_d128_causal"])
def test_attention_bwd_matches_plain_and_reruns_bitwise(shape, device):
    b, h, hkv, s, d, padded, causal = shape
    gen = torch.Generator(device=device).manual_seed(0)
    q, dout = (torch.randn(b, s, h, d, generator=gen, device=device)
               .bfloat16().transpose(1, 2) for _ in range(2))
    k, v = (torch.randn(b, s, hkv, d, generator=gen, device=device)
            .bfloat16().transpose(1, 2) for _ in range(2))
    valid = None
    if padded:
        valid = torch.ones(b, s, dtype=torch.int32, device=device)
        valid[0, s - s // 4:] = 0
        valid[-1, :3] = 0  # with causal, rows 0-2 have no valid key
    cuda_lib.reset_launches()
    got = attention_bwd(q, k, v, valid, dout, causal=causal)
    again = attention_bwd(q, k, v, valid, dout, causal=causal)
    want = attention_bwd_reference(q, k, v, valid, dout, causal=causal)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[BWD_KERNEL_NAME] == 2 * BWD_LAUNCHES_PER_CALL
    for g, a, w in zip(got, again, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        assert torch.equal(g, a)
        assert g.transpose(1, 2).is_contiguous()
        err = float((g.float() - w.float()).abs().max())
        assert err <= BWD_RTOL * float(w.float().abs().max())


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[4], SHAPES[8]],
                         ids=["llm", "odd37_d72", "s2048_causal"])
def test_attention_bwd_d_kernel_matches_plain(shape, device):
    """Kernel 1 alone: each row's D in the statistics scratch against
    attention_bwd_d_reference, rows with a valid key (a row without has
    ds = 0 and the kernel writes D = 0), and the forward's lse beside it,
    times log2(e). D sums p * bf16(dp): where the kernel's fp32 dp and the
    plain product's straddle a bf16 rounding, that term moves by p times
    one bf16 ulp (2^-8 of |dp|), so the largest error is held to 1e-2 of
    D's largest and the mean to 1e-5 (fp32 sums in another order)."""
    b, h, hkv, s, d, padded, causal = shape
    gen = torch.Generator(device=device).manual_seed(2)
    q, dout = (torch.randn(b, s, h, d, generator=gen, device=device)
               .bfloat16().transpose(1, 2) for _ in range(2))
    k, v = (torch.randn(b, s, hkv, d, generator=gen, device=device)
            .bfloat16().transpose(1, 2) for _ in range(2))
    valid = torch.ones(b, s, dtype=torch.int32, device=device)
    valid[0, s - s // 4:] = 0
    valid[-1, :3] = 0
    lse = fused_attention(q, k, v, valid, causal=causal, return_lse=True)[1]
    stats = torch.empty((2, b, h, -(-s // 64) * 64), dtype=torch.float32,
                        device=device)
    attention_bwd(q, k, v, valid, dout, causal=causal, lse=lse, stats=stats,
                  kernels=("d",))
    want = attention_bwd_d_reference(q, k, v, valid, dout, causal=causal)
    torch.cuda.synchronize()
    live = lse > -1e9
    got = stats[1, ..., :s]
    scale = float(want[live].abs().max())
    err = (got - want)[live].abs()
    assert float(err.max()) <= 1e-2 * scale
    assert float(err.mean()) <= 1e-5 * scale
    assert torch.equal(got[~live], torch.zeros_like(got[~live]))
    torch.testing.assert_close(stats[0, ..., :s], lse * 1.4426950408889634,
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("m,k,n", [(640, 896, 4864), (37, 64, 48),
                                   (10, 4864, 896)])
def test_ste_bit_for_bit(m, k, n, device):
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn(m, k, generator=gen, device=device).bfloat16()
    dy = torch.randn(m, n, generator=gen, device=device).bfloat16()
    wq = torch.randint(-127, 128, (n, k), generator=gen, device=device,
                       dtype=torch.int8)
    ws = torch.rand(n, generator=gen, device=device) * 0.01 + 1e-3
    out = {}
    for kernels in ("kernel", "plain"):
        xr = x.clone().requires_grad_(True)
        y = W8A8STE.apply(xr, wq, ws, wq.t().contiguous(), kernels)
        out[kernels] = (y, torch.autograd.grad(y, xr, dy)[0])
    for g, w in zip(out["kernel"], out["plain"]):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="transposed"):
        xr = x.clone().requires_grad_(True)
        torch.autograd.grad(W8A8STE.apply(xr, wq, ws, None, "kernel"), xr,
                            dy)


# bf16 finetune of the tiny VLA, kernels against plain versions: the
# attention kernels differ from plain by ~1 bf16 ulp, which can flip a
# per-token int8 rounding downstream; three steps' losses stay within 5%.
LOSS_RTOL = 5e-2


def test_tiny_finetune_kernel_path_against_plain(device, tmp_path):
    cfg = tiny_cfg(tc, tk)
    tcfg = tc.TrainConfig(model=cfg, batch_size=4, base_int8=True,
                          run_root_dir=str(tmp_path), log_freq=100,
                          optim=tc.OptimizerConfig(max_steps=3))
    batch = make_dummy_batch(cfg, 4, np.random.default_rng(0))
    losses, launches = {}, {}
    for kernels in ("kernel", "plain"):
        # widths >= 48 run w8a8 (every such K a multiple of 16)
        rt = dataclasses.replace(build_runtime(tcfg, kernels),
                                 act_int8_min_dim=48)
        cuda_lib.reset_launches()
        state = finetune(dataclasses.replace(tcfg, run_id=kernels),
                         data_iter=itertools.repeat(batch), rt=rt)
        torch.cuda.synchronize()
        launches[kernels] = dict(cuda_lib.LAUNCHES)
        losses[kernels] = np.asarray([h["loss"] for h in state.history])
    assert np.isfinite(losses["kernel"]).all()
    for name in (KERNEL_NAME, BWD_KERNEL_NAME, w8a8_matmul.KERNEL_NAME):
        assert launches["kernel"].get(name, 0) > 0, name
        assert launches["plain"].get(name, 0) == 0, name
    np.testing.assert_allclose(losses["kernel"], losses["plain"],
                               rtol=LOSS_RTOL)
