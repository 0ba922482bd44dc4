"""The whole-decoder-layer CUDA kernel (B6) against its plain version, on
the card.

The kernel sums the attention and RMSNorm2 in another order than its plain
version and takes expf from the CUDA math library, so a bf16 ulp of the
context or a float ulp of h2 can flip an int8 rounding of the o-projection
or MLP inputs; a flip moves its row by a fraction of an int8 step through
one more projection. Tolerance: every output within four bf16 ulps (2^-5)
of its row's largest output, and at most 10% of the rows with an output
more than two bf16 ulps of its own size away (``_assert_close``).

Imports no JAX: ``python -m pytest tests/test_torch_megalayer_cuda.py -m
cuda``. Without a card every test here skips.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vla_adapter_torch.core.config import Qwen2Config
from vla_adapter_torch.models.layers import Runtime, init_random_
from vla_adapter_torch.models.quantize import quantize_state_dict, quantize_weight
from vla_adapter_torch.models.qwen2 import Qwen2Model
from vla_adapter_torch.ops import cuda_lib
from vla_adapter_torch.ops.megalayer import (
    KERNEL_NAME,
    megalayer_reference,
    w8a8_qwen2_layer,
)

pytestmark = pytest.mark.cuda

BF16_ULP = 2.0 ** -7
ROW_SHARE = 0.10


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _layer_args(m, d, heads, kv_heads, dh, f, dev, seed):
    """x, strided q/k/v views of one projection's output, key padding, the
    norm weight and one layer's int8 weights (lecun-normal, quantized)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = randn(m, d).bfloat16()
    qkv = randn(m, (heads + 2 * kv_heads) * dh).bfloat16()
    q = qkv[:, :heads * dh].view(m, heads, dh)
    k = qkv[:, heads * dh:(heads + kv_heads) * dh].view(m, kv_heads, dh)
    v = qkv[:, (heads + kv_heads) * dh:].view(m, kv_heads, dh)
    valid = (torch.rand(m, generator=gen, device=dev) < 0.9).int()
    n2 = 1.0 + 0.2 * randn(d)
    weights = []
    for n_out, k_in in ((d, heads * dh), (f, d), (f, d), (d, f)):
        weights += quantize_weight(randn(n_out, k_in) / k_in ** 0.5)
    return (x, q, k, v, valid, n2, *weights)


def _assert_close(got, want):
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs()
    row_max = want.float().abs().amax(dim=-1, keepdim=True)
    assert bool((err <= 4 * BF16_ULP * row_max).all()), \
        float((err / row_max).max())
    beyond = (err > 2 * BF16_ULP * want.float().abs()).any(dim=-1)
    assert float(beyond.float().mean()) <= ROW_SHARE, int(beyond.sum())


# (M, D, heads, kv heads, head dim, F): the Qwen2.5-0.5B layer at B=1, a
# ragged M at the same widths, and small ones over the other head dims
# (F below one panel, ragged; wide heads).
SHAPES = [
    (640, 896, 14, 2, 64, 4864),
    (100, 896, 14, 2, 64, 4864),
    (37, 64, 4, 2, 16, 208),
    (70, 256, 8, 2, 32, 1040),
    (50, 512, 4, 1, 128, 1536),
]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_megalayer_matches_plain(device, shape):
    args = _layer_args(*shape, device, seed=sum(shape))
    before = cuda_lib.LAUNCHES[KERNEL_NAME]
    got = w8a8_qwen2_layer(*args, eps=1e-6)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[KERNEL_NAME] == before + 1
    _assert_close(got, megalayer_reference(*args, eps=1e-6))


def test_megalayer_without_key_padding(device):
    args = list(_layer_args(96, 256, 8, 2, 32, 512, device, seed=1))
    args[4] = None
    _assert_close(w8a8_qwen2_layer(*args, eps=1e-6),
                  megalayer_reference(*args, eps=1e-6))


@pytest.mark.parametrize("padded", [True, False], ids=["padded", "unpadded"])
@pytest.mark.parametrize("m", [17, 100])
def test_megalayer_at_small_m(device, m, padded):
    """Row tiles that are mostly past M, one or a few per stage; two calls
    give the same bits."""
    args = list(_layer_args(m, 896, 14, 2, 64, 4864, device, seed=m))
    if not padded:
        args[4] = None
    got, again = (w8a8_qwen2_layer(*args, eps=1e-6) for _ in range(2))
    torch.cuda.synchronize()
    _assert_close(got, megalayer_reference(*args, eps=1e-6))
    assert torch.equal(again, got)


def test_graph_replay_matches_eager(device):
    """A launch captured in a CUDA graph (the kernel sets its shared-memory
    limit once, at its first uncaptured launch) replays to the eager
    output, bit for bit."""
    args = _layer_args(640, 896, 14, 2, 64, 4864, device, seed=3)
    eager = w8a8_qwen2_layer(*args, eps=1e-6)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        w8a8_qwen2_layer(*args, eps=1e-6)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = w8a8_qwen2_layer(*args, eps=1e-6)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


def test_one_launch_per_decoder_layer(device):
    """A Qwen2Model under "mega" launches B6 once per layer at B=1 and
    agrees with its all-plain version."""
    cfg = Qwen2Config(vocab_size=64, hidden_size=256, num_layers=3,
                      num_heads=8, num_kv_heads=2, intermediate_size=1040,
                      head_dim=32)
    float_rt = Runtime(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    model = init_random_(Qwen2Model(cfg, float_rt, device=device),
                         torch.Generator(device=device).manual_seed(0))
    rt = dataclasses.replace(float_rt, weights_int8=True, act_int8=True,
                             act_int8_min_dim=16, w8a8_impl="mega")
    mega = Qwen2Model(cfg, rt, device="meta")
    mega.load_state_dict(quantize_state_dict(model.state_dict(),
                                             mega.state_dict(), device),
                         assign=True)
    plain = Qwen2Model(cfg, dataclasses.replace(rt, kernels="plain"),
                       device="meta")
    plain.load_state_dict(mega.state_dict(), assign=True)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(1, 77, 256)).astype(np.float32))
    valid = torch.ones(1, 77, dtype=torch.int32)
    valid[0, 60:] = 0
    x, valid = x.to(device), valid.to(device)
    before = cuda_lib.LAUNCHES[KERNEL_NAME]
    with torch.inference_mode():
        got = mega(x, valid=valid, causal=False, output_hidden_states=True)
        torch.cuda.synchronize()
        assert cuda_lib.LAUNCHES[KERNEL_NAME] == before + cfg.num_layers
        want = plain(x, valid=valid, causal=False, output_hidden_states=True)
    assert cuda_lib.LAUNCHES[KERNEL_NAME] == before + cfg.num_layers
    assert got["hidden_states"].shape == (1, cfg.num_layers + 1, 77, 256)
    # the first layer's output (hidden state 1) holds the per-call bound;
    # later layers see inputs that already differ
    _assert_close(got["hidden_states"][0, 1], want["hidden_states"][0, 1])
    assert torch.isfinite(got["last_hidden_state"].float()).all()


def test_rejects_what_it_does_not_take(device):
    args = list(_layer_args(32, 64, 4, 2, 16, 208, device, seed=2))
    f32 = [a.float() if i < 4 else a for i, a in enumerate(args)]
    with pytest.raises(TypeError):  # bf16 only on the card
        w8a8_qwen2_layer(*f32, eps=1e-6)
    with pytest.raises(ValueError):  # block_f not a multiple of 64
        w8a8_qwen2_layer(*args, eps=1e-6, block_f=100)
    wide = _layer_args(16, 64, 17, 1, 64, 64, device, seed=4)
    with pytest.raises(ValueError, match="exact"):  # H*Dh*127^2 >= 2^24
        w8a8_qwen2_layer(*wide, eps=1e-6)
    odd = _layer_args(16, 64, 2, 1, 48, 64, device, seed=5)
    with pytest.raises(ValueError, match="head dim"):
        w8a8_qwen2_layer(*odd, eps=1e-6)
