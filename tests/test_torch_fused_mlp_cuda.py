"""Kernels B2/B3 (``ops/fused_mlp.py``) on the card at the edges of their
plan (``mlp_plan``), bit for bit against their plain version and against
themselves on a second call:

* the rows around the decode split (M = 1 and 31 split K and the panels,
  32 is the last such, 33 the first with one slice and one group) and
  around the tiles (64 rows a quant and up item, 128 a down item: M = 64,
  65, 640);
* so400m's ragged F = 4304 (the last of 9 panels 208 columns) and a K of
  4304 (the last 128-byte step 80 bytes, the rest zeros from TMA);
* the 7B and 13B widths, K = 4096-5120, at a decode row and above 32;
* a CUDA graph of each kind of plan, replayed to the eager bits.

Imports no JAX: ``python -m pytest tests/test_torch_fused_mlp_cuda.py -m
cuda``. Without a card every test here skips.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _case(shape, dev):
    """x and one MLP's weights as the models hold them (lecun-normal float
    weights quantized per output channel), the kernel call and the plain
    one."""
    from vla_adapter_torch.models.quantize import quantize_weight
    from vla_adapter_torch.ops.fused_mlp import (
        fused_mlp_reference,
        w8a8_gated_mlp,
        w8a8_mlp,
    )

    m, k, f, d, act, gated = shape
    gen = torch.Generator(device=dev).manual_seed(m * 7 + k + f)

    def randn(*size):
        return torch.randn(size, generator=gen, device=dev)

    def weight(n, kk):
        return quantize_weight(randn(n, kk) / kk ** 0.5)

    x = randn(m, k).bfloat16()
    w1, s1 = weight(f, k)
    w2, s2 = weight(d, f)
    if gated:
        wu, su = weight(f, k)
        return (lambda: w8a8_gated_mlp(x, w1, s1, wu, su, w2, s2, act=act),
                lambda: fused_mlp_reference(x, w1, s1, w2, s2, up_q=wu,
                                            up_scale=su, act=act))
    b1, b2 = 0.02 * randn(f), 0.02 * randn(d)
    return (lambda: w8a8_mlp(x, w1, s1, b1, w2, s2, b2, act=act),
            lambda: fused_mlp_reference(x, w1, s1, w2, s2, b1=b1, b2=b2,
                                        act=act))


# (M, K, F, D, activation, gated)
EDGE_SHAPES = [(m, 896, 4864, 896, "silu", True)
               for m in (1, 31, 32, 33, 64, 65, 640)] + [
    (512, 1152, 4304, 1152, "gelu_tanh", False),   # so400m, ragged F
    (17, 1152, 4304, 1152, "gelu_tanh", False),
    (96, 4304, 1152, 4304, "gelu", False),         # K = 4304
    (3, 4304, 1152, 4304, "gelu", False),
    (2, 4096, 11008, 4096, "silu", True),          # Llama-2 7B
    (40, 4096, 14336, 4096, "silu", True),         # Mistral 7B
    (4, 5120, 13824, 5120, "silu", True),          # Llama-2 13B
    (129, 5120, 13824, 5120, "silu", True),
]


@pytest.mark.parametrize("shape", EDGE_SHAPES,
                         ids=lambda s: "x".join(map(str, s[:4])))
def test_fused_mlp_equals_plain_at_the_plans_edges(device, shape):
    from vla_adapter_torch.ops import cuda_lib
    from vla_adapter_torch.ops.fused_mlp import (
        GATED_KERNEL_NAME,
        KERNEL_NAME,
    )

    kernel, plain = _case(shape, device)
    name = GATED_KERNEL_NAME if shape[5] else KERNEL_NAME
    before = cuda_lib.LAUNCHES[name]
    got, again = kernel(), kernel()
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[name] == before + 2
    want = plain()
    assert torch.equal(got, want), float((got.float() - want.float())
                                         .abs().max())
    assert torch.equal(again, got)


@pytest.mark.parametrize("shape", [EDGE_SHAPES[0], EDGE_SHAPES[6],
                                   EDGE_SHAPES[10]],
                         ids=["decode", "wide", "k4304"])
def test_fused_mlp_graph_replay_matches_eager(device, shape):
    """A launch captured in a CUDA graph replays to the eager output, bit
    for bit, leaving its counters and split sums zeroed for the next call
    (an eager call after the replays gives the same bits)."""
    kernel, _ = _case(shape, device)
    eager = kernel()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernel()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = kernel()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)
    assert torch.equal(kernel(), eager)
