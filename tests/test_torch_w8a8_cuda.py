"""The w8a8 CUDA kernels against their plain versions, on the card.

Kernels B4/B5 (``ops/w8a8_matmul.py``) must match bit for bit: the int32
product is exact and the epilogue rounds as the plain version does; with
the quantization inside (``w8a8_linear``) the kernel's int8 rows and
scales equal ``quantize_rows``' too.
Kernels B2/B3 (``ops/fused_mlp.py``) may differ where the kernel's
expf/tanhf and PyTorch's land an ulp apart: a panel scale one ulp off moves
its row by ulps, and an int8 rounding of h can flip. The tolerance is one
int8 step of h through the down projection (``_flip_bound``) plus two ulps
of the largest output, and at most 2% of the rows may differ from the plain
version by more than two ulps of an output.

Imports no JAX: ``python -m pytest tests/test_torch_w8a8_cuda.py -m cuda``.
Without a card every test here skips.
"""

import numpy as np
import pytest
import torch

from vla_adapter_torch.ops import cuda_lib
from vla_adapter_torch.ops.fused_mlp import (
    GATED_KERNEL_NAME,
    KERNEL_NAME as MLP_KERNEL_NAME,
    fused_mlp_reference,
    w8a8_gated_mlp,
    w8a8_mlp,
)
from vla_adapter_torch.ops.w8a8_matmul import (
    KERNEL_NAME,
    STACKED_KERNEL_NAME,
    quantize_rows,
    w8a8_linear,
    w8a8_linear_reference,
    w8a8_matmul,
    w8a8_matmul_reference,
    w8a8_matmul_stacked,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _int8(rng, shape, dev):
    return torch.from_numpy(rng.integers(-127, 128, size=shape,
                                         dtype=np.int8)).to(dev)


def _scales(rng, shape, dev, lo=0.5, hi=2.0):
    return torch.from_numpy(rng.uniform(lo, hi, size=shape)
                            .astype(np.float32)).to(dev)


# (M, K, N): Qwen2 q/o at B=1, ragged M and N, the head's M=8 and fc_in K.
MATMUL_SHAPES = [(640, 896, 896), (522, 1024, 1024), (70, 48, 200),
                 (8, 6272, 896), (1, 896, 896)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", MATMUL_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_w8a8_matmul_matches_plain_exactly(device, shape, dtype):
    m, k, n = shape
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(device)
    xq, rs = quantize_rows(x)
    w, ws = _int8(rng, (n, k), device), _scales(rng, (n,), device, 1e-3, 1e-2)
    before = cuda_lib.LAUNCHES[KERNEL_NAME]
    got = w8a8_matmul(xq, rs, w, ws, out_dtype=dtype)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[KERNEL_NAME] == before + 1
    want = w8a8_matmul_reference(xq, rs, w, ws, out_dtype=dtype)
    assert got.dtype == dtype and got.shape == (m, n)
    assert torch.equal(got, want)


def test_w8a8_matmul_stacked_matches_plain_exactly(device):
    """One layer of a stack, and every layer at once (BatchedDense)."""
    rng = np.random.default_rng(3)
    num_l, m, k, n = 5, 65, 896, 896
    w, ws = _int8(rng, (num_l, n, k), device), _scales(rng, (num_l, n), device)
    x = torch.from_numpy(rng.normal(size=(num_l, m, k)).astype(np.float32))
    xq, rs = quantize_rows(x.to(device))
    before = cuda_lib.LAUNCHES[STACKED_KERNEL_NAME]
    got = w8a8_matmul_stacked(xq, rs, w, ws)
    one = w8a8_matmul_stacked(xq[2], rs[2], w, ws, layer=2)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[STACKED_KERNEL_NAME] == before + 2
    assert torch.equal(got, w8a8_matmul_reference(xq, rs, w, ws))
    assert torch.equal(one, got[2])


# (M, K, N) beyond MATMUL_SHAPES for the entry with the quantization
# inside: the head at B=4 (M = 32) and a small M, ragged M at B=1, the
# B=4 Qwen2 q/o, a "dense" MLP down projection (x streamed), three K
# slices at M <= 16 (their maxima exchanged) and 13 column tiles (no
# cluster divides them: x streamed).
LINEAR_SHAPES = MATMUL_SHAPES + [(4, 896, 896), (32, 896, 896),
                                 (523, 1024, 1024), (2560, 896, 896),
                                 (640, 4864, 896), (16, 1040, 896),
                                 (100, 1152, 832)]


def _activations(rng, shape, dev, dtype):
    """Normal activations with an outlier column and an all-zero row
    (its scale is 1e-8 / 127), in the working dtype."""
    x = rng.normal(size=shape).astype(np.float32)
    x[..., 3] *= 20.0
    x[..., min(1, shape[-2] - 1), :] = 0.0
    return torch.from_numpy(x).to(dev, dtype)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32],
                         ids=["out_bf16", "out_f32"])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32],
                         ids=["x_bf16", "x_f32"])
@pytest.mark.parametrize("shape", LINEAR_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_w8a8_linear_matches_plain_exactly(device, shape, x_dtype,
                                           out_dtype):
    m, k, n = shape
    rng = np.random.default_rng(m * 7 + k + n)
    x = _activations(rng, (m, k), device, x_dtype)
    w, ws = _int8(rng, (n, k), device), _scales(rng, (n,), device, 1e-3, 1e-2)
    before = cuda_lib.LAUNCHES[KERNEL_NAME]
    got = w8a8_linear(x, w, ws, out_dtype=out_dtype)
    again = w8a8_linear(x, w, ws, out_dtype=out_dtype)  # scratch left zeroed
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[KERNEL_NAME] == before + 2
    want = w8a8_linear_reference(x, w, ws, out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == (m, n)
    assert torch.equal(got, want)
    assert torch.equal(again, want)


def _every_bf16(lo_exp: int, hi_exp: int) -> np.ndarray:
    """Every bf16 value with lo_exp <= log2|v| < hi_exp, both signs."""
    bits = np.arange((127 + lo_exp) << 7, (127 + hi_exp) << 7,
                     dtype=np.uint32) << 16
    pos = bits.view(np.float32)
    return np.concatenate([pos, -pos])


# (M, values, pad): every bf16 in [1, 64) (K = 1536: xq resident, the
# quantization shared by a cluster), in [2^-6, 64) (K = 3088: x streamed;
# at M = 8 split over K with the maxima exchanged).
@pytest.mark.parametrize("m,lo_exp,pad", [(256, 0, 0), (256, -6, 16),
                                          (8, -6, 16)],
                         ids=["resident", "streamed", "narrow"])
def test_w8a8_linear_rounds_ties_as_division(device, m, lo_exp, pad):
    """Each row holds every bf16 value of a range beside its own bf16
    absmax (256 of them in [64, 256)), so x / scale meets half-integers
    exactly (x = absmax / 2 among them) and within an ulp of them: the
    kernel's division-free quotient must round every value as
    quantize_rows' division does."""
    vals = _every_bf16(lo_exp, 6)
    absmax = (np.arange(0x4280, 0x4380, dtype=np.uint32) << 16).view(
        np.float32)
    x = np.zeros((m, vals.size + pad), dtype=np.float32)
    x[:, :vals.size] = vals
    x[:, 0] = absmax[:m] if m < absmax.size else absmax
    rng = np.random.default_rng(12)
    x = torch.from_numpy(x).to(device, torch.bfloat16)
    n = 512
    w, ws = _int8(rng, (n, x.shape[1]), device), _scales(rng, (n,), device)
    got = w8a8_linear(x, w, ws, out_dtype=torch.float32)
    want = w8a8_linear_reference(x, w, ws, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32],
                         ids=["out_bf16", "out_f32"])
@pytest.mark.parametrize("m", [65, 512], ids=["adapter", "task"])
def test_w8a8_linear_stacked_matches_plain_exactly(device, m, out_dtype):
    """The head's K/V stacks: 24 layers, row block l against layer l."""
    rng = np.random.default_rng(m)
    num_l, k, n = 24, 896, 896
    x = _activations(rng, (num_l, m, k), device, torch.bfloat16)
    w, ws = _int8(rng, (num_l, n, k), device), _scales(rng, (num_l, n), device)
    before = cuda_lib.LAUNCHES[STACKED_KERNEL_NAME]
    got = w8a8_linear(x, w, ws, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[STACKED_KERNEL_NAME] == before + 1
    assert torch.equal(got, w8a8_linear_reference(x, w, ws,
                                                  out_dtype=out_dtype))


def test_w8a8_layers_quantize_inside_the_kernel(device, monkeypatch):
    """On the card Dense and BatchedDense run w8a8 as one launch each: no
    quantize_rows (its ~10 elementwise launches) before the kernel."""
    import dataclasses

    from vla_adapter_torch.models import layers
    from vla_adapter_torch.ops import w8a8_matmul as ops

    rng = np.random.default_rng(4)
    rt = dataclasses.replace(layers.Runtime(), weights_int8=True,
                             act_int8=True)
    dense = layers.Dense(512, 256, rt=rt, device=device)
    stack = layers.BatchedDense(512, 256, 3, rt=rt, device=device)
    for mod in (dense, stack):
        mod.weight_q.copy_(_int8(rng, tuple(mod.weight_q.shape), device))
        mod.weight_scale.fill_(1e-2)
        mod.bias.zero_()
    x = _activations(rng, (2, 5, 512), device, torch.bfloat16)
    xs = _activations(rng, (2, 3, 5, 512), device, torch.bfloat16)
    want = (dense(x), stack(xs))

    def refuse(_):
        raise AssertionError("quantize_rows ran on the card")

    monkeypatch.setattr(ops, "quantize_rows", refuse)
    before = dict(cuda_lib.LAUNCHES)
    got = (dense(x), stack(xs))
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[KERNEL_NAME] == before.get(KERNEL_NAME, 0) + 1
    assert cuda_lib.LAUNCHES[STACKED_KERNEL_NAME] == \
        before.get(STACKED_KERNEL_NAME, 0) + 1
    monkeypatch.undo()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    plain = dataclasses.replace(rt, kernels="plain")
    dense.rt = stack.rt = plain
    assert torch.equal(dense(x), got[0]) and torch.equal(stack(xs), got[1])


def _flip_bound(x, w1, s1, w2, s2, up_q, up_scale, b1, act):
    """Largest output change one int8 flip of h can cause: one step of the
    panel scale hs times the largest |w2| * s2 of a column."""
    from vla_adapter_torch.ops.fused_mlp import kernel_activation
    from vla_adapter_torch.ops.w8a8_matmul import int_matmul

    xq, rs = quantize_rows(x)
    g = int_matmul(xq, w1).float() * rs * s1
    if b1 is not None:
        g = g + b1
    h = kernel_activation(act)(g)
    if up_q is not None:
        h = h * (int_matmul(xq, up_q).float() * rs * up_scale)
    hs_max = h.abs().max() / 127.0
    return float(hs_max * (w2.float().abs() * s2[:, None]).max())


# (M, K, F, D, act, gated): the flagship MLPs at B=1 and small ragged ones.
MLP_SHAPES = [
    (640, 896, 4864, 896, "silu", True),      # Qwen2
    (522, 1024, 4096, 1024, "gelu", False),   # DINOv2
    (512, 1152, 4304, 1152, "gelu_tanh", False),  # so400m, ragged F
    (512, 2176, 8704, 896, "gelu", False),    # projector fc1 -> fc2
    (37, 64, 208, 72, "quick_gelu", False),
    (20, 96, 1040, 64, "gelu_tanh", True),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", MLP_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_fused_mlp_matches_plain(device, shape, dtype):
    m, k, f, d, act, gated = shape
    rng = np.random.default_rng(m + f)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(
        device, dtype)
    w1, s1 = _int8(rng, (f, k), device), _scales(rng, (f,), device, 1e-4, 3e-4)
    w2, s2 = _int8(rng, (d, f), device), _scales(rng, (d,), device, 1e-4, 3e-4)
    up_q = up_scale = b1 = b2 = None
    if gated:
        up_q = _int8(rng, (f, k), device)
        up_scale = _scales(rng, (f,), device, 1e-4, 3e-4)
        name = GATED_KERNEL_NAME
    else:
        b1 = torch.from_numpy(rng.normal(size=f).astype(np.float32)).to(device)
        b2 = torch.from_numpy(rng.normal(size=d).astype(np.float32)).to(device)
        name = MLP_KERNEL_NAME
    before = cuda_lib.LAUNCHES[name]
    if gated:
        got = w8a8_gated_mlp(x, w1, s1, up_q, up_scale, w2, s2, act=act)
    else:
        got = w8a8_mlp(x, w1, s1, b1, w2, s2, b2, act=act)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[name] == before + 1
    want = fused_mlp_reference(x, w1, s1, w2, s2, up_q=up_q,
                               up_scale=up_scale, b1=b1, b2=b2, act=act)
    assert got.dtype == dtype and got.shape == (m, d)
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs()
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -23
    tol = _flip_bound(x.float(), w1, s1, w2, s2, up_q, up_scale, b1, act) \
        + 2 * ulp * float(want.float().abs().max())
    assert float(err.max()) <= tol, (float(err.max()), tol)
    # Beyond two ulps of each output only flips remain, each confined to
    # its row, and they are rare.
    flipped = (err > 2 * ulp * want.float().abs()).any(dim=-1)
    assert float(flipped.float().mean()) <= 0.02, int(flipped.sum())


def _mlp_case(shape, dev, dtype=torch.bfloat16):
    """x and one MLP's weights as the models hold them: lecun-normal float
    weights quantized per output channel, normal activations."""
    from vla_adapter_torch.models.quantize import quantize_weight

    m, k, f, d, act, gated = shape
    gen = torch.Generator(device=dev).manual_seed(m * 3 + f)

    def randn(*size):
        return torch.randn(size, generator=gen, device=dev)

    def weight(n, kk):
        return quantize_weight(randn(n, kk) / kk ** 0.5)

    x = randn(m, k).to(dtype)
    w1, s1 = weight(f, k)
    w2, s2 = weight(d, f)
    if gated:
        up_q, up_scale = weight(f, k)
        return x, lambda: w8a8_gated_mlp(x, w1, s1, up_q, up_scale, w2, s2,
                                         act=act), \
            lambda: fused_mlp_reference(x, w1, s1, w2, s2, up_q=up_q,
                                        up_scale=up_scale, act=act)
    b1, b2 = 0.02 * randn(f), 0.02 * randn(d)
    return x, lambda: w8a8_mlp(x, w1, s1, b1, w2, s2, b2, act=act), \
        lambda: fused_mlp_reference(x, w1, s1, w2, s2, b1=b1, b2=b2, act=act)


# (M, K, F, D, act, gated) where the work split is uneven: a ragged F
# (so400m, the last of 9 panels 208 wide), a half last panel (Qwen2, F =
# 4864), 17 panels (the projector), M not a multiple of the 32-row tile
# (1, 17, 522, 2088) and M above one wave of CTAs (Qwen2 at B=4).
SPLIT_SHAPES = [
    (1, 896, 4864, 896, "silu", True),
    (17, 896, 4864, 896, "silu", True),
    (17, 1152, 4304, 1152, "gelu_tanh", False),
    (512, 1152, 4304, 1152, "gelu_tanh", False),
    (522, 1024, 4096, 1024, "gelu", False),
    (2088, 1024, 4096, 1024, "gelu", False),
    (256, 2176, 8704, 896, "gelu", False),
    (2560, 896, 4864, 896, "silu", True),
]


@pytest.mark.parametrize("shape", SPLIT_SHAPES,
                         ids=lambda s: "x".join(map(str, s[:4])))
def test_fused_mlp_equals_plain_where_the_split_is_uneven(device, shape):
    """Bit for bit with the plain version, and two calls on the same
    inputs give the same bits (no float atomics: the panels meet in one
    order)."""
    _, kernel, plain = _mlp_case(shape, device)
    got, again = kernel(), kernel()
    torch.cuda.synchronize()
    want = plain()
    assert torch.equal(got, want), float((got.float() - want.float())
                                         .abs().max())
    assert torch.equal(again, got)


@pytest.mark.parametrize("shape", [SPLIT_SHAPES[1], SPLIT_SHAPES[4]],
                         ids=["gated", "plain"])
def test_fused_mlp_graph_replay_matches_eager(device, shape):
    """A launch captured in a CUDA graph (the per-device counters exist and
    the shared-memory limit is set before the capture) replays to the
    eager output, bit for bit, and leaves the counters zeroed."""
    _, kernel, _ = _mlp_case(shape, device)
    eager = kernel()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernel()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = kernel()
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)
    assert torch.equal(kernel(), eager)


def test_fused_mlp_panel_width_is_numerics(device):
    """block_f changes the re-quantization of h, and the kernel follows the
    plain version at 128 as at 512."""
    rng = np.random.default_rng(9)
    m, k, f, d = 48, 128, 336, 128
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(device)
    w1, s1 = _int8(rng, (f, k), device), _scales(rng, (f,), device, 1e-3, 2e-3)
    w2, s2 = _int8(rng, (d, f), device), _scales(rng, (d,), device, 1e-3, 2e-3)
    b1 = torch.zeros(f, device=device)
    for block_f in (128, 512):
        got = w8a8_mlp(x, w1, s1, b1, w2, s2, None, act="gelu",
                       block_f=block_f)
        want = fused_mlp_reference(x, w1, s1, w2, s2, b1=b1, act="gelu",
                                   block_f=block_f)
        torch.cuda.synchronize()
        bound = _flip_bound(x, w1, s1, w2, s2, None, None, b1, "gelu")
        assert float((got - want).abs().max()) <= bound + 1e-5


def test_kernels_reject_what_they_do_not_take(device):
    rng = np.random.default_rng(0)
    xq = _int8(rng, (4, 40), device)   # K % 16 != 0
    rs = torch.ones(4, 1, device=device)
    with pytest.raises(ValueError):
        w8a8_matmul(xq, rs, _int8(rng, (8, 40), device),
                    torch.ones(8, device=device))
    with pytest.raises(TypeError):  # float16 activations
        w8a8_linear(torch.zeros(4, 64, dtype=torch.float16, device=device),
                    _int8(rng, (8, 64), device), torch.ones(8, device=device))
    x = torch.zeros(4, 64, device=device)
    w1, w2 = _int8(rng, (64, 64), device), _int8(rng, (64, 64), device)
    s = torch.ones(64, device=device)
    with pytest.raises(TypeError):   # out dtype must be x's
        w8a8_mlp(x, w1, s, None, w2, s, None, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        w8a8_mlp(x, w1, s, None, w2, s, None, block_f=100)
