"""The serving forward replayed as a CUDA graph against the eager forward,
on the card.

The tiny VLA of ``tests/torch_tiny.py`` with random bf16 weights, served in
every tier (bf16, weight-only int8, and w8a8 under "fused", "dense", "auto"
and "mega") with ``act_int8_min_dim=16``, so that every w8a8 kernel takes
part; the so400m-style tower's MLP is widened from 40 to 64 because the
fused-MLP kernels take F % 16 == 0. A graph replays the eager forward's
launches in the eager order on the same inputs, so normalized actions must
be equal bit for bit, and so must the launch counts per request.

Imports no JAX: ``python -m pytest tests/test_torch_graph_cuda.py -m
cuda``. Without a card every test here skips.
"""

import dataclasses

import numpy as np
import pytest
import torch

import vla_adapter_torch.core.config as tc
import vla_adapter_torch.core.constants as tk
from tests.torch_tiny import tiny_cfg
from vla_adapter_torch.data.normalization import dataset_statistics
from vla_adapter_torch.data.tokenization import MockTokenizer
from vla_adapter_torch.infer.predict import SERVING_RUNTIME, Predictor
from vla_adapter_torch.models.layers import init_random_
from vla_adapter_torch.models.vla import VLAModel
from vla_adapter_torch.ops import cuda_lib, fused_mlp, w8a8_matmul

pytestmark = pytest.mark.cuda

MIN_DIM = 16
# (tier, Predictor keywords); every tier at B=1 and B=4 but "mega" (B=1)
TIERS = {
    "bf16": {},
    "int8": {"int8": True},
    "fused": {"act_int8": True, "w8a8_impl": "fused"},
    "dense": {"act_int8": True, "w8a8_impl": "dense"},
    "auto": {"act_int8": True, "w8a8_impl": "auto"},
    "mega": {"act_int8": True, "w8a8_impl": "mega"},
}
CASES = [(tier, b) for tier in TIERS for b in (1, 4)
         if not (tier == "mega" and b > 1)]
# prompts of different lengths, so that the prompt length differs between
# the replays of one graph
TEXTS = ["pick up the cup", "open the top drawer and put the bowl inside it",
         "stack blocks", "put both the soup and the sauce in the basket"]


def card_cfg():
    cfg = tiny_cfg(tc, tk)
    vision = dataclasses.replace(
        cfg.vision, fused=dataclasses.replace(cfg.vision.fused, mlp_dim=64))
    return dataclasses.replace(cfg, vision=vision)


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def base(device):
    """Random bf16 weights of the tiny VLA and what a Predictor needs."""
    cfg = card_cfg()
    gen = torch.Generator(device=device).manual_seed(0)
    model = init_random_(VLAModel(cfg, SERVING_RUNTIME, device=device), gen)
    rng = np.random.default_rng(0)
    stats = {"libero_spatial": dataset_statistics(
        rng.uniform(-1, 1, size=(200, 7)), proprio=rng.normal(size=(200, 8)),
        action_mask=[True] * 6 + [False])}
    tok = MockTokenizer()
    return dict(cfg=cfg, params=model.state_dict(),
                tokenize=lambda t: tok(t).input_ids, norm_stats=stats,
                center_crop=False, device="cuda")


def _predictor(base, tier, **kw):
    rt = dataclasses.replace(SERVING_RUNTIME, act_int8_min_dim=MIN_DIM)
    return Predictor(rt=rt, **base, **TIERS[tier], **kw)


def _rows(pred, b, seed, proprio=True):
    rng = np.random.default_rng(seed)
    size = pred.cfg.vision.primary.image_size
    return [pred.preprocess(
        [rng.integers(0, 256, size=(size, size, 3), dtype=np.uint8)
         for _ in range(pred.cfg.vision.num_images)],
        TEXTS[(seed + i) % len(TEXTS)],
        rng.normal(size=8) if proprio else None) for i in range(b)]


def _counted(pred, rows):
    cuda_lib.reset_launches()
    out = pred.normalized_actions(rows)
    torch.cuda.synchronize()
    return out, dict(cuda_lib.LAUNCHES)


@pytest.mark.parametrize("tier,b", CASES, ids=[f"{t}-b{b}" for t, b in CASES])
def test_graph_equals_eager(base, tier, b):
    """Over several requests whose prompt lengths and images differ, the
    replayed forward gives the eager actions bit for bit and launches what
    the eager one launches; one graph serves them all."""
    graph = _predictor(base, tier)
    eager = graph.with_runtime(graph.rt, cuda_graph=False)
    assert graph.cuda_graph and eager.graphs is None
    outs = []
    for seed in range(3):
        rows = _rows(graph, b, seed)
        want, want_launches = _counted(eager, rows)
        got, got_launches = _counted(graph, rows)
        assert got.shape == (b, 8, 7) and np.isfinite(got).all()
        np.testing.assert_array_equal(got, want)
        assert got_launches == want_launches
        assert got_launches.get("fused_attention")
        if "act_int8" in TIERS[tier]:
            assert got_launches.get(w8a8_matmul.KERNEL_NAME)
        outs.append(got)
    assert not np.array_equal(outs[0], outs[1])  # the inputs did change
    (key,) = graph.graphs.captures
    assert key == graph.graph_key(b, True)
    assert graph.graphs.captures[key].replays == 3


def test_replays_follow_prompt_length_and_pixels(base):
    """One graph, replayed on rows that differ only in the prompt (and its
    length), then only in pixels: each replay gives that row's eager
    actions."""
    graph = _predictor(base, "fused")
    eager = graph.with_runtime(graph.rt, cuda_graph=False)
    row = _rows(graph, 1, 0)[0]
    short = dict(row, **graph.preprocess(
        [np.zeros((28, 28, 3), np.uint8)] * 2, "go", np.zeros(8)))
    short["pixels"] = row["pixels"]
    other_pixels = dict(row, pixels=255 - row["pixels"])
    assert short["plen"] != row["plen"]
    for r in (row, short, other_pixels, row):
        np.testing.assert_array_equal(graph.normalized_actions([r]),
                                      eager.normalized_actions([r]))
    assert len(graph.graphs.captures) == 1


def test_proprio_takes_its_own_key(base):
    graph = _predictor(base, "fused")
    eager = graph.with_runtime(graph.rt, cuda_graph=False)
    with_p, without_p = _rows(graph, 2, 5), _rows(graph, 2, 5, proprio=False)
    for rows in (with_p, without_p, with_p):
        np.testing.assert_array_equal(graph.normalized_actions(rows),
                                      eager.normalized_actions(rows))
    assert set(graph.graphs.captures) == {("fused", 2, True),
                                          ("fused", 2, False)}
    assert not np.array_equal(graph.normalized_actions(with_p),
                              graph.normalized_actions(without_p))


def test_counters_stay_zero_across_graphs_in_turns(base, device):
    """The persistent kernels' ticket and ready counters and B4's split-K
    scratch, shared by every graph on the device, are zero again after
    replays of several graphs in turns."""
    fused = _predictor(base, "fused")
    mega = fused.with_runtime(fused.rt, w8a8_impl="mega")
    dense = fused.with_runtime(fused.rt, w8a8_impl="dense")
    batches = {b: _rows(fused, b, 10 + b) for b in (1, 2, 4)}
    first = {}
    for turn in range(3):
        for b, rows in batches.items():
            for name, pred in (("fused", fused), ("dense", dense)):
                out = pred.normalized_actions(rows)
                if turn:
                    np.testing.assert_array_equal(out, first[name, b])
                first[name, b] = out
            out = mega.normalized_actions(batches[1])
            if turn:
                np.testing.assert_array_equal(out, first["mega"])
            first["mega"] = out
    torch.cuda.synchronize()
    counters = fused_mlp.counters(device, 1)
    assert int(counters.abs().sum()) == 0
    part, count = w8a8_matmul._scratch(device)
    assert int(count.abs().sum()) == 0 and int(part.abs().sum()) == 0


def test_cluster_launch_of_b4_captures(device):
    """Kernel B4 with bf16 x at M > 32 (the Hopper branch: its quantization
    pre-pass, then the product with its tensor maps as kernel parameters):
    captured and replayed, it gives the eager bits."""
    gen = torch.Generator(device=device).manual_seed(3)
    x = torch.randn(640, 896, generator=gen, device=device).bfloat16()
    w = torch.randint(-127, 128, (896, 896), generator=gen, device=device,
                      dtype=torch.int8)
    ws = 1e-3 * torch.rand(896, generator=gen, device=device) + 1e-4
    eager = w8a8_matmul.w8a8_linear(x, w, ws)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        w8a8_matmul.w8a8_linear(x, w, ws)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with cuda_lib.recording() as launches, torch.cuda.graph(graph):
        captured = w8a8_matmul.w8a8_linear(x, w, ws)
    x.copy_(torch.randn(640, 896, generator=gen, device=device))
    graph.replay()
    torch.cuda.synchronize()
    assert launches == {w8a8_matmul.QUANT_KERNEL_NAME: 1,
                        w8a8_matmul.KERNEL_NAME: 1}
    assert torch.equal(captured, w8a8_matmul.w8a8_linear(x, w, ws))
    assert not torch.equal(captured, eager)
