"""The causal language path's kernels and the graphed decode step, on the
card.

The decode step of a tiny Qwen2 (random bf16 weights) captured as a CUDA
graph against the eager step, bit for bit, in bf16 and w8a8 "fused"
(``act_int8_min_dim=16``), with and without sampling; kernels B2 and B4 at
a decode step's rows (M = 1, 2, 4, at the flagship's widths) and B4 at
Phi-2's widths against their plain versions, bit for bit; B1 at a causal prefill (the flagship's
14/2 heads of 64) and at Phi-2's 32 heads of D = 80 within B1's bound of
its plain version (``ATOL``, as tests/test_torch_attention_cuda.py).

Imports no JAX: ``python -m pytest tests/test_torch_generate_cuda.py -m
cuda``. Without a card every test here skips.
"""

import dataclasses

import pytest
import torch

from vla_adapter_torch.core.config import Qwen2Config
from vla_adapter_torch.infer.graph import decode_graphs
from vla_adapter_torch.infer.predict import SERVING_RUNTIME
from vla_adapter_torch.models.generate import (
    decode_key,
    decode_step_fn,
    greedy_generate_cached,
    prefill_state,
)
from vla_adapter_torch.models.layers import init_random_
from vla_adapter_torch.models.quantize import quantize_state_dict
from vla_adapter_torch.models.quantize import quantize_weight
from vla_adapter_torch.models.qwen2 import Qwen2Decode, Qwen2Model
from vla_adapter_torch.ops import cuda_lib, fused_mlp, w8a8_matmul
from vla_adapter_torch.ops.attention_kernel import (
    attention_reference,
    fused_attention,
)

pytestmark = pytest.mark.cuda

ATOL = 2e-2  # B1 against its plain version (bf16 outputs below 4)
CFG = Qwen2Config(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
                  num_kv_heads=2, intermediate_size=256, head_dim=32)


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def models(device):
    bf16 = init_random_(Qwen2Model(CFG, SERVING_RUNTIME, device=device),
                        torch.Generator(device=device).manual_seed(0)).eval()
    rt8 = dataclasses.replace(SERVING_RUNTIME, weights_int8=True,
                              act_int8=True, act_int8_min_dim=16,
                              w8a8_impl="fused")
    w8a8 = Qwen2Model(CFG, rt8, device="meta")
    w8a8.load_state_dict(quantize_state_dict(
        bf16.state_dict(), w8a8.state_dict(), device), assign=True)
    return {"bf16": bf16, "w8a8": w8a8.eval()}


@pytest.mark.parametrize("backend", ["bf16", "w8a8"])
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_graphed_decode_equals_eager(device, models, backend, batch,
                                     temperature):
    """Nine steps from one prefill: every state tensor (tokens, cache,
    logits, done flags, position) after the replays equals eager's, bit
    for bit; the launches of a replay are those of an eager step."""
    model = models[backend]
    gen = torch.Generator(device=device).manual_seed(1)
    ids = torch.randint(1, CFG.vocab_size, (batch, 16), generator=gen,
                        device=device)
    steps = 9
    with torch.inference_mode():
        state = prefill_state(model, ids, 7)
        noise = None
        if temperature:
            noise = torch.empty((steps,) + state["logits"].shape,
                                device=device).exponential_(generator=gen)
            state["noise"] = torch.zeros_like(noise[0])
        step = decode_step_fn(Qwen2Decode(model), 3, temperature)
        s_e = {k: v.clone() for k, v in state.items()}
        with cuda_lib.recording() as eager_launches:
            for i in range(steps):
                if noise is not None:
                    s_e["noise"].copy_(noise[i])
                step(s_e)
        s_g = {k: v.clone() for k, v in state.items()}
        it = iter(range(steps))

        def before(s):
            s["noise"].copy_(noise[next(it)])

        graphs = decode_graphs(model, device)
        key = decode_key(model, batch, 16, 3, temperature)
        graphs(key, step, s_g, steps, before if noise is not None else None)
        torch.cuda.synchronize()
    for k in state:
        assert torch.equal(s_e[k], s_g[k]), k
    per_step = {k: v // steps for k, v in eager_launches.items()}
    assert graphs.captures[key].launches == per_step
    if backend == "w8a8":
        assert per_step == {w8a8_matmul.KERNEL_NAME: 2 * CFG.num_layers
                            + 2 * CFG.num_layers,
                            fused_mlp.GATED_KERNEL_NAME: CFG.num_layers}


def test_generate_cached_graph_equals_eager(device, models):
    ids = torch.randint(1, CFG.vocab_size, (4, 24), device=device,
                        generator=torch.Generator(device=device).manual_seed(2))
    for model in models.values():
        a = greedy_generate_cached(model, ids, 8, 16)
        b = greedy_generate_cached(model, ids, 8, 16, cuda_graph=False)
        assert torch.equal(a, b)


@pytest.mark.parametrize("m", [1, 2, 4])
def test_b2_b4_at_decode_rows_equal_plain(device, m):
    """The flagship's decode-step products: B4 at q/o (896 -> 896) and B2
    at the MLP (896 -> 4864 -> 896), bit for bit with their plain versions,
    and again on a rerun."""
    gen = torch.Generator(device=device).manual_seed(3 + m)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    x = randn(m, 896).bfloat16()
    w, ws = quantize_weight(randn(896, 896) / 30.0)
    want = w8a8_matmul.w8a8_linear_reference(x, w, ws)
    for _ in range(2):
        assert torch.equal(w8a8_matmul.w8a8_linear(x, w, ws), want)
    (g, gs), (u, us), (d, ds) = (quantize_weight(randn(*s) / s[1] ** 0.5)
                                 for s in ((4864, 896), (4864, 896),
                                           (896, 4864)))
    want = fused_mlp.fused_mlp_reference(x, g, gs, d, ds, up_q=u,
                                         up_scale=us, act="silu")
    for _ in range(2):
        got = fused_mlp.w8a8_gated_mlp(x, g, gs, u, us, d, ds, act="silu")
        torch.cuda.synchronize()
        assert torch.equal(got, want), float((got.float() - want.float())
                                             .abs().max())


@pytest.mark.parametrize("m,k,n", [(136, 2560, 2560), (136, 2560, 10240),
                                   (136, 10240, 2560), (1, 2560, 51200),
                                   (4, 2560, 51200)])
def test_b4_at_phi_widths_equals_plain(device, m, k, n):
    """B4 at Phi-2's w8a8 products, the untied lm_head's too (a narrow
    split too wide to be resident at once: it takes the wide design)."""
    gen = torch.Generator(device=device).manual_seed(6)
    x = torch.randn(m, k, generator=gen, device=device).bfloat16()
    w, ws = quantize_weight(torch.randn(n, k, generator=gen, device=device)
                            / k ** 0.5)
    want = w8a8_matmul.w8a8_linear_reference(x, w, ws)
    for _ in range(2):
        got = w8a8_matmul.w8a8_linear(x, w, ws)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(1, 14, 2, 128, 64), (4, 14, 2, 128, 64),
                                   (1, 32, 32, 136, 80)],
                         ids=["prefill_b1", "prefill_b4", "phi_d80"])
def test_b1_causal_prefill_and_phi_within_bound(device, shape):
    b, h, hkv, s, d = shape
    gen = torch.Generator(device=device).manual_seed(5)
    q, k, v = (torch.randn(b, n, s, d, generator=gen, device=device)
               .bfloat16() for n in (h, hkv, hkv))
    valid = torch.ones((b, s), dtype=torch.int32, device=device)
    got = fused_attention(q, k, v, valid, causal=True)
    want = attention_reference(q, k, v, valid, causal=True)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert float((got.float() - want.float()).abs().max()) <= ATOL
