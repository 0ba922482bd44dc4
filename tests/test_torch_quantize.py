"""The port's quantizers against the JAX package's, on the CPU.

Bit for bit: the weight quantizer against the numpy ``quantize_kernel``
(the JAX package's reference twin) and ``chip_smoke.py``'s copy of it, the
activation quantizer against the JAX ``quantize_rows`` (eager and jitted),
and a quantized JAX tree carried by ``from_jax_params`` against the port
quantizing the carried float tree itself.
"""

import collections
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_modules import JCFG, TCFG, jax_params
from vla_adapter_tpu.models import layers as jlayers
from vla_adapter_tpu.models.quantize import quantize_kernel as np_quantize_kernel
from vla_adapter_tpu.models.quantize import quantize_params
from vla_adapter_torch.models import layers as tlayers
from vla_adapter_torch.models.quantize import (
    quantize_kernel,
    quantize_state_dict,
    quantize_weight,
)
from vla_adapter_torch.models.vla import VLAModel
from vla_adapter_torch.ops.w8a8_matmul import quantize_rows
from vla_adapter_torch.weights.from_jax import from_jax_params


def _kernels():
    """(name, float32 array in the JAX (..., in, out) layout)."""
    rng = np.random.default_rng(0)
    zero_col = rng.normal(size=(64, 24)).astype(np.float32)
    zero_col[:, 5] = 0.0
    halves = np.tile(np.asarray([[127.0], [0.5], [-1.5], [2.5]], np.float32),
                     (1, 3))  # scale 1: ties round to even
    return [
        ("normal_2d", rng.normal(size=(96, 80)).astype(np.float32)),
        ("wide_range", (rng.standard_cauchy(size=(130, 33)) * 3
                        ).astype(np.float32)),
        ("stack_3d", rng.normal(size=(3, 48, 40)).astype(np.float32) * 0.02),
        ("zero_column", zero_col),
        ("ties", halves),
    ]


@pytest.mark.parametrize("name,kernel", _kernels(),
                         ids=[name for name, _ in _kernels()])
def test_quantize_kernel_matches_numpy_bit_for_bit(name, kernel):
    want_q, want_s = np_quantize_kernel(kernel)
    got_q, got_s = quantize_kernel(torch.from_numpy(kernel))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy().view(np.int32),
                                  want_s.view(np.int32))
    # the port's (out, in) layout quantizes to the transposed bits
    wq, ws = quantize_weight(torch.from_numpy(kernel).transpose(-1, -2))
    np.testing.assert_array_equal(wq.transpose(-1, -2).numpy(), want_q)
    np.testing.assert_array_equal(ws.numpy(), want_s)
    # chip_smoke.py checks the on-card quantizer against its own numpy copy
    cq, cs = chip_smoke.numpy_quantize_kernel(kernel)
    np.testing.assert_array_equal(cq, want_q)
    np.testing.assert_array_equal(cs, want_s)


def test_quantize_kernel_of_bf16_weights():
    """Serving weights arrive in bf16: quantized from their exact f32
    values, as the JAX package quantizes a bf16 tree."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.normal(size=(72, 40)).astype(np.float32)
                         ).bfloat16()
    want_q, want_s = np_quantize_kernel(w.float().numpy())
    got_q, got_s = quantize_kernel(w)
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), want_s)


def _activations():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(7, 33, 96)).astype(np.float32) * 3
    x[0, 0] = 0.0                     # an all-zero row: scale 1e-8 / 127
    x[1, 2, :4] = [127.0, 0.5, -2.5, 1.5]
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_matches_jax_bit_for_bit(dtype):
    """The port's quantize_rows is the JAX function as written (a division
    by 127), bit for bit."""
    x = _activations()
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want_q, want_s = jlayers.quantize_rows(jx)
    got_q, got_s = quantize_rows(
        torch.tensor(np.asarray(jx.astype(jnp.float32))).to(
            getattr(torch, dtype)))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy().view(np.int32),
                                  np.asarray(want_s).view(np.int32))


def test_quantize_rows_against_jitted_jax():
    """Under jit, XLA rewrites ``/ 127.0`` into ``* float32(1/127)``, so
    the jitted JAX function (as the JAX Predictor runs it) can round a row
    scale one ulp away from the division. The int8 values agree on these
    rows; the scales within one ulp."""
    x = _activations()
    want_q, want_s = jax.jit(jlayers.quantize_rows)(jnp.asarray(x))
    got_q, got_s = quantize_rows(torch.tensor(x))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    ulps = np.abs(got_s.numpy().view(np.int32).astype(np.int64)
                  - np.asarray(want_s).view(np.int32))
    assert ulps.max() <= 1
    absmax = np.maximum(np.abs(x).max(-1, keepdims=True), np.float32(1e-8))
    np.testing.assert_array_equal(np.asarray(want_s),
                                  absmax * np.float32(1.0 / 127.0))


@pytest.fixture(scope="module")
def params():
    return jax_params()


def test_quantized_jax_tree_carries_to_the_port_quantizers_state(params):
    """from_jax_params of the JAX package's quantize_params tree equals the
    port quantizing the carried float tree: same keys, same bits."""
    model = VLAModel(TCFG, tlayers.Runtime(
        dtype=torch.float32, param_dtype=torch.float32, weights_int8=True),
        device="meta")
    expected = model.state_dict()
    carried = from_jax_params(quantize_params(params), TCFG)
    ported = quantize_state_dict(from_jax_params(params, TCFG), expected)
    assert set(carried) == set(ported) == set(expected)
    n_int8 = 0
    for key, want in ported.items():
        got = carried[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        assert torch.equal(got, want), key
        n_int8 += want.dtype == torch.int8
    # every Dense and BatchedDense of the tiny VLA but the patch embeddings
    head_stacks = [k for k in ported if k.startswith("action_head.k_task")]
    assert head_stacks == ["action_head.k_task.weight_q",
                           "action_head.k_task.weight_scale",
                           "action_head.k_task.bias"]
    assert ported["action_head.k_task.weight_q"].shape == (2, 64, 64)
    assert "vision_backbone.featurizer.patch_embed.weight" in ported
    assert n_int8 == sum(k.endswith(".weight_q") for k in expected) > 40
    model.load_state_dict(ported, strict=True, assign=True)


def test_quantize_state_dict_rejects_unknown_entries(params):
    model = VLAModel(TCFG, tlayers.Runtime(weights_int8=True), device="meta")
    state = from_jax_params(params, TCFG)
    state["stray.weight"] = torch.zeros(3)
    with pytest.raises(KeyError, match="stray"):
        quantize_state_dict(state, model.state_dict())


def test_chip_smoke_derives_the_flagship_w8a8_launches():
    """chip_smoke.py checks the w8a8 main path's launch counts against the
    ones it derives from VLAConfig(); these are the counts one flagship
    forward made on the card, per backend: every B4/B5 call above 32 rows
    takes the Hopper branch, its quantization pre-pass a launch of its
    own."""
    from vla_adapter_torch.core.config import VLAConfig
    from vla_adapter_torch.data.tokenization import MockTokenizer

    tok = MockTokenizer()
    shapes = chip_smoke.w8a8_shapes(VLAConfig(), lambda t: tok(t).input_ids)
    assert chip_smoke.expected_w8a8_launches(shapes, "fused") == {
        "w8a8_gated_mlp": 24, "w8a8_mlp": 50, "w8a8_matmul": 367,
        "w8a8_matmul_stacked": 4, "w8a8_quantize": 367 - 1 - 1 - 120 + 4}
    assert chip_smoke.expected_w8a8_launches(shapes, "dense") == {
        "w8a8_matmul": 539, "w8a8_matmul_stacked": 4,
        "w8a8_quantize": 539 - 1 - 1 - 120 + 4}
    # "mega": one layer kernel per decoder layer, which absorbs the Qwen2
    # MLP and the o-projection's matmul
    assert chip_smoke.expected_w8a8_launches(shapes, "mega") == {
        "w8a8_qwen2_layer": 24, "w8a8_mlp": 50, "w8a8_matmul": 343,
        "w8a8_matmul_stacked": 4, "w8a8_quantize": 343 - 1 - 1 - 120 + 4}
    # every shape is a multiple the kernels take: K % 16, N and F even
    for sh in shapes:
        assert sh["k"] % 16 == 0 and sh.get("n", 2) % 2 == 0
        assert sh.get("f", 16) % 16 == 0


@pytest.mark.parametrize("batch", [8, 16])
def test_chip_smoke_dense_shapes_cover_the_server_buckets(batch):
    """The server's buckets 8 and 16, which "auto" serves with "dense":
    the matmuls chip_smoke.py holds against their plain versions there are
    every w8a8 launch of such a forward, each MLP split into its matmuls."""
    from vla_adapter_torch.core.config import VLAConfig
    from vla_adapter_torch.data.tokenization import MockTokenizer

    tok = MockTokenizer()
    shapes = chip_smoke.w8a8_shapes(VLAConfig(), lambda t: tok(t).input_ids,
                                    batches=(batch,))
    dense = chip_smoke.dense_shapes(shapes)
    from vla_adapter_torch.ops import w8a8_matmul

    got = collections.Counter()
    for sh in dense:
        assert sh["forward_batch"] == batch and "f" not in sh
        assert sh["k"] % 16 == 0 and sh["n"] % 2 == 0
        got[sh["kernel"]] += sh["launches_per_forward"]
        if w8a8_matmul.w8a8_plan(sh["m"], sh["n"], sh["k"],
                                 sh.get("layers", 1))["prepass"]:
            got[w8a8_matmul.QUANT_KERNEL_NAME] += sh["launches_per_forward"]
    assert dict(got) == chip_smoke.expected_w8a8_launches(shapes, "dense",
                                                          batch)
    assert len({(sh["kernel"], sh["m"], sh["k"], sh["n"])
                for sh in dense}) == len(dense)
    llm = [sh for sh in dense if "qwen2_mlp_fc1" in sh["shape"]]
    assert len(llm) == 1 and llm[0]["shape"] == ["qwen2_mlp_fc1",
                                                  "qwen2_mlp_up"]
    assert llm[0]["m"] == batch * 640
