"""The port's int8 and w8a8 serving tiers against the JAX package's, on
the CPU.

* Kernels B4/B5: the plain versions (``ops/w8a8_matmul.py``) against the
  Pallas ``w8a8_matmul`` / ``w8a8_matmul_stacked`` in interpret mode, as
  tests/test_ops.py runs them: the int32 product is exact, so within 1e-6
  (they agree bit for bit here). The plain version of ``w8a8_linear`` (the
  entry with the quantization inside) against the JAX Dense's
  ``_w8a8_fwd_math`` and the JAX BatchedDense's int8 einsum, run eagerly
  (where JAX divides by 127 as the port does): bit for bit.
* Dense and BatchedDense in their w8a8 and weight-only branches against
  the JAX modules on the same quantized weights (fp32, 1e-5).
* The whole tiny VLA (tests/test_torch_modules.py) through the JAX
  ``Predictor`` and the port's, in fp32, with ``act_int8_min_dim=16`` in
  both runtimes: every width of the tiny model is below the default 256,
  which would leave the w8a8 branch untested; at 16 the w8a8 branch, the
  weight-only branch (proprio fc1 8 -> 64, the head's fc_out 64 -> 7) and
  the fused MLPs all run. Tolerance 1e-4, fp32 rounding: w8a8 actions lie
  0.1 from float ones, so a looser bound would prove nothing. The port
  divides by 127 for a row scale where jitted JAX multiplies by 1/127
  (tests/test_torch_quantize.py); on these inputs no int8 value differs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_modules import JCFG, TCFG, jax_params
from tests.test_torch_predict import _images, _stats
from vla_adapter_tpu.data.tokenization import MockTokenizer as JaxMockTokenizer
from vla_adapter_tpu.infer.predict import Predictor as JaxPredictor
from vla_adapter_tpu.models import layers as jlayers
from vla_adapter_tpu.models.quantize import quantize_kernel as np_quantize
from vla_adapter_tpu.ops.pallas_matmul import (
    w8a8_matmul as jax_w8a8_matmul,
    w8a8_matmul_stacked as jax_w8a8_matmul_stacked,
)
from vla_adapter_torch.data.tokenization import MockTokenizer
from vla_adapter_torch.infer.predict import Predictor
from vla_adapter_torch.models import layers as tlayers
from vla_adapter_torch.ops import cuda_lib
from vla_adapter_torch.ops.w8a8_matmul import (
    KERNEL_NAME,
    quantize_rows,
    w8a8_linear,
    w8a8_linear_reference,
    w8a8_matmul,
    w8a8_matmul_reference,
    w8a8_matmul_stacked,
)
from vla_adapter_torch.weights.from_jax import from_jax_params

ATOL = RTOL = 1e-4
MIN_DIM = 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _operands(rng, m, k, n, layers=None):
    x = rng.normal(size=(m, k)).astype(np.float32)
    lead = () if layers is None else (layers,)
    wq = rng.integers(-127, 128, size=lead + (k, n)).astype(np.int8)
    ws = rng.uniform(0.5, 2.0, size=lead + (n,)).astype(np.float32)
    return x, wq, ws


@pytest.mark.parametrize("m,k,n", [(96, 448, 384), (70, 128, 200),
                                   (8, 896, 256)])
def test_w8a8_matmul_plain_matches_pallas(m, k, n):
    x, wq, ws = _operands(np.random.default_rng(m + n), m, k, n)
    xq, rs = jlayers.quantize_rows(jnp.asarray(x))
    want = jax_w8a8_matmul(xq, rs, jnp.asarray(wq), jnp.asarray(ws),
                           out_dtype=jnp.float32, block_m=64, block_n=128,
                           interpret=True)
    # the port's weight layout is (out, in)
    got = w8a8_matmul(_t(xq), _t(rs), _t(wq.T), _t(ws),
                      out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_w8a8_matmul_stacked_plain_matches_pallas_every_layer():
    num_l, m, k, n = 3, 96, 128, 384
    x, wq, ws = _operands(np.random.default_rng(5), m, k, n, layers=num_l)
    xq, rs = jlayers.quantize_rows(jnp.asarray(x))
    w_port = _t(np.swapaxes(wq, -1, -2))
    per_layer = []
    for layer in range(num_l):
        want = np.asarray(jax_w8a8_matmul_stacked(
            xq, rs, jnp.asarray(wq), jnp.asarray(ws), jnp.int32(layer),
            out_dtype=jnp.float32, block_m=64, block_n=128, interpret=True))
        got = w8a8_matmul_stacked(_t(xq), _t(rs), w_port, _t(ws),
                                  layer=layer, out_dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
        per_layer.append(want)
    # every layer in one call: row block l against layer l (BatchedDense)
    xs = _t(np.stack([np.asarray(xq)] * num_l))
    rss = _t(np.stack([np.asarray(rs)] * num_l))
    got = w8a8_matmul_stacked(xs, rss, w_port, _t(ws),
                              out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.stack(per_layer), rtol=1e-6,
                               atol=1e-6)


def test_wrappers_never_fall_back_off_the_cpu():
    """Only a CPU tensor takes the plain version: on another device the
    wrapper launches its kernel or raises."""
    xq = torch.zeros(4, 32, dtype=torch.int8, device="meta")
    rs = torch.ones(4, 1, device="meta")
    w = torch.zeros(8, 32, dtype=torch.int8, device="meta")
    ws = torch.ones(8, device="meta")
    with pytest.raises(ValueError, match="device"):
        w8a8_matmul(xq, rs, w, ws)
    with pytest.raises(ValueError, match="device"):
        w8a8_matmul_stacked(xq[None], rs[None], w[None], ws[None])
    x = torch.zeros(4, 32, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="device"):
        w8a8_linear(x, w, ws)
    with pytest.raises(ValueError, match="device"):
        w8a8_linear(x[None], w[None], ws[None])


# (M, K, N) for the entry with the quantization inside: M = 1 (proprio),
# 8 (the action head), odd and multi-tile M, and fc_in's K = 6272.
LINEAR_CASES = [(1, 896, 256), (8, 6272, 128), (17, 448, 96),
                (65, 896, 128), (200, 1152, 64)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m,k,n", LINEAR_CASES,
                         ids=lambda v: str(v))
def test_w8a8_linear_plain_matches_jax_fwd_math(m, k, n, dtype):
    """quantize_rows + the plain product == the JAX Dense's w8a8 math, bit
    for bit, with an all-zero row (scale 1e-8 / 127) where M > 2."""
    x, wq, ws = _operands(np.random.default_rng(m * k + n), m, k, n)
    if m > 2:
        x[1] = 0.0
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jlayers._w8a8_fwd_math(jnp.asarray(x, jdt), jnp.asarray(wq),
                                  jnp.asarray(ws), jdt)
    before = cuda_lib.LAUNCHES[KERNEL_NAME]
    got = w8a8_linear(_t(x).to(tdt), _t(wq.T), _t(ws), out_dtype=tdt)
    assert cuda_lib.LAUNCHES[KERNEL_NAME] == before  # a CPU tensor: plain
    assert got.dtype == tdt and got.shape == (m, n)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    assert torch.equal(got, w8a8_linear_reference(_t(x).to(tdt), _t(wq.T),
                                                  _t(ws), out_dtype=tdt))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_w8a8_linear_stacked_plain_matches_jax_batched_dense(dtype):
    """Row block l of x (L, M, K) against layer l of the stack == the JAX
    BatchedDense's int8 einsum with its row scales, bit for bit."""
    rng = np.random.default_rng(11)
    num_l, s, k, n = 3, 9, 64, 48
    x = rng.normal(size=(1, num_l, s, k)).astype(np.float32)
    q, sc = np_quantize(rng.normal(size=(num_l, k, n)).astype(np.float32))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    mod = jlayers.BatchedDense(n, num_l, use_bias=False,
                               rt=_jax_rt(act_int8=True, dtype=jdt))
    want = mod.apply({"params": {"kernel_q": q, "kernel_scale": sc}},
                     jnp.asarray(x, jdt))
    got = w8a8_linear(_t(x[0]).to(tdt), _t(np.swapaxes(q, -1, -2)), _t(sc),
                      out_dtype=tdt)
    assert got.shape == (num_l, s, n)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want[0].astype(jnp.float32)))


def _jax_rt(**kw):
    return dataclasses.replace(jlayers.FP32_RUNTIME, weights_int8=True,
                               act_int8_min_dim=MIN_DIM, **kw)


def _port_rt(**kw):
    return dataclasses.replace(tlayers.FP32_RUNTIME, weights_int8=True,
                               act_int8_min_dim=MIN_DIM, **kw)


# (in, out, act_int8): w8a8, the min-dim gate, weight-only
DENSE_CASES = [(48, 40, True), (8, 64, True), (64, 24, False)]


@pytest.mark.parametrize("k,n,act_int8", DENSE_CASES,
                         ids=["w8a8", "gated_to_upcast", "weight_only"])
def test_dense_int8_branches_match_jax(k, n, act_int8):
    import flax.linen  # noqa: F401  (the JAX Dense is a flax module)

    rng = np.random.default_rng(k * n)
    x = rng.normal(size=(3, 11, k)).astype(np.float32)
    q, s = np_quantize(rng.normal(size=(k, n)).astype(np.float32))
    bias = rng.normal(size=n).astype(np.float32)
    dense = jlayers.Dense(n, rt=_jax_rt(act_int8=act_int8))
    want = dense.apply({"params": {"kernel_q": q, "kernel_scale": s,
                                   "bias": bias}}, jnp.asarray(x))
    port = tlayers.Dense(k, n, rt=_port_rt(act_int8=act_int8))
    port.load_state_dict({"weight_q": _t(q.T), "weight_scale": _t(s),
                          "bias": _t(bias)})
    got = port(_t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act_int8", [True, False], ids=["w8a8", "weight_only"])
def test_batched_dense_int8_matches_jax(act_int8):
    rng = np.random.default_rng(3)
    b, num_l, s, k, n = 2, 3, 9, 32, 48
    x = rng.normal(size=(b, num_l, s, k)).astype(np.float32)
    q, sc = np_quantize(rng.normal(size=(num_l, k, n)).astype(np.float32))
    bias = rng.normal(size=(num_l, n)).astype(np.float32)
    mod = jlayers.BatchedDense(n, num_l, rt=_jax_rt(act_int8=act_int8))
    want = mod.apply({"params": {"kernel_q": q, "kernel_scale": sc,
                                 "bias": bias}}, jnp.asarray(x))
    port = tlayers.BatchedDense(k, n, num_l, rt=_port_rt(act_int8=act_int8))
    port.load_state_dict({"weight_q": _t(np.swapaxes(q, -1, -2)),
                          "weight_scale": _t(sc), "bias": _t(bias)})
    got = port(_t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def params():
    return jax_params()


# (JAX Predictor kwargs, the port's): "xla" is the port's "dense"
TIERS = {
    "w8a8_fused": (dict(act_int8=True, w8a8_impl="fused"),
                   dict(act_int8=True, w8a8_impl="fused")),
    "w8a8_dense": (dict(act_int8=True, w8a8_impl="xla"),
                   dict(act_int8=True, w8a8_impl="dense")),
    "int8": (dict(int8=True), dict(int8=True)),
}


@pytest.fixture(scope="module", params=list(TIERS))
def predictors(request, params):
    jkw, tkw = TIERS[request.param]
    stats = _stats()
    jtok, ttok = JaxMockTokenizer(), MockTokenizer()
    jax_pred = JaxPredictor(
        cfg=JCFG, params=params, tokenize=lambda t: jtok(t).input_ids,
        norm_stats=stats, center_crop=False,
        rt=dataclasses.replace(jlayers.FP32_RUNTIME,
                               act_int8_min_dim=MIN_DIM), **jkw)
    port_pred = Predictor(
        cfg=TCFG, params=from_jax_params(params, TCFG),
        tokenize=lambda t: ttok(t).input_ids, norm_stats=stats,
        center_crop=False, device="cpu",
        rt=dataclasses.replace(tlayers.FP32_RUNTIME,
                               act_int8_min_dim=MIN_DIM), **tkw)
    return jax_pred, port_pred


def test_predict_action_matches_jax(predictors):
    jax_pred, port_pred = predictors
    imgs = _images(3)
    proprio = np.random.default_rng(4).normal(size=8)
    want = jax_pred.predict_action(imgs, "fold the towel", proprio=proprio)
    got = port_pred.predict_action(imgs, "fold the towel", proprio=proprio)
    assert got.shape == (8, 7) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_predict_action_batch_matches_jax(predictors):
    jax_pred, port_pred = predictors
    rng = np.random.default_rng(5)
    imgs = [_images(6), _images(7, (36, 30, 3))]
    texts = ["open the drawer", "put the bowl on the plate"]
    proprio = [rng.normal(size=8), rng.normal(size=8)]
    want = jax_pred.predict_action_batch(imgs, texts, proprio)
    got = port_pred.predict_action_batch(imgs, texts, proprio)
    assert got.shape == (2, 8, 7)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_int8_predictor_keeps_no_float_weights(predictors):
    """Every Dense/BatchedDense but the patch embeddings holds int8 weights
    and nothing else: no float copy is kept."""
    _, port_pred = predictors
    state = port_pred.params
    int8_keys = [k for k, v in state.items() if v.dtype == torch.int8]
    assert int8_keys and all(k.endswith(".weight_q") for k in int8_keys)
    floats = [k for k in state if k.endswith((".weight", ".kernel"))
              and k.rsplit(".", 1)[0] + ".weight_q" in state]
    assert not floats
    assert state["vision_backbone.featurizer.patch_embed.weight"].dtype \
        == torch.float32


def test_auto_picks_fused_at_batch_1_and_shares_weights(params):
    """"auto" builds both w8a8 backends over one set of int8 tensors and
    picks per batch (models/layers.resolve_w8a8_impl)."""
    pred = Predictor(
        cfg=TCFG, params=from_jax_params(params, TCFG),
        tokenize=MockTokenizer().encode, norm_stats=_stats(), device="cpu",
        rt=dataclasses.replace(tlayers.FP32_RUNTIME,
                               act_int8_min_dim=MIN_DIM), act_int8=True)
    assert pred.w8a8_impl == "auto"
    fused, dense = pred._models["fused"], pred._models["dense"]
    limit = tlayers.W8A8_FUSED_MAX_BATCH
    assert pred._model_for_batch(limit) is fused
    assert pred._model_for_batch(limit + 1) is dense
    for (k, a), (_, b) in zip(fused.state_dict().items(),
                              dense.state_dict().items()):
        assert a.data_ptr() == b.data_ptr(), k
    assert tlayers.resolve_w8a8_impl("dense", 1) == "dense"
    plain = pred.with_runtime(dataclasses.replace(pred.rt, kernels="plain"))
    assert plain.w8a8_impl == "auto"
    assert plain.params["action_head.fc_in.weight_q"].data_ptr() == \
        pred.params["action_head.fc_in.weight_q"].data_ptr()


def test_w8a8_backend_without_w8a8_raises(params):
    with pytest.raises(ValueError, match="act_int8"):
        Predictor(cfg=TCFG, params=from_jax_params(params, TCFG),
                  tokenize=MockTokenizer().encode, norm_stats=_stats(),
                  device="cpu", int8=True, w8a8_impl="fused")
