"""The fused w8a8 MLPs (kernels B2/B3) against the JAX package's, on the
CPU.

* The plain version (``ops/fused_mlp.py:fused_mlp_reference``, which the
  wrappers run on a CPU tensor) against the Pallas kernels in interpret
  mode, as tests/test_ops.py runs them: the golden shapes (several panels,
  ragged F and M, gated and biased) for every layer of the stack and every
  activation. The golden cases of tests/test_ops.py (gated silu, biased
  gelu) hold at its own tolerance, 1e-5. XLA's and PyTorch's exp and tanh
  land an ulp apart on some inputs, so an int8 rounding of h can flip where
  h / hs lies that close to a half: the other activations hold at 1e-5
  outside the rows with a flip, and a flipped row by one int8 step of h
  through the down projection (``_assert_close_up_to_flips``).
* One case at real width with the real ``block_f=512``: so400m
  1152 -> 4304 -> 1152 at M=64 (9 panels, the last 208 wide).
* The modules that dispatch to the kernels, in the fused backend, against
  their JAX counterparts with F spanning several 512 panels (the tiny VLA's
  F all fit in one panel, where per-panel and per-token quantization of h
  coincide): Qwen2MLP (F=1100), ViTMLP (F=600, ragged) and FusedProjector
  (4 * 160 = 640 wide). fp32; 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vla_adapter_torch.core.config as tc
import vla_adapter_tpu.core.config as jc
from vla_adapter_tpu.models import layers as jlayers
from vla_adapter_tpu.models.projector import FusedProjector as JaxFusedProjector
from vla_adapter_tpu.models.quantize import (
    quantize_kernel as np_quantize,
    quantize_params,
    split_qstack,
)
from vla_adapter_tpu.models.qwen2 import Qwen2MLP as JaxQwen2MLP
from vla_adapter_tpu.models.vit import ViTMLP as JaxViTMLP
from vla_adapter_tpu.ops import pallas_fused_mlp as jfm
from vla_adapter_torch.models import layers as tlayers
from vla_adapter_torch.models.projector import FusedProjector
from vla_adapter_torch.models.qwen2 import Qwen2MLP
from vla_adapter_torch.models.vit import ViTMLP
from vla_adapter_torch.ops.fused_mlp import (
    ACTIVATIONS,
    fused_mlp_reference,
    kernel_activation,
    w8a8_gated_mlp,
    w8a8_mlp,
)
from vla_adapter_torch.ops.w8a8_matmul import int_matmul, quantize_rows

GOLDEN_TOL = 1e-5  # tests/test_ops.py:test_fused_mlp_kernel_goldens


def _t(a):
    return torch.from_numpy(np.array(a))


def _golden_weights(seed, num_l=2, m=70, k=128, f=336, d=128):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w1 = rng.normal(size=(num_l, k, f)).astype(np.float32) * 0.05
    up = rng.normal(size=(num_l, k, f)).astype(np.float32) * 0.05
    w2 = rng.normal(size=(num_l, f, d)).astype(np.float32) * 0.05
    b1 = rng.normal(size=(f,)).astype(np.float32) * 0.1
    b2 = rng.normal(size=(d,)).astype(np.float32) * 0.1
    return x, np_quantize(w1), np_quantize(up), np_quantize(w2), b1, b2


def _port(q):
    """One layer's JAX (K, F) int8 kernel -> the port's (F, K)."""
    return _t(np.ascontiguousarray(np.swapaxes(q, -1, -2)))


# the activation tests/test_ops.py:test_fused_mlp_kernel_goldens checks each
# form with, held there at GOLDEN_TOL exactly
GOLDEN_ACT = {"gated": "silu", "plain": "gelu"}


def _assert_close_up_to_flips(got, want, h_max, q2, s2, max_rows=2):
    """got == want within GOLDEN_TOL, except in at most ``max_rows`` rows
    where one int8 rounding of h flipped: such a row moves by at most one
    step of the panel scale (|h| <= h_max, so hs <= h_max / 127) times the
    largest |q2| * s2 of a down-projection weight (JAX layout (F, D))."""
    step = h_max / 127.0 * float(np.abs(q2.astype(np.float32) * s2).max())
    err = np.abs(got - want)
    flipped = (err > GOLDEN_TOL + GOLDEN_TOL * np.abs(want)).any(axis=-1)
    assert flipped.sum() <= max_rows, (int(flipped.sum()), err.max())
    assert err.max() <= step + GOLDEN_TOL, (err.max(), step)


def _h_max(x, q1, s1, act, qu=None, su=None, b1=None):
    """Largest |h| of the fused MLP (x quantized as the kernels do)."""
    xq, rs = quantize_rows(_t(x))
    g = int_matmul(xq, _port(q1)).float() * rs * _t(s1)
    if b1 is not None:
        g = g + _t(b1)
    h = kernel_activation(act)(g)
    if qu is not None:
        h = h * (int_matmul(xq, _port(qu)).float() * rs * _t(su))
    return float(h.abs().max())


@pytest.mark.parametrize("act", ACTIVATIONS)
def test_activations_match_the_tpu_kernel(act):
    x = np.linspace(-8, 8, 4001, dtype=np.float32)
    want = np.asarray(jfm._kernel_activation(act)(jnp.asarray(x)))
    got = kernel_activation(act)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("act", ACTIVATIONS)
def test_gated_plain_matches_pallas_goldens(act):
    """Golden shapes: M=70 (ragged), F=336 over block_f=128 (3 panels, the
    last ragged), every layer."""
    x, (q1, s1), (qu, su), (q2, s2), _, _ = _golden_weights(11)
    for layer in range(q1.shape[0]):
        want = np.asarray(jfm.w8a8_gated_mlp_stacked(
            jnp.asarray(x), q1, s1, qu, su, q2, s2, jnp.int32(layer),
            act=act, block_f=128, out_dtype=jnp.float32, interpret=True))
        got = w8a8_gated_mlp(
            _t(x), _port(q1[layer]), _t(s1[layer]), _port(qu[layer]),
            _t(su[layer]), _port(q2[layer]), _t(s2[layer]), act=act,
            block_f=128)
        if act == GOLDEN_ACT["gated"]:
            np.testing.assert_allclose(got.numpy(), want, rtol=GOLDEN_TOL,
                                       atol=GOLDEN_TOL)
        else:
            _assert_close_up_to_flips(
                got.numpy(), want,
                _h_max(x, q1[layer], s1[layer], act, qu[layer], su[layer]),
                q2[layer], s2[layer])


@pytest.mark.parametrize("act", ACTIVATIONS)
@pytest.mark.parametrize("biased", [True, False], ids=["bias", "no_bias"])
def test_plain_mlp_plain_matches_pallas_goldens(act, biased):
    x, (q1, s1), _, (q2, s2), b1, b2 = _golden_weights(12)
    if not biased:
        b1 = b2 = None
    for layer in range(q1.shape[0]):
        want = np.asarray(jfm.w8a8_mlp_stacked(
            jnp.asarray(x), q1, s1, None if b1 is None else jnp.asarray(b1),
            q2, s2, None if b2 is None else jnp.asarray(b2),
            jnp.int32(layer), act=act, block_f=128, out_dtype=jnp.float32,
            interpret=True))
        got = w8a8_mlp(
            _t(x), _port(q1[layer]), _t(s1[layer]),
            None if b1 is None else _t(b1), _port(q2[layer]), _t(s2[layer]),
            None if b2 is None else _t(b2), act=act, block_f=128)
        if act == GOLDEN_ACT["plain"]:
            np.testing.assert_allclose(got.numpy(), want, rtol=GOLDEN_TOL,
                                       atol=GOLDEN_TOL)
        else:
            _assert_close_up_to_flips(
                got.numpy(), want, _h_max(x, q1[layer], s1[layer], act, b1=b1),
                q2[layer], s2[layer])


def test_so400m_width_with_block_f_512():
    """Real widths, real panel: 9 panels of 512, the last 208 wide (the
    TPU kernel pads 4304 to 4352 and masks; the port stores 4304).

    Tolerance: both sides quantize h per (token, panel) from fp32 values
    that agree to ~1 ulp (XLA and PyTorch sum the int products exactly but
    compute tanh differently), so an int8 rounding of h can flip where h /
    hs lies within ~1e-5 of a half: at most 2 of the 64 rows may differ
    beyond 1e-5, each by at most one int8 step of h through fc2."""
    rng = np.random.default_rng(7)
    m, k, f, d = 64, 1152, 4304, 1152
    x = rng.normal(size=(m, k)).astype(np.float32)
    q1, s1 = np_quantize(rng.normal(size=(1, k, f)).astype(np.float32) * 0.03)
    q2, s2 = np_quantize(rng.normal(size=(1, f, d)).astype(np.float32) * 0.03)
    b1 = rng.normal(size=(f,)).astype(np.float32) * 0.1
    b2 = rng.normal(size=(d,)).astype(np.float32) * 0.1
    want = np.asarray(jfm.w8a8_mlp_stacked(
        jnp.asarray(x), q1, s1, jnp.asarray(b1), q2, s2, jnp.asarray(b2),
        jnp.int32(0), act="gelu_tanh", out_dtype=jnp.float32, interpret=True))
    got = w8a8_mlp(_t(x), _port(q1[0]), _t(s1[0]), _t(b1), _port(q2[0]),
                   _t(s2[0]), _t(b2), act="gelu_tanh").numpy()
    _assert_close_up_to_flips(
        got, want, _h_max(x, q1[0], s1[0], "gelu_tanh", b1=b1), q2[0], s2[0])


def _jax_rt(**kw):
    return dataclasses.replace(
        jlayers.FP32_RUNTIME, weights_int8=True, act_int8=True,
        act_int8_min_dim=16, w8a8_impl="fused", **kw)


PORT_RT = dataclasses.replace(
    tlayers.FP32_RUNTIME, weights_int8=True, act_int8=True,
    act_int8_min_dim=16, w8a8_impl="fused")


def _jax_fused_apply(module, float_params, x, *call_args):
    """Apply a JAX module in the fused backend: its int8 MLP kernels in the
    "qstack" collection (split_qstack pads and stacks them as the JAX
    Predictor does), everything else in "params"."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), x,
                                                *call_args))
    params, qstack = split_qstack(quantize_params(float_params),
                                  shapes["qstack"])
    return np.asarray(module.apply({"params": params, "qstack": qstack}, x,
                                   *call_args))


def _dense(rng, k, n, bias=True, std=0.05):
    node = {"kernel": rng.normal(size=(k, n)).astype(np.float32) * std}
    if bias:
        node["bias"] = rng.normal(size=(n,)).astype(np.float32) * 0.1
    return node


def _port_state(float_params):
    """Flax Dense nodes -> the port's int8 Dense state (quantized by the
    JAX package's numpy quantizer)."""
    state = {}
    for name, node in float_params.items():
        q, s = np_quantize(node["kernel"])
        state[f"{name}.weight_q"] = _port(q)
        state[f"{name}.weight_scale"] = _t(s)
        if "bias" in node:
            state[f"{name}.bias"] = _t(node["bias"])
    return state


def test_qwen2_mlp_fused_matches_jax_across_panels():
    cfg_j = jc.Qwen2Config(vocab_size=64, hidden_size=64, num_layers=1,
                           num_heads=4, num_kv_heads=2,
                           intermediate_size=1100, head_dim=16)
    cfg_t = tc.Qwen2Config(vocab_size=64, hidden_size=64, num_layers=1,
                           num_heads=4, num_kv_heads=2,
                           intermediate_size=1100, head_dim=16)
    rng = np.random.default_rng(21)
    float_params = {"gate_proj": _dense(rng, 64, 1100, bias=False),
                    "up_proj": _dense(rng, 64, 1100, bias=False),
                    "down_proj": _dense(rng, 1100, 64, bias=False)}
    x = rng.normal(size=(2, 37, 64)).astype(np.float32)
    want = _jax_fused_apply(JaxQwen2MLP(cfg_j, _jax_rt(stacked_layers=1)),
                            float_params, jnp.asarray(x), jnp.int32(0))
    port = Qwen2MLP(cfg_t, PORT_RT)
    port.load_state_dict(_port_state(float_params))
    got = port(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=GOLDEN_TOL, atol=GOLDEN_TOL)


@pytest.mark.parametrize("act", ["gelu", "gelu_tanh"])
def test_vit_mlp_fused_matches_jax_across_panels(act):
    kw = dict(name="vit", image_size=28, patch_size=14, hidden_size=48,
              num_layers=2, num_heads=4, mlp_dim=600, mlp_activation=act)
    rng = np.random.default_rng(22)
    float_params = {"fc1": _dense(rng, 48, 600), "fc2": _dense(rng, 600, 48)}
    x = rng.normal(size=(2, 5, 48)).astype(np.float32)
    want = _jax_fused_apply(
        JaxViTMLP(jc.ViTConfig(**kw), _jax_rt(stacked_layers=1)),
        float_params, jnp.asarray(x), jnp.int32(0))
    port = ViTMLP(tc.ViTConfig(**kw), PORT_RT)
    port.load_state_dict(_port_state(float_params))
    got = port(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=GOLDEN_TOL, atol=GOLDEN_TOL)


def test_fused_projector_matches_jax_across_panels():
    rng = np.random.default_rng(23)
    float_params = {"fc1": _dense(rng, 160, 640), "fc2": _dense(rng, 640, 64),
                    "fc3": _dense(rng, 64, 64)}
    x = rng.normal(size=(2, 9, 160)).astype(np.float32)
    want = _jax_fused_apply(JaxFusedProjector(64, rt=_jax_rt()),
                            float_params, jnp.asarray(x))
    port = FusedProjector(160, 64, PORT_RT)
    port.load_state_dict(_port_state(float_params))
    got = port(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=GOLDEN_TOL, atol=GOLDEN_TOL)


def test_plain_runtime_takes_the_plain_version():
    """kernels="plain" reaches fused_mlp_reference directly (on the CPU the
    two routes give the same numbers)."""
    rng = np.random.default_rng(24)
    cfg = tc.Qwen2Config(vocab_size=64, hidden_size=64, num_layers=1,
                         num_heads=4, num_kv_heads=2, intermediate_size=96,
                         head_dim=16)
    float_params = {"gate_proj": _dense(rng, 64, 96, bias=False),
                    "up_proj": _dense(rng, 64, 96, bias=False),
                    "down_proj": _dense(rng, 96, 64, bias=False)}
    x = _t(rng.normal(size=(3, 64)).astype(np.float32))
    outs = []
    for kernels in ("kernel", "plain"):
        mlp = Qwen2MLP(cfg, dataclasses.replace(PORT_RT, kernels=kernels))
        mlp.load_state_dict(_port_state(float_params))
        outs.append(mlp(x))
    assert torch.equal(outs[0], outs[1])
    s = _port_state(float_params)
    want = fused_mlp_reference(
        x, s["gate_proj.weight_q"], s["gate_proj.weight_scale"],
        s["down_proj.weight_q"], s["down_proj.weight_scale"],
        up_q=s["up_proj.weight_q"], up_scale=s["up_proj.weight_scale"],
        act="silu")
    assert torch.equal(outs[0], want)
