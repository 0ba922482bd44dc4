"""The "mega" w8a8 serving path (kernel B6) against the JAX package's, on
the CPU.

* The plain version (``ops/megalayer.py:megalayer_reference``, which the
  wrapper runs on a CPU tensor) against the Pallas
  ``w8a8_qwen2_layer_stacked`` in interpret mode, one layer of the JAX
  stack at a time (weights transposed to the port's ``(out, in)``):
  (a) float32 at tests/test_ops.py:test_megalayer_kernel_golden's geometry
  (L=2, M=32, D=64, 4/2 heads of 16, ragged F=80 over block_f=64, key
  padding), within 1e-5: both sides do the same float32 operations and
  differ only in summation order (2.5e-7 here; no int8 rounding flips on
  these inputs);
  (b) bfloat16 at the flagship widths (D=896, 14/2 heads of 64, F=4864:
  nine 512-wide panels and a masked 256-wide one) at M=48. XLA and PyTorch
  sum the bf16 attention in another order, so a bf16 ulp of the context or
  a float ulp of h2 can flip an int8 rounding downstream; a flip moves its
  row by a fraction of an int8 step through one more projection. Over six
  seeds at most 3 of 48 rows differed from the JAX output by more than two
  bf16 ulps of an element, and no element by more than 1.5% of its row's
  largest output. Bound: at most 4 such rows, and every element within four
  bf16 ulps (2^-5, 3.1%) of its row's largest output.
* The tiny VLA (tests/test_torch_modules.py) through the JAX Predictor's
  "mega" backend and the port's at B=1, fp32, ``act_int8_min_dim=16``:
  1e-4, as the other w8a8 tiers.
* What the backend refuses (B > 1, causal), that it shares its int8 tensors
  with "fused" and keeps the fused ViT/projector MLPs (B3), that the
  wrapper takes the plain version only for a CPU tensor, and that the
  kernel library's name covers the headers its source includes.
"""

import dataclasses
import shutil

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
from vla_adapter_tpu.ops.pallas_megalayer import w8a8_qwen2_layer_stacked
from vla_adapter_torch.data.tokenization import MockTokenizer
from vla_adapter_torch.infer.predict import Predictor
from vla_adapter_torch.models import layers as tlayers
from vla_adapter_torch.models import vit as tvit
from vla_adapter_torch.models.qwen2 import Qwen2DecoderLayer
from vla_adapter_torch.ops import cuda_lib
from vla_adapter_torch.ops.megalayer import (
    megalayer_reference,
    w8a8_qwen2_layer,
)
from vla_adapter_torch.weights.from_jax import from_jax_params

F32_TOL = 1e-5
BF16_ULP = 2.0 ** -7
MIN_DIM = 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _layer_case(seed, num_l, m, d, heads, kv_heads, dh, f, dtype):
    """Inputs of the JAX function (x, q (Hkv, G, M, Dh), k, v, bias, n2
    and the (L, in, out) int8 stacks) and the same values for the port."""
    rng = np.random.default_rng(seed)
    groups = heads // kv_heads
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    x, q, k, v = (jnp.asarray(rng.normal(size=s).astype(np.float32)).astype(jdt)
                  for s in ((m, d), (kv_heads, groups, m, dh),
                            (kv_heads, m, dh), (kv_heads, m, dh)))
    valid = (rng.random(m) < 0.8).astype(np.int32)
    n2 = (rng.normal(size=d) * 0.2 + 1.0).astype(np.float32)

    def stack(k_in, n_out):
        return np_quantize(rng.normal(size=(num_l, k_in, n_out))
                           .astype(np.float32) * 0.05)

    weights = [stack(heads * dh, d), stack(d, f), stack(d, f), stack(f, d)]
    jax_args = (x, q, k, v, jnp.asarray(np.where(valid > 0, 0.0, -2.0e9)
                                        .astype(np.float32)),
                jnp.asarray(n2), *(jnp.asarray(a) for w in weights for a in w))

    def port(a):  # a JAX array -> a torch tensor of the same values
        return _t(np.asarray(a.astype(jnp.float32))).to(dtype)

    # q (Hkv, G, M, Dh) -> (M, H, Dh) with head kvh * G + g; k, v -> (M, Hkv, Dh)
    port_qkv = (port(q).reshape(heads, m, dh).transpose(0, 1),
                port(k).transpose(0, 1), port(v).transpose(0, 1))

    def port_layer(layer):
        out = []
        for wq, ws in weights:  # (L, in, out) -> one layer's (out, in)
            out += [_t(wq[layer].T), _t(ws[layer])]
        return out

    return jax_args, (port(x), *port_qkv, _t(valid), _t(n2)), port_layer


def _jax_layer(jax_args, layer, heads, kv_heads, **kw):
    return np.asarray(w8a8_qwen2_layer_stacked(
        *jax_args, jnp.int32(layer), num_heads=heads, num_kv_heads=kv_heads,
        eps=1e-6, interpret=True, **kw).astype(jnp.float32))


def test_plain_matches_pallas_golden_f32():
    heads, kv_heads = 4, 2
    jax_args, port_args, port_layer = _layer_case(
        5, 2, 32, 64, heads, kv_heads, 16, 80, torch.float32)
    for layer in range(2):
        want = _jax_layer(jax_args, layer, heads, kv_heads, block_q=16,
                          block_f=64, out_dtype=jnp.float32)
        got = w8a8_qwen2_layer(*port_args, *port_layer(layer), eps=1e-6,
                               block_f=64)
        assert got.dtype == torch.float32 and got.shape == (32, 64)
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL,
                                   atol=F32_TOL)


def test_plain_matches_pallas_flagship_widths_bf16():
    heads, kv_heads, m = 14, 2, 48
    jax_args, port_args, port_layer = _layer_case(
        6, 1, m, 896, heads, kv_heads, 64, 4864, torch.bfloat16)
    want = _jax_layer(jax_args, 0, heads, kv_heads, out_dtype=jnp.bfloat16)
    got = w8a8_qwen2_layer(*port_args, *port_layer(0), eps=1e-6)
    assert got.dtype == torch.bfloat16 and got.shape == (m, 896)
    got = got.float().numpy()
    err = np.abs(got - want)
    row_max = np.abs(want).max(axis=-1, keepdims=True)
    assert (err <= 4 * BF16_ULP * row_max).all(), (err / row_max).max()
    beyond = (err > 2 * BF16_ULP * np.abs(want)).any(axis=-1)
    assert beyond.sum() <= 4, int(beyond.sum())


def _port_rt(**kw):
    return dataclasses.replace(tlayers.FP32_RUNTIME, act_int8_min_dim=MIN_DIM,
                               **kw)


@pytest.fixture(scope="module")
def params():
    return jax_params()


@pytest.fixture(scope="module")
def fused(params):
    """The port's fused w8a8 Predictor of the tiny VLA (CPU, fp32)."""
    return Predictor(cfg=TCFG, params=from_jax_params(params, TCFG),
                     tokenize=lambda t: MockTokenizer()(t).input_ids,
                     norm_stats=_stats(), center_crop=False, device="cpu",
                     rt=_port_rt(), act_int8=True, w8a8_impl="fused")


@pytest.fixture(scope="module")
def mega(fused):
    return fused.with_runtime(fused.rt, w8a8_impl="mega")


def test_mega_predictor_matches_jax(params):
    """Both Predictors built with act_int8=True, w8a8_impl="mega" from the
    same float weights (each quantizes them itself)."""
    jtok, ttok = JaxMockTokenizer(), MockTokenizer()
    jax_pred = JaxPredictor(
        cfg=JCFG, params=params, tokenize=lambda t: jtok(t).input_ids,
        norm_stats=_stats(), center_crop=False, act_int8=True,
        w8a8_impl="mega", rt=dataclasses.replace(jlayers.FP32_RUNTIME,
                                                 act_int8_min_dim=MIN_DIM))
    port_pred = Predictor(
        cfg=TCFG, params=from_jax_params(params, TCFG),
        tokenize=lambda t: ttok(t).input_ids, norm_stats=_stats(),
        center_crop=False, device="cpu", rt=_port_rt(), act_int8=True,
        w8a8_impl="mega")
    assert port_pred.model.rt.mega
    imgs = _images(3)
    proprio = np.random.default_rng(4).normal(size=8)
    want = jax_pred.predict_action(imgs, "fold the towel", proprio=proprio)
    got = port_pred.predict_action(imgs, "fold the towel", proprio=proprio)
    assert got.shape == (8, 7) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_mega_equals_fused_in_fp32(fused, mega):
    """In fp32 the two backends round in the same places (the residual and
    RMSNorm2 roundings of "fused" are float32 no-ops), so the port's mega
    layer, its plain version and the fused modules agree bit for bit."""
    imgs = _images(5)
    proprio = np.random.default_rng(6).normal(size=8)
    row = fused.preprocess(imgs, "stack the cups", proprio)
    want = fused.normalized_actions([row])
    np.testing.assert_array_equal(mega.normalized_actions([row]), want)
    plain = mega.with_runtime(dataclasses.replace(mega.rt, kernels="plain"))
    np.testing.assert_array_equal(plain.normalized_actions([row]), want)


def test_mega_shares_the_fused_int8_tensors(fused, mega):
    assert mega.w8a8_impl == "mega" and mega.model.rt.mega
    for key, val in fused.params.items():
        assert mega.params[key].data_ptr() == val.data_ptr(), key
    for (key, a), (_, b) in zip(fused.model.state_dict().items(),
                                mega.model.state_dict().items()):
        assert a.data_ptr() == b.data_ptr(), key


def test_mega_refuses_a_batch(mega):
    imgs = _images(7)
    with pytest.raises(ValueError, match="mega"):
        mega.predict_action_batch([imgs, imgs], ["a", "b"])
    rows = [mega.preprocess(imgs, "a"), mega.preprocess(imgs, "b")]
    with pytest.raises(ValueError, match="mega"):
        mega.predict_action_rows(rows)


def test_mega_layer_refuses_b2_and_causal():
    cfg = TCFG.llm
    layer = Qwen2DecoderLayer(cfg, _port_rt(weights_int8=True, act_int8=True,
                                            w8a8_impl="mega"))
    cos = sin = torch.zeros(5, cfg.head_dim)
    with pytest.raises(ValueError, match="batch 1"):
        layer(torch.zeros(2, 5, cfg.hidden_size), cos, sin, None, False)
    with pytest.raises(ValueError, match="bidirectional"):
        layer(torch.zeros(1, 5, cfg.hidden_size), cos, sin, None, True)


def test_mega_keeps_the_fused_vit_and_projector_mlps(mega, monkeypatch):
    """Under "mega" the ViT and projector MLPs still take kernel B3's path
    (the JAX package's stacked_serving covers both backends); "auto" never
    resolves to "mega"."""
    rt = mega.model.rt
    assert rt.fused_mlp(1024, 4096) and rt.fused_mlp(2176, 8704, 896)
    assert not dataclasses.replace(rt, w8a8_impl="dense").fused_mlp(1024, 4096)
    assert {tlayers.resolve_w8a8_impl("auto", b) for b in (1, 2, 64)} \
        == {"fused", "dense"}
    calls = []
    real = tvit.fused_mlp
    monkeypatch.setattr(tvit, "fused_mlp",
                        lambda *a, **kw: calls.append(a[3]) or real(*a, **kw))
    mega.predict_action(_images(8), "open the drawer")
    vision = TCFG.vision
    assert calls.count(vision.primary.mlp_activation) == \
        vision.primary.resolved_feature_layer + 1
    assert calls.count(vision.fused.mlp_activation) == \
        vision.fused.resolved_feature_layer + 1


def test_wrapper_takes_the_plain_version_only_on_the_cpu():
    m, d, h, dh, f = 4, 32, 2, 16, 64
    x = torch.zeros(m, d, device="meta")
    q = torch.zeros(m, h, dh, device="meta")
    i8 = dict(dtype=torch.int8, device="meta")
    args = (x, q, q[:, :1], q[:, :1], None, torch.ones(d, device="meta"),
            torch.zeros(d, h * dh, **i8), torch.ones(d, device="meta"),
            torch.zeros(f, d, **i8), torch.ones(f, device="meta"),
            torch.zeros(f, d, **i8), torch.ones(f, device="meta"),
            torch.zeros(d, f, **i8), torch.ones(d, device="meta"))
    with pytest.raises(ValueError, match="device"):
        w8a8_qwen2_layer(*args, eps=1e-6)
    cpu = [None if a is None else torch.ones_like(a, device="cpu")
           for a in args]
    assert torch.equal(w8a8_qwen2_layer(*cpu, eps=1e-6),
                       megalayer_reference(*cpu, eps=1e-6))


def test_library_name_covers_included_headers(tmp_path, monkeypatch):
    """Editing a csrc/ header renames (so rebuilds) every library whose
    source includes it, and only those."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_lib.CSRC_DIR, csrc)
    monkeypatch.setattr(cuda_lib, "CSRC_DIR", csrc)
    sources = ("megalayer_w8a8.cu", "fused_mlp_w8a8.cu", "fused_attention.cu",
               "w8a8_matmul.cu")
    before = {s: cuda_lib.library_path(s) for s in sources}
    with open(csrc / "w8a8_mlp.cuh", "a") as header:
        header.write("// an edit\n")
    after = {s: cuda_lib.library_path(s) for s in sources}
    changed = {s for s in sources if before[s] != after[s]}
    # w8a8_matmul.cu takes the quantization helpers from the same header
    assert changed == {"megalayer_w8a8.cu", "fused_mlp_w8a8.cu",
                       "w8a8_matmul.cu"}
