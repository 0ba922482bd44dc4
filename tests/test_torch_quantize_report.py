"""The port's quantization reports against the JAX package's, on the CPU
(``models/quantize.py``: ``quantization_report``, ``forward_error_report``,
``dequantize_params``), over the tiny VLA's weights.

* ``quantization_report``: the port reports each weight of its state dict,
  the JAX package each Flax kernel, a scanned stack as one entry; a JAX
  entry's ``max_abs_err`` is the largest of its layers' in the port, equal
  to the bit, and its ``rel_err`` that over the stack's absmax.
* ``forward_error_report``: the same seeded inputs and weights, weight-only
  and w8a8 (``act_int8_min_dim=16``), fp32: both packages' float and
  quantized forwards agree to fp32 rounding, so the reported action
  differences agree within 1e-4. Under w8a8 one per-token int8 rounding
  may flip between the packages, and is then shown and made in the port
  (``tests/torch_int8_flip.py``) before the reports are compared.
* ``dequantize_params``: the port's quantized state, dequantized, equals
  the JAX package's dequantized tree carried over, bit for bit, and loads
  into the float model.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_modules import JCFG, TCFG, jax_params
from tests.torch_int8_flip import assert_close_up_to_one_flip, flipped
from vla_adapter_tpu.models import layers as jlayers
from vla_adapter_tpu.models import quantize as jquant
from vla_adapter_torch.models import layers as tlayers
from vla_adapter_torch.models import quantize as tquant
from vla_adapter_torch.models.vla import VLAModel
from vla_adapter_torch.weights.from_jax import from_jax_params

ATOL = 1e-4
MIN_DIM = 16
_SCANNED = ("layers/layer/", "blocks/block/")


@pytest.fixture(scope="module")
def params():
    return jax_params(seed=5)


def _port_names(path: str, layers: int):
    """The port's weight names that make up a JAX report entry."""
    for scanned in _SCANNED:
        if scanned in path:
            head, tail = path.split(scanned)
            return [f"{head}{scanned.split('/')[0]}/{i}/{tail}"
                    .replace("/", ".") for i in range(layers)]
    return [path.replace("/", ".")]


def _leaf(params, path):
    node = params
    for key in path.split("/"):
        node = node[key]
    return np.asarray(node["kernel"], np.float32)


def test_quantization_report_matches_jax(params):
    want = jquant.quantization_report(params)
    got = tquant.quantization_report(from_jax_params(params, TCFG), TCFG)
    covered = set()
    for path, entry in want["per_layer"].items():
        kernel = _leaf(params, path)
        scanned = any(s in path for s in _SCANNED)
        names = _port_names(path, kernel.shape[0])
        assert all(n in got["per_layer"] for n in names), path
        covered.update(names)
        errs = [got["per_layer"][n]["max_abs_err"] for n in names]
        assert max(errs) == entry["max_abs_err"], path
        assert max(errs) / float(np.abs(kernel).max()) == pytest.approx(
            entry["rel_err"], rel=1e-6)
        shapes = [got["per_layer"][n]["shape"] for n in names]
        assert all(list(kernel.shape[1:] if scanned else kernel.shape) == s
                   for s in shapes), (path, shapes)
    assert covered == set(got["per_layer"])
    assert got["max_rel_err"] == max(d["rel_err"]
                                     for d in got["per_layer"].values())
    assert got["worst"][0][1] == got["max_rel_err"]
    assert len(got["worst"]) == min(10, len(got["per_layer"]))


def _report_inputs(cfg, batch, seed=0):
    """forward_error_report's inputs, drawn as both packages draw them."""
    rng = np.random.default_rng(seed)
    v = cfg.vision
    ids = rng.integers(3, min(cfg.llm.vocab_size, 10_000),
                       size=(batch, cfg.max_text_tokens))
    pixels = rng.normal(size=(batch, v.num_images, v.primary.image_size,
                              v.primary.image_size, v.channels_per_image))
    proprio = rng.normal(size=(batch, cfg.constants.proprio_dim))
    return ids, pixels.astype(np.float32), proprio.astype(np.float32)


def _quantized_actions(params, batch, act_int8):
    """Both packages' quantized forwards on forward_error_report's inputs:
    (a function that runs the port's, the JAX package's normalized
    actions)."""
    import jax.numpy as jnp

    from vla_adapter_tpu.models.vla import VLAModel as JaxVLA

    ids, pixels, proprio = _report_inputs(JCFG, batch)
    q_tree = jquant.quantize_params(params)
    want = JaxVLA(JCFG, dataclasses.replace(
        jlayers.FP32_RUNTIME, act_int8_min_dim=MIN_DIM, weights_int8=True,
        act_int8=act_int8)).apply(
        {"params": q_tree}, input_ids=jnp.asarray(ids, jnp.int32),
        prompt_len=jnp.full((batch,), 8, jnp.int32),
        text_valid=jnp.ones(ids.shape, jnp.int32),
        pixel_values=jnp.asarray(pixels), proprio=jnp.asarray(proprio),
    )["actions"]
    model = VLAModel(TCFG, dataclasses.replace(
        tlayers.FP32_RUNTIME, act_int8_min_dim=MIN_DIM, weights_int8=True,
        act_int8=act_int8), device="cpu")
    model.load_state_dict(from_jax_params(q_tree, TCFG), strict=True)

    def run():
        with torch.no_grad():
            return model.eval()(
                torch.from_numpy(ids).long(), torch.full((batch,), 8).long(),
                torch.ones(ids.shape, dtype=torch.int32),
                torch.from_numpy(pixels), torch.from_numpy(proprio)
            )["actions"].numpy()
    return run, np.asarray(want)


@pytest.mark.parametrize("act_int8", [False, True],
                         ids=["weight_only", "w8a8"])
def test_forward_error_report_matches_jax(params, act_int8):
    """The two reports within 1e-4. Weight-only, the quantized forwards on
    the report's inputs agree within 1e-4 in every request. Under w8a8 a
    per-token int8 rounding can flip between the packages (they round fp32
    activations that agree to a few ulps): they must agree so in every
    request, or else after one rounding that lay within a thousandth of a
    level of a half level is taken the other way in the port; the port's
    report is then made with that same rounding taken so."""
    batch = 2
    want = jquant.forward_error_report(
        JCFG, params, rt=dataclasses.replace(jlayers.FP32_RUNTIME,
                                             act_int8_min_dim=MIN_DIM),
        batch=batch, act_int8=act_int8)
    run, jax_q = _quantized_actions(params, batch, act_int8)
    flip = assert_close_up_to_one_flip(run, jax_q, ATOL)
    assert flip is None or act_int8, flip
    with flipped(*flip) if flip else contextlib.nullcontext():
        got = tquant.forward_error_report(
            TCFG, from_jax_params(params, TCFG),
            rt=dataclasses.replace(tlayers.FP32_RUNTIME,
                                   act_int8_min_dim=MIN_DIM),
            batch=batch, act_int8=act_int8, device="cpu")
    assert set(got) == set(want)
    assert got["max_abs_action_diff"] > 0
    for key in want:
        assert abs(got[key] - want[key]) <= ATOL, (key, got, want, flip)


def test_dequantize_params_matches_jax(params):
    int8_rt = dataclasses.replace(tlayers.FP32_RUNTIME, weights_int8=True)
    expected = VLAModel(TCFG, int8_rt, device="meta").state_dict()
    quantized = tquant.quantize_state_dict(from_jax_params(params, TCFG),
                                           expected)
    got = tquant.dequantize_params(quantized)
    want = from_jax_params(
        jquant.dequantize_params(jquant.quantize_params(params)), TCFG)
    assert set(got) == set(want)
    for key, val in want.items():
        assert got[key].dtype == torch.float32, key
        assert torch.equal(got[key], val), key
    model = VLAModel(TCFG, tlayers.FP32_RUNTIME, device="cpu")
    model.load_state_dict(got, strict=True)
