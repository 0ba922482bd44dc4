"""The original VLA-Adapter model against the JAX package's, on the CPU:
the non-Pro ``BridgeBlock`` head (shared ``k_proj``/``v_proj`` stacks, no
RoPE) and the FiLM vision towers (each block modulated by the mean prompt
embedding), apart and together.

The tiny VLA of ``tests/torch_tiny.py`` in each variant, Flax params
perturbed away from their init (FiLM's zero-init projections included),
carried over with ``from_jax_params``: the whole model in fp32 within
atol = rtol = 1e-4; the weight-only int8 and w8a8 Predictors with
``act_int8_min_dim=16`` (the JAX package's Pallas kernels in interpret
mode) within the same 1e-4 in every request, as tests/test_torch_w8a8.py
holds them (under w8a8 up to one int8 rounding flip, shown and made in the
port: ``tests/torch_int8_flip.py``); and the original head's checkpoint,
each package's export read by the other, bit for bit.
A FiLM model has no checkpoint names in either package: the port's
exporter refuses it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_modules import JCFG, TCFG, make_inputs
from tests.test_torch_predict import _images, _stats
from tests.test_torch_weights_load import (
    _assert_states_equal,
    _assert_trees_equal,
)
from tests.torch_int8_flip import assert_close_up_to_one_flip
from vla_adapter_tpu.data.tokenization import MockTokenizer as JaxMockTokenizer
from vla_adapter_tpu.infer.predict import Predictor as JaxPredictor
from vla_adapter_tpu.models import layers as jlayers
from vla_adapter_tpu.models.vla import VLAModel as JaxVLA
from vla_adapter_tpu.weights import export as jexport
from vla_adapter_tpu.weights import load as jload
from vla_adapter_torch.data.tokenization import MockTokenizer
from vla_adapter_torch.infer.predict import Predictor
from vla_adapter_torch.models import layers as tlayers
from vla_adapter_torch.models.vla import VLAModel
from vla_adapter_torch.weights import export, load
from vla_adapter_torch.weights.from_jax import from_jax_params

ATOL = RTOL = 1e-4
MIN_DIM = 16


def variant(cfg, original: bool, film: bool):
    """``cfg`` with the original head and/or FiLM on both towers, the
    language vector of the LLM's width."""
    if original:
        cfg = dataclasses.replace(cfg, head=dataclasses.replace(
            cfg.head, use_pro_version=False))
    if film:
        d = cfg.llm.hidden_size
        v = cfg.vision
        cfg = dataclasses.replace(cfg, vision=dataclasses.replace(
            v, use_film=True,
            primary=dataclasses.replace(v.primary, film_llm_dim=d),
            fused=dataclasses.replace(v.fused, film_llm_dim=d)))
    return cfg


VARIANTS = {"original": (True, False), "film": (False, True),
            "original_film": (True, True)}


def variant_params(jcfg, seed=0, noise=0.05):
    x = make_inputs(jcfg, batch=1)
    params = jax.jit(JaxVLA(jcfg, jlayers.FP32_RUNTIME).init)(
        jax.random.key(seed), **{k: jnp.asarray(v) for k, v in x.items()}
    )["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + noise * rng.normal(size=a.shape).astype(
            np.float32), params)


@pytest.fixture(scope="module", params=list(VARIANTS))
def case(request):
    original, film = VARIANTS[request.param]
    jcfg, tcfg = variant(JCFG, original, film), variant(TCFG, original, film)
    return request.param, jcfg, tcfg, variant_params(jcfg)


def test_variant_carries_its_parameters(case):
    name, _, tcfg, params = case
    state = from_jax_params(params, tcfg)
    model = VLAModel(tcfg, tlayers.FP32_RUNTIME, device="cpu")
    assert set(state) == set(model.state_dict())
    film = [k for k in state if ".film_" in k]
    head = [k for k in state if k.startswith("action_head.k_proj")]
    assert bool(film) == ("film" in name)
    assert bool(head) == name.startswith("original")
    if film:  # one scale and one shift (weight, bias) per block and tower
        blocks = sum(c.resolved_feature_layer + 1
                     for c in (tcfg.vision.primary, tcfg.vision.fused))
        assert len(film) == 4 * blocks


def test_variant_forward_matches_jax_fp32(case):
    _, jcfg, tcfg, params = case
    x = make_inputs(jcfg)
    want = JaxVLA(jcfg, jlayers.FP32_RUNTIME).apply(
        {"params": params}, **{k: jnp.asarray(v) for k, v in x.items()},
        return_hidden_states=True)
    model = VLAModel(tcfg, tlayers.FP32_RUNTIME, device="cpu")
    model.load_state_dict(from_jax_params(params, tcfg), strict=True)
    with torch.no_grad():
        got = model.eval()(
            torch.from_numpy(x["input_ids"]).long(),
            torch.from_numpy(x["prompt_len"]).long(),
            torch.from_numpy(x["text_valid"]),
            torch.from_numpy(x["pixel_values"]),
            torch.from_numpy(x["proprio"]), return_hidden_states=True)
    np.testing.assert_allclose(got["hidden_states"].numpy(),
                               np.asarray(want["hidden_states"]),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got["actions"].numpy(),
                               np.asarray(want["actions"]),
                               atol=ATOL, rtol=RTOL)


def test_film_depends_on_the_prompt_not_the_queries(case):
    """The language vector takes valid prompt positions only: the ids under
    the query placeholders and the padding past STOP change nothing, and
    under FiLM a prompt token changes the vision tokens the LLM sees."""
    name, _, tcfg, params = case
    model = VLAModel(tcfg, tlayers.FP32_RUNTIME, device="cpu")
    model.load_state_dict(from_jax_params(params, tcfg), strict=True)
    x = {k: torch.from_numpy(v) for k, v in make_inputs(tcfg).items()}
    num_patches = tcfg.num_patches

    def vision_tokens(ids):
        with torch.no_grad():
            hs = model.eval()(ids.long(), x["prompt_len"].long(),
                              x["text_valid"], x["pixel_values"],
                              x["proprio"], return_hidden_states=True)
        return hs["hidden_states"][:, 0, 1:num_patches]  # layer 0 input

    base = vision_tokens(x["input_ids"])
    other = x["input_ids"].clone()
    q = tcfg.constants.num_action_query_tokens
    for row, p in enumerate(x["prompt_len"].tolist()):
        other[row, p:p + q] += 7     # the query placeholders
        other[row, p + q + 1:] += 5  # the padding past STOP
    assert torch.equal(vision_tokens(other), base)
    prompt = x["input_ids"].clone()
    prompt[:, 2] += 3
    assert torch.equal(vision_tokens(prompt), base) == ("film" not in name)


# --- the quantized tiers through the Predictors ------------------------------

# (JAX Predictor kwargs, the port's): "xla" is the port's "dense"
TIERS = {
    "int8": (dict(int8=True), dict(int8=True)),
    "w8a8_fused": (dict(act_int8=True, w8a8_impl="fused"),
                   dict(act_int8=True, w8a8_impl="fused")),
    "w8a8_dense": (dict(act_int8=True, w8a8_impl="xla"),
                   dict(act_int8=True, w8a8_impl="dense")),
}


def _jax_answer(got, batch, alone):
    """Each request's JAX answer, from its batch or alone, whichever the
    port's request lies nearer. The JAX package's XLA w8a8 forward is not
    the same for a request in a batch and alone: its fp32 activations
    differ by ulps with the batch, and an int8 rounding can flip (seen:
    original head + FiLM, "xla" at batch 2, one request 0.107 away from the
    same request alone, from the Pallas batch and from every port path)."""
    def err(want):
        return np.abs(got - want).reshape(len(got), -1).max(-1)
    return np.where((err(batch) <= err(alone))[:, None, None], batch, alone)


@pytest.mark.parametrize("tier", list(TIERS))
def test_variant_quantized_predictor_matches_jax(case, tier):
    """Every request within ATOL/RTOL of the JAX package's. Weight-only
    int8 rounds no activation: against the JAX batch directly. w8a8:
    against the JAX answer for each request (:func:`_jax_answer`), up to
    one activation rounding within a thousandth of a level of a half level,
    shown by taking it the other way in the port."""
    _, jcfg, tcfg, params = case
    jkw, tkw = TIERS[tier]
    stats = _stats()
    jtok, ttok = JaxMockTokenizer(), MockTokenizer()
    jrt = dataclasses.replace(jlayers.FP32_RUNTIME, act_int8_min_dim=MIN_DIM)
    jax_pred = JaxPredictor(
        cfg=jcfg, params=params, tokenize=lambda t: jtok(t).input_ids,
        norm_stats=stats, center_crop=False, rt=jrt, **jkw)
    port_pred = Predictor(
        cfg=tcfg, params=from_jax_params(params, tcfg),
        tokenize=lambda t: ttok(t).input_ids, norm_stats=stats,
        center_crop=False, device="cpu",
        rt=dataclasses.replace(tlayers.FP32_RUNTIME,
                               act_int8_min_dim=MIN_DIM), **tkw)
    rng = np.random.default_rng(5)
    imgs = [_images(6), _images(7)]
    texts = ["open the drawer", "put the bowl on the plate"]
    proprio = [rng.normal(size=8), rng.normal(size=8)]
    want = jax_pred.predict_action_batch(imgs, texts, proprio)
    got = port_pred.predict_action_batch(imgs, texts, proprio)
    assert got.shape == (2, 8, 7) and np.isfinite(got).all()
    if tier == "int8":
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
        return
    alone = np.stack([jax_pred.predict_action(*r)
                      for r in zip(imgs, texts, proprio)])
    assert_close_up_to_one_flip(
        lambda: port_pred.predict_action_batch(imgs, texts, proprio),
        _jax_answer(got, want, alone), ATOL, RTOL)


# --- checkpoints -------------------------------------------------------------

@pytest.fixture(scope="module")
def original():
    jcfg, tcfg = variant(JCFG, True, False), variant(TCFG, True, False)
    return jcfg, tcfg, variant_params(jcfg, seed=4)


def test_port_loads_jax_export_of_the_original_head(original, tmp_path):
    jcfg, tcfg, params = original
    out = jexport.export_checkpoint_dir(params, jcfg, tmp_path / "ckpt",
                                        norm_stats=_stats())
    cfg = load.vla_config_from_checkpoint(out)
    assert cfg == tcfg
    _assert_states_equal(load.load_vla_state(out, cfg),
                         from_jax_params(params, tcfg))


def test_jax_loads_port_export_of_the_original_head(original, tmp_path):
    jcfg, tcfg, params = original
    out = export.export_checkpoint_dir(from_jax_params(params, tcfg), tcfg,
                                       tmp_path / "ckpt",
                                       norm_stats=_stats())
    assert jload.vla_config_from_checkpoint(out) == jcfg
    _assert_trees_equal(jload.load_vla_params(out, jcfg),
                        jax.tree_util.tree_map(np.asarray, params))


def test_export_refuses_film(tmp_path):
    tcfg = variant(TCFG, False, True)
    state = VLAModel(tcfg, tlayers.FP32_RUNTIME, device="cpu").state_dict()
    with pytest.raises(NotImplementedError, match="FiLM"):
        export.export_checkpoint_dir(state, tcfg, tmp_path / "ckpt")
    assert not (tmp_path / "ckpt").exists()
