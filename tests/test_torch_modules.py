"""The port's modules against the JAX package's, on the CPU.

One tiny VLA (DINO-style primary tower with registers and LayerScale, a
SigLIP-style fused tower with head dim 24, a 2-layer Qwen2, a 2-block Pro
head) is built in Flax, its params perturbed away from their init, carried
into the port with ``from_jax_params``, and every module that reaches the
attention kernel is compared with its JAX counterpart on the same numpy
inputs: fp32 at atol = rtol = 1e-4, and the whole model once in bf16.

The helpers here (config, params, inputs) are shared with
tests/test_torch_predict.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vla_adapter_torch.core.config as tc
import vla_adapter_torch.core.constants as tk
import vla_adapter_tpu.core.config as jc
import vla_adapter_tpu.core.constants as jk
from vla_adapter_tpu.models import layers as jlayers
from vla_adapter_tpu.models.action_head import (
    L1RegressionActionHead as JaxHead,
)
from vla_adapter_tpu.models.projector import (
    FusedProjector as JaxFusedProjector,
    NoisyActionProjector as JaxNoisyActionProjector,
    Projector as JaxProjector,
    ProprioProjector as JaxProprioProjector,
)
from vla_adapter_tpu.models.qwen2 import Qwen2Model as JaxQwen2
from vla_adapter_tpu.models.vit import VisionTransformer as JaxViT
from vla_adapter_tpu.models.vla import VLAModel as JaxVLA
from vla_adapter_tpu.ops import rope as jrope
from vla_adapter_torch.models import layers as tlayers
from vla_adapter_torch.models.projector import (
    NoisyActionProjector,
    Projector,
)
from vla_adapter_torch.models.vla import VLAModel
from vla_adapter_torch.ops import rope as trope
from vla_adapter_torch.weights.from_jax import from_jax_params
from tests.torch_tiny import tiny_cfg

ATOL = RTOL = 1e-4  # fp32: summation order over a handful of layers
# bf16 activations through ~10 layers: the JAX package's own bf16 forward
# is 0.042 from its fp32 forward at |actions| <= 1.8 on these inputs, so two
# bf16 forwards that round in different places may differ by about that.
BF16_ACTIONS_ATOL = 6e-2
BATCH = 2


JCFG = tiny_cfg(jc, jk)
TCFG = tiny_cfg(tc, tk)


def make_inputs(cfg, batch=BATCH, seed=1):
    """Model inputs as numpy: ids, prompt_len, text_valid, pixels, proprio."""
    rng = np.random.default_rng(seed)
    t, q = cfg.max_text_tokens, cfg.constants.num_action_query_tokens
    plen = np.asarray([5 + 4 * i for i in range(batch)], np.int32)
    valid = np.zeros((batch, t), np.int32)
    for i, p in enumerate(plen):
        valid[i, :p + q + 1] = 1
    v = cfg.vision
    return dict(
        input_ids=rng.integers(3, 400, size=(batch, t)).astype(np.int32),
        prompt_len=plen,
        text_valid=valid,
        pixel_values=rng.normal(size=(
            batch, v.num_images, v.primary.image_size, v.primary.image_size,
            v.channels_per_image)).astype(np.float32),
        proprio=rng.normal(size=(batch, cfg.constants.proprio_dim)
                           ).astype(np.float32),
    )


def jax_params(seed=0, noise=0.05):
    """Flax params of the tiny VLA, each leaf perturbed by N(0, noise) so
    that zero-init leaves (action queries, the head's gates, biases) and
    the 1e-5 LayerScale take part in the comparison."""
    x = make_inputs(JCFG, batch=1)
    params = jax.jit(JaxVLA(JCFG, jlayers.FP32_RUNTIME).init)(
        jax.random.key(seed), **{k: jnp.asarray(v) for k, v in x.items()}
    )["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + noise * rng.normal(size=a.shape).astype(
            np.float32), params)


@pytest.fixture(scope="module")
def params():
    return jax_params()


@pytest.fixture(scope="module")
def port_model(params):
    model = VLAModel(TCFG, tlayers.FP32_RUNTIME, device="cpu")
    model.load_state_dict(from_jax_params(params, TCFG), strict=True)
    return model.eval()


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


# --- RoPE -------------------------------------------------------------------

def test_rope_tables_and_rotations():
    rng = np.random.default_rng(2)
    cos_j, sin_j = jrope.rope_cos_sin(37, 16, 1e6)
    cos_t, sin_t = trope.rope_cos_sin(37, 16, 1e6)
    _close(cos_t, cos_j, atol=1e-6, rtol=1e-6)
    _close(sin_t, sin_j, atol=1e-6, rtol=1e-6)
    x = rng.normal(size=(2, 37, 4, 16)).astype(np.float32)
    _close(trope.apply_rope_half(torch.from_numpy(x), cos_t, sin_t),
           jrope.apply_rope_half(jnp.asarray(x), cos_j, sin_j), atol=1e-6)
    ci_j, si_j = jrope.interleaved_cos_sin(37, 16, 1e4)
    ci_t, si_t = trope.interleaved_cos_sin(37, 16, 1e4)
    _close(ci_t, ci_j, atol=1e-6, rtol=1e-6)
    y = rng.normal(size=(2, 4, 37, 16)).astype(np.float32)
    _close(trope.apply_rope_interleaved(torch.from_numpy(y), ci_t, si_t),
           jrope.apply_rope_interleaved(jnp.asarray(y), ci_j, si_j),
           atol=1e-6)


# --- from_jax_params ----------------------------------------------------------

def test_from_jax_params_carries_every_weight(params, port_model):
    state = from_jax_params(params, TCFG)
    ours = port_model.state_dict()
    assert set(state) == set(ours)
    for key, val in state.items():
        assert tuple(val.shape) == tuple(ours[key].shape), key
    # Dense kernels (in, out) become (out, in); scanned layer i is layers.i
    llm = params["language_model"]["layers"]["layer"]
    np.testing.assert_array_equal(
        state["language_model.layers.1.self_attn.q_proj.weight"].numpy(),
        llm["self_attn"]["q_proj"]["kernel"][1].T)
    # the head's hoisted stacks keep their (L, in, out) layout
    np.testing.assert_array_equal(
        state["action_head.k_task.kernel"].numpy(),
        params["action_head"]["k_task"]["kernel"])
    np.testing.assert_array_equal(
        state["proprio_projector.fc2.weight"].numpy(),
        params["proprio_projector"]["fc2"]["kernel"].T)


def test_from_jax_params_takes_bf16_trees(params):
    """A bf16 Flax tree (the JAX serving default) converts to fp32 tensors
    holding the bf16 values."""
    bf = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), params)
    state = from_jax_params(bf, TCFG)
    w = state["action_head.fc_in.weight"]
    assert w.dtype == torch.float32
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(bf["action_head"]["fc_in"]["kernel"],
                              np.float32).T)


def test_from_jax_params_checks_layer_counts(params):
    wrong = dataclasses.replace(
        TCFG, llm=dataclasses.replace(TCFG.llm, num_layers=3))
    with pytest.raises(ValueError, match="layers"):
        from_jax_params(params, wrong)


# --- modules that hold the attention kernel -----------------------------------

@pytest.mark.parametrize("tower", ["featurizer", "fused_featurizer"])
def test_vit_tower_matches_jax(params, port_model, tower):
    vcfg = JCFG.vision.primary if tower == "featurizer" else JCFG.vision.fused
    rng = np.random.default_rng(4)
    images = rng.normal(size=(3, 28, 28, 3)).astype(np.float32)
    want = JaxViT(vcfg, jlayers.FP32_RUNTIME).apply(
        {"params": params["vision_backbone"][tower]}, jnp.asarray(images))
    with torch.no_grad():
        got = getattr(port_model.vision_backbone, tower)(
            torch.from_numpy(images))
    assert got.shape == (3, vcfg.num_patches, vcfg.hidden_size)
    _close(got, want)


def test_fused_backbone_and_projectors_match_jax(params, port_model):
    x = make_inputs(JCFG)
    pixels = x["pixel_values"]
    with torch.no_grad():
        feats = port_model.vision_backbone(torch.from_numpy(pixels))
        proj = port_model.projector(feats)
        prop = port_model.proprio_projector(torch.from_numpy(x["proprio"]))
    assert feats.shape == (BATCH, JCFG.num_patches, 32 + 48)
    from vla_adapter_tpu.models.vla import FusedVisionBackbone

    want_feats = FusedVisionBackbone(JCFG, jlayers.FP32_RUNTIME).apply(
        {"params": params["vision_backbone"]}, jnp.asarray(pixels))
    _close(feats, want_feats)
    want_proj = JaxFusedProjector(64, rt=jlayers.FP32_RUNTIME).apply(
        {"params": params["projector"]}, want_feats)
    _close(proj, want_proj)
    want_prop = JaxProprioProjector(64, rt=jlayers.FP32_RUNTIME).apply(
        {"params": params["proprio_projector"]}, jnp.asarray(x["proprio"]))
    _close(prop, want_prop)


def test_single_tower_projector_matches_jax():
    """The projector of a single-tower config: vision -> llm -> llm."""
    rng = np.random.default_rng(8)
    patches = rng.normal(size=(2, 5, 32)).astype(np.float32)
    jp = jax.jit(JaxProjector(64, rt=jlayers.FP32_RUNTIME).init)(
        jax.random.key(1), jnp.asarray(patches))["params"]
    want = JaxProjector(64, rt=jlayers.FP32_RUNTIME).apply(
        {"params": jp}, jnp.asarray(patches))
    port = Projector(32, 64, tlayers.FP32_RUNTIME, device="cpu")
    state = {}
    for fc in ("fc1", "fc2"):
        state[f"{fc}.weight"] = torch.tensor(np.asarray(jp[fc]["kernel"]).T)
        state[f"{fc}.bias"] = torch.tensor(np.asarray(jp[fc]["bias"]))
    port.load_state_dict(state)
    with torch.no_grad():
        got = port(torch.from_numpy(patches))
    _close(got, want)


def test_noisy_action_projector_matches_jax():
    """The diffusion path's projector, (B, T, 1) noisy action scalars ->
    (B, T, llm), fp32, its weights carried by from_jax_params."""
    rng = np.random.default_rng(9)
    noisy = rng.normal(size=(2, 56, 1)).astype(np.float32)
    module = JaxNoisyActionProjector(64, rt=jlayers.FP32_RUNTIME)
    jp = jax.jit(module.init)(jax.random.key(2), jnp.asarray(noisy))["params"]
    jp = jax.tree.map(lambda a: a + 0.05 * jax.random.normal(
        jax.random.key(3), a.shape), jp)   # non-zero biases
    want = module.apply({"params": jp}, jnp.asarray(noisy))
    port = NoisyActionProjector(64, tlayers.FP32_RUNTIME, device="cpu")
    port.load_state_dict(from_jax_params(jax.device_get(jp), TCFG),
                         strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(noisy))
    assert got.shape == (2, 56, 64)
    _close(got, want)


@pytest.mark.parametrize("causal", [False, True], ids=["bidir", "causal"])
def test_qwen2_hidden_states_match_jax(params, port_model, causal):
    rng = np.random.default_rng(5)
    s = 45
    embeds = rng.normal(size=(BATCH, s, 64)).astype(np.float32)
    valid = np.ones((BATCH, s), np.int32)
    valid[1, 30:] = 0
    want = JaxQwen2(JCFG.llm, jlayers.FP32_RUNTIME).apply(
        {"params": params["language_model"]}, inputs_embeds=jnp.asarray(embeds),
        valid=jnp.asarray(valid), causal=causal, output_hidden_states=True)
    with torch.no_grad():
        got = port_model.language_model(
            torch.from_numpy(embeds), valid=torch.from_numpy(valid),
            causal=causal, output_hidden_states=True)
    assert got["hidden_states"].shape == (BATCH, 3, s, 64)
    m = valid.astype(bool)  # padded query rows are not compared
    _close(got["hidden_states"].permute(0, 2, 1, 3)[torch.from_numpy(m)],
           np.asarray(want["hidden_states"]).transpose(0, 2, 1, 3)[m])
    _close(got["last_hidden_state"][torch.from_numpy(m)],
           np.asarray(want["last_hidden_state"])[m])


@pytest.mark.parametrize("with_proprio", [True, False],
                         ids=["proprio", "no_proprio"])
def test_pro_head_matches_jax(params, port_model, with_proprio):
    rng = np.random.default_rng(6)
    t, q = JCFG.num_patches, JCFG.constants.num_action_query_tokens
    hs = rng.normal(size=(BATCH, 3, t + q, 64)).astype(np.float32)
    prop = rng.normal(size=(BATCH, 1, 64)).astype(np.float32)
    want = JaxHead(JCFG.head, action_dim=7, num_actions_chunk=8,
                   num_task_tokens=t, rt=jlayers.FP32_RUNTIME).apply(
        {"params": params["action_head"]}, jnp.asarray(hs),
        jnp.asarray(prop) if with_proprio else None)
    with torch.no_grad():
        got = port_model.action_head(
            torch.from_numpy(hs),
            torch.from_numpy(prop) if with_proprio else None)
    assert got.shape == (BATCH, 8, 7)
    _close(got, want)


# --- the slice as a whole -----------------------------------------------------

def _jax_forward(params, x, rt):
    def fwd(p, inputs):
        return JaxVLA(JCFG, rt).apply({"params": p}, **inputs,
                                      return_hidden_states=True)

    return jax.jit(fwd)(params, {k: jnp.asarray(v) for k, v in x.items()})


def _port_forward(model, x):
    with torch.inference_mode():
        return model(**{k: torch.from_numpy(v) for k, v in x.items()},
                     return_hidden_states=True)


def test_vla_model_matches_jax_fp32(params, port_model):
    x = make_inputs(JCFG)
    want = _jax_forward(params, x, jlayers.FP32_RUNTIME)
    got = _port_forward(port_model, x)
    q = JCFG.constants.num_action_query_tokens
    assert got["actions"].shape == (BATCH, 8, 7)
    assert got["hidden_states"].shape == (BATCH, 3, JCFG.num_patches + q, 64)
    _close(got["hidden_states"], want["hidden_states"])
    _close(got["actions"], want["actions"])


def test_vla_model_matches_jax_bf16(params):
    """bf16 compute, fp32 weights on both sides (the JAX side on XLA
    attention, the port on the kernel's plain version, which also rounds
    the probabilities to bf16): actions within BF16_ACTIONS_ATOL of the JAX
    bf16 forward, and no further from the fp32 forward than JAX bf16 is."""
    rt_t = tlayers.Runtime(dtype=torch.bfloat16, param_dtype=torch.float32)
    model = VLAModel(TCFG, rt_t, device="cpu")
    model.load_state_dict(from_jax_params(params, TCFG), strict=True)
    x = make_inputs(JCFG, seed=7)
    rt_j = jlayers.Runtime(dtype=jnp.bfloat16, param_dtype=jnp.float32,
                           attn_impl="xla")
    want = np.asarray(_jax_forward(params, x, rt_j)["actions"], np.float32)
    exact = np.asarray(_jax_forward(params, x, jlayers.FP32_RUNTIME)["actions"])
    got = _port_forward(model.eval(), x)["actions"]
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.abs(want).max() > 0.5  # the bound is tight relative to scale
    _close(got, want, atol=BF16_ACTIONS_ATOL, rtol=0)
    assert (np.abs(got - exact).max()
            <= 1.5 * np.abs(want - exact).max() + 1e-2)


def test_init_random_fills_every_parameter():
    """Random weights (the smoke run's stand-in for a checkpoint) reach
    every parameter, and the same generator seed gives the same model."""
    models = []
    for _ in range(2):
        model = VLAModel(TCFG, tlayers.FP32_RUNTIME, device="cpu")
        with torch.no_grad():
            for p in model.parameters():
                p.fill_(float("nan"))
        tlayers.init_random_(model, torch.Generator().manual_seed(3))
        for name, p in model.named_parameters():
            assert torch.isfinite(p).all(), name
        models.append(model.state_dict())
    for key, val in models[0].items():
        assert torch.equal(val, models[1][key]), key
