"""The port's PrismaticVLM and Phi-2 against the JAX package's, on the CPU.

The tiny VLA config of ``tests/torch_tiny.py`` as a PrismaticVLM (logits
and CE loss, multimodal and unimodal), ``multimodal_ce_loss``, a tiny
PhiModel (logits, hidden states), a Phi-backed PrismaticVLM and VLAModel,
the HF Phi converter against the JAX package's, and the Phi config's
text_config and dict round trip. Weights from the Flax init, perturbed,
carried with ``from_jax_params``. fp32, atol = rtol = 1e-4 (summation
order through a few layers).

Shared with tests/test_torch_generate.py and
tests/test_torch_token_objective.py: :data:`JCFG`, :data:`TCFG`,
:func:`jax_vlm_params`, :func:`vlm_inputs`.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vla_adapter_torch.core.config as tc
import vla_adapter_torch.core.constants as tk
import vla_adapter_tpu.core.config as jc
import vla_adapter_tpu.core.constants as jk
from tests.torch_tiny import tiny_cfg
from vla_adapter_tpu.models.layers import FP32_RUNTIME as JRT
from vla_adapter_tpu.models.phi import PhiModel as JPhi
from vla_adapter_tpu.models.vla import VLAModel as JVLA
from vla_adapter_tpu.models.vlm import PrismaticVLM as JVLM
from vla_adapter_tpu.models.vlm import multimodal_ce_loss as jce
from vla_adapter_tpu.weights import convert as jconvert
from vla_adapter_tpu.weights import export as jexport
from vla_adapter_torch.models.layers import FP32_RUNTIME as TRT
from vla_adapter_torch.models.phi import PhiModel
from vla_adapter_torch.models.vla import VLAModel
from vla_adapter_torch.models.vlm import PrismaticVLM, multimodal_ce_loss
from vla_adapter_torch.weights import convert as tconvert
from vla_adapter_torch.weights import export as texport
from vla_adapter_torch.weights import load as tload
from vla_adapter_torch.weights.from_jax import from_jax_params

ATOL = RTOL = 1e-4
JCFG, TCFG = tiny_cfg(jc, jk), tiny_cfg(tc, tk)
PHI = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
           intermediate_size=128, head_dim=16, partial_rotary_factor=0.5)
JPHI, TPHI = jc.PhiConfig(**PHI), tc.PhiConfig(**PHI)
JPHI_CFG = dataclasses.replace(JCFG, llm=JPHI)
TPHI_CFG = dataclasses.replace(TCFG, llm=TPHI)


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.normal(
        size=a.shape).astype(np.float32), tree)


def vlm_inputs(cfg, batch=2, seed=1, text=24):
    """ids, text_valid (prompt of 6 + 5 i tokens), pixels, labels (the
    tokens after the first two, IGNORE elsewhere)."""
    rng = np.random.default_rng(seed)
    v = cfg.vision
    ids = rng.integers(3, cfg.llm.vocab_size, size=(batch, text)).astype(
        np.int32)
    valid = np.zeros((batch, text), np.int32)
    labels = np.full((batch, text), -100, np.int32)
    for i in range(batch):
        n = 6 + 5 * i
        valid[i, :n] = 1
        labels[i, 2:n] = ids[i, 2:n]
    return dict(
        input_ids=ids, text_valid=valid, labels=labels,
        pixel_values=rng.normal(size=(
            batch, v.num_images, v.primary.image_size, v.primary.image_size,
            v.channels_per_image)).astype(np.float32))


def jax_vlm_params(cfg, seed=0):
    x = vlm_inputs(cfg, batch=1)
    params = jax.jit(JVLM(cfg, JRT).init)(
        jax.random.key(seed), input_ids=jnp.asarray(x["input_ids"]),
        text_valid=jnp.asarray(x["text_valid"]),
        pixel_values=jnp.asarray(x["pixel_values"]))["params"]
    return _perturb(params, seed)


def _port_vlm(params, cfg=TCFG):
    vlm = PrismaticVLM(cfg, TRT, device="cpu")
    vlm.load_state_dict(from_jax_params(params, cfg), strict=True)
    return vlm.eval()


@pytest.fixture(scope="module")
def vlm_params():
    return jax_vlm_params(JCFG, seed=2)


@pytest.mark.parametrize("pixels", [True, False],
                         ids=["multimodal", "unimodal"])
def test_prismatic_vlm_matches_jax(vlm_params, pixels):
    x = vlm_inputs(JCFG, seed=3)
    px = x["pixel_values"] if pixels else None
    want = JVLM(JCFG, JRT).apply(
        {"params": vlm_params}, input_ids=jnp.asarray(x["input_ids"]),
        text_valid=jnp.asarray(x["text_valid"]),
        pixel_values=None if px is None else jnp.asarray(px),
        labels=jnp.asarray(x["labels"]))
    with torch.no_grad():
        got = _port_vlm(vlm_params)(
            torch.from_numpy(x["input_ids"]),
            torch.from_numpy(x["text_valid"]),
            None if px is None else torch.from_numpy(px),
            labels=torch.from_numpy(x["labels"]))
    assert tuple(got["logits"].shape) == (2, 24, JCFG.llm.vocab_size)
    rows = x["text_valid"].astype(bool)
    _close(got["logits"].numpy()[rows], np.asarray(want["logits"])[rows])
    _close(got["loss"], want["loss"])


def test_multimodal_ce_loss_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(3, 11, 50)).astype(np.float32)
    labels = rng.integers(0, 50, size=(3, 11)).astype(np.int32)
    labels[:, :3] = -100
    valid = np.ones((3, 11), np.int32)
    valid[2, 5:] = 0
    _close(multimodal_ce_loss(torch.from_numpy(logits),
                              torch.from_numpy(labels),
                              torch.from_numpy(valid)),
           jce(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(valid)),
           atol=1e-6, rtol=1e-6)
    labels[:] = -100  # nothing supervised: 0, not a division by zero
    assert float(multimodal_ce_loss(torch.from_numpy(logits),
                                    torch.from_numpy(labels),
                                    torch.from_numpy(valid))) == 0.0


# --- Phi-2 ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def phi_params():
    ids = jnp.ones((1, 9), jnp.int32)
    params = JPhi(JPHI, JRT).init(jax.random.key(3), input_ids=ids,
                                  valid=jnp.ones_like(ids), causal=True,
                                  compute_logits=True)["params"]
    return _perturb(params, 3)


@pytest.mark.parametrize("causal", [True, False])
def test_phi_model_matches_jax(phi_params, causal):
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 512, size=(2, 13)).astype(np.int32)
    valid = np.ones_like(ids)
    valid[1, 9:] = 0
    want = JPhi(JPHI, JRT).apply(
        {"params": phi_params}, input_ids=jnp.asarray(ids),
        valid=jnp.asarray(valid), causal=causal, compute_logits=True,
        output_hidden_states=True)
    model = PhiModel(TPHI, TRT, device="cpu")
    model.load_state_dict(from_jax_params(phi_params, TPHI), strict=True)
    with torch.no_grad():
        got = model(input_ids=torch.from_numpy(ids),
                    valid=torch.from_numpy(valid), causal=causal,
                    compute_logits=True, output_hidden_states=True)
    rows = valid.astype(bool)
    _close(got["logits"].numpy()[rows], np.asarray(want["logits"])[rows])
    _close(got["hidden_states"].numpy().transpose(0, 2, 1, 3)[rows],
           np.asarray(want["hidden_states"]).transpose(0, 2, 1, 3)[rows])
    assert TPHI.rotary_dim == 8 and TPHI.num_kv_heads == 4


def test_phi_backed_vlm_matches_jax():
    params = jax_vlm_params(JPHI_CFG, seed=6)
    x = vlm_inputs(JPHI_CFG, seed=7)
    want = JVLM(JPHI_CFG, JRT).apply(
        {"params": params}, input_ids=jnp.asarray(x["input_ids"]),
        text_valid=jnp.asarray(x["text_valid"]),
        pixel_values=jnp.asarray(x["pixel_values"]),
        labels=jnp.asarray(x["labels"]))
    with torch.no_grad():
        got = _port_vlm(params, TPHI_CFG)(
            torch.from_numpy(x["input_ids"]),
            torch.from_numpy(x["text_valid"]),
            torch.from_numpy(x["pixel_values"]),
            labels=torch.from_numpy(x["labels"]))
    rows = x["text_valid"].astype(bool)
    _close(got["logits"].numpy()[rows], np.asarray(want["logits"])[rows])
    _close(got["loss"], want["loss"])


def test_phi_backed_vla_matches_jax():
    """Actions and the slow-path logits (Phi's head is untied) of a
    Phi-backed VLAModel."""
    from tests.test_torch_modules import make_inputs

    x = make_inputs(JPHI_CFG)
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    params = _perturb(jax.jit(lambda k: JVLA(JPHI_CFG, JRT).init(
        k, compute_logits=True, **jx))(jax.random.key(8))["params"], 8)
    want = JVLA(JPHI_CFG, JRT).apply({"params": params}, compute_logits=True,
                                     **jx)
    model = VLAModel(TPHI_CFG, TRT, device="cpu")
    model.load_state_dict(from_jax_params(params, TPHI_CFG), strict=True)
    with torch.no_grad():
        got = model.eval()(**{k: torch.from_numpy(v) for k, v in x.items()},
                           compute_logits=True)
    _close(got["actions"], want["actions"])
    rows = x["text_valid"].astype(bool)
    _close(got["logits"].numpy()[rows], np.asarray(want["logits"])[rows])


def test_phi_state_from_hf_matches_jax():
    """One HF-layout numpy state dict through both converters."""
    rng = np.random.default_rng(9)
    d, f, L = PHI["hidden_size"], PHI["intermediate_size"], PHI["num_layers"]
    sd = {"model.embed_tokens.weight": (512, d),
          "model.final_layernorm.weight": (d,),
          "model.final_layernorm.bias": (d,),
          "lm_head.weight": (512, d), "lm_head.bias": (512,)}
    for i in range(L):
        p = f"model.layers.{i}."
        for n in ("q_proj", "k_proj", "v_proj", "dense"):
            sd[f"{p}self_attn.{n}.weight"] = (d, d)
            sd[f"{p}self_attn.{n}.bias"] = (d,)
        sd[f"{p}mlp.fc1.weight"], sd[f"{p}mlp.fc1.bias"] = (f, d), (f,)
        sd[f"{p}mlp.fc2.weight"], sd[f"{p}mlp.fc2.bias"] = (d, f), (d,)
        sd[f"{p}input_layernorm.weight"] = (d,)
        sd[f"{p}input_layernorm.bias"] = (d,)
    sd = {k: rng.normal(size=s).astype(np.float32) for k, s in sd.items()}
    want = from_jax_params(jconvert.phi_params_from_hf(sd, JPHI), TPHI)
    got = tconvert.phi_state_from_hf(
        {k: torch.from_numpy(v) for k, v in sd.items()}, TPHI)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert set(got) == set(PhiModel(TPHI, TRT, device="meta").state_dict())


def test_phi_text_config_and_dict_round_trip(tmp_path):
    d = tc.vla_config_to_dict(TPHI_CFG)
    assert d == jc.vla_config_to_dict(JPHI_CFG)
    assert tc.vla_config_from_dict(d) == TPHI_CFG
    assert jc.vla_config_from_dict(d) == JPHI_CFG
    for pkg, cfg, sub in ((jexport, JPHI_CFG, "jax"),
                          (texport, TPHI_CFG, "port")):
        (tmp_path / sub).mkdir()
        pkg.write_config_json(cfg, tmp_path / sub)
    docs = [json.loads((tmp_path / s / "config.json").read_text())
            for s in ("jax", "port")]
    assert docs[0] == docs[1]
    assert docs[1]["text_config"]["model_type"] == "phi"
    assert tload.vla_config_from_checkpoint(tmp_path / "port") == TPHI_CFG
    # a reference-style config.json (no lossless block): the Phi
    # text_config and the registry's vision backbone decide
    doc = {"model_type": "openvla", "n_action_bins": 256,
           "vision_backbone_id": "dinosiglip-vit-so-224px",
           "text_config": texport_text_config(tc.PhiConfig())}
    (tmp_path / "ref").mkdir()
    (tmp_path / "ref" / "config.json").write_text(json.dumps(doc))
    assert tload.vla_config_from_checkpoint(tmp_path / "ref") == \
        tc.VLAConfig(llm=tc.PhiConfig())


def texport_text_config(llm):
    """The text_config the port's exporter writes for ``llm``."""
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as d:
        texport.write_config_json(tc.VLAConfig(llm=llm), d)
        return json.loads((Path(d) / "config.json").read_text())[
            "text_config"]
