"""Checkpoint loading of the port against the JAX package's, on the CPU.

Each package's exporter writes the tiny VLA of ``tests/torch_tiny.py``
into ``tmp_path`` and the other package's loader reads it back, bit for
bit; the port's ``load_vla`` serves what the JAX Predictor serves (fp32,
atol = rtol = 1e-4, as tests/test_torch_predict.py). The port's own
safetensors reader and writer are held against the ``safetensors``
package, its configs and registry against the JAX package's.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import safetensors.torch as safetensors_torch
import torch

import vla_adapter_torch.core.config as tc
import vla_adapter_tpu.core.config as jc
import vla_adapter_tpu.models.registry as jreg
from tests.test_torch_modules import JCFG, TCFG, jax_params
from tests.test_torch_predict import _images, _stats
from vla_adapter_tpu.data.tokenization import MockTokenizer as JaxMockTokenizer
from vla_adapter_tpu.infer.predict import Predictor as JaxPredictor
from vla_adapter_tpu.models.layers import FP32_RUNTIME as JAX_FP32
from vla_adapter_tpu.weights import export as jexport
from vla_adapter_tpu.weights import load as jload
from vla_adapter_torch.data.tokenization import MockTokenizer
from vla_adapter_torch.models import registry as treg
from vla_adapter_torch.models.layers import FP32_RUNTIME
from vla_adapter_torch.weights import convert, export, load, safetensors_io
from vla_adapter_torch.weights.from_jax import from_jax_params

ATOL = RTOL = 1e-4


@pytest.fixture(scope="module")
def params():
    return jax_params(seed=3)


def _without_proprio(params):
    return {k: v for k, v in params.items() if k != "proprio_projector"}


def _assert_states_equal(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for key, val in want.items():
        assert got[key].dtype == val.dtype, key
        assert torch.equal(got[key], val), key


def _assert_trees_equal(got, want, path=""):
    assert set(got) == set(want), (path, set(got) ^ set(want))
    for key, val in want.items():
        if isinstance(val, dict):
            _assert_trees_equal(got[key], val, f"{path}/{key}")
        else:
            np.testing.assert_array_equal(np.asarray(got[key]),
                                          np.asarray(val),
                                          err_msg=f"{path}/{key}")


# --- the JAX package's export, the port's loader ----------------------------

@pytest.mark.parametrize("proprio", [True, False],
                         ids=["proprio", "no_proprio"])
def test_port_loads_jax_export(params, tmp_path, proprio):
    tree = params if proprio else _without_proprio(params)
    out = jexport.export_checkpoint_dir(tree, JCFG, tmp_path / "ckpt",
                                        norm_stats=_stats())
    cfg = load.vla_config_from_checkpoint(out)
    assert cfg == TCFG
    _assert_states_equal(load.load_vla_state(out, cfg),
                         from_jax_params(tree, TCFG))
    assert load.load_norm_stats(out) == json.loads(json.dumps(_stats()))


# --- the port's export, the JAX package's loader ----------------------------

@pytest.mark.parametrize("proprio", [True, False],
                         ids=["proprio", "no_proprio"])
def test_jax_loads_port_export(params, tmp_path, proprio):
    tree = params if proprio else _without_proprio(params)
    out = export.export_checkpoint_dir(from_jax_params(tree, TCFG), TCFG,
                                       tmp_path / "ckpt",
                                       norm_stats=_stats())
    assert jload.vla_config_from_checkpoint(out) == JCFG
    got = jload.load_vla_params(out, JCFG)
    _assert_trees_equal(got, jax.tree_util.tree_map(np.asarray, tree))
    assert ((out / "proprio_projector--0_checkpoint.pt").exists()
            == proprio)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_port_export_round_trips(params, tmp_path, dtype):
    """The port's export read back by the port: the same state, in the
    same dtype, bit for bit."""
    state = {k: v.to(dtype) for k, v in from_jax_params(params, TCFG).items()}
    out = export.export_checkpoint_dir(state, TCFG, tmp_path / "ckpt")
    _assert_states_equal(load.load_vla_state(out, TCFG), state)


def test_load_vla_serves_what_jax_serves(params, tmp_path):
    """A CPU Predictor from the port's load_vla against the JAX Predictor
    over the same tree: fp32 actions within 1e-4."""
    out = jexport.export_checkpoint_dir(params, JCFG, tmp_path / "ckpt",
                                        norm_stats=_stats())
    ttok, jtok = MockTokenizer(), JaxMockTokenizer()
    pred = load.load_vla(out, tokenize=lambda t: ttok(t).input_ids,
                         device="cpu", rt=FP32_RUNTIME)
    assert pred.cfg == TCFG and not pred.cuda_graph
    jax_pred = JaxPredictor(
        cfg=JCFG, params=jload.load_vla_params(out, JCFG),
        tokenize=lambda t: jtok(t).input_ids,
        norm_stats=jload.load_norm_stats(out), rt=JAX_FP32)
    imgs, proprio = _images(11), np.random.default_rng(12).normal(size=8)
    got = pred.predict_action(imgs, "close the drawer", proprio=proprio)
    want = jax_pred.predict_action(imgs, "close the drawer", proprio=proprio)
    assert got.shape == (8, 7) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_load_vla_needs_a_tokenizer_or_transformers(params, tmp_path):
    """Without tokenize= load_vla reads the checkpoint's tokenizer files
    through transformers: here there are none, so it raises."""
    out = jexport.export_checkpoint_dir(params, JCFG, tmp_path / "ckpt",
                                        norm_stats=_stats())
    with pytest.raises((ImportError, OSError, ValueError)):
        load.load_vla(out, device="cpu")


def test_qwen_tokenizer_needs_transformers(monkeypatch, tmp_path):
    import sys

    from vla_adapter_torch.data.tokenization import load_qwen_tokenizer

    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="tokenize="):
        load_qwen_tokenizer(str(tmp_path))


# --- the converters' shapes --------------------------------------------------

def test_timm_patch_conv_and_qkv(params):
    """timm's (out, in, kh, kw) conv and fused qkv, as the JAX exporter
    writes them, land where from_jax_params puts the Flax kernels."""
    hf = jexport.vla_params_to_hf(params, JCFG)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in hf.items()}
    state = convert.vla_state_from_hf(sd, TCFG)
    want = from_jax_params(params, TCFG)
    conv = "vision_backbone.fused_featurizer.patch_embed.weight"
    assert sd[conv.replace("patch_embed", "patch_embed.proj")].shape == (
        48, 3, 14, 14)
    assert torch.equal(state[conv], want[conv])
    for q in ("q_proj", "k_proj", "v_proj"):
        key = f"vision_backbone.featurizer.blocks.1.attn.{q}.weight"
        assert torch.equal(state[key], want[key])


def test_non_pro_head_raises(params):
    """The original (non-Pro) head reads its own names: a Pro head's
    checkpoint has no shared k_proj/v_proj, so converting it as an original
    head raises, naming the missing projection (the original head itself
    is converted in tests/test_torch_head_variants.py)."""
    head = export._sub(from_jax_params(params, TCFG), "action_head.")
    pro = export.head_state_to_torch(head, 2, use_pro_version=True)
    with pytest.raises(KeyError, match="k_proj"):
        convert.action_head_state_from_torch(pro, 2, use_pro_version=False)


def test_native_prismatic_names_map_to_hf():
    sd = {"vision_backbone.dino_featurizer.blocks.0.ls1.gamma": 1,
          "llm_backbone.llm.model.norm.weight": 2,
          "projector.projector.4.bias": 3}
    assert convert.native_prismatic_to_hf(sd) == {
        "vision_backbone.featurizer.blocks.0.ls1.scale_factor": 1,
        "language_model.model.norm.weight": 2, "projector.fc3.bias": 3}
    assert convert.strip_prefix({"module.a": 1, "b": 2}, "module.") == {
        "a": 1, "b": 2}


# --- safetensors without the package ---------------------------------------

DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int8,
          torch.int32, torch.int64, torch.uint8, torch.bool]


def _tensors(dtype):
    gen = torch.Generator().manual_seed(0)
    if dtype.is_floating_point:
        make = lambda *s: torch.randn(s, generator=gen).to(dtype)  # noqa: E731
    elif dtype == torch.bool:
        make = lambda *s: torch.rand(s, generator=gen) < 0.5  # noqa: E731
    else:
        lo, hi = (0, 255) if dtype == torch.uint8 else (-100, 100)
        make = lambda *s: torch.randint(lo, hi, s, generator=gen,  # noqa: E731
                                        dtype=dtype)
    return {"matrix": make(5, 7), "vector": make(3), "scalar": make(),
            "empty": make(0, 4), "cube": make(2, 3, 4).transpose(0, 2)}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_safetensors_reader_reads_the_package(tmp_path, dtype):
    tensors = _tensors(dtype)
    safetensors_torch.save_file({k: v.contiguous() for k, v in
                                 tensors.items()}, tmp_path / "a.safetensors")
    got = safetensors_io.load_file(tmp_path / "a.safetensors")
    _assert_states_equal(got, tensors)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_safetensors_writer_is_read_by_the_package(tmp_path, dtype):
    tensors = _tensors(dtype)
    safetensors_io.save_file(tensors, tmp_path / "a.safetensors",
                             metadata={"format": "pt"})
    got = safetensors_torch.load_file(tmp_path / "a.safetensors")
    _assert_states_equal(got, tensors)


def test_safetensors_reader_refuses_a_truncated_file(tmp_path):
    path = safetensors_io.save_file({"w": torch.ones(64)},
                                    tmp_path / "a.safetensors")
    data = path.read_bytes()
    path.write_bytes(data[:-8])
    with pytest.raises(ValueError, match="spans"):
        safetensors_io.load_file(path)


# --- configs and the registry -------------------------------------------------

CONFIGS = {
    "tiny": (JCFG, TCFG),
    "flagship": (jc.VLAConfig(), tc.VLAConfig()),
    "single_tower_calvin": (
        jc.VLAConfig(platform="calvin",
                     vision=jreg.VISION_BACKBONES["siglip-vit-so400m"]),
        tc.VLAConfig(platform="calvin",
                     vision=treg.VISION_BACKBONES["siglip-vit-so400m"])),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_dicts_round_trip_and_match_jax(name):
    jcfg, tcfg = CONFIGS[name]
    d = tc.vla_config_to_dict(tcfg)
    assert d == jc.vla_config_to_dict(jcfg)
    assert json.loads(json.dumps(d)) == d
    assert tc.vla_config_from_dict(d) == tcfg
    assert tc.vla_config_from_dict(jc.vla_config_to_dict(jcfg)) == tcfg
    assert jc.vla_config_from_dict(d) == jcfg


def test_phi_config_dict_raises():
    d = jc.vla_config_to_dict(jc.VLAConfig(llm=jc.PhiConfig()))
    with pytest.raises(NotImplementedError, match="Phi"):
        tc.vla_config_from_dict(d)


@pytest.mark.parametrize("backbone_id", sorted(jreg.VISION_BACKBONES))
def test_vision_registry_matches_jax(backbone_id):
    assert dataclasses.asdict(treg.get_vision_backbone(backbone_id)) == \
        dataclasses.asdict(jreg.get_vision_backbone(backbone_id))


@pytest.mark.parametrize("backbone_id", sorted(
    k for k, v in jreg.LLM_BACKBONES.items()
    if isinstance(v, jc.Qwen2Config)))
def test_llm_registry_matches_jax(backbone_id):
    assert dataclasses.asdict(treg.get_llm_backbone(backbone_id)) == \
        dataclasses.asdict(jreg.get_llm_backbone(backbone_id))


def test_registry_refuses_phi_and_unknown_ids():
    assert set(treg.LLM_BACKBONES) | set(treg.NOT_PORTED_LLMS) == set(
        jreg.LLM_BACKBONES)
    with pytest.raises(NotImplementedError, match="Phi"):
        treg.get_llm_backbone("phi-2-3b")
    with pytest.raises(KeyError):
        treg.get_llm_backbone("gpt-2")
    with pytest.raises(KeyError):
        treg.get_vision_backbone("resnet-50")


@pytest.mark.parametrize("backbone_id", ["dinosiglip-vit-so-224px",
                                         "siglip-vit-so400m"])
def test_config_from_reference_style_json(tmp_path, backbone_id):
    """A config.json as the reference writes it (no vla_adapter_tpu
    block): the text_config and the vision backbone id decide."""
    doc = {"model_type": "openvla", "n_action_bins": 256,
           "vision_backbone_id": backbone_id,
           "text_config": {"model_type": "qwen2", "vocab_size": 151936,
                           "hidden_size": 896, "num_hidden_layers": 24,
                           "num_attention_heads": 14,
                           "num_key_value_heads": 2,
                           "intermediate_size": 4864, "rms_norm_eps": 1e-6,
                           "rope_theta": 1000000.0,
                           "tie_word_embeddings": True}}
    (tmp_path / "config.json").write_text(json.dumps(doc))
    got = load.vla_config_from_checkpoint(tmp_path)
    want = jload.vla_config_from_checkpoint(tmp_path)
    assert tc.vla_config_to_dict(got) == jc.vla_config_to_dict(want)
    if backbone_id == "dinosiglip-vit-so-224px":
        assert got == tc.VLAConfig()


def test_resolve_checkpoint_is_local_only(tmp_path):
    assert load.resolve_checkpoint(tmp_path) == tmp_path
    (tmp_path / "file").write_text("x")
    for path in (tmp_path / "file", tmp_path / "missing",
                 "openvla/openvla-7b"):
        with pytest.raises(FileNotFoundError):
            load.resolve_checkpoint(path)
