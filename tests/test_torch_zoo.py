"""The port's model zoo against the JAX package's, on the CPU.

* Every one of the 52 zoo ids, and its display name, resolves to the same
  entry and the same ``VLAConfig`` in both packages, field for field
  (``dataclasses.asdict``); ``with_num_images`` gives the same vision
  config in both.
* Two published 7B zoo models, shrunk by their widths only (depth, width,
  heads, vocabulary and image size; every other field of the entry's
  config kept: no attention bias, the untied-head flag, RMSNorm eps 1e-5,
  RoPE theta 1e4, GQA 4:1 for Mistral, CLIP's pre-norm and quick-gelu):
  ``prism-dinosiglip+7b`` (Llama-2, the fused DINOv2 + SigLIP towers,
  resize-naive) and ``mistral-instruct-v0.1+7b`` (Mistral, CLIP-L @ 336,
  letterbox). Seeded non-square uint8 images go through each package's
  ``ImageProcessor`` with the entry's strategy; the port's PrismaticVLM,
  with the Flax weights carried by ``from_jax_params``, matches the JAX
  one's logits and loss in fp32 within 1e-4 (summation order through a few
  layers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vla_adapter_tpu.data import image_processing as jimg
from vla_adapter_tpu.models import registry as jreg
from vla_adapter_tpu.models import zoo as jzoo
from vla_adapter_tpu.models.layers import FP32_RUNTIME as JRT
from vla_adapter_tpu.models.vlm import PrismaticVLM as JVLM
from vla_adapter_torch.data import image_processing as timg
from vla_adapter_torch.models import registry as treg
from vla_adapter_torch.models import zoo as tzoo
from vla_adapter_torch.models.layers import FP32_RUNTIME as TRT
from vla_adapter_torch.models.vlm import PrismaticVLM
from vla_adapter_torch.weights.from_jax import from_jax_params

ATOL = RTOL = 1e-4
IDS = jzoo.available_models()


def test_zoo_holds_the_same_52_models():
    assert len(tzoo.MODEL_ZOO) == len(jzoo.MODEL_ZOO) == 52
    assert tzoo.available_models() == IDS
    assert set(tzoo.GLOBAL_ZOO) == set(jzoo.GLOBAL_ZOO)


@pytest.mark.parametrize("model_id", IDS)
def test_zoo_entry_and_config_match_jax(model_id):
    want = jzoo.get_zoo_entry(model_id)
    for key in (model_id, want.name):
        got = tzoo.get_zoo_entry(key)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert dataclasses.asdict(tzoo.build_vlm_config(got)) == \
            dataclasses.asdict(jzoo.build_vlm_config(want))
    assert dataclasses.asdict(tzoo.build_vlm_config(got, 300)) == \
        dataclasses.asdict(jzoo.build_vlm_config(want, 300))


def test_zoo_keeps_the_reference_quirks_and_refuses_unknown_ids():
    # prism-siglip+13b is registered with the CLIP tower upstream
    entry = tzoo.get_zoo_entry("prism-siglip+13b")
    assert entry.vision_backbone_id == "clip-vit-l-336px"
    assert tzoo.get_zoo_entry("Prism DINOSigLIP 13B").model_id == \
        "prism-dinosiglip+13b"
    base = tzoo.build_vlm_config(
        tzoo.get_zoo_entry("prism-qwen25-extra-dinosiglip-224px+0_5b"))
    assert base.llm.hidden_size == 896 and base.vision.embed_dim == 2176
    with pytest.raises(KeyError, match="unknown model"):
        tzoo.get_zoo_entry("llava-v2+7b")


@pytest.mark.parametrize("backbone_id", ["dinosiglip-vit-so-384px",
                                         "clip-vit-l-336px"])
def test_with_num_images_matches_jax(backbone_id):
    for n in (1, 3):
        got = treg.with_num_images(treg.get_vision_backbone(backbone_id), n)
        want = jreg.with_num_images(jreg.get_vision_backbone(backbone_id), n)
        assert got.num_images == n
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    multi = dataclasses.replace(tzoo.get_zoo_entry("prism-clip+7b"),
                                image_sequence_len=3)
    assert tzoo.build_vlm_config(multi).vision.num_images == 3


# --- tiny zoo VLMs against the JAX package ------------------------------------

def _shrink(cfg):
    """The zoo config at a test's size, by widths only."""
    llm = cfg.llm
    heads = 4
    llm = dataclasses.replace(
        llm, vocab_size=512, hidden_size=64, num_layers=2, num_heads=heads,
        num_kv_heads=heads * llm.num_kv_heads // llm.num_heads,
        intermediate_size=128, head_dim=16)

    def tower(t, hidden, num_heads):
        if t is None:
            return None
        return dataclasses.replace(t, image_size=28, patch_size=14,
                                   hidden_size=hidden, num_layers=3,
                                   num_heads=num_heads, mlp_dim=2 * hidden)

    vision = dataclasses.replace(
        cfg.vision, primary=tower(cfg.vision.primary, 32, 4),
        fused=tower(cfg.vision.fused, 48, 2))
    return dataclasses.replace(cfg, llm=llm, vision=vision)


ZOO_VLMS = {"prism-dinosiglip+7b": "resize-naive",
            "mistral-instruct-v0.1+7b": "letterbox"}


def _images(seed, batch=2):
    """Seeded uint8 images, wide and tall."""
    rng = np.random.default_rng(seed)
    shapes = [(30, 47, 3), (41, 26, 3)]
    return [rng.integers(0, 256, size=shapes[i % 2], dtype=np.uint8)
            for i in range(batch)]


def _inputs(cfg, pixels, seed):
    rng = np.random.default_rng(seed)
    b, text = pixels.shape[0], 20
    ids = rng.integers(3, cfg.llm.vocab_size, size=(b, text)).astype(np.int32)
    valid = np.zeros((b, text), np.int32)
    labels = np.full((b, text), -100, np.int32)
    for i in range(b):
        n = 8 + 6 * i
        valid[i, :n] = 1
        labels[i, 2:n] = ids[i, 2:n]
    return ids, valid, labels


@pytest.mark.parametrize("model_id", sorted(ZOO_VLMS))
def test_tiny_zoo_vlm_matches_jax(model_id):
    jentry, tentry = jzoo.get_zoo_entry(model_id), tzoo.get_zoo_entry(model_id)
    assert tentry.image_resize_strategy == ZOO_VLMS[model_id]
    jcfg = _shrink(jzoo.build_vlm_config(jentry))
    tcfg = _shrink(tzoo.build_vlm_config(tentry))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    llm = tcfg.llm
    assert not llm.attention_bias and not llm.tie_word_embeddings
    assert llm.num_heads // llm.num_kv_heads == (
        4 if model_id.startswith("mistral") else 1)
    # the entry's image strategy, in each package, on the same images
    jproc = dataclasses.replace(jimg.image_processor_for(jcfg.vision),
                                resize_strategy=jentry.image_resize_strategy)
    tproc = dataclasses.replace(timg.image_processor_for(tcfg.vision),
                                resize_strategy=tentry.image_resize_strategy)
    images = _images(1)
    px_j = np.stack([jproc(im) for im in images])[:, None]
    px_t = np.stack([tproc(im) for im in images])[:, None]
    assert np.array_equal(px_j, px_t)
    ids, valid, labels = _inputs(tcfg, px_t, seed=2)
    rng = np.random.default_rng(3)
    params = jax.jit(JVLM(jcfg, JRT).init)(
        jax.random.key(0), input_ids=jnp.asarray(ids),
        text_valid=jnp.asarray(valid), pixel_values=jnp.asarray(px_j))[
            "params"]
    params = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.normal(
        size=a.shape).astype(np.float32), params)
    want = JVLM(jcfg, JRT).apply(
        {"params": params}, input_ids=jnp.asarray(ids),
        text_valid=jnp.asarray(valid), pixel_values=jnp.asarray(px_j),
        labels=jnp.asarray(labels))
    vlm = PrismaticVLM(tcfg, TRT, device="cpu")
    vlm.load_state_dict(from_jax_params(params, tcfg), strict=True)
    with torch.no_grad():
        got = vlm.eval()(torch.from_numpy(ids), torch.from_numpy(valid),
                         torch.from_numpy(px_t),
                         labels=torch.from_numpy(labels))
    rows = valid.astype(bool)
    np.testing.assert_allclose(got["logits"].numpy()[rows],
                               np.asarray(want["logits"])[rows], atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               atol=ATOL, rtol=RTOL)
