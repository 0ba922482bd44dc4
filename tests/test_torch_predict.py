"""The port's Predictor against the JAX package's, end to end on the CPU.

Same tiny VLA and weights (tests/test_torch_modules.py), same uint8 images,
MockTokenizer and dataset statistics: preprocessing must agree exactly and
the unnormalized actions to fp32 rounding (atol = rtol = 1e-4).
"""

import numpy as np
import pytest
import torch

from tests.test_torch_modules import JCFG, TCFG, jax_params
from vla_adapter_tpu.data import normalization as jnorm
from vla_adapter_tpu.data.tokenization import MockTokenizer as JaxMockTokenizer
from vla_adapter_tpu.infer.predict import Predictor as JaxPredictor
from vla_adapter_tpu.models.layers import FP32_RUNTIME as JAX_FP32
from vla_adapter_torch.core.constants import NormalizationType
from vla_adapter_torch.data import normalization as tnorm
from vla_adapter_torch.data.tokenization import MockTokenizer
from vla_adapter_torch.infer.predict import Predictor
from vla_adapter_torch.models.layers import FP32_RUNTIME
from vla_adapter_torch.weights.from_jax import from_jax_params

ATOL = RTOL = 1e-4


def _stats(seed=0):
    rng = np.random.default_rng(seed)
    return {"libero_spatial": jnorm.dataset_statistics(
        rng.uniform(-2, 3, size=(500, 7)),
        proprio=rng.normal(size=(500, 8)),
        action_mask=[True] * 6 + [False])}


@pytest.fixture(scope="module")
def params():
    return jax_params()


@pytest.fixture(scope="module", params=[False, True],
                ids=["no_crop", "center_crop"])
def predictors(request, params):
    stats = _stats()
    jtok, ttok = JaxMockTokenizer(), MockTokenizer()
    jax_pred = JaxPredictor(
        cfg=JCFG, params=params, tokenize=lambda t: jtok(t).input_ids,
        norm_stats=stats, rt=JAX_FP32, center_crop=request.param)
    port_pred = Predictor(
        cfg=TCFG, params=from_jax_params(params, TCFG),
        tokenize=lambda t: ttok(t).input_ids, norm_stats=stats,
        rt=FP32_RUNTIME, center_crop=request.param, device="cpu")
    return jax_pred, port_pred


def _images(seed, shape=(28, 28, 3), n=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, size=shape, dtype=np.uint8)
            for _ in range(n)]


@pytest.mark.parametrize("shape", [(28, 28, 3), (40, 52, 3)],
                         ids=["policy_size", "resized"])
def test_preprocess_matches_jax(predictors, shape):
    jax_pred, port_pred = predictors
    imgs = _images(1, shape)
    proprio = np.random.default_rng(2).normal(size=8)
    want = jax_pred.preprocess(imgs, "Pick up the cup", proprio)
    got = port_pred.preprocess(imgs, "Pick up the cup", proprio)
    assert set(got) == set(want)
    for key in ("ids", "plen", "valid", "pixels"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["pixels"].dtype == np.uint8
    np.testing.assert_allclose(got["proprio"], want["proprio"], atol=1e-7)


def test_predict_action_matches_jax(predictors):
    jax_pred, port_pred = predictors
    imgs = _images(3)
    proprio = np.random.default_rng(4).normal(size=8)
    want = jax_pred.predict_action(imgs, "fold the towel", proprio=proprio)
    got = port_pred.predict_action(imgs, "fold the towel", proprio=proprio)
    assert got.shape == (8, 7) and got.dtype == np.float32
    assert np.isfinite(got).all()
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
    # a row of the batch is the single request
    single = port_pred.predict_action(imgs[1], texts[1], proprio=proprio[1])
    np.testing.assert_allclose(got[1], single, atol=ATOL, rtol=RTOL)
    # without proprio the head sees no proprio token on either side
    np.testing.assert_allclose(port_pred.predict_action_batch(imgs, texts),
                               jax_pred.predict_action_batch(imgs, texts),
                               atol=ATOL, rtol=RTOL)


def test_plain_runtime_shares_weights(predictors):
    """with_runtime builds a second Predictor over the same tensors; on the
    CPU both attention settings run the plain version."""
    _, port_pred = predictors
    import dataclasses

    plain = port_pred.with_runtime(
        dataclasses.replace(port_pred.rt, kernels="plain"))
    for key, val in plain.params.items():
        assert val.data_ptr() == port_pred.params[key].data_ptr(), key
    imgs = _images(8)
    np.testing.assert_array_equal(plain.predict_action(imgs, "stack blocks"),
                                  port_pred.predict_action(imgs, "stack blocks"))


def test_mixed_proprio_batch_raises(predictors):
    _, port_pred = predictors
    imgs = _images(9)
    rows = [port_pred.preprocess(imgs, "a", np.zeros(8)),
            port_pred.preprocess(imgs, "b", None)]
    with pytest.raises(ValueError, match="proprio"):
        port_pred.predict_action_rows(rows)


def test_normalization_matches_jax():
    stats = _stats(3)
    rng = np.random.default_rng(10)
    a = rng.uniform(-1.5, 1.5, size=(4, 8, 7))
    for nt in (NormalizationType.BOUNDS, NormalizationType.BOUNDS_Q99):
        jnt = jnorm.NormalizationType(nt.value)
        np.testing.assert_array_equal(
            tnorm.unnormalize(a, stats["libero_spatial"]["action"], nt),
            jnorm.unnormalize(a, stats["libero_spatial"]["action"], jnt))
    p = rng.normal(size=(3, 8))
    np.testing.assert_array_equal(
        tnorm.normalize(p, stats["libero_spatial"]["proprio"],
                        NormalizationType.NORMAL),
        jnorm.normalize(p, stats["libero_spatial"]["proprio"],
                        jnorm.NormalizationType.NORMAL))


def test_cuda_entry_point_refuses_without_a_card(monkeypatch):
    """The default device is the card; without one the Predictor raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(cfg=TCFG, params={}, tokenize=MockTokenizer().encode,
                  norm_stats=_stats())


def test_cpu_predictor_runs_eager(predictors):
    """On the CPU the forward runs eagerly by default, and asking for a
    CUDA graph there raises."""
    _, port_pred = predictors
    assert port_pred.cuda_graph is False and port_pred.graphs is None
    with pytest.raises(ValueError, match="cuda_graph"):
        Predictor(cfg=TCFG, params=port_pred.params,
                  tokenize=MockTokenizer().encode, norm_stats=_stats(),
                  rt=FP32_RUNTIME, device="cpu", cuda_graph=True)
    with pytest.raises(ValueError, match="cuda_graph"):
        port_pred.with_runtime(port_pred.rt, cuda_graph=True)


class _KeyRecorder:
    """Stands in for the CUDA graphs: records the key each forward asks
    for and returns zero actions, capturing nothing."""

    def __init__(self):
        self.keys = []

    def __call__(self, key, ids, plen, valid, pixels, proprio):
        self.keys.append(key)
        return np.zeros((ids.shape[0], 8, 7), np.float32)


def test_graph_key_is_chosen_as_the_card_path_chooses_it(params):
    """(backend, batch, proprio present): "auto" resolves the backend per
    batch and "mega" refuses a batch, before any graph is asked for."""
    import dataclasses

    rt = dataclasses.replace(FP32_RUNTIME, act_int8_min_dim=16)
    common = dict(cfg=TCFG, params=from_jax_params(params, TCFG),
                  tokenize=MockTokenizer().encode, norm_stats=_stats(),
                  rt=rt, device="cpu", act_int8=True)
    auto = Predictor(w8a8_impl="auto", **common)
    auto.graphs = _KeyRecorder()
    imgs = _images(13)
    auto.predict_action(imgs, "pick", proprio=np.zeros(8))
    auto.predict_action_batch([imgs] * 5, ["a b"] * 5)
    auto.predict_action_batch([imgs] * 4, ["a"] * 4, [np.zeros(8)] * 4)
    assert auto.graphs.keys == [("fused", 1, True), ("dense", 5, False),
                                ("fused", 4, True)]
    assert auto.graph_key(4, True) == ("fused", 4, True)
    mega = auto.with_runtime(auto.rt, w8a8_impl="mega")
    mega.graphs = _KeyRecorder()
    mega.predict_action(imgs, "pick")
    with pytest.raises(ValueError, match="one request at a time"):
        mega.normalized_actions([mega.preprocess(imgs, "a")] * 2)
    assert mega.graphs.keys == [("mega", 1, False)]
    # a model without a proprio projector ignores proprio: one key
    no_proprio = dataclasses.replace(
        auto, cfg=dataclasses.replace(TCFG, use_proprio=False),
        params={k: v for k, v in auto.params.items()
                if not k.startswith("proprio_projector.")})
    assert no_proprio.graph_key(1, True) == ("fused", 1, False)


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import with jax, flax
    and the JAX package blocked."""
    import pathlib
    import subprocess
    import sys

    code = """
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "flax", "vla_adapter_tpu"):
            raise ImportError("blocked " + name)
sys.meta_path.insert(0, Block())
import vla_adapter_torch
for m in pkgutil.walk_packages(vla_adapter_torch.__path__, "vla_adapter_torch."):
    importlib.import_module(m.name)
import chip_smoke
"""
    root = pathlib.Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_import_no_jax():
    """A static scan of every import statement of the port and of
    chip_smoke.py, at any depth: the imports inside functions, which
    importing a module does not run, are held to it too."""
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent
    files = sorted((root / "vla_adapter_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}:{node.lineno} {name}" for name in names
                    if name.split(".")[0] in ("jax", "jaxlib", "flax",
                                              "vla_adapter_tpu")]
    assert len(files) > 20 and not bad, bad
