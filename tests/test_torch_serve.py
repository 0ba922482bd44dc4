"""The port's /act server against the JAX package's, on the CPU.

* The JAX package's batcher and server cases (tests/test_batching.py,
  tests/test_eval_serve.py::test_act_server_http_roundtrip), each run over
  both packages' ``DynamicBatcher`` / ``ActionServer`` / ``run_load`` with
  the same fake predictors.
* One payload through the JAX ``ActionServer`` over the tiny JAX
  Predictor and through the port's over the tiny port Predictor (fp32,
  weights carried over with ``from_jax_params``): actions within 1e-4,
  inline, with an image-pipeline pool, and with host normalization
  (``device_normalize=False``).
* A coalesced batch through the port's server equals
  ``predict_action_rows`` on the same padded rows, bit for bit; a batch
  over a "mega" Predictor fails its requests with the backend's
  ValueError, as in the JAX package.
* ``run_load`` against a port server on the CPU, clients in spawned
  processes; ``parse_config`` on ``DeployConfig``.
"""

import dataclasses
import importlib.util
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from tests.test_torch_modules import JCFG, TCFG, jax_params
from tests.test_torch_predict import _images, _stats
from vla_adapter_tpu.data.tokenization import MockTokenizer as JaxMockTokenizer
from vla_adapter_tpu.infer.predict import Predictor as JaxPredictor
from vla_adapter_tpu.models.layers import FP32_RUNTIME as JAX_FP32
from vla_adapter_tpu.serve import batching as jbatching
from vla_adapter_tpu.serve import loadtest as jloadtest
from vla_adapter_tpu.serve import server as jserver
from vla_adapter_torch.core.cli import parse_config
from vla_adapter_torch.data.tokenization import MockTokenizer
from vla_adapter_torch.infer.predict import Predictor
from vla_adapter_torch.models import layers as tlayers
from vla_adapter_torch.serve import batching as tbatching
from vla_adapter_torch.serve import deploy as tdeploy
from vla_adapter_torch.serve import loadtest as tloadtest
from vla_adapter_torch.serve.loadtest import _post
from vla_adapter_torch.serve import server as tserver
from vla_adapter_torch.weights.from_jax import from_jax_params

ATOL = RTOL = 1e-4
PACKAGES = {"jax": (jbatching, jserver, jloadtest),
            "torch": (tbatching, tserver, tloadtest)}


@pytest.fixture(params=list(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


class FakeBatchPredictor:
    """Deterministic per-request result: mean(image) + len(instruction) +
    proprio[0]; records the forward batch sizes it saw."""

    def __init__(self, delay_s=0.0):
        self.calls = []
        self.delay_s = delay_s
        self.lock = threading.Lock()

    def predict_action_batch(self, images_batch, instructions,
                             proprio_batch=None, unnorm_key=None):
        with self.lock:
            self.calls.append(
                (len(instructions), unnorm_key, proprio_batch is not None))
        if self.delay_s:
            time.sleep(self.delay_s)
        out = []
        for i, (imgs, ins) in enumerate(zip(images_batch, instructions)):
            p = 0.0 if proprio_batch is None else float(proprio_batch[i][0])
            out.append(np.full((8, 7), float(np.mean(imgs[0])) + len(ins) + p))
        return np.stack(out)


class FakePredictor:
    def predict_action(self, images, instruction, proprio=None,
                       unnorm_key=None):
        assert images[0].dtype == np.uint8
        base = float(len(images)) + (0.0 if proprio is None
                                     else float(np.sum(proprio)))
        return np.full((8, 7), base, np.float32)


def _req(i):
    return ([np.full((4, 4, 3), i, np.uint8)], f"task {i}",
            np.array([i * 10.0, 0.0]))


def _expect(i, with_proprio=True):
    imgs, ins, pr = _req(i)
    return np.full((8, 7), float(np.mean(imgs[0])) + len(ins)
                   + (pr[0] if with_proprio else 0.0))


# --- the JAX package's batcher cases, over both packages ---------------------

def test_bucket(pkg):
    bucket = pkg[0]._bucket
    assert bucket(1, (1, 2, 4)) == 1
    assert bucket(3, (1, 2, 4)) == 4
    assert bucket(9, (1, 2, 4)) == 4  # clamps to the largest


def test_concurrent_requests_coalesce_and_match(pkg):
    fake = FakeBatchPredictor(delay_s=0.02)
    b = pkg[0].DynamicBatcher(fake, max_batch=8, max_wait_ms=50.0)
    results = {}

    def call(i):
        imgs, ins, pr = _req(i)
        results[i] = b.predict(imgs, ins, proprio=pr, unnorm_key="k")

    threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    b.close()
    for i in range(8):
        np.testing.assert_allclose(results[i], _expect(i))
    stats = b.stats()
    assert stats["num_requests"] == 8
    assert stats["num_forwards"] < 8, stats
    assert max(stats["batch_sizes"]) > 1


def test_groups_split_by_unnorm_key_and_proprio(pkg):
    fake = FakeBatchPredictor(delay_s=0.05)
    b = pkg[0].DynamicBatcher(fake, max_batch=8, max_wait_ms=200.0)
    results = {}

    def call(i, key, with_proprio):
        imgs, ins, pr = _req(i)
        results[i] = b.predict(imgs, ins, proprio=pr if with_proprio
                               else None, unnorm_key=key)

    specs = [(0, "a", True), (1, "a", True), (2, "b", True), (3, "a", False)]
    threads = [threading.Thread(target=call, args=s) for s in specs]
    for t in threads:
        t.start()
        time.sleep(0.005)
    for t in threads:
        t.join(timeout=30)
    b.close()
    keys = sorted((k, has_p) for _, k, has_p in fake.calls)
    assert ("b", True) in keys and ("a", False) in keys
    for i, _, with_p in specs:
        np.testing.assert_allclose(results[i], _expect(i, with_p))


def test_error_propagates_to_caller(pkg):
    class Exploding:
        def predict_action_batch(self, *a, **k):
            raise ValueError("boom")

    b = pkg[0].DynamicBatcher(Exploding(), max_batch=2, max_wait_ms=1.0)
    try:
        with pytest.raises(ValueError, match="boom"):
            b.predict([np.zeros((2, 2, 3), np.uint8)], "x")
    finally:
        b.close()


def test_server_dynamic_batch_roundtrip(pkg):
    _, server_mod, _ = pkg
    fake = FakeBatchPredictor(delay_s=0.02)
    server = server_mod.ActionServer(fake, host="127.0.0.1", port=0,
                                     dynamic_batch=True, max_wait_ms=50.0)
    port = server.serve_background()
    results = {}

    def call(i):
        payload = {
            "full_image": server_mod.encode_ndarray(
                np.full((4, 4, 3), i, np.uint8)),
            "instruction": f"task {i}",
            "proprio": server_mod.encode_ndarray(np.array([i * 10.0, 0.0])),
            "unnorm_key": "k",
        }
        results[i] = server_mod.decode_payload(
            _post(f"http://127.0.0.1:{port}/act", payload))["action"]

    threads = [threading.Thread(target=call, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    server.shutdown()
    for i in range(6):
        np.testing.assert_allclose(results[i], _expect(i))
    assert sum(n for n, _, _ in fake.calls) >= 6
    assert len(fake.calls) < 6  # coalesced


def test_loadtest_run_load_against_fake_server(pkg):
    _, server_mod, loadtest_mod = pkg
    fake = FakeBatchPredictor(delay_s=0.005)
    server = server_mod.ActionServer(fake, host="127.0.0.1", port=0,
                                     dynamic_batch=True, max_batch=8,
                                     max_wait_ms=5.0)
    port = server.serve_background()
    try:
        stats = loadtest_mod.run_load(f"http://127.0.0.1:{port}/act",
                                      num_clients=4, duration_s=1.5,
                                      image_hw=8, proprio_dim=2,
                                      warmup_s=0.3)
    finally:
        server.shutdown()
    assert stats["errors"] == 0, stats
    assert stats["completed"] > 10
    assert stats["latency_ms"]["p50"] > 0
    assert stats["latency_ms"]["p99"] >= stats["latency_ms"]["p50"]


def test_bucket_ladder_extends_past_defaults(pkg):
    batching = pkg[0]
    b = batching.DynamicBatcher(FakeBatchPredictor(), max_batch=32,
                                max_wait_ms=1.0)
    assert max(b.buckets) >= 32
    assert batching._bucket(17, b.buckets) == 32
    b.close()


def test_predict_after_close_raises_instead_of_hanging(pkg):
    b = pkg[0].DynamicBatcher(FakeBatchPredictor(), max_batch=4,
                              max_wait_ms=1.0)
    b.close()
    with pytest.raises(RuntimeError):
        b.predict(*_req(0))


def test_close_bounded_when_forward_is_wedged(pkg):
    """A forward that never returns must not hang close(): it gives up
    after join_timeout_s, fails the stranded callers, and returns."""
    release = threading.Event()
    entered = threading.Event()

    class Wedged(FakeBatchPredictor):
        def predict_action_batch(self, *a, **kw):
            entered.set()
            release.wait(timeout=30)
            return super().predict_action_batch(*a, **kw)

    b = pkg[0].DynamicBatcher(Wedged(), max_batch=2, max_wait_ms=1.0)
    errors = []

    def call():
        try:
            b.predict(*_req(1))
        except RuntimeError as e:
            errors.append(e)

    t = threading.Thread(target=call, daemon=True)
    t.start()
    assert entered.wait(timeout=10), "worker never entered the forward"
    t2 = threading.Thread(target=call, daemon=True)
    t2.start()
    time.sleep(0.1)
    t0 = time.monotonic()
    b.close(join_timeout_s=1.0)
    assert time.monotonic() - t0 < 15, "close() failed to bound its wait"
    release.set()
    t2.join(timeout=5)
    assert not t2.is_alive(), "queued caller was stranded by close()"
    assert errors


def test_act_server_http_roundtrip(pkg):
    _, server_mod, _ = pkg
    server = server_mod.ActionServer(FakePredictor(), host="127.0.0.1",
                                     port=0)
    port = server.serve_background()
    try:
        payload = {
            "full_image": server_mod.encode_ndarray(
                np.zeros((64, 64, 3), np.uint8)),
            "wrist_image": server_mod.encode_ndarray(
                np.zeros((64, 64, 3), np.uint8)),
            "proprio": server_mod.encode_ndarray(np.ones(8, np.float32)),
            "instruction": "pick up the cup",
        }
        out = server_mod.decode_payload(
            _post(f"http://127.0.0.1:{port}/act", payload))
        np.testing.assert_allclose(out["action"], np.full((8, 7), 10.0))
        bad = urllib.request.Request(f"http://127.0.0.1:{port}/nope",
                                     data=b"{}")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad, timeout=10)
        assert e.value.code == 404
        garbage = urllib.request.Request(f"http://127.0.0.1:{port}/act",
                                         data=b"not json")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(garbage, timeout=10)
        assert e.value.code == 500
    finally:
        server.shutdown()


def test_make_fastapi_app_is_gated():
    if importlib.util.find_spec("fastapi") is None:
        with pytest.raises(ImportError):
            tserver.make_fastapi_app(FakePredictor())
    else:
        assert tserver.make_fastapi_app(FakePredictor()) is not None


# --- the tiny VLA behind both packages' servers ------------------------------

@pytest.fixture(scope="module")
def params():
    return jax_params(seed=7)


def _predictors(params, **kw):
    jtok, ttok = JaxMockTokenizer(), MockTokenizer()
    jax_pred = JaxPredictor(cfg=JCFG, params=params,
                            tokenize=lambda t: jtok(t).input_ids,
                            norm_stats=_stats(), rt=JAX_FP32, **kw)
    port_pred = Predictor(cfg=TCFG, params=from_jax_params(params, TCFG),
                          tokenize=lambda t: ttok(t).input_ids,
                          norm_stats=_stats(), rt=tlayers.FP32_RUNTIME,
                          device="cpu", **kw)
    return jax_pred, port_pred


def _payload(server_mod, seed, shape=(28, 28, 3)):
    imgs = _images(seed, shape)
    proprio = np.random.default_rng(seed).normal(size=8).astype(np.float32)
    return imgs, proprio, {
        "full_image": server_mod.encode_ndarray(imgs[0]),
        "wrist_image": server_mod.encode_ndarray(imgs[1]),
        "proprio": server_mod.encode_ndarray(proprio),
        "instruction": "put the bowl on the plate"}


def _serve_one(server_mod, predictor, payload, **kw):
    server = server_mod.ActionServer(predictor, host="127.0.0.1", port=0,
                                     **kw)
    port = server.serve_background()
    try:
        return server_mod.decode_payload(
            _post(f"http://127.0.0.1:{port}/act", payload))["action"]
    finally:
        server.shutdown()


SERVER_MODES = {
    "inline": ({}, {}),
    "dynamic_batch": ({}, {"dynamic_batch": True, "max_wait_ms": 1.0}),
    "host_normalize": ({"device_normalize": False}, {}),
}


@pytest.mark.parametrize("mode", list(SERVER_MODES))
def test_port_server_answers_what_jax_server_answers(params, mode):
    pred_kw, server_kw = SERVER_MODES[mode]
    jax_pred, port_pred = _predictors(params, **pred_kw)
    _, _, payload = _payload(tserver, 21, shape=(36, 30, 3))
    want = _serve_one(jserver, jax_pred, payload, **server_kw)
    got = _serve_one(tserver, port_pred, payload, **server_kw)
    assert got.shape == (8, 7) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_host_normalized_rows_match_jax(params):
    jax_pred, port_pred = _predictors(params, device_normalize=False)
    imgs, proprio, _ = _payload(tserver, 22)
    want = jax_pred.preprocess(imgs, "open the drawer", proprio)
    got = port_pred.preprocess(imgs, "open the drawer", proprio)
    assert got["pixels"].dtype == np.float32
    np.testing.assert_array_equal(got["pixels"], want["pixels"])
    np.testing.assert_allclose(
        port_pred.predict_action(imgs, "open the drawer", proprio),
        jax_pred.predict_action(imgs, "open the drawer", proprio),
        atol=ATOL, rtol=RTOL)


def test_preprocess_pool_matches_inline_and_stays_off_the_card(params):
    """ActionServer(preprocess_workers=2): the pool's rows equal the
    inline ones; its spawned workers import no torch and see no CUDA
    device; shutdown closes the pool the server made."""
    _, port_pred = _predictors(params)
    imgs, proprio, payload = _payload(tserver, 23, shape=(40, 52, 3))
    want = port_pred.preprocess(imgs, "stack the blocks", proprio)
    inline_action = port_pred.predict_action(imgs, payload["instruction"],
                                             proprio)
    server = tserver.ActionServer(port_pred, host="127.0.0.1", port=0,
                                  preprocess_workers=2)
    port = server.serve_background()
    try:
        pool = port_pred._pixel_pool
        got = port_pred.preprocess(imgs, "stack the blocks", proprio)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
        child = pool._pool.apply(eval, (
            "('torch' in __import__('sys').modules, "
            "__import__('os').environ.get('CUDA_VISIBLE_DEVICES'))",))
        assert child == (False, "")
        action = tserver.decode_payload(
            _post(f"http://127.0.0.1:{port}/act", payload))["action"]
        np.testing.assert_array_equal(action, inline_action)
    finally:
        server.shutdown()
    assert port_pred._pixel_pool is None


def test_coalesced_batch_equals_predict_action_rows(params):
    """Three requests coalesced into one forward (max_batch=3, a long
    max_wait_ms, sent in a known order) are padded to the bucket of 4 by
    repeating the last row: each answer equals predict_action_rows on those
    four rows, bit for bit."""
    _, port_pred = _predictors(params)
    server = tserver.ActionServer(port_pred, host="127.0.0.1", port=0,
                                  dynamic_batch=True, max_batch=3,
                                  max_wait_ms=10_000.0)
    port = server.serve_background()
    requests = [_payload(tserver, 30 + i) for i in range(3)]
    results = {}

    def call(i):
        results[i] = tserver.decode_payload(_post(
            f"http://127.0.0.1:{port}/act", requests[i][2]))["action"]

    threads = []
    try:
        for i in range(3):
            threads.append(threading.Thread(target=call, args=(i,)))
            threads[-1].start()
            time.sleep(0.3)  # enqueued in order
        for t in threads:
            t.join(timeout=60)
        assert server.batcher.stats()["batch_sizes"] == [3]
    finally:
        server.shutdown()
    rows = [port_pred.preprocess(imgs, p["instruction"], proprio)
            for imgs, proprio, p in requests]
    want = port_pred.predict_action_rows(rows + rows[-1:])
    for i in range(3):
        np.testing.assert_array_equal(results[i], want[i])


def test_batcher_over_mega_fails_a_batch_with_the_backends_error(params):
    """A coalesced batch of two over a "mega" Predictor fails both
    requests with its ValueError; one request alone is served."""
    _, fused = _predictors(params, act_int8=True, w8a8_impl="fused")
    mega = fused.with_runtime(
        dataclasses.replace(fused.rt, act_int8_min_dim=16), w8a8_impl="mega")
    b = tbatching.DynamicBatcher(mega, max_batch=2, max_wait_ms=10_000.0)
    errors = []

    def call(seed):
        imgs, proprio, _ = _payload(tserver, seed)
        try:
            b.predict(imgs, "fold the towel", proprio)
        except ValueError as err:
            errors.append(err)

    threads = [threading.Thread(target=call, args=(s,)) for s in (40, 41)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert len(errors) == 2 and "one request at a time" in str(errors[0])
        imgs, proprio, _ = _payload(tserver, 42)
        single = tbatching.DynamicBatcher(mega, max_batch=2, max_wait_ms=1.0)
        try:
            assert single.predict(imgs, "fold", proprio).shape == (8, 7)
        finally:
            single.close()
    finally:
        b.close()


def test_run_load_against_port_server(params):
    _, port_pred = _predictors(params)
    server = tserver.ActionServer(port_pred, host="127.0.0.1", port=0,
                                  dynamic_batch=True, max_batch=4,
                                  max_wait_ms=2.0)
    port = server.serve_background()
    try:
        stats = tloadtest.run_load(
            f"http://127.0.0.1:{port}/act", num_clients=3, duration_s=2.0,
            image_hw=28, proprio_dim=8, warmup_s=0.5, processes=2,
            action_shape=(8, 7))
        sizes = server.batcher.stats()["batch_sizes"]
    finally:
        server.shutdown()
    assert stats["errors"] == 0, stats
    assert stats["completed"] >= 3
    assert 1 <= max(sizes) <= 4


def test_parse_config_on_deploy_config():
    cfg = tdeploy.parse_config(tdeploy.DeployConfig, [
        "--ckpt_dir", "/ckpt", "--port=9000", "--act_int8", "true",
        "--w8a8_impl", "fused", "--max_wait_ms", "2.5", "--device", "cpu"])
    assert cfg == dataclasses.replace(
        tdeploy.DeployConfig(), ckpt_dir="/ckpt", port=9000, act_int8=True,
        w8a8_impl="fused", max_wait_ms=2.5, device="cpu")
    assert parse_config is tdeploy.parse_config
    with pytest.raises(KeyError):
        parse_config(tdeploy.DeployConfig, ["--nope", "1"])
    with pytest.raises(SystemExit):
        tdeploy.main(["--port", "1"])  # --ckpt_dir is required
