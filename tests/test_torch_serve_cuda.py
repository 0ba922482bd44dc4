"""The /act serving path over the CUDA graphs, on the card.

The tiny VLA of ``tests/torch_tiny.py`` with random bf16 weights (as in
tests/test_torch_graph_cuda.py, ``act_int8_min_dim=16``), served through
the port's ``DynamicBatcher`` and ``ActionServer``:

* the batcher pads each coalesced group to its bucket (1, 2, 4, 8, 16), and
  each bucket's graph, captured once, answers as the eager forward does,
  bit for bit, under bf16 and w8a8 "auto" (whose buckets above 4 are
  "dense");
* a batch the batcher is made to coalesce (max_batch=3, sent in a known
  order) equals ``predict_action_rows`` on the same padded rows;
* ``dynamic_batch=False``: many threads' requests at once through the
  graphs' lock, each equal to its request served alone;
* ``device_normalize=False`` captures fp32 pixel buffers of its own, equal
  to the eager forward, and a graph captured with uint8 pixels refuses
  fp32 ones.

Imports no JAX: ``python -m pytest tests/test_torch_serve_cuda.py -m cuda``.
Without a card every test here skips.
"""

import threading
import time

import numpy as np
import pytest
import torch

from tests.test_torch_graph_cuda import _predictor, _rows, base, device  # noqa: F401
from vla_adapter_torch.models.layers import resolve_w8a8_impl
from vla_adapter_torch.serve.batching import DynamicBatcher, _bucket
from vla_adapter_torch.serve.loadtest import post_act
from vla_adapter_torch.serve.server import ActionServer

pytestmark = pytest.mark.cuda

BUCKETS = (1, 2, 4, 8, 16)


def _request(seed, size=28):
    rng = np.random.default_rng(seed)
    images = [rng.integers(0, 256, size=(size, size, 3), dtype=np.uint8)
              for _ in range(2)]
    return images, "pick up the cup", rng.normal(size=8).astype(np.float32)


def _post(port, images, text, proprio):
    return post_act(f"http://127.0.0.1:{port}/act", images, text, proprio)


@pytest.mark.parametrize("tier", ["bf16", "auto"])
def test_batcher_buckets_replay_their_graphs(base, tier):  # noqa: F811
    """n concurrent requests (n = 1, 2, 3, 6, 16) land in one coalesced
    group padded to its bucket (1, 2, 4, 8, 16); each answer equals the
    eager forward of the padded rows, and each bucket's graph is captured
    once and replayed once."""
    pred = _predictor(base, tier)
    eager = pred.with_runtime(pred.rt, cuda_graph=False)
    for n in (1, 2, 3, 6, 16):
        b = DynamicBatcher(pred, max_batch=n, max_wait_ms=30_000.0)
        reqs = [_request(100 * n + i) for i in range(n)]
        out = {}

        def call(i):
            out[i] = b.predict(*reqs[i])

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(n)]
        try:
            for t in threads:
                t.start()
                time.sleep(0.05)  # enqueued in order
            for t in threads:
                t.join(timeout=120)
            assert b.stats()["batch_sizes"] == [n]
        finally:
            b.close()
        rows = [pred.preprocess(*r) for r in reqs]
        padded = rows + rows[-1:] * (_bucket(n, BUCKETS) - n)
        want = eager.predict_action_rows(padded)
        for i in range(n):
            np.testing.assert_array_equal(out[i], want[i])
    keys = set(pred.graphs.captures)
    assert keys == {pred.graph_key(bk, True) for bk in BUCKETS}
    if tier == "auto":
        assert {k[0] for k in keys} == {resolve_w8a8_impl("auto", bk)
                                        for bk in BUCKETS} == {"fused",
                                                               "dense"}
    assert all(c.replays == 1 for c in pred.graphs.captures.values())


def test_server_coalesced_batch_equals_rows(base):  # noqa: F811
    pred = _predictor(base, "fused")
    server = ActionServer(pred, host="127.0.0.1", port=0, dynamic_batch=True,
                          max_batch=3, max_wait_ms=30_000.0)
    port = server.serve_background()
    reqs = [_request(7 + i) for i in range(3)]
    out = {}

    def call(i):
        out[i] = _post(port, *reqs[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    try:
        for t in threads:
            t.start()
            time.sleep(0.2)
        for t in threads:
            t.join(timeout=120)
        assert server.batcher.stats()["batch_sizes"] == [3]
    finally:
        server.shutdown()
    rows = [pred.preprocess(*r) for r in reqs]
    want = pred.predict_action_rows(rows + rows[-1:])
    for i in range(3):
        np.testing.assert_array_equal(out[i], want[i])
    alone = pred.predict_action(*reqs[0])
    assert alone.shape == (8, 7) and np.isfinite(alone).all()


@pytest.mark.parametrize("tier", ["bf16", "mega"])
def test_concurrent_requests_without_batching(base, tier):  # noqa: F811
    """dynamic_batch=False: 12 clients at once; every answer equals its
    request served alone, and the first capture happened once."""
    pred = _predictor(base, tier)
    reqs = [_request(50 + i) for i in range(12)]
    want = [pred.predict_action(*r) for r in reqs]
    server = ActionServer(pred, host="127.0.0.1", port=0)
    port = server.serve_background()
    out, errors = {}, []

    def call(i):
        try:
            out[i] = _post(port, *reqs[i])
        except Exception as err:  # noqa: BLE001 - reported below
            errors.append(err)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(12)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        server.shutdown()
    assert not errors, errors
    for i in range(12):
        np.testing.assert_array_equal(out[i], want[i])
    assert len(pred.graphs.captures) == 1
    assert next(iter(pred.graphs.captures.values())).replays == 24


def test_host_normalized_pixels_keep_their_own_graphs(base):  # noqa: F811
    uint8 = _predictor(base, "bf16")
    host = _predictor(base, "bf16", device_normalize=False)
    eager = host.with_runtime(host.rt, cuda_graph=False)
    rows = _rows(host, 2, 3)
    assert rows[0]["pixels"].dtype == np.float32
    got = host.normalized_actions(rows)
    np.testing.assert_array_equal(got, eager.normalized_actions(rows))
    (cap,) = host.graphs.captures.values()
    assert cap.static["pixels"].dtype == torch.float32
    # the same request through uint8 pixels normalized on the card
    uint8_rows = _rows(uint8, 2, 3)
    assert uint8_rows[0]["pixels"].dtype == np.uint8
    np.testing.assert_allclose(uint8.normalized_actions(uint8_rows), got,
                               atol=0.1)
    with pytest.raises(ValueError, match="pixels"):
        uint8.normalized_actions(rows)  # fp32 rows into the uint8 graph
