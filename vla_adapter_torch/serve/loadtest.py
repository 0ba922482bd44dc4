"""/act load generator: serving capacity and latency percentiles
(counterpart of vla_adapter_tpu/serve/loadtest.py).

Measures what a deployment sees: whole POST /act round trips (JSON and
base64 decoding, host image preprocessing, dynamic micro-batching, the
forward on the card, unnormalization) under N concurrent closed-loop
clients, each of which sends its next request as soon as the previous one
returns (the worst case for a batcher).

CLI, self-serving (builds the flagship ``VLAConfig()`` with random bf16
weights from a seeded generator on the card, or a tiny VLA with
``--tiny``; the weights' values do not change the timing):

    python -m vla_adapter_torch.serve.loadtest --clients 16 --duration 30 \\
        --act-int8 --dynamic-batch --prewarm

or point --url at a running ActionServer. Prints one JSON line:
  {"requests_per_s": ..., "actions_per_s": ..., "latency_ms": {"p50": ...,
   "p90": ..., "p99": ...}, "batch_size_hist": {...}}

Every request carries a uniquely perturbed image, so no two forwards see
the same inputs. This module and the client processes it spawns import
numpy and the stdlib only; the Predictor is built in the server process.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
import urllib.request
from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np

from vla_adapter_torch.serve.server import decode_payload, encode_ndarray


def _post(url: str, payload: Dict, timeout: float = 120.0) -> Dict:
    body = json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def act_payload(images: Sequence[np.ndarray], instruction: str,
                proprio: Optional[np.ndarray] = None,
                unnorm_key: Optional[str] = None) -> Dict:
    """The /act JSON body of one request: the full and the wrist image
    (base64 arrays), the instruction, and proprio and the unnorm key where
    given."""
    payload = {"full_image": encode_ndarray(images[0]),
               "wrist_image": encode_ndarray(images[1]),
               "instruction": instruction}
    if proprio is not None:
        payload["proprio"] = encode_ndarray(proprio)
    if unnorm_key:
        payload["unnorm_key"] = unnorm_key
    return payload


def post_act(url: str, images: Sequence[np.ndarray], instruction: str,
             proprio: Optional[np.ndarray] = None,
             timeout: float = 120.0) -> np.ndarray:
    """One request to /act: its decoded action."""
    out = _post(url, act_payload(images, instruction, proprio), timeout)
    return decode_payload(out["action"])


def _check_action(out: Dict, action_shape: Optional[Sequence[int]]) -> None:
    """A response must carry an action; with ``action_shape``, a finite
    array of that shape."""
    if "action" not in out:
        raise ValueError(f"no action in the response: {out}")
    if action_shape is not None:
        action = decode_payload(out["action"])
        if tuple(action.shape) != tuple(action_shape) \
                or not np.isfinite(action).all():
            raise ValueError(f"action {action.dtype} {action.shape}, "
                             f"finite={np.isfinite(action).all()}")


def _client_loop(url: str, cid: int, stop: float, t_measure: float,
                 image_hw: int, proprio_dim: Optional[int], instruction: str,
                 unnorm_key: Optional[str], latencies: List[float],
                 errors: List[str], lock,
                 action_shape: Optional[Sequence[int]] = None) -> None:
    """One closed-loop client: back-to-back POSTs until the deadline."""
    rng = np.random.default_rng(1000 + cid)
    base_full = np.random.default_rng(0).integers(
        0, 255, size=(image_hw, image_hw, 3), dtype=np.uint8)
    base_wrist = np.random.default_rng(1).integers(
        0, 255, size=(image_hw, image_hw, 3), dtype=np.uint8)
    fail_streak = 0
    while time.monotonic() < stop:
        # a unique payload per request: a few random pixels flipped
        full = base_full.copy()
        ys, xs = rng.integers(0, image_hw, 8), rng.integers(0, image_hw, 8)
        full[ys, xs] = rng.integers(0, 255, size=(8, 3))
        proprio = (rng.normal(size=proprio_dim).astype(np.float32)
                   if proprio_dim else None)
        payload = act_payload((full, base_wrist), instruction, proprio,
                              unnorm_key)
        t0 = time.monotonic()
        try:
            out = _post(url, payload)
            dt = time.monotonic() - t0
            _check_action(out, action_shape)
            if t0 >= t_measure:
                with lock:
                    latencies.append(dt)
            fail_streak = 0
        except Exception as e:  # noqa: BLE001 - recorded, not fatal
            # failures in the warm-up (a first capture outlasting a client
            # timeout) stay out of the stats; a long streak still aborts
            if t0 >= t_measure:
                with lock:
                    errors.append(f"{type(e).__name__}: {e}")
            fail_streak += 1
            if fail_streak > 50 or len(errors) > 100:
                return


def _client_proc(url, cids, warmup_s, duration_s, image_hw, proprio_dim,
                 instruction, unnorm_key, out_q, go,
                 action_shape=None) -> None:
    """A client worker process: reports that it is up, waits for ``go``
    (set once every worker is up, so that no client's window depends on
    how long its process took to start), runs len(cids) client threads
    for the warm-up and the window, and ships (latencies, errors) back
    through out_q. Top level, for 'spawn'; imports no torch."""
    out_q.put("ready")
    go.wait()
    t_measure = time.monotonic() + warmup_s
    stop = t_measure + duration_s
    latencies: List[float] = []
    errors: List[str] = []
    lock = threading.Lock()
    threads = [
        threading.Thread(
            target=_client_loop,
            args=(url, cid, stop, t_measure, image_hw, proprio_dim,
                  instruction, unnorm_key, latencies, errors, lock,
                  action_shape),
            daemon=True)
        for cid in cids
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out_q.put((latencies, errors))


def run_load(
    url: str,
    num_clients: int,
    duration_s: float,
    image_hw: int = 224,
    proprio_dim: Optional[int] = 8,
    instruction: str = "pick up the black bowl and place it on the plate",
    unnorm_key: Optional[str] = None,
    warmup_s: float = 0.0,
    processes: int = 1,
    action_shape: Optional[Sequence[int]] = None,
) -> Dict:
    """Closed-loop load: ``num_clients`` clients post back-to-back requests
    for ``duration_s`` seconds (after ``warmup_s`` of untimed requests).
    ``processes > 1`` spreads the clients over separate OS processes, which
    a fair measurement of a server in the same process needs: in one
    process the clients' base64 and JSON work shares the server's
    interpreter lock. ``action_shape``: each response must be a finite
    array of that shape, else it counts as an error. Returns aggregate
    stats."""
    latencies: List[float] = []
    errors: List[str] = []

    if processes <= 1:
        stop = time.monotonic() + warmup_s + duration_s
        t_measure = time.monotonic() + warmup_s
        lock = threading.Lock()
        threads = [
            threading.Thread(
                target=_client_loop,
                args=(url, i, stop, t_measure, image_hw, proprio_dim,
                      instruction, unnorm_key, latencies, errors, lock,
                      action_shape),
                daemon=True)
            for i in range(num_clients)
        ]
        t_start = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=warmup_s + duration_s + 300)
    else:
        import multiprocessing as mp

        from vla_adapter_torch.data.image_processing import (
            spawn_without_accelerator,
        )

        ctx = mp.get_context("spawn")  # clean children: no inherited CUDA
        out_q, go = ctx.Queue(), ctx.Event()
        chunks = [list(range(num_clients))[i::processes]
                  for i in range(processes)]
        chunks = [c for c in chunks if c]
        procs = [
            ctx.Process(
                target=_client_proc,
                args=(url, cids, warmup_s, duration_s, image_hw, proprio_dim,
                      instruction, unnorm_key, out_q, go, action_shape),
                daemon=True)
            for cids in chunks
        ]
        with spawn_without_accelerator():
            for p in procs:
                p.start()
        try:
            for _ in procs:
                if out_q.get(timeout=600) != "ready":
                    raise RuntimeError("a client process did not start")
            t_start = time.monotonic()
            go.set()
            for _ in procs:  # drain the queue before joining its writers
                lat, err = out_q.get(timeout=warmup_s + duration_s + 600)
                latencies.extend(lat)
                errors.extend(err)
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.terminate()
    elapsed = min(time.monotonic() - t_start, duration_s) or 1e-9

    lat = np.sort(np.asarray(latencies)) * 1e3  # ms
    # nearest rank: ceil(p/100 * n) - 1
    pct = (lambda p: float(lat[max(0, -(-len(lat) * p // 100) - 1)])
           if len(lat) else None)
    return {
        "num_clients": num_clients,
        "duration_s": round(elapsed, 2),
        "completed": len(latencies),
        "errors": len(errors),
        "error_sample": errors[:3],
        "requests_per_s": round(len(latencies) / elapsed, 2),
        "latency_ms": {"p50": pct(50), "p90": pct(90), "p99": pct(99),
                       "mean": float(lat.mean()) if len(lat) else None},
    }


# ---------------------------------------------------------------------------
# Self-serving CLI
# ---------------------------------------------------------------------------


def _build_predictor(tiny: bool, int8: bool, act_int8: bool,
                     w8a8_impl: str = "auto", device: str = "cuda",
                     seed: int = 0):
    """The flagship ``VLAConfig()`` (or, with ``tiny``, a small VLA) with
    random weights drawn from a seeded generator on ``device`` (bf16; fp32
    for the tiny model on the CPU), served in the tier asked for."""
    import torch

    from vla_adapter_torch.core.config import (
        ActionHeadConfig,
        FusedVisionConfig,
        Qwen2Config,
        ViTConfig,
        VLAConfig,
    )
    from vla_adapter_torch.core.constants import (
        NormalizationType,
        PlatformConstants,
    )
    from vla_adapter_torch.data.normalization import dataset_statistics
    from vla_adapter_torch.data.tokenization import MockTokenizer
    from vla_adapter_torch.infer.predict import (
        SERVING_RUNTIME,
        Predictor,
        resolve_device,
    )
    from vla_adapter_torch.models.layers import FP32_RUNTIME, init_random_
    from vla_adapter_torch.models.vla import VLAModel

    device = resolve_device(device)
    rt = SERVING_RUNTIME
    if tiny:
        cfg = VLAConfig(
            custom_constants=PlatformConstants(
                name="loadtest", num_actions_chunk=8, action_dim=7,
                proprio_dim=8,
                normalization_type=NormalizationType.BOUNDS_Q99,
                num_action_query_tokens=16),
            vision=FusedVisionConfig(
                primary=ViTConfig(name="p", image_size=28, patch_size=14,
                                  hidden_size=32, num_layers=2, num_heads=4,
                                  mlp_dim=64),
                fused=None, num_images=2),
            llm=Qwen2Config(vocab_size=512, hidden_size=64, num_layers=2,
                            num_heads=4, num_kv_heads=2,
                            intermediate_size=128, head_dim=16),
            head=ActionHeadConfig(num_blocks=2, hidden_dim=64),
            max_text_tokens=64,
        )
        if device.type == "cpu":
            rt = FP32_RUNTIME
    else:
        cfg = VLAConfig()
    gen = torch.Generator(device=device).manual_seed(seed)
    model = init_random_(VLAModel(cfg, rt, device=device), gen)
    rng = np.random.default_rng(seed)
    stats = {"loadtest": dataset_statistics(
        rng.uniform(-1, 1, size=(200, cfg.constants.action_dim)),
        proprio=rng.normal(size=(200, cfg.constants.proprio_dim)))}
    tok = MockTokenizer()
    return Predictor(cfg=cfg, params=model.state_dict(),
                     tokenize=lambda text: tok(text).input_ids,
                     norm_stats=stats, rt=rt, device=str(device), int8=int8,
                     act_int8=act_int8, w8a8_impl=w8a8_impl)


def prewarm(predictor, max_batch: int, seed: int = 9) -> None:
    """Serve one request at each bucket of the batcher's ladder (1, 2, 4,
    ... up to ``max_batch``), with proprio, so that every bucket's graph is
    captured before the load starts."""
    rng = np.random.default_rng(seed)
    hw = predictor.cfg.vision.primary.image_size
    n_img = predictor.cfg.vision.num_images
    ladder = [1]
    while ladder[-1] < max_batch:
        ladder.append(ladder[-1] * 2)  # the DynamicBatcher's buckets
    for b in ladder:
        imgs = [[rng.integers(0, 255, size=(hw, hw, 3), dtype=np.uint8)
                 for _ in range(n_img)] for _ in range(b)]
        predictor.predict_action_batch(
            imgs, ["warm"] * b,
            [np.zeros(predictor.cfg.constants.proprio_dim, np.float32)] * b)


def main(argv: Optional[List[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--url", default=None,
                   help="measure an existing server instead of self-serving")
    p.add_argument("--clients", type=int, default=16)
    p.add_argument("--processes", type=int, default=4,
                   help="client worker processes (>1 keeps the clients' "
                        "base64/JSON work off the server's interpreter lock)")
    p.add_argument("--duration", type=float, default=30.0)
    p.add_argument("--warmup", type=float, default=10.0)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--int8", action="store_true")
    p.add_argument("--act-int8", action="store_true")
    p.add_argument("--w8a8-impl", default="auto",
                   choices=("auto", "dense", "fused", "mega"),
                   help="w8a8 backend: 'auto' picks per batch bucket "
                        "(models/layers.resolve_w8a8_impl)")
    p.add_argument("--dynamic-batch", action="store_true")
    p.add_argument("--prewarm", action="store_true",
                   help="capture every batch bucket's graph before the load")
    p.add_argument("--max-batch", type=int, default=16)
    p.add_argument("--max-wait-ms", type=float, default=8.0)
    p.add_argument("--preprocess-workers", type=int, default=0,
                   help="server-side image-pipeline process pool size")
    args = p.parse_args(argv)

    server = None
    url = args.url
    image_hw = 224
    if url is None:
        from vla_adapter_torch.serve.server import ActionServer

        predictor = _build_predictor(args.tiny, args.int8, args.act_int8,
                                     args.w8a8_impl, args.device)
        image_hw = predictor.cfg.vision.primary.image_size
        if args.prewarm:
            prewarm(predictor, args.max_batch)
        server = ActionServer(
            predictor, host="127.0.0.1", port=0,
            dynamic_batch=args.dynamic_batch, max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms,
            preprocess_workers=args.preprocess_workers)
        port = server.serve_background()
        url = f"http://127.0.0.1:{port}/act"

    try:
        stats = run_load(url, args.clients, args.duration, image_hw=image_hw,
                         warmup_s=args.warmup, unnorm_key=None,
                         processes=args.processes)
        chunk = 8
        stats["actions_per_s"] = round(stats["requests_per_s"] * chunk, 1)
        if server is not None and server.batcher is not None:
            sizes = server.batcher.stats()["batch_sizes"]
            stats["batch_size_hist"] = dict(sorted(Counter(sizes).items()))
        print(json.dumps(stats))
        return stats
    finally:
        if server is not None:
            server.shutdown()


if __name__ == "__main__":
    main()
