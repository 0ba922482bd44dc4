"""Action-prediction server (counterpart of vla_adapter_tpu/serve/server.py;
the reference's vla-scripts/deploy.py).

POST /act with a JSON payload:
  {"full_image": <np>, "wrist_image": <np, optional>, "proprio": <np>,
   "instruction": str, "unnorm_key": str?}
-> JSON {"action": <np (chunk, dim)>}

Numpy arrays travel as {"__ndarray__": base64, "dtype": ..., "shape": ...}
(json_numpy's shape). The stdlib ``http.server`` backend needs nothing
more; :func:`make_fastapi_app` builds the FastAPI app where fastapi is
installed. Imports no ``torch``: the load-test clients import this module.
"""

from __future__ import annotations

import base64
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np

log = logging.getLogger(__name__)


def encode_ndarray(a: np.ndarray) -> Dict[str, Any]:
    a = np.ascontiguousarray(a)
    return {
        "__ndarray__": base64.b64encode(a.tobytes()).decode(),
        "dtype": str(a.dtype),
        "shape": list(a.shape),
    }


def decode_payload(obj):
    if isinstance(obj, dict):
        if "__ndarray__" in obj:
            data = base64.b64decode(obj["__ndarray__"])
            return np.frombuffer(data, dtype=obj["dtype"]).reshape(obj["shape"])
        return {k: decode_payload(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [decode_payload(v) for v in obj]
    return obj


class ActionServer:
    """Wraps an infer.Predictor behind POST /act.

    ``dynamic_batch=True`` coalesces concurrent requests into batched
    forwards (serve/batching.py): ThreadingHTTPServer handles each request
    on its own thread, so simultaneous clients land in one forward instead
    of serializing batch-1 calls (the reference server's behaviour). With
    ``dynamic_batch=False`` the threads call ``predict_action`` at once;
    the Predictor serializes their forwards on the card.
    ``preprocess_workers=N`` gives the Predictor an image-pipeline pool of
    N processes, which :meth:`shutdown` closes.
    """

    def __init__(self, predictor, host: str = "0.0.0.0", port: int = 8777,
                 dynamic_batch: bool = False, max_batch: int = 16,
                 max_wait_ms: float = 4.0, preprocess_workers: int = 0):
        self.predictor = predictor
        self.host, self.port = host, port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self.batcher = None
        self._owns_pixel_pool = False
        if preprocess_workers and hasattr(predictor, "enable_preprocess_pool"):
            # the image pipeline on a process pool: concurrent requests
            # preprocess on several cores instead of sharing one GIL
            predictor.enable_preprocess_pool(preprocess_workers)
            self._owns_pixel_pool = True
        if dynamic_batch:
            from vla_adapter_torch.serve.batching import DynamicBatcher

            self.batcher = DynamicBatcher(
                predictor, max_batch=max_batch, max_wait_ms=max_wait_ms
            )

    def handle_act(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        payload = decode_payload(payload)
        images = [np.asarray(payload["full_image"], np.uint8)]
        if payload.get("wrist_image") is not None:
            images.append(np.asarray(payload["wrist_image"], np.uint8))
        predict = (self.batcher.predict if self.batcher is not None
                   else self.predictor.predict_action)
        action = predict(
            images,
            payload["instruction"],
            proprio=payload.get("proprio"),
            unnorm_key=payload.get("unnorm_key"),
        )
        return {"action": encode_ndarray(np.asarray(action))}

    def _make_handler(server_self):
        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                if self.path.rstrip("/") != "/act":
                    self.send_error(404)
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length))
                    result = server_self.handle_act(payload)
                    body = json.dumps(result).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except Exception as e:  # noqa: BLE001
                    log.exception("act failed")
                    body = json.dumps({"error": str(e)}).encode()
                    self.send_response(500)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        return Handler

    def serve_background(self) -> int:
        """Start in a daemon thread; returns the bound port."""
        self._httpd = ThreadingHTTPServer((self.host, self.port or 0),
                                          self._make_handler())
        self.port = self._httpd.server_port
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        t.start()
        return self.port

    def serve_forever(self) -> None:
        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          self._make_handler())
        log.info("serving /act on %s:%d", self.host, self.port)
        self._httpd.serve_forever()

    def shutdown(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()  # release the listening socket fd
        if self.batcher is not None:
            self.batcher.close()
        pool = getattr(self.predictor, "_pixel_pool", None)
        if self._owns_pixel_pool and pool is not None:
            # the server created these spawn workers: leaking them across
            # create/shutdown cycles accumulates processes until the parent
            # exits
            pool.close()
            self.predictor._pixel_pool = None


def make_fastapi_app(predictor):
    """The FastAPI app of the reference's deploy.py, where fastapi is
    installed (imported here, and only here)."""
    from fastapi import FastAPI

    app = FastAPI()
    server = ActionServer(predictor)

    @app.post("/act")
    def act(payload: dict):
        return server.handle_act(payload)

    return app
