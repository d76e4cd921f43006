"""Persistent HTTP serving daemon with micro-batching (counterpart of
``alg_tpu/http_serving.py``).

A long-lived process keeps the pipeline on the device, so the checkpoint's
load is paid once and every request afterwards costs its generation alone.

* **Micro-batches at their real size.** One worker thread drains the queue:
  it blocks for the first request, waits up to ``batch_window`` seconds for
  up to ``max_batch - 1`` more, and runs them through one
  :func:`alg_tpu_torch.serving.serve_batch` call. ``alg_tpu`` pads every
  micro-batch to ``max_batch`` so that XLA compiles one shape; PyTorch runs
  any batch size without a compile, so the port runs each micro-batch as it
  is and spends no device time on padding rows. Per-request seeds keep each
  output the one its request would get in any batch of the same size.
  HunyuanVideo's size bucket comes from each micro-batch's first image.
* **One device owner.** HTTP threads only enqueue and wait; all device work
  happens on the worker, one ``serve_batch`` at a time.

Protocol (JSON over HTTP, standard library only):

* ``GET /healthz`` -> ``{"ok": true, "family": ..., "queue_depth": n,
  "max_batch": k, "served": m}``
* ``POST /generate`` with ``{"prompt": str, "image_b64": str |
  "image_path": str, "negative_prompt": str?, "seed": int?,
  "last_image_b64" / "last_image_path": ...?}`` -> blocks until the video is
  made -> ``{"video_b64": str, "container": "mp4" | "avi" | "gif",
  "num_frames": int, "seed": int}``. ``image_b64`` is the base64 of an image
  FILE (png or jpeg bytes), opened with PIL. A bad body gives 400, an unknown
  path 404, a failed generation 500.

Start it with ``alg-tpu-torch-serve --config ... --listen 8000 [--max_batch
4 --batch_window 0.2]``.

Over a device mesh (``torchrun`` with ``--dp/--sp/--tp``) rank 0 serves
HTTP: its worker broadcasts each micro-batch and its keywords to every rank
(``broadcast_object_list``), and the other ranks run :func:`follow`, so all
ranks enter each ``serve_batch`` together. Under dp a micro-batch is padded
to a multiple of dp with copies of its last request, whose videos are
dropped.
"""

from __future__ import annotations

import base64
import io
import json
import logging
import os
import queue
import tempfile
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)


def _image_from_request(obj: Dict[str, Any], key: str):
    """PIL image from ``{key}_b64`` (base64 of an image file) or ``{key}_path``."""
    b64, path = obj.get(f"{key}_b64"), obj.get(f"{key}_path")
    if b64 is None and path is None:
        return None
    from PIL import Image

    return Image.open(io.BytesIO(base64.b64decode(b64)) if b64 is not None else path).convert("RGB")


@dataclass
class _Pending:
    request: Any  # serving.BatchRequest
    done: threading.Event = field(default_factory=threading.Event)
    result: Any = None  # the request's frames on success
    error: Optional[str] = None


class BatchingWorker(threading.Thread):
    """The device-owning thread: drains the queue into micro-batches of at
    most ``max_batch`` requests and runs each at its real size.
    ``batches`` lists the size of each micro-batch run, in order."""

    def __init__(self, pipeline, gen_kwargs, *, max_batch: int = 1, batch_window: float = 0.2,
                 hunyuan_resolution=None, mesh=None):
        super().__init__(daemon=True, name="alg-tpu-torch-batcher")
        self.pipeline = pipeline
        self.gen_kwargs = dict(gen_kwargs)
        self.max_batch = max(1, int(max_batch))
        self.batch_window = float(batch_window)
        self.hunyuan_resolution = hunyuan_resolution
        self.mesh = mesh
        self.queue: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self.served = 0
        self.batches = []
        self._stopping = threading.Event()  # not _stop: Thread.join calls its own _stop()

    def submit(self, request) -> _Pending:
        p = _Pending(request)
        self.queue.put(p)
        return p

    def shutdown(self):
        self._stopping.set()
        self.queue.put(None)  # unblock the drain loop

    def _serve(self, requests, kw):
        """``serve_batch`` on this rank, after handing the micro-batch to the
        mesh's other ranks (padded to a multiple of dp)."""
        from alg_tpu_torch.serving import serve_batch

        if self.mesh is None:
            return serve_batch(self.pipeline, requests, **kw)
        n, dp = len(requests), self.mesh.size("dp")
        padded = requests + [requests[-1]] * (-n % dp)
        _broadcast((padded, kw), self.mesh)
        return serve_batch(self.pipeline, padded, **kw)[:n]

    # -- internals ----------------------------------------------------------

    def _drain_batch(self):
        """Block for one request, then collect up to ``max_batch`` within the window."""
        first = self.queue.get()
        if first is None:
            return []
        batch = [first]
        deadline = time.monotonic() + self.batch_window
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self.queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                break
            batch.append(nxt)
        return batch

    def _gen_kwargs_for(self, batch):
        kw = dict(self.gen_kwargs)
        if self.hunyuan_resolution is not None:  # one micro-batch, one shape: the first image's bucket
            from alg_tpu_torch.serving import hunyuan_size

            kw["height"], kw["width"] = hunyuan_size(self.hunyuan_resolution, batch[0].request.image)
        return kw

    def run(self):
        if self.mesh is not None and self.mesh.device.type == "cuda":
            import torch

            torch.cuda.set_device(self.mesh.device)  # a thread starts on card 0
        try:
            self._loop()
        finally:
            if self.mesh is not None:
                _broadcast(None, self.mesh)  # the followers stop

    def _loop(self):
        while not self._stopping.is_set():
            batch = self._drain_batch()
            if not batch:
                continue
            n = len(batch)
            try:
                videos = self._serve([p.request for p in batch], self._gen_kwargs_for(batch))
                self.batches.append(n)
                for p, frames in zip(batch, videos):
                    p.result = frames
                    p.done.set()
                self.served += n
            except Exception as exc:  # surface the failure to every waiter
                logger.exception("micro-batch of %d failed", n)
                for p in batch:
                    p.error = f"{type(exc).__name__}: {exc}"
                    p.done.set()


def _broadcast(obj, mesh):
    """``obj`` from rank 0 to every rank of the default group; returns it."""
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, src=0, device=mesh.device if mesh.device.type == "cuda" else None)
    return box[0]


def follow(pipeline, mesh) -> int:
    """A rank other than 0 of a serving mesh: run each micro-batch rank 0's
    worker broadcasts, until it stops; returns the number of micro-batches."""
    from alg_tpu_torch.serving import serve_batch

    n = 0
    while True:
        item = _broadcast(None, mesh)
        if item is None:
            return n
        requests, kw = item
        try:
            serve_batch(pipeline, requests, **kw)
        except Exception:  # rank 0 reports the failure to its clients
            logger.exception("micro-batch of %d failed on rank %d", len(requests), mesh.rank)
        n += 1


def _encode_video_bytes(frames, fps: int):
    """frames -> (container bytes, container name) through ``io.video.write_video``."""
    from alg_tpu_torch.io.video import write_video

    with tempfile.TemporaryDirectory() as td:
        out = write_video(os.path.join(td, "out.mp4"), frames, fps=fps)
        with open(out, "rb") as f:
            data = f.read()
        return data, os.path.splitext(out)[1].lstrip(".")


def make_handler(worker: BatchingWorker, fps: int, family: str):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # through logging, not stderr
            logger.info("%s - %s", self.address_string(), fmt % args)

        def _json(self, code: int, obj: Dict[str, Any]):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True, "family": family, "queue_depth": worker.queue.qsize(),
                                 "max_batch": worker.max_batch, "served": worker.served})
            else:
                self._json(404, {"error": "unknown path (GET /healthz, POST /generate)"})

        def do_POST(self):
            if self.path != "/generate":
                self._json(404, {"error": "unknown path (GET /healthz, POST /generate)"})
                return
            try:
                from alg_tpu_torch.serving import BatchRequest

                length = int(self.headers.get("Content-Length", "0"))
                obj = json.loads(self.rfile.read(length) or b"{}")
                image = _image_from_request(obj, "image")
                if "prompt" not in obj or image is None:
                    self._json(400, {"error": "body needs 'prompt' and 'image_b64' or 'image_path'"})
                    return
                req = BatchRequest(prompt=obj["prompt"], image=image, negative_prompt=obj.get("negative_prompt"),
                                   seed=int(obj.get("seed", 42)), last_image=_image_from_request(obj, "last_image"))
            except Exception as exc:
                self._json(400, {"error": f"bad request: {exc}"})
                return
            pending = worker.submit(req)
            pending.done.wait()
            if pending.error is not None:
                self._json(500, {"error": pending.error})
                return
            data, container = _encode_video_bytes(pending.result, fps)
            self._json(200, {"video_b64": base64.b64encode(data).decode(), "container": container,
                             "num_frames": len(pending.result), "seed": req.seed})

    return Handler


def serve_http(pipeline, cfg, *, host: str = "127.0.0.1", port: int = 8000, max_batch: int = 1,
               batch_window: float = 0.2, mesh=None) -> ThreadingHTTPServer:
    """Build and return the bound server (call ``serve_forever`` to run it).
    ``cfg``: a :class:`alg_tpu_torch.core.config.RunConfig`; the generation
    and ALG keywords and the fps come from it, as in the batch entry point.
    ``mesh``: the sharded pipeline's mesh, on rank 0 (the other ranks run
    :func:`follow`)."""
    gen_kwargs = dict(cfg.pipeline_kwargs)
    hunyuan_resolution = None
    if cfg.family == "hunyuan" and "resolution" in (cfg.video or {}):
        hunyuan_resolution = cfg.video["resolution"]
        gen_kwargs.pop("height", None)
        gen_kwargs.pop("width", None)
    worker = BatchingWorker(pipeline, gen_kwargs, max_batch=max_batch, batch_window=batch_window,
                            hunyuan_resolution=hunyuan_resolution, mesh=mesh)
    worker.start()
    handler = make_handler(worker, fps=int(cfg.video["fps"]), family=cfg.family)
    server = ThreadingHTTPServer((host, port), handler)
    server.alg_worker = worker  # for tests and a clean shutdown
    logger.info("Serving %s on http://%s:%d (max_batch=%d, window=%.2fs)", cfg.family, *server.server_address[:2],
                max_batch, batch_window)
    return server
