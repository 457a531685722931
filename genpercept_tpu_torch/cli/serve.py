"""HTTP inference server on PyTorch.

    python -m genpercept_tpu_torch.cli.serve --checkpoint /path/to/ckpt \
        --mode depth --port 8000 [--bf16] [--device cuda]

Counterpart of ``genpercept_tpu/cli/serve.py``, with the same flags (and
``--device``), endpoints, formats and replies:
  GET  /healthz           -> {"status": "ok", "mode": ..., "platform": "cuda"|"cpu"}
  POST /v1/infer          body: PNG/JPEG bytes (Content-Type image/*)
                          query: ?format=npy|png16|png|colored (default npy)
                          -> prediction as requested binary
  POST /v1/infer_json     body: {"image_b64": ...} -> {"pred_b64", "shape",
                          "dtype", "latency_ms"}
A failed request gets a 500 with {"error": ...}.

A worker thread owns each pipeline and serializes its device work; the HTTP
threads decode and encode. The worker launches on its thread's current CUDA
stream, which is the one the kernel wrappers read
(``ops/_dispatch.py::stream_handle``). Requests queued when a worker frees
up, up to ``--max_batch``, fuse into one ``GenPerceptPipeline.batch`` call
on the genpercept arch; the marigold and rgb_blending archs serve one
request at a time through ``__call__``, which draws marigold's noise
(``.batch`` runs without it). ``--data_parallel`` puts one pipeline and one
worker on each visible GPU, all draining one queue. The kernels' launch
counters are plain attributes, not exact when several workers launch at
once. Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import io
import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GenPercept inference server (PyTorch)")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--base_ckpt_dir", default=None,
                   help="SD2.1 base checkpoint for unet-only "
                        "checkpoints (default: $BASE_CKPT_DIR)")
    p.add_argument("--mode", default="depth",
                   choices=["depth", "normal", "matting", "dis", "seg",
                            "disparity", "disparity_dpt_head"])
    p.add_argument("--archs", default="genpercept",
                   choices=["genpercept", "rgb_blending", "marigold"])
    p.add_argument("--processing_res", type=int, default=768)
    p.add_argument("--half_precision", "--bf16", action="store_true")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--data_parallel", action="store_true",
                   help="one pipeline and one worker per visible GPU, all "
                        "draining one request queue")
    p.add_argument("--max_batch", type=int, default=16,
                   help="max queued requests fused into one device batch "
                        "(genpercept arch)")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    return p


class _Job:
    __slots__ = ("image", "event", "result", "error")

    def __init__(self, image: np.ndarray):
        self.image = image
        self.event = threading.Event()
        self.result = None
        self.error: str | None = None


class InferenceWorker:
    """One consumer thread per pipeline, all on one queue: each serializes
    its pipeline's device work, while request handling (decode/encode) stays
    on the HTTP threads.

    max_batch > 1 turns on micro-batching: the requests queued at the moment
    a worker frees up (up to max_batch) fuse into one
    ``GenPerceptPipeline.batch`` call, on the genpercept arch only."""

    def __init__(self, pipes, max_batch: int = 1):
        self.pipes = list(pipes) if isinstance(pipes, (list, tuple)) else [pipes]
        self.max_batch = max(1, max_batch)
        self.q: "queue.Queue[_Job]" = queue.Queue()
        self.threads = [threading.Thread(target=self._run, args=(pipe,), daemon=True)
                        for pipe in self.pipes]
        for t in self.threads:
            t.start()

    def _drain(self, limit: int) -> list | None:
        """The next jobs, up to ``limit``; None when the worker is closing."""
        jobs = [self.q.get()]
        if jobs[0] is None:
            return None
        while len(jobs) < limit:
            try:
                job = self.q.get_nowait()
            except queue.Empty:
                break
            if job is None:  # leave the stop for a thread to take alone
                self.q.put(None)
                break
            jobs.append(job)
        return jobs

    def _run(self, pipe):
        import torch

        device = pipe.device
        ctx = torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
        limit = self.max_batch if pipe.cfg.arch == "genpercept" else 1
        with ctx:
            while (jobs := self._drain(limit)) is not None:
                try:
                    if len(jobs) == 1:
                        jobs[0].result = pipe(jobs[0].image)
                    else:
                        for j, out in zip(jobs, pipe.batch([j.image for j in jobs])):
                            j.result = out
                except Exception as e:  # noqa: BLE001 — surfaced per request
                    for j in jobs:
                        j.error = f"{type(e).__name__}: {e}"
                finally:
                    for j in jobs:
                        j.event.set()

    def close(self) -> None:
        """Stop every worker thread once the jobs queued before are done."""
        for _ in self.threads:
            self.q.put(None)
        for t in self.threads:
            t.join()

    def infer(self, image: np.ndarray, timeout: float = 600.0):
        job = _Job(image)
        self.q.put(job)
        if not job.event.wait(timeout):
            raise TimeoutError("inference timed out")
        if job.error is not None:
            raise RuntimeError(job.error)
        return job.result


def _encode_pred(out, fmt: str, mode: str) -> tuple[bytes, str]:
    """Prediction -> (payload bytes, content type)."""
    from PIL import Image

    if fmt == "npy":
        buf = io.BytesIO()
        np.save(buf, out.pred_np)
        return buf.getvalue(), "application/octet-stream"
    if fmt == "png16":
        png = (np.clip(out.pred_np, 0, 1) * 65535.0).astype(np.uint16)
        buf = io.BytesIO()
        Image.fromarray(png).save(buf, format="PNG")  # uint16 is mode I;16
        return buf.getvalue(), "image/png"
    if fmt == "png":
        arr = np.clip(out.pred_np, 0, 1)
        png = (arr * 255.0).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(png).save(buf, format="PNG")
        return buf.getvalue(), "image/png"
    if fmt == "colored":
        if out.pred_colored is None:
            raise ValueError(f"no colorized output for mode={mode}")
        buf = io.BytesIO()
        Image.fromarray(out.pred_colored).save(buf, format="PNG")
        return buf.getvalue(), "image/png"
    raise ValueError(f"unknown format {fmt!r}")


def make_handler(worker: InferenceWorker, mode: str, platform: str):
    from PIL import Image

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route through logging
            logging.info("%s - %s", self.address_string(), fmt % args)

        def _reply(self, code: int, payload: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def _reply_json(self, code: int, obj):
            self._reply(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path == "/healthz":
                self._reply_json(200, {"status": "ok", "mode": mode,
                                       "platform": platform})
            else:
                self._reply_json(404, {"error": "not found"})

        def _read_body(self) -> bytes:
            n = int(self.headers.get("Content-Length", "0"))
            return self.rfile.read(n)

        def do_POST(self):
            t0 = time.perf_counter()
            path, _, query = self.path.partition("?")
            try:
                if path == "/v1/infer":
                    img = Image.open(io.BytesIO(self._read_body())).convert("RGB")
                    fmt = "npy"
                    for kv in query.split("&"):
                        if kv.startswith("format="):
                            fmt = kv.split("=", 1)[1]
                    out = worker.infer(np.asarray(img))
                    payload, ctype = _encode_pred(out, fmt, mode)
                    self._reply(200, payload, ctype)
                elif path == "/v1/infer_json":
                    req = json.loads(self._read_body())
                    img = Image.open(
                        io.BytesIO(base64.b64decode(req["image_b64"]))
                    ).convert("RGB")
                    out = worker.infer(np.asarray(img))
                    pred = np.asarray(out.pred_np, np.float32)
                    self._reply_json(200, {
                        "pred_b64": base64.b64encode(pred.tobytes()).decode(),
                        "shape": list(pred.shape),
                        "dtype": "float32",
                        "latency_ms": round((time.perf_counter() - t0) * 1e3, 1),
                    })
                else:
                    self._reply_json(404, {"error": "not found"})
            except Exception as e:  # noqa: BLE001 — per-request error reply
                logging.exception("request failed")
                self._reply_json(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def _devices(args) -> list:
    """The devices the server runs on: every visible GPU with
    --data_parallel on the card, else --device alone."""
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the server runs on the card by default and no CUDA device is "
                           "available; pass --device cpu to run on the CPU")
    if device.type == "cuda" and device.index is None and args.data_parallel:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def make_server(args, pipe=None) -> ThreadingHTTPServer:
    """Build the HTTP server. ``pipe`` (a pipeline or a list of them, one
    worker each) is injectable for tests; otherwise the checkpoint is loaded
    once per device. The server's ``worker`` holds the pipelines."""
    import torch

    if pipe is None:
        from genpercept_tpu_torch.io.checkpoints import load_genpercept_checkpoint
        from genpercept_tpu_torch.pipeline import GenPerceptPipeline, PipelineConfig

        dtype = torch.bfloat16 if args.half_precision else torch.float32
        cfg = PipelineConfig(mode=args.mode, arch=args.archs,
                             processing_res=args.processing_res, dtype=dtype)
        pipe = [GenPerceptPipeline(
                    load_genpercept_checkpoint(args.checkpoint, dtype=dtype,
                                               base_ckpt_dir=args.base_ckpt_dir, device=d),
                    cfg, device=d)
                for d in _devices(args)]
    worker = InferenceWorker(pipe, max_batch=getattr(args, "max_batch", 1))
    platform = worker.pipes[0].device.type
    server = ThreadingHTTPServer((args.host, args.port),
                                 make_handler(worker, args.mode, platform))
    server.worker = worker
    return server


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    server = make_server(args)
    logging.info(f"serving mode={args.mode} on http://{args.host}:{server.server_address[1]}")
    server.serve_forever()


if __name__ == "__main__":
    main()
