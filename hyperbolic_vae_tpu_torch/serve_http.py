"""HTTP serving front-end over the port's bucketed ``Inferencer``.

Port of ``hyperbolic_vae_tpu/serve_http.py`` with the same endpoints,
wire formats and metrics, stdlib only (``http.server``):

  * One device, many client threads: requests funnel through ONE
    dispatcher thread that owns the CUDA device, and every device call
    (``generate`` included) runs there. The dispatcher COALESCES:
    everything that queues up while a dispatch runs merges into the next
    one (CoalescingDispatcher; --no-coalesce for a plain per-request
    lock).
  * Two wire formats per endpoint: JSON (nested lists), and raw
    little-endian f32 (or f16 with ``X-Dtype: float16``) bytes with an
    ``X-Shape`` header.
  * Startup runs every (method, bucket) program once (``--no-warmup``
    skips it), so the kernels are built before the first request.

Endpoints:
  GET  /v1/health            {"status": "ok", "programs": N}
  GET  /v1/manifest          batch size, buckets, methods, shapes
  GET  /v1/metrics           per-endpoint request/row/error counters +
                             latency quantiles (JSON; add
                             ``?format=prometheus`` for text exposition)
  POST /v1/encode            posterior parameters (JSON: all outputs)
  POST /v1/embed             the on-manifold mean only (one array)
  POST /v1/decode            latents -> reconstruction
  POST /v1/reconstruct       inputs -> deterministic reconstruction
  POST /v1/generate          ``{"n": N, "seed": S}`` -> N decoded
                             latent-prior samples (seed-replayable;
                             ``Accept: application/octet-stream`` for a
                             raw-f32 reply)

Run: ``python -m hyperbolic_vae_tpu_torch.serve_http --checkpoint DIR
--name best`` (a Trainer's checkpoint directory, any model family) or
``... --state-dict FILE [--model-config JSON]`` (a state_dict of any
family, told by its keys or by ``"family"`` in the JSON where they fit
two; what it does not hold as constructor arguments, e.g. the data shape
and curvature; the reference's Lightning ``.ckpt`` with geoopt's entries
too, and ``--allow-unsafe-pickle`` for one the weights-only unpickler
refuses) or ``... --bundle DIR`` (a bundle written by
``Inferencer.export_programs`` or ``experiments/export_serving_bundle.py``,
served without the model's code; a method it lacks answers 404);
serves on the CUDA device. Image families take and
return channels-last arrays (n, H, W, C); an engine without ``generate``
(the Autoencoder, PvaeMLPVAE) answers 404 there.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np


_METHODS = ("encode", "embed", "decode", "reconstruct")


class ServerMetrics:
    """Thread-safe request counters + bounded latency reservoirs.

    Quantiles are computed over the last ``window`` observations per
    endpoint (a deque ring buffer)."""

    def __init__(self, window: int = 2048):
        self._lock = threading.Lock()
        self.started_at = time.time()
        self._window = window
        self._lat = {}
        self._requests = {}
        self._rows = {}
        self._errors = {"bad_request": 0, "inference_failed": 0}
        for m in _METHODS:
            self._ensure(m)

    def _ensure(self, endpoint: str) -> None:
        if endpoint not in self._lat:
            self._lat[endpoint] = deque(maxlen=self._window)
            self._requests[endpoint] = 0
            self._rows[endpoint] = 0

    def observe(self, endpoint: str, rows: int, seconds: float) -> None:
        with self._lock:
            self._ensure(endpoint)
            self._requests[endpoint] += 1
            self._rows[endpoint] += int(rows)
            self._lat[endpoint].append(seconds)

    def error(self, kind: str) -> None:
        with self._lock:
            self._errors[kind] += 1

    def snapshot(self) -> dict:
        with self._lock:
            endpoints = {}
            for m in self._lat:
                lat = np.asarray(self._lat[m], np.float64)
                row = {"requests": self._requests[m], "rows": self._rows[m]}
                if lat.size:
                    p50, p90, p99 = np.percentile(lat, [50, 90, 99]) * 1e3
                    row.update(
                        p50_ms=round(float(p50), 3),
                        p90_ms=round(float(p90), 3),
                        p99_ms=round(float(p99), 3),
                        window=int(lat.size),
                    )
                endpoints[m] = row
            return {
                "uptime_s": round(time.time() - self.started_at, 3),
                "endpoints": endpoints,
                "errors": dict(self._errors),
            }

    def prometheus(self, snapshot: dict) -> str:
        """Prometheus text exposition of :meth:`snapshot`."""
        lines = [
            "# TYPE hvt_uptime_seconds gauge",
            f"hvt_uptime_seconds {snapshot['uptime_s']}",
        ]
        for k in ("programs", "dispatch_groups", "requests_served"):
            if k in snapshot:
                lines += [f"# TYPE hvt_{k} gauge", f"hvt_{k} {snapshot[k]}"]
        lines.append("# TYPE hvt_requests_total counter")
        for m, row in snapshot["endpoints"].items():
            lines.append(f'hvt_requests_total{{endpoint="{m}"}} {row["requests"]}')
        lines.append("# TYPE hvt_rows_total counter")
        for m, row in snapshot["endpoints"].items():
            lines.append(f'hvt_rows_total{{endpoint="{m}"}} {row["rows"]}')
        lines.append("# TYPE hvt_latency_ms gauge")
        for m, row in snapshot["endpoints"].items():
            for q in ("p50", "p90", "p99"):
                if f"{q}_ms" in row:
                    lines.append(
                        f'hvt_latency_ms{{endpoint="{m}",quantile="{q}"}} '
                        f"{row[f'{q}_ms']}"
                    )
        lines.append("# TYPE hvt_errors_total counter")
        for k, v in snapshot["errors"].items():
            lines.append(f'hvt_errors_total{{kind="{k}"}} {v}')
        return "\n".join(lines) + "\n"


def _to_arrays(out):
    if isinstance(out, (tuple, list)):
        return [np.asarray(a) for a in out]
    return [np.asarray(out)]


def _map_outputs(f, tree):
    """Row-slice a numpy output tree (array, or tuple/list of arrays)."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(f(np.asarray(a)) for a in tree)
    return f(np.asarray(tree))


class CoalescingDispatcher:
    """Dynamic micro-batching: merge concurrent requests into one dispatch.

    A single dispatcher thread owns the device. Callers (``call(method,
    x)`` from any thread) enqueue and block on a Future. Each loop
    iteration drains everything queued, groups by (model, method, feature
    shape), concatenates each group's rows into one array, runs ONE
    padded/bucketed dispatch per group, and splits the outputs back per
    request. ``generate(n, seed)`` requests run on the same thread, one
    by one (they have no rows to merge).

    A solo request on an idle device dispatches immediately;
    ``max_wait_ms > 0`` holds the first request of a wave open for
    stragglers.
    """

    _CLOSE = object()
    _DEFAULT = "default"
    _GENERATE = "generate"

    def __init__(self, inferencer, max_wait_ms: float = 0.0):
        # single engine or a {name: engine} registry; one dispatcher
        # thread still owns the device across all models
        self.engines = (
            dict(inferencer) if isinstance(inferencer, dict)
            else {self._DEFAULT: inferencer}
        )
        self.inferencer = next(iter(self.engines.values()))
        self.max_wait_ms = float(max_wait_ms)
        self.n_dispatches = 0  # observability: device dispatch groups run
        self.n_requests = 0
        self._closed = False
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _submit(self, model, method, x):
        if self._closed:
            raise RuntimeError("dispatcher is closed")
        model = model or next(iter(self.engines))
        if model not in self.engines:
            raise KeyError(f"no model {model!r}; have {sorted(self.engines)}")
        fut: Future = Future()
        self._q.put((model, method, x, fut))
        if self._closed and not self._thread.is_alive():
            # raced close(): the loop may have exited before our put
            self._fail_pending()
        return fut.result()

    def call(self, method: str, x: np.ndarray, model: Optional[str] = None):
        return self._submit(model, method, np.asarray(x, np.float32))

    def generate(self, n: int, seed: int, model: Optional[str] = None) -> np.ndarray:
        return self._submit(model, self._GENERATE, (int(n), int(seed)))

    def close(self):
        # flag first so new call()s fail fast; the loop then fails any
        # request that raced the sentinel into the queue
        self._closed = True
        self._q.put(self._CLOSE)
        self._thread.join(timeout=10)
        self._fail_pending()

    def _fail_pending(self):
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is not self._CLOSE and not item[-1].done():
                item[-1].set_exception(RuntimeError("dispatcher is closed"))

    # ------------------------------------------------------------------ #

    def _drain(self, first):
        """first + everything already queued (+ a max_wait_ms grace)."""
        batch = [first]
        deadline = (
            time.monotonic() + self.max_wait_ms / 1e3 if self.max_wait_ms else None
        )
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                if deadline is not None and time.monotonic() < deadline:
                    time.sleep(0.0002)
                    continue
                return batch, False
            if item is self._CLOSE:
                return batch, True
            batch.append(item)

    def _run_generate(self, model, args, fut):
        self.n_dispatches += 1
        self.n_requests += 1
        try:
            fut.set_result(self.engines[model].generate(*args))
        except Exception as e:  # propagate to the caller
            fut.set_exception(e)

    def _loop(self):
        while True:
            item = self._q.get()
            if item is self._CLOSE:
                self._fail_pending()
                return
            batch, closing = self._drain(item)
            groups: dict = {}
            for model, method, x, fut in batch:
                if method == self._GENERATE:
                    self._run_generate(model, x, fut)
                    continue
                groups.setdefault((model, method, x.shape[1:]), []).append((x, fut))
            for (model, method, _), items in groups.items():
                self.n_dispatches += 1
                self.n_requests += len(items)
                try:
                    xs = [x for x, _ in items]
                    out = getattr(self.engines[model], method)(
                        np.concatenate(xs, axis=0) if len(xs) > 1 else xs[0]
                    )
                    offs = np.cumsum([0] + [x.shape[0] for x in xs])
                    for (_, fut), s, e in zip(items, offs[:-1], offs[1:]):
                        fut.set_result(
                            _map_outputs(lambda a, s=s, e=e: a[s:e], out)
                        )
                except Exception as e:  # propagate to every caller in the group
                    for _, fut in items:
                        if not fut.done():
                            fut.set_exception(e)
            if closing:
                self._fail_pending()
                return


class InferenceServer:
    """Wrap an Inferencer in a threading HTTP server.

    ``serve_forever()`` blocks; ``start()`` runs it on a daemon thread.
    ``port=0`` picks a free port (read it back from ``server.port``).

    ``coalesce=True`` (default) routes requests through a
    CoalescingDispatcher; ``coalesce=False`` uses a plain lock (one
    dispatch per request, strictly serialized).

    A ``{name: Inferencer}`` dict serves a model registry: the first entry
    is the default behind ``/v1/<method>``; every model also answers
    ``/v1/models/<name>/<method>``; ``GET /v1/models`` lists manifests.
    """

    def __init__(self, inferencer, host: str = "127.0.0.1", port: int = 8000,
                 coalesce: bool = True, max_wait_ms: float = 0.0,
                 max_generate_rows: int = 65536):
        self.engines = (
            dict(inferencer) if isinstance(inferencer, dict)
            else {"default": inferencer}
        )
        # bounds a single /v1/generate request
        self.max_generate_rows = int(max_generate_rows)
        if not self.engines:
            raise ValueError("empty model registry")
        self.default_name = next(iter(self.engines))
        self.inferencer = self.engines[self.default_name]
        self.dispatcher = (
            CoalescingDispatcher(self.engines, max_wait_ms=max_wait_ms)
            if coalesce else None
        )
        self.metrics = ServerMetrics()
        self._device_lock = threading.Lock()
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: N802
                pass

            def _reply(self, code: int, payload: bytes, ctype: str,
                       extra: Optional[dict] = None):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                for k, v in (extra or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(payload)

            def _reply_json(self, code: int, obj):
                self._reply(code, json.dumps(obj).encode(), "application/json")

            def _counters(self, d: dict) -> dict:
                d["programs"] = sum(e.n_programs for e in server.engines.values())
                if server.dispatcher is not None:
                    d["dispatch_groups"] = server.dispatcher.n_dispatches
                    d["requests_served"] = server.dispatcher.n_requests
                return d

            def do_GET(self):  # noqa: N802
                if self.path == "/v1/health":
                    self._reply_json(200, self._counters({"status": "ok"}))
                elif self.path == "/v1/manifest":
                    self._reply_json(200, server.manifest())
                elif self.path == "/v1/models":
                    self._reply_json(
                        200,
                        {
                            "default": server.default_name,
                            "models": {
                                name: server.manifest(name)
                                for name in server.engines
                            },
                        },
                    )
                elif self.path.split("?")[0] == "/v1/metrics":
                    snap = self._counters(server.metrics.snapshot())
                    if "format=prometheus" in (self.path.split("?") + [""])[1]:
                        self._reply(
                            200, server.metrics.prometheus(snap).encode(),
                            "text/plain; version=0.0.4",
                        )
                    else:
                        self._reply_json(200, snap)
                else:
                    self._reply_json(404, {"error": f"no route {self.path}"})

            def _do_generate(self, model):
                """POST /v1/generate {"n": N, "seed": S}."""
                try:
                    n_len = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n_len) or b"{}")
                    n = int(req.get("n", server.engines[
                        model or server.default_name].batch_size))
                    seed = int(req.get("seed", 0))
                    if not 0 < n <= server.max_generate_rows:
                        raise ValueError(
                            f"n must be in [1, {server.max_generate_rows}]"
                        )
                    # validate the reply wire dtype before paying for inference
                    accept = (self.headers.get("Accept") or "").split(";")[0]
                    wd = (self.headers.get("X-Dtype") or "float32").strip()
                    if accept == "application/octet-stream" and wd not in (
                        "float32", "float16",
                    ):
                        raise ValueError(
                            f"X-Dtype must be float32 or float16, got {wd!r}"
                        )
                except Exception as e:
                    server.metrics.error("bad_request")
                    self._reply_json(400, {"error": f"bad request: {e}"})
                    return
                t_start = time.perf_counter()
                engine = server.engines[model or server.default_name]
                if not engine.supports_method("generate"):
                    server.metrics.error("bad_request")
                    self._reply_json(
                        404, {"error": "generate unavailable on this engine"},
                    )
                    return
                try:
                    if server.dispatcher is not None:
                        out = server.dispatcher.generate(n, seed, model=model)
                    else:
                        with server._device_lock:
                            out = engine.generate(n, seed)
                except Exception as e:
                    server.metrics.error("inference_failed")
                    self._reply_json(500, {"error": f"inference failed: {e}"})
                    return
                server.metrics.observe(
                    "generate" if model is None else f"{model}/generate",
                    n, time.perf_counter() - t_start,
                )
                if accept == "application/octet-stream":
                    wire = np.dtype("<f2" if wd == "float16" else "<f4")
                    a = np.ascontiguousarray(out, wire)
                    self._reply(
                        200, a.tobytes(), "application/octet-stream",
                        {"X-Shape": ",".join(str(d) for d in a.shape),
                         "X-Dtype": np.dtype(wire).name},
                    )
                else:
                    self._reply_json(200, {"outputs": [out.tolist()]})

            def do_POST(self):  # noqa: N802
                parts = self.path.strip("/").split("/")
                # /v1/<method>  |  /v1/models/<model>/<method>
                model = None
                if len(parts) == 2 and parts[0] == "v1":
                    name = parts[1]
                elif len(parts) == 4 and parts[:2] == ["v1", "models"]:
                    model, name = parts[2], parts[3]
                    if model not in server.engines:
                        self._reply_json(
                            404,
                            {"error": f"no model {model!r}; "
                             f"have {sorted(server.engines)}"},
                        )
                        return
                else:
                    name = ""
                if name == "generate":
                    self._do_generate(model)
                    return
                if name not in _METHODS:
                    self._reply_json(404, {"error": f"no route {self.path}"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(n)
                    ctype = (self.headers.get("Content-Type") or "").split(";")[0]
                    wire = np.dtype("<f4")
                    if ctype == "application/octet-stream":
                        wd = (self.headers.get("X-Dtype") or "float32").strip()
                        if wd not in ("float32", "float16"):
                            raise ValueError(
                                f"X-Dtype must be float32 or float16, got {wd!r}"
                            )
                        if wd == "float16":
                            wire = np.dtype("<f2")
                        shape = tuple(
                            int(s) for s in self.headers["X-Shape"].split(",")
                        )
                        x = np.frombuffer(body, wire).reshape(shape)
                    else:
                        x = np.asarray(json.loads(body)["data"], np.float32)
                except Exception as e:  # malformed request, not a bug
                    server.metrics.error("bad_request")
                    self._reply_json(400, {"error": f"bad request: {e}"})
                    return
                t_start = time.perf_counter()
                engine = server.engines[model or server.default_name]
                if not engine.supports_method(name):
                    server.metrics.error("bad_request")
                    self._reply_json(
                        404, {"error": f"{name} unavailable on this engine"}
                    )
                    return
                try:
                    if server.dispatcher is not None:
                        out = _to_arrays(
                            server.dispatcher.call(name, x, model=model)
                        )
                    else:
                        with server._device_lock:
                            out = _to_arrays(getattr(engine, name)(x))
                except Exception as e:
                    server.metrics.error("inference_failed")
                    self._reply_json(500, {"error": f"inference failed: {e}"})
                    return
                server.metrics.observe(
                    name if model is None else f"{model}/{name}",
                    len(x), time.perf_counter() - t_start,
                )
                if ctype == "application/octet-stream":
                    a = np.ascontiguousarray(out[0], wire)
                    self._reply(
                        200, a.tobytes(), "application/octet-stream",
                        {"X-Shape": ",".join(str(d) for d in a.shape),
                         "X-Dtype": np.dtype(wire).name},
                    )
                else:
                    self._reply_json(200, {"outputs": [a.tolist() for a in out]})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def manifest(self, name: Optional[str] = None) -> dict:
        inf = self.engines[name or self.default_name]
        # a bundle has only what was exported
        m = getattr(inf, "_manifest", None)
        return {
            "batch_size": inf.batch_size,
            "max_batches_per_dispatch": inf.max_batches_per_dispatch,
            "buckets": list(inf._buckets),
            "row_buckets": list(inf._row_buckets),
            "io_dtype": (None if inf.io_dtype is None
                         else str(inf.io_dtype).removeprefix("torch.")),
            "methods": (list(m["methods"]) if m else list(_METHODS)
                        + (["generate"] if inf.supports_method("generate") else [])),
            "data_shape": list(inf._data_shape()),
        }

    def start(self) -> "InferenceServer":
        self._serving = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def serve_forever(self):
        self._serving = True
        self._httpd.serve_forever()

    def shutdown(self):
        # BaseServer.shutdown blocks on an event only serve_forever sets:
        # calling it when the serve loop never started would deadlock
        if getattr(self, "_serving", False):
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
        if self.dispatcher is not None:
            self.dispatcher.close()


def parse_args(argv: Optional[list] = None):
    """The CLI's arguments: exactly one of ``--checkpoint DIR`` (with
    ``--name``), ``--state-dict FILE`` and ``--bundle DIR``."""
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--checkpoint", help="a Trainer's checkpoint_dir (any model family)")
    src.add_argument("--state-dict",
                     help="a state_dict (.npz from experiments/export_torch_state_dict.py, .pt, "
                          "or the reference's Lightning .ckpt) of any family, told by its keys "
                          "or --model-config's family")
    src.add_argument("--bundle", help="an exported serving bundle's directory (no model code)")
    p.add_argument("--allow-unsafe-pickle", action="store_true",
                   help="with a state_dict file the weights-only unpickler refuses: full pickle, "
                        "which EXECUTES code embedded in the file (only for your own files)")
    p.add_argument("--model-config", default="{}", metavar="JSON",
                   help="with --state-dict: what a state_dict does not hold, as the "
                        "model's constructor arguments, e.g. '{\"data_shape\": [32, 32, 1], "
                        "\"manifold_curvature\": 1.4}', and \"family\" (e.g. "
                        "\"PvaeMLPVAE\") where the keys fit two families")
    p.add_argument("--name", default="best",
                   help="checkpoint name with --checkpoint (best/last/ema)")
    p.add_argument(
        "--also", action="append", default=[], metavar="MODEL=SOURCE",
        help="serve an extra model from the same process under "
             "/v1/models/MODEL/... (repeatable); SOURCE is CKPT_DIR[:NAME] "
             "or a state_dict file",
    )
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--max-batches-per-dispatch", type=int, default=16)
    p.add_argument("--io-dtype", default=None, choices=["float16", "bfloat16"],
                   help="half-precision host<->device wire format for "
                        "data-shaped arrays (Inferencer io_dtype)")
    p.add_argument("--no-sub-batch-buckets", action="store_true",
                   help="pad every request to full batches (disable the "
                        "power-of-two row buckets for small requests)")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip running every (method, bucket) program at startup")
    p.add_argument("--no-coalesce", action="store_true",
                   help="one dispatch per request (disable micro-batching)")
    p.add_argument("--max-wait-ms", type=float, default=0.0,
                   help="hold the first request of a wave open this long "
                        "for stragglers (0 = opportunistic drain only)")
    return p.parse_args(argv)


def load_engines(args, device=None) -> dict:
    """The engines the parsed ``args`` name, by model name ("default"
    first), on ``device`` (default ``cuda``)."""
    from pathlib import Path

    from hyperbolic_vae_tpu_torch.serve import Inferencer

    kw = dict(batch_size=args.batch_size,
              max_batches_per_dispatch=args.max_batches_per_dispatch,
              io_dtype=args.io_dtype, sub_batch_buckets=not args.no_sub_batch_buckets,
              device=device)
    model_config = json.loads(args.model_config)
    unsafe = dict(allow_unsafe_pickle=args.allow_unsafe_pickle)

    def load_checkpoint_or_file(src: str):
        """CKPT_DIR[:NAME] (NAME defaults to best), or a state_dict file."""
        ckpt, _, name = src.rpartition(":")
        if not (ckpt and Path(ckpt).is_dir()):
            ckpt, name = src, "best"
        if Path(ckpt).is_dir():
            return Inferencer.from_checkpoint(ckpt, name=name, **kw)
        return Inferencer.from_state_dict(src, **kw, **unsafe)

    if args.bundle:
        from hyperbolic_vae_tpu_torch.serve import ExportedInferencer

        default = ExportedInferencer.load(args.bundle, device=device)
    elif args.checkpoint:
        default = Inferencer.from_checkpoint(args.checkpoint, name=args.name, **kw)
    else:
        default = Inferencer.from_state_dict(args.state_dict, **kw, **unsafe, **model_config)
    engines = {"default": default}
    for spec in args.also:
        mname, _, src = spec.partition("=")
        if not mname or not src:
            raise SystemExit(f"--also expects MODEL=SOURCE, got {spec!r}")
        engines[mname] = load_checkpoint_or_file(src)
    return engines


def main(argv: Optional[list] = None, device=None):
    """CLI: serve a checkpoint, a state_dict or a bundle over HTTP.
    ``device`` (for callers embedding the CLI) defaults to ``cuda``."""
    from hyperbolic_vae_tpu_torch.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(device)
    engines = load_engines(args, device)
    inf = engines["default"]
    if not args.no_warmup:
        print("warming up (every method x bucket)...", flush=True)
        for e in engines.values():
            e.warmup()
    server = InferenceServer(engines, host=args.host, port=args.port,
                             coalesce=not args.no_coalesce,
                             max_wait_ms=args.max_wait_ms)
    print(f"serving on http://{server.host}:{server.port} "
          f"(batch {inf.batch_size}, buckets {inf._buckets}, "
          f"models {sorted(engines)}, device {device})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
