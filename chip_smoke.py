#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and swallowed):

  1. Device: the card's name and power limit (nvidia-smi); builds every
     CUDA kernel of the port from ``hyperbolic_vae_tpu_torch/csrc``.
  2. Kernels: each kernel against its plain PyTorch version on CUDA
     tensors at the serving path's shapes, then timed beside it with CUDA
     events at the serving batch: called from Python (median of 51 means
     of 20 back-to-back calls) and replayed from a CUDA graph (device
     time alone).
  3. Serve: the flagship GyroplaneVAE at its published width (random
     weights from a seed, carried through ``state_dict_from_jax_params``)
     behind ``Inferencer`` and ``InferenceServer`` on 127.0.0.1, answering
     real HTTP requests on synthetic MNIST. Launch counters are zeroed
     just before the requests and read just after.
  4. Summary: a ``{"kernels": [...]}`` line, then, as the last line,
     ``{"ok": true, "device": {...}}``.

Prints no result and exits 1 when CUDA is unavailable.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import urllib.request

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, f32 outside tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# flops per output of the gyroplane epilogue (den, alpha, beta, <diff,p>,
# |diff|^2 and its clamp, |p|, the ratio, arsinh counted as one, bias)
GYRO_EPILOGUE_OPS = 40

P, D = 16, 2  # the flagship's gyroplanes and latent width
BATCH = 256   # serving batch: the kernel's shape on every full batch


def _fail(msg: str) -> None:
    raise AssertionError(msg)


def _points(rng, n, c, region):
    """n points in the c-ball: norm <= 0.7 radius (interior) or in
    [0.95, 1 - 4e-3] radius (near the boundary)."""
    u = rng.normal(size=(n, D))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    lo, hi = (0.0, 0.7) if region == "interior" else (0.95, 1.0 - 4e-3)
    return (u * rng.uniform(lo, hi, size=(n, 1)) / np.sqrt(c)).astype(np.float32)


def _time_ms(fn, reps: int = 51, inner: int = 20) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back
    calls, from CUDA events, after 20 calls of warm-up. Called from
    Python, a call that launches little work is bounded by the host's
    launch cost; that is what a caller of the op pays."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _graph_ms(fn, n: int = 50) -> float:
    """Device time of one call with the host out of the way: ``n`` calls
    captured in one CUDA graph, the graph replayed and timed by
    ``_time_ms``, divided by ``n``."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    ms = _time_ms(graph.replay, reps=21, inner=5) / n
    del graph
    return ms


def kernel_phase() -> dict:
    """K1 against its plain version: B in {1, 256, 4096}, P = 16, D = 2,
    c in {0.5, 1}, signed and unsigned, with and without bias.

    Interior points: max abs error against the plain version <= 1e-5.
    Near the boundary the analytic epilogue cancels in f32 (den and
    |diff|^2 lose most of their bits), so the kernel and the plain version
    each lie up to ~3e-3 from the float64 evaluation of the same formula
    on the same inputs, and as far from each other. There the check is
    that the kernel is as accurate as the plain version: its max abs error
    against float64 is at most twice the plain f32 version's, plus 1e-5."""
    import torch

    from hyperbolic_vae_tpu_torch.ops import gyroplane as g

    rng = np.random.default_rng(0)
    err_in = err_bd = 0.0
    for b in (1, 256, 4096):
        for c in (0.5, 1.0):
            for region in ("interior", "boundary"):
                x = torch.from_numpy(_points(rng, b, c, region)).cuda()
                pts = torch.from_numpy(_points(rng, P, c, region)).cuda()
                bias = torch.from_numpy(rng.uniform(-1, 1, P).astype(np.float32)).cuda()
                for signed in (True, False):
                    for bb in (None, bias):
                        out = g.gyroplane_distances_cuda(x, pts, c, signed, bb)
                        torch.cuda.synchronize()
                        ref = g.gyroplane_distances(x, pts, c, signed, bb)
                        if out.shape != (b, P) or not torch.isfinite(out).all():
                            _fail(f"gyroplane kernel: bad output at B={b} c={c} {region}")
                        err = float((out - ref).abs().max())
                        if region == "interior":
                            err_in = max(err_in, err)
                            continue
                        err_bd = max(err_bd, err)
                        exact = g.gyroplane_distances(
                            x.double(), pts.double(), c, signed,
                            None if bb is None else bb.double())
                        k_err = float((out.double() - exact).abs().max())
                        p_err = float((ref.double() - exact).abs().max())
                        if k_err > 2.0 * p_err + 1e-5:
                            _fail(f"gyroplane kernel near boundary: err vs float64 {k_err} > "
                                  f"2 x plain's {p_err} + 1e-5 at B={b} c={c} signed={signed}")
    if err_in > 1e-5:
        _fail(f"gyroplane kernel: interior max abs err {err_in} > 1e-5")
    print(f"kernel gyroplane_distances: max_abs_err vs plain: interior {err_in:.3e}, "
          f"near boundary {err_bd:.3e}", flush=True)

    # timing at the serving batch, as the decoder calls it (signed, bias),
    # in turns: plain, kernel, kernel, plain
    x = torch.from_numpy(_points(rng, BATCH, 1.0, "interior")).cuda()
    pts = torch.from_numpy(_points(rng, P, 1.0, "interior")).cuda()
    bias = torch.from_numpy(rng.uniform(-1, 1, P).astype(np.float32)).cuda()

    def kernel():
        return g.gyroplane_distances_cuda(x, pts, 1.0, True, bias)

    def plain():
        return g.gyroplane_distances(x, pts, 1.0, True, bias)

    plain_a, ms_a, ms_b, plain_b = (_time_ms(f) for f in (plain, kernel, kernel, plain))
    ms, plain_ms = (ms_a + ms_b) / 2, (plain_a + plain_b) / 2
    graph_ms, plain_graph_ms = _graph_ms(kernel), _graph_ms(plain)
    n_bytes = 4 * (BATCH * D + P * D + P + BATCH * P)
    n_ops = BATCH * P * (2 * D + GYRO_EPILOGUE_OPS) + 2 * D * (BATCH + P)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_FLOP_PER_S * 1e3
    print(f"kernel gyroplane_distances at B={BATCH}: called from Python {ms_a:.5f} ms, "
          f"{ms_b:.5f} ms; plain {plain_a:.5f} ms, {plain_b:.5f} ms; replayed from a "
          f"CUDA graph {graph_ms:.5f} ms, plain {plain_graph_ms:.5f} ms; "
          f"{n_bytes} bytes, {n_ops} flops", flush=True)
    return {
        "name": "gyroplane_distances",
        "route": "cuda",
        "source": "hyperbolic_vae_tpu_torch/csrc/gyroplane.cu",
        "replaces": "hyperbolic_vae_tpu/ops/gyroplane.py:187",
        "max_abs_err": err_in,
        "max_abs_err_boundary": err_bd,
        "ms": ms,
        "kernel_ms": ms,
        "graph_ms": graph_ms,
        "plain_graph_ms": plain_graph_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        # no single PyTorch call computes gyroplane distances
        "library_ms": None,
    }


def _jax_tree(sd) -> dict:
    """The JAX flagship's parameter names for a port state_dict, as numpy
    (kernels (in, out)): the input ``state_dict_from_jax_params`` takes."""
    def lin(k):
        return {"kernel": sd[f"{k}.weight"].cpu().numpy().T, "bias": sd[f"{k}.bias"].cpu().numpy()}

    return {
        "enc_0": lin("encoder.1"), "enc_1": lin("encoder.3"),
        "mu": lin("mu.0"), "scale": lin("scale.0"),
        "gyroplanes": {"mp_points": sd["decoder.0.points"].cpu().numpy(),
                       "bias": sd["decoder.0.bias"].cpu().numpy()},
        "dec_0": lin("decoder.2"), "out": lin("decoder.4"),
    }


def _http(server, path, body=None, headers=None):
    req = urllib.request.Request(f"http://{server.host}:{server.port}{path}",
                                 data=body, headers=headers or {})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as r:
        payload, hdrs = r.read(), r.headers
    return hdrs, payload, (time.perf_counter() - t0) * 1e3


def serve_phase() -> dict:
    """The flagship over HTTP on the card. Returns launches per kernel."""
    import torch

    from hyperbolic_vae_tpu_torch.data import synthetic_mnist_arrays
    from hyperbolic_vae_tpu_torch.interop import (
        gyroplane_vae_from_state_dict,
        state_dict_from_jax_params,
    )
    from hyperbolic_vae_tpu_torch.models import GyroplaneVAE
    from hyperbolic_vae_tpu_torch.ops import gyroplane as g
    from hyperbolic_vae_tpu_torch.serve import Inferencer
    from hyperbolic_vae_tpu_torch.serve_http import InferenceServer

    seeded = GyroplaneVAE(generator=torch.Generator().manual_seed(0))
    sd = state_dict_from_jax_params(_jax_tree(seeded.state_dict()))
    model = gyroplane_vae_from_state_dict(sd)
    for k, v in seeded.state_dict().items():
        if not torch.equal(v, model.state_dict()[k]):
            _fail(f"weights changed carrying {k} through state_dict_from_jax_params")
    c = model.manifold_curvature
    inf = Inferencer(model, batch_size=BATCH, max_batches_per_dispatch=16)
    t0 = time.perf_counter()
    inf.warmup()
    torch.cuda.synchronize()
    print(f"serve: warmup {time.perf_counter() - t0:.3f} s, {inf.n_programs} programs", flush=True)
    x = synthetic_mnist_arrays(n_train=2048, n_test=1, seed=0)[0]
    z = np.random.default_rng(1).uniform(-0.6, 0.6, size=(64, 2)).astype(np.float32)
    server = InferenceServer(inf, host="127.0.0.1", port=0).start()
    lat = {}
    try:
        g.launches.reset()
        _, body, lat["GET /v1/health"] = _http(server, "/v1/health")
        if json.loads(body)["status"] != "ok":
            _fail("health not ok")
        jhdr = {"Content-Type": "application/json"}
        _, body, lat["POST /v1/embed 1 row json"] = _http(
            server, "/v1/embed", json.dumps({"data": x[:1].tolist()}).encode(), jhdr)
        emb = np.asarray(json.loads(body)["outputs"][0], np.float32)
        _, body, lat["POST /v1/reconstruct 300 rows json"] = _http(
            server, "/v1/reconstruct", json.dumps({"data": x[:300].tolist()}).encode(), jhdr)
        rec300 = np.asarray(json.loads(body)["outputs"][0], np.float32)
        xr = np.ascontiguousarray(x[:2048], "<f4")
        h, body, lat["POST /v1/reconstruct 2048 rows octet-stream"] = _http(
            server, "/v1/reconstruct", xr.tobytes(),
            {"Content-Type": "application/octet-stream", "X-Shape": ",".join(map(str, xr.shape))})
        rec2048 = np.frombuffer(body, "<f4").reshape(tuple(int(s) for s in h["X-Shape"].split(",")))
        _, body, lat["POST /v1/decode 64 latents json"] = _http(
            server, "/v1/decode", json.dumps({"data": z.tolist()}).encode(), jhdr)
        dec = np.asarray(json.loads(body)["outputs"][0], np.float32)
        gens = []
        for i in range(2):
            _, body, lat[f"POST /v1/generate n=512 seed=3 ({i + 1})"] = _http(
                server, "/v1/generate", json.dumps({"n": 512, "seed": 3}).encode(), jhdr)
            gens.append(np.asarray(json.loads(body)["outputs"][0], np.float32))
        _, body, lat["GET /v1/metrics"] = _http(server, "/v1/metrics")
        metrics = json.loads(body)
        launches = {"gyroplane_distances": g.launches.count}
    finally:
        server.shutdown()
    for name, ms in lat.items():
        print(f"latency {name}: {ms:.3f} ms", flush=True)
    print(f"serve metrics: {json.dumps(metrics)}", flush=True)

    for name, a, shape in (("embed", emb, (1, 2)), ("reconstruct 300", rec300, (300, 28, 28, 1)),
                           ("reconstruct 2048", rec2048, (2048, 28, 28, 1)),
                           ("decode", dec, (64, 28, 28, 1)), ("generate", gens[0], (512, 28, 28, 1))):
        if a.shape != shape or not np.all(np.isfinite(a)):
            _fail(f"{name}: shape {a.shape} (want {shape}) or non-finite values")
    max_norm = (1.0 - 4e-3) / np.sqrt(c)
    if not np.all(np.linalg.norm(emb, axis=-1) <= max_norm * (1 + 1e-6)):
        _fail("embedding outside the ball")
    if not np.array_equal(gens[0], gens[1]):
        _fail("generate(n=512, seed=3) differs between two requests")
    # the same weights on the CPU, plain path: pixel probabilities within
    # 1e-4 (f32 matmul summation order differs between cuBLAS and the CPU)
    cpu = Inferencer(gyroplane_vae_from_state_dict(sd, device="cpu"), batch_size=BATCH,
                     max_batches_per_dispatch=16, device="cpu")
    err = float(np.abs(cpu.reconstruct(x[:300]) - rec300).max())
    print(f"serve: reconstruct 300 rows, card vs CPU max abs err {err:.3e}", flush=True)
    if err > 1e-4:
        _fail(f"reconstruct on the card differs from the CPU by {err}")
    # one K1 launch per decoded batch: 2 + 8 (reconstruct 300, 2048 rows),
    # 1 (decode 64), 2 x 2 (generate 512 twice); embed decodes nothing
    if launches["gyroplane_distances"] != 15:
        _fail(f"gyroplane kernel launched {launches['gyroplane_distances']} times, want 15")
    print(f"serve: launches {json.dumps(launches)}", flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card",
              file=sys.stderr)
        return 1
    from hyperbolic_vae_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(card, flush=True)  # name, power limit: as nvidia-smi gives them
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    for name in ("gyroplane",):
        _build.load_library(name)
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for name, (secs, log) in _build.build_log.items():
        print(f"build {name}: nvcc {secs:.2f} s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {line.strip()}", flush=True)

    kernels = [kernel_phase()]
    launches = serve_phase()
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
