#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and swallowed):

  1. Device: the card's name and power limit (nvidia-smi); builds every
     CUDA kernel of the port from ``hyperbolic_vae_tpu_torch/csrc``, one
     nvcc per source, all started together; the registers of each kernel;
     K2's and K3's rows kernels' shared memory against the wrapper's bound
     and how many of their clusters the card holds at once.
  2. Kernels: each kernel against its plain PyTorch version on CUDA
     tensors at its path's shapes, then timed beside it with CUDA events
     at the path's batch (K1 also at the IWAE decode's 128,000 rows):
     called from Python (median of 51 means of 20
     back-to-back calls; a plain version over a millisecond a call, of 11
     means of 3) and replayed from a CUDA graph (device time alone; for
     K2 and K3 also per internal kernel, from torch.profiler).
     K1 (gyroplane distances, beside an empty kernel of its launch shape:
     the launch floor), K2 (the fused forward + ELBO) and K3 (the whole
     training step, lr read from device memory).
  3. Serve: the flagship GyroplaneVAE at its published width (random
     weights from a seed, carried through ``state_dict_from_jax_params``)
     behind ``Inferencer`` and ``InferenceServer`` on 127.0.0.1, answering
     real HTTP requests on synthetic MNIST.
  4. Train, at the flagship's published width on synthetic MNIST
     (54,000 train and 6,000 val rows, batch 256): (a) five steps of the
     fused loss, backward and RiemannianAdam, and (a3) five K3 steps, on
     the card against the same steps on the CPU; then ``Trainer.fit``,
     whose chunk program runs as CUDA graphs, on each path: two epochs of
     the fused ``loss_fn`` (K2 in every step and val batch), two of K3
     (``train_step_fn``; K2 for val), one of the default path (K1 in every
     decoder forward), each against the eager run of the same program
     (bit for bit), with wall time, device busy time and idle share a
     step (torch.profiler) of both; (f) five K3 epochs in one chunk
     (K = 5) against K = 1 and the eager run, with the in-graph plateau
     dropping lr inside the chunk, and with a cosine lr schedule; (d) one
     eager step split into the K2 forward, the autograd backward and the
     optimizer, and one K3 step synchronised.
  Each path (serve, fused train, K3 train, default train, eval, the
  RNA-seq family's fits, serve and eval, the conv families', the pvae
  phase's, the interop phase's, the sweeps', the deploy phase's, the
  data-mesh phase's and the shard phase's) zeroes the launch counters
  just before it and reads
  them just after; the graph runner adds each captured kernel's launches
  on every replay.
  5. North star: the reference protocol (at most 300 epochs, patience 10,
     ReduceLROnPlateau(0.2, 20, 5e-5), lr 1e-3, batch 256) on the graphed
     K3 path with ``epochs_per_dispatch=10``; fails unless the best
     val/loss_total is within 1 % of the JAX flagship's -923.698.
  6. Eval, from the north-star fit's best params on its 10,000-row test
     split (``eval_phase``): the IWAE bound card vs CPU on host draws;
     ``evaluate_iwae(k=5000)`` (exactly 400 K1 launches, at least the
     ELBO) with its wall time and K1's device time; ``encode_split`` and
     ``evaluate_probe`` card vs CPU; ``evaluate`` under a beta warm-up
     longer than the fit; the figure callbacks' PNGs from a fit.
  7. RNA-seq (``rnaseq_phase``): ``RNASeqVAE`` at its realistic width
     (20,480 genes, hidden 256: K1 at 256 planes) on the fake Jerby-Arnon
     data (8,192 cells): K1 at 256 planes against its plain version and
     timed; five steps card vs CPU; f32, bf16 and negative-binomial fits
     graphed against eager (bit for bit), the latter's NaN-poisoned batch
     skipped; the graphed steps' wall, busy and idle share; a 20-epoch fit
     with checkpoints, served over HTTP from its best checkpoint; and
     ``evaluate_iwae(k=5000, k_chunk=100)`` (exactly 250 K1 launches, at
     least the ELBO).
  8. Conv (``conv_phase``): experiment 5's ``HyperbolicImageVAE`` (Mobius
     head, 512 gyroplanes on the c = 1.4 ball: K1 at 512 planes) on
     synthetic MNIST padded to 32 x 32, ``EuclideanVAE`` and ``Autoencoder``
     at experiments 2's and 1's widths on synthetic CIFAR-10, cuDNN
     deterministic: K1 at 512 planes, c = 1.4, against its plain version
     and timed; five steps card vs CPU; each family (and experiment 5 in
     bf16) graphed against eager, bit for bit, with the graphed step's
     wall, busy and idle share; a 6-epoch fit with checkpoints, served
     over HTTP from its best checkpoint, and the Euclidean controls from
     their own (the Autoencoder's generate 404); ``evaluate_iwae(k=5000)``
     on 1,024 test rows
     (exactly 40 K1 launches, at least the k = 1 bound).
  9. Pvae (``pvae_phase``): ``PvaeMLPVAE`` at experiment 9's protocol
     (784 -> 600 -> 2-D ball, geodesic decoder, batch 128, lr 5e-4,
     synthetic MNIST) with the wrapped and the Riemannian posterior, and
     ``UnifiedVAE`` at experiment 8's config (20,480 genes -> hidden 100:
     K1 at 100 planes, on its wide kernel; batch 64) and its Euclidean
     arm: K1 at 100 planes against its plain version and timed; five
     steps card vs CPU for the four arms; each arm graphed against eager,
     bit for bit, with the graphed step's wall, busy and idle share; the
     Riemannian posterior's 80-epoch fit (best val within 1 % of JAX's
     319.970) and ``evaluate_iwae(k=5000)`` (within 1 % of JAX's
     -320.655, at least the test ELBO); the wrapped posterior's 10-epoch
     fit served over HTTP from its best checkpoint (generate 404);
     UnifiedVAE's 6-epoch fit served from its best checkpoint and
     ``evaluate_iwae(k=5000, k_chunk=100)`` (exactly 250 K1 launches), the
     Euclidean arm's fit with none.
  10. Interop (``interop_phase``): a reference user's Lightning ``.ckpt``
     of the flagship, built here in geoopt's form (no gyroplane bias,
     ``manifold.k``, ``decoder.0.ball.k``, keys under ``model.``) from a
     seeded port model: imported bit for bit; served from the ``.ckpt``
     over HTTP (replies bit for bit the source model's, exactly 3 K1);
     ``import_torch_checkpoint``, then a 2-epoch graphed K3-path fine-tune
     (exactly 420 K3, 48 K2); ``eval_checkpoints --iwae 5000 --probe 10``
     (exactly 400 K1 in the bound, 40 in the test pass, the bound at
     least the ELBO); ``export_torch_state_dict`` equal to the source's
     export; experiments 5 (K1 at 512 planes) and 8 (K1 at 100 planes,
     20,480 genes) for 2 epochs and 1 (one latent, run twice: the second
     skips the fit), 2 and 3 for one, through their CLIs.
  11. Sweeps (``sweep_phase``): K1 at 512 planes against its plain
     version at c = 0.5 and 1.0; experiment 6's flagship as the parity
     protocol's 8 seed lanes (``Trainer.fit_ensemble``, a CUDA stream a
     lane) on the default path (3 epochs, exactly 8 x 3 x 234 K1) and on
     the K3 path (10 epochs, exactly 8 x 10 x 210 K3 and 8 x 10 x 24 K2),
     two lanes of each equal to their own fits bit for bit; aggregate
     train samples/s at S = 1, 2, 4, 8 beside sequential fits, and the
     S = 8 chunk's idle share; experiment 7's (mobius, geoopt_gyroplane)
     group as 6 curvature x beta lanes (``fit_lane_sweep``, K1 at 512
     planes, one lane equal to its fit) and ``evaluate_lanes``; experiment
     9's CLI with ``--lane-sweep`` (the bound at least the ELBO); a sweep
     stopped by ``max_wall_seconds`` and resumed, bit for bit.
  12. Deploy (``deploy_phase``): K1 through its ``torch.library`` op
     (``torch.ops.hvae_torch.gyroplane_distances``, what every decoder and
     every exported program calls) against its plain version at P = 16,
     100, 256 and 512 and equal to the ctypes call, with the host's time a
     call of each; ``RNASeqVAE`` (20,480 genes, 8,192 train cells)
     through ``Trainer.fit_streamed``: one block bit for bit ``fit``, four
     blocks of 2,048 rows under a memory limit that refuses ``fit`` (its
     remedy names ``fit_streamed``), their samples/s and the copies'
     overlap with compute, ``evaluate(stream_block_rows=1000)``; the
     flagship's K3 path streamed (one block bit for bit ``fit``, then 4);
     experiment 8's CLI with ``--stream-block-rows``; the flagship's
     bundle exported by its CLI and served in a fresh process that never
     imports the model classes, every endpoint bit for bit the live
     engine's, ``serve_http --bundle`` answering each method; a bf16
     bundle's parameters exact.
  13. Data and meshes (``data_mesh_phase``): GEO's GSE115978 layout at
     20,480 genes x 2,048 cells written from the fake factory, parsed by
     the port's C++ parser (built with g++; timed, held to Python's parse)
     and loaded by ``make_rnaseq_data_module(data_dir=...)`` with pandas
     hidden (bit for bit the written arrays' module); experiment 8's CLI
     on it with ``--use-mesh`` (K1 at 100 planes); graphed fits at world
     size 1 over NCCL (the flagship's default and K3 paths, ``RNASeqVAE``
     at 20,480 genes) bit for bit their unmeshed twins, with the NCCL
     kernels and ops a step and the step's wall beside the unmeshed one;
     experiment 6's ``--seed-mesh 1`` against the same sweep. The parquet
     splits (``data/jerby_arnon_parquet.py``) are a host path that needs
     pandas and pyarrow and does not run here.
  14. Sharding (``shard_phase``): K1 on every plane shard a 2- or 4-way
     model axis gives the gyroplane decoders (256, 100 and 16 planes, at
     B = 256 and an IWAE decode's rows), each shard bit for bit the whole
     launch's columns and held to the plain version, with its path, graph
     time, launch floor and bound; graphed RNASeqVAE fits at 20,480 genes
     under the TP, FSDP and FSDP x TP layouts at world size 1 over NCCL,
     each bit for bit its unsharded twin; experiment 8's ``--tp 1 --fsdp``.
  15. Summary: a ``{"kernels": [...]}`` line (K1 four times: at the
     flagship's 16 planes, the RNA-seq family's 256, the conv family's
     512 and UnifiedVAE's 100, each counted on its own paths, the interop,
     deploy, data-mesh and shard phases' among them, each with its op
     check ``via_op``, the 16-, 256- and 100-plane entries with their
     ``plane_shards``), then, as the last line, ``{"ok": true, "device":
     {...}}``.

Prints no result and exits 1 when CUDA is unavailable.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import statistics
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, f32 outside tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# flops per output of the gyroplane epilogue (den, alpha, beta, <diff,p>,
# |diff|^2 and its clamp, |p|, the ratio, arsinh counted as one, bias)
GYRO_EPILOGUE_OPS = 40

P, D = 16, 2  # the flagship's gyroplanes and latent width
BATCH = 256   # serving and training batch: the kernels' shape on every full batch
IWAE_K, IWAE_ROWS = 500, 500 * 256  # evaluate_iwae's k_chunk; its decode, k_chunk x batch_chunk
DATA = 784    # the flagship's pixels
# K2's f32 work per row beyond the products: per pixel the sigmoid, the two
# clips and logits, softplus and the log density (~30); per hidden unit
# the bias and tanh-GELU (~10, for 64 + 16 + 16 + 64 units); the 16
# gyroplane epilogues; the latent chain and both log densities (~300)
K2_PIXEL_OPS, K2_GELU_OPS, K2_LATENT_OPS = 30, 10, 300
# K3's f32 work beyond K2's forward and the products: the backward per
# pixel (~15: the softplus, logit and sigmoid derivatives), per hidden unit
# (~15: the tanh-GELU derivative), per gyroplane epilogue (~60), the latent
# chain's backward with both log densities (~600), and per parameter
# element the finite guard's square and the Adam update (~12)
K3_PIXEL_OPS, K3_GELU_OPS, K3_GYRO_OPS, K3_LATENT_OPS, K3_ADAM_OPS = 15, 15, 60, 600, 12


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


def _capture(fn, n: int):
    """``n`` calls of fn captured in one CUDA graph (after one call on a
    side stream, which allocates what the calls reuse)."""
    import torch

    from hyperbolic_vae_tpu_torch.train.cuda_graph import no_collection

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with no_collection(), torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return graph


def _graph_ms(fn, n: int = 50) -> float:
    """Device time of one call with the host out of the way: ``n`` calls
    captured in one CUDA graph, the graph replayed and timed by
    ``_time_ms``, divided by ``n``."""
    graph = _capture(fn, n)
    ms = _time_ms(graph.replay, reps=21, inner=5) / n
    del graph
    return ms


def _in_turns(kernel, plain) -> tuple:
    """A kernel and its plain version called from Python in turns (plain,
    kernel, kernel, plain; ``_time_ms``), then each replayed from a CUDA
    graph (``_graph_ms``). A plain version over a millisecond a call (K3's
    and K2's; K1's at P = 512 and B = 128,000) is timed over 11 means of 3
    calls and a graph of 4, so that its timing stays seconds. Returns
    (plain_a, ms_a, ms_b, plain_b, graph_ms, plain_graph_ms)."""
    heavy = _time_ms(plain, reps=3, inner=2) > 1.0
    reps = dict(reps=11, inner=3) if heavy else {}
    plain_a, ms_a, ms_b, plain_b = (_time_ms(f, **(reps if f is plain else {}))
                                    for f in (plain, kernel, kernel, plain))
    return plain_a, ms_a, ms_b, plain_b, _graph_ms(kernel), _graph_ms(plain, n=4 if heavy else 50)


def _graph_split(fn, n: int = 50) -> dict:
    """Device time per call of each CUDA kernel that fn launches: torch.profiler
    over five replays of ``n`` calls captured in one CUDA graph. Kernels that
    overlap (programmatic dependent launch) each count their own span."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    graph = _capture(fn, n)
    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            graph.replay()
        torch.cuda.synchronize()
    del graph
    split = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
        if us > 0 and str(e.device_type).endswith("CUDA"):
            name = e.key.replace("(anonymous namespace)::", "").split("(")[0].split()[-1].split("::")[-1]
            split[name] = split.get(name, 0.0) + us / 1e3 / (5 * n)
    return split


def _print_split(label: str, split: dict) -> None:
    if not split:
        print(f"kernel {label}: per-kernel device time not measured (the profiler saw none)", flush=True)
        return
    print(f"kernel {label} at B={BATCH}, per internal kernel (graph replay under torch.profiler, "
          f"ms a call): " + ", ".join(f"{k} {v:.5f}" for k, v in sorted(split.items(), key=lambda kv: -kv[1])),
          flush=True)


def kernel_phase() -> dict:
    """K1 against its plain version: B in {1, 256, 4096, 128,000 (the IWAE
    decode)}, P = 16, D = 2, c in {0.5, 1, 2}, signed and unsigned, with
    and without bias.

    Interior points: max abs error against the plain version <= 1e-5.
    Near the boundary the analytic epilogue cancels in f32 (den and
    |diff|^2 lose most of their bits), so the kernel and the plain version
    each lie up to ~3e-3 from the float64 evaluation of the same formula
    on the same inputs, and as far from each other. There the check is
    that the kernel is as accurate as the plain version: its max abs error
    against float64 is at most twice the plain f32 version's, plus 1e-5.
    Then K1 is timed at the decode's batch (B = 256) and at the IWAE
    decode's (B = 128,000)."""
    rng = np.random.default_rng(0)
    err_in, err_bd = _k1_check(rng, (1, BATCH, 4096, IWAE_ROWS), P)
    print(f"kernel gyroplane_distances: max_abs_err vs plain: interior {err_in:.3e}, "
          f"near boundary {err_bd:.3e}", flush=True)
    return _k1_entry(err_in, err_bd, _k1_times(rng, BATCH), _k1_times(rng, IWAE_ROWS))


def _k1_entry(err_in: float, err_bd: float, at_batch: dict, at_iwae: dict) -> dict:
    """K1's entry of the ``{"kernels": [...]}`` line: its errors against
    the plain version (``_k1_check``) and its times at the model's batch
    and at the IWAE decode's (``_k1_times``)."""
    return {
        "name": "gyroplane_distances",
        "route": "cuda",
        "source": "hyperbolic_vae_tpu_torch/csrc/gyroplane.cu",
        "replaces": "hyperbolic_vae_tpu/ops/gyroplane.py:187",
        "max_abs_err": err_in,
        "max_abs_err_boundary": err_bd,
        **at_batch,
        # no single PyTorch call computes gyroplane distances
        "library_ms": None,
        "at_iwae_decode": {**at_iwae, "library_ms": None},
    }


def _k1_check(rng, sizes, p: int, curvatures=(0.5, 1.0, 2.0), kernel=None):
    """K1 against its plain version at each B of ``sizes`` with ``p``
    planes, each c of ``curvatures``, interior and near the boundary,
    signed and unsigned, with and without bias (``kernel_phase``'s rules).
    ``kernel(x, points, c, signed, bias)`` is the call held (default the
    wrapper ``gyroplane_distances_cuda``). Returns the max abs errors
    against the plain version (interior, near the boundary)."""
    import torch

    from hyperbolic_vae_tpu_torch.ops import gyroplane as g

    kernel = kernel or g.gyroplane_distances_cuda

    err_in = err_bd = 0.0
    for b in sizes:
        for c in curvatures:
            for region in ("interior", "boundary"):
                x = torch.from_numpy(_points(rng, b, c, region)).cuda()
                pts = torch.from_numpy(_points(rng, p, c, region)).cuda()
                bias = torch.from_numpy(rng.uniform(-1, 1, p).astype(np.float32)).cuda()
                for signed in (True, False):
                    for bb in (None, bias):
                        out = kernel(x, pts, c, signed, bb)
                        torch.cuda.synchronize()
                        ref = g.gyroplane_distances(x, pts, c, signed, bb)
                        if out.shape != (b, p) or not torch.isfinite(out).all():
                            _fail(f"gyroplane kernel: bad output at B={b} P={p} c={c} {region}")
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
                                  f"2 x plain's {p_err} + 1e-5 at B={b} P={p} c={c} "
                                  f"signed={signed}")
    if err_in > 1e-5:
        _fail(f"gyroplane kernel: interior max abs err {err_in} > 1e-5 at P={p}")
    return err_in, err_bd


def _k1_wide_check(label: str, sizes, p: int, curvatures, seed: int) -> None:
    """K1's wide kernel at ``p`` planes: each shape must take it (no model's
    shape reaches the fallback kernel), and its output must equal the
    fallback kernel's (``gyroplane_distances_fallback_cuda``, not counted)
    bit for bit at each B of ``sizes`` and each c of ``curvatures``,
    interior and near the boundary, signed and unsigned, with and without
    bias. Draws from its own generator, so the phase's draws stay as they
    were."""
    import torch

    from hyperbolic_vae_tpu_torch.ops import gyroplane as g

    rng = np.random.default_rng(seed)
    calls = 0
    for b in sizes:
        for c in curvatures:
            for region in ("interior", "boundary"):
                x = torch.from_numpy(_points(rng, b, c, region)).cuda()
                pts = torch.from_numpy(_points(rng, p, c, region)).cuda()
                bias = torch.from_numpy(rng.uniform(-1, 1, p).astype(np.float32)).cuda()
                path = g.kernel_path(x, pts)
                if path != "wide":
                    _fail(f"{label}: K1 at B={b} P={p} takes the {path} kernel, not the wide one")
                for signed in (True, False):
                    for bb in (None, bias):
                        out = g.gyroplane_distances_cuda(x, pts, c, signed, bb)
                        ref = g.gyroplane_distances_fallback_cuda(x, pts, c, signed, bb)
                        torch.cuda.synchronize()
                        differ = int((out.view(torch.int32) != ref.view(torch.int32)).sum())
                        if differ:
                            _fail(f"{label}: K1's wide kernel differs from the fallback in "
                                  f"{differ} outputs at B={b} P={p} c={c} {region} "
                                  f"signed={signed} bias={bb is not None}")
                        calls += 1
    print(f"{label}: K1 at P={p} takes the wide kernel at B={', '.join(map(str, sizes))}, "
          f"bit for bit the fallback kernel's in {calls} calls", flush=True)


def _k1_times(rng, b: int, p: int = P, c: float = 1.0) -> dict:
    """K1 at batch b as the decoder calls it (signed, bias, curvature c),
    in turns: plain, kernel, kernel, plain from Python; then each replayed
    from a CUDA graph, beside an empty kernel of K1's launch shape (the
    launch floor); and the bound."""
    import torch

    from hyperbolic_vae_tpu_torch.ops import gyroplane as g

    x = torch.from_numpy(_points(rng, b, c, "interior")).cuda()
    pts = torch.from_numpy(_points(rng, p, c, "interior")).cuda()
    bias = torch.from_numpy(rng.uniform(-1, 1, p).astype(np.float32)).cuda()

    def kernel():
        return g.gyroplane_distances_cuda(x, pts, c, True, bias)

    def plain():
        return g.gyroplane_distances(x, pts, c, True, bias)

    plain_a, ms_a, ms_b, plain_b, graph_ms, plain_graph_ms = _in_turns(kernel, plain)
    ms, plain_ms = (ms_a + ms_b) / 2, (plain_a + plain_b) / 2
    floor_ms = _graph_ms(_empty_launch(b, p))
    n_bytes = 4 * (b * D + p * D + p + b * p)
    n_ops = b * p * (2 * D + GYRO_EPILOGUE_OPS) + 2 * D * (b + p)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_FLOP_PER_S * 1e3
    print(f"kernel gyroplane_distances at B={b}, P={p}, c={c}: called from Python {ms_a:.7f} ms, "
          f"{ms_b:.7f} ms; plain {plain_a:.7f} ms, {plain_b:.7f} ms; replayed from a "
          f"CUDA graph {graph_ms:.7f} ms, plain {plain_graph_ms:.7f} ms; an empty kernel of its "
          f"launch shape replayed the same way (the launch floor) {floor_ms:.7f} ms; "
          f"{n_bytes} bytes, {n_ops} flops: bound {max(t_bytes, t_ops):.7f} ms", flush=True)
    return {
        "B": b,
        "P": p,
        "c": c,
        "ms": ms,
        "kernel_ms": ms,
        "graph_ms": graph_ms,
        "launch_floor_ms": floor_ms,
        "plain_graph_ms": plain_graph_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


def _empty_launch(b: int, p: int = P):
    """A call of ``gyroplane_empty_launch``: an empty kernel with K1's grid
    at (b, p, D = 2)."""
    import ctypes

    import torch

    from hyperbolic_vae_tpu_torch.ops import _build

    fn = _build.load_library("gyroplane").gyroplane_empty_launch
    fn.argtypes, fn.restype = [ctypes.c_int] * 3 + [ctypes.c_void_p], ctypes.c_int

    def call():
        if fn(b, p, D, torch.cuda.current_stream().cuda_stream) != 0:
            _fail("the empty kernel did not launch")

    return call


def _k2_close(out, ref, beta: float) -> bool:
    """JAX's Pallas-vs-mirror tolerances: recon rtol 1e-5; KL rtol 1e-4,
    atol 1e-5; loss_total rtol 1e-5 taken on the scale of its two terms
    (|recon| + beta |kl|), since their sum can cancel."""
    d = (out.double() - ref.double()).abs().tolist()
    lt, rm, km = ref.double().abs().tolist()
    return (d[0] <= 1e-5 * (rm + beta * km) and d[1] <= 1e-5 * rm
            and d[2] <= 1e-4 * km + 1e-5)


def _k3_close(out, ref, beta: float) -> bool:
    """``_k2_close`` with an absolute floor of 1e-5 on recon and loss_total:
    a batch's mean recon sums 784 pixel terms that each cancel two numbers
    of up to ~87 (pixels at exactly 0), so it can lie near 0 where no
    relative rule holds it; the two versions differ there by ~1e-7."""
    d = (out.double() - ref.double()).abs().tolist()
    lt, rm, km = ref.double().abs().tolist()
    return (d[0] <= 1e-5 * (rm + beta * km) + 1e-5 and d[1] <= 1e-5 * rm + 1e-5
            and d[2] <= 1e-4 * km + 1e-5)


def k2_phase() -> dict:
    """K2 against its plain version on CUDA tensors: B in {1, 37, 256,
    1024}, c in {0.5, 1}, latent in {2, 3}, for the seeded flagship and
    for a copy whose posterior means sit at the projection margin (mean
    head scaled by 30, +2 on its bias; scale bias +3, so the truncation
    of the tangent draw is active). Tolerances in ``_k2_close``. Near the
    boundary, where artanh amplifies last-bit differences, a case outside
    them passes when the kernel's error against the float64 evaluation of
    the same formula is at most twice the plain f32 version's, plus 1e-6
    relative (K1's rule). Then both are timed at B = 256."""
    import torch

    from hyperbolic_vae_tpu_torch.data import synthetic_mnist_arrays
    from hyperbolic_vae_tpu_torch.models import GyroplaneVAE
    from hyperbolic_vae_tpu_torch.ops import flagship_fused as ff

    x_all = torch.from_numpy(synthetic_mnist_arrays(1024, 1, seed=0)[0]).cuda().reshape(1024, -1)
    err = {"interior": 0.0, "boundary": 0.0}
    n_f64 = 0
    for lat in (2, 3):
        for c in (0.5, 1.0):
            for region in ("interior", "boundary"):
                m = GyroplaneVAE(latent_dim=lat, manifold_curvature=c,
                                 generator=torch.Generator().manual_seed(0))
                if region == "boundary":
                    with torch.no_grad():
                        m.mu[0].weight.mul_(30.0)
                        m.mu[0].bias.add_(2.0)
                        m.scale[0].bias.add_(3.0)
                params, cfg = ff.params_tuple(m), ff.fused_config(m)
                for b in (1, 37, 256, 1024):
                    eps = torch.randn(b, lat, generator=torch.Generator().manual_seed(b)).cuda()
                    xb = x_all[:b].contiguous()
                    out = ff.flagship_fused_cuda(params, xb, eps, **cfg)
                    torch.cuda.synchronize()
                    with torch.no_grad():
                        ref = torch.stack(ff.flagship_forward_torch(params, xb, eps, **cfg))
                    if out.shape != (3,) or not torch.isfinite(out).all():
                        _fail(f"flagship kernel: bad output {out.tolist()} at B={b} c={c} L={lat}")
                    rel = float(((out - ref).abs() / ref.abs().clamp_min(1e-6)).max())
                    err[region] = max(err[region], float((out - ref).abs().max()))
                    if region == "boundary" and b == 1024:
                        with torch.no_grad():
                            mu, _ = m.encode(xb)
                        share = float((mu.norm(dim=-1) >= 0.99 * (1 - 4e-3) / c**0.5).float().mean())
                        print(f"kernel flagship_fused near boundary c={c} L={lat}: {share:.3f} of rows "
                              f"with |mu| >= 0.99 of the projection radius", flush=True)
                        if share < 0.5:
                            _fail("the boundary case does not reach the boundary")
                    if _k2_close(out, ref, cfg["beta"]):
                        continue
                    if region == "interior":
                        _fail(f"flagship kernel vs plain at B={b} c={c} L={lat}: "
                              f"{out.tolist()} vs {ref.tolist()} (max rel {rel:.3e})")
                    p64 = [t.detach().double() for t in params]
                    with torch.no_grad():
                        exact = torch.stack(ff.flagship_forward_torch(p64, xb.double(), eps.double(), **cfg))
                    k_err = ((out.double() - exact).abs() / exact.abs()).tolist()
                    p_err = ((ref.double() - exact).abs() / exact.abs()).tolist()
                    if any(k > 2.0 * p + 1e-6 for k, p in zip(k_err, p_err)):
                        _fail(f"flagship kernel near boundary at B={b} c={c} L={lat}: rel err vs "
                              f"float64 {k_err} > 2 x plain's {p_err} + 1e-6")
                    n_f64 += 1
    print(f"kernel flagship_fused: max_abs_err vs plain: interior {err['interior']:.3e}, "
          f"near boundary {err['boundary']:.3e} ({n_f64} boundary cases held to float64)", flush=True)

    # timing at the training batch, flagship config, in turns: plain, kernel, kernel, plain
    m = GyroplaneVAE(generator=torch.Generator().manual_seed(0))
    params, cfg = ff.params_tuple(m), ff.fused_config(m)
    xb = x_all[:BATCH].contiguous()
    eps = torch.randn(BATCH, D, generator=torch.Generator().manual_seed(1)).cuda()

    def kernel():
        return ff.flagship_fused_cuda(params, xb, eps, **cfg)

    @torch.no_grad()
    def plain():
        return ff.flagship_forward_torch(params, xb, eps, **cfg)

    plain_a, ms_a, ms_b, plain_b, graph_ms, plain_graph_ms = _in_turns(kernel, plain)
    ms, plain_ms = (ms_a + ms_b) / 2, (plain_a + plain_b) / 2
    split = _graph_split(kernel)
    _print_split("flagship_fused", split)
    n_par = sum(t.numel() for t in params)
    n_bytes = 4 * (BATCH * DATA + BATCH * D + n_par + 3)
    h1, h2 = ff.HIDDEN
    n_mac = DATA * h1 + h1 * h2 + 2 * h2 * D + P * D + h2 * h1 + h1 * DATA
    n_ops = BATCH * (2 * n_mac + DATA * K2_PIXEL_OPS + (2 * h1 + 2 * h2) * K2_GELU_OPS
                     + P * GYRO_EPILOGUE_OPS + K2_LATENT_OPS)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_FLOP_PER_S * 1e3
    print(f"kernel flagship_fused at B={BATCH}: called from Python {ms_a:.5f} ms, "
          f"{ms_b:.5f} ms; plain {plain_a:.5f} ms, {plain_b:.5f} ms; replayed from a "
          f"CUDA graph {graph_ms:.5f} ms, plain {plain_graph_ms:.5f} ms; "
          f"{n_bytes} bytes, {n_ops} flops", flush=True)
    return {
        "name": "flagship_fused",
        "route": "cuda",
        "source": "hyperbolic_vae_tpu_torch/csrc/flagship_fused.cu",
        "replaces": "hyperbolic_vae_tpu/ops/flagship_fused.py:212",
        "max_abs_err": err["interior"],
        "max_abs_err_boundary": err["boundary"],
        "ms": ms,
        "kernel_ms": ms,
        "graph_ms": graph_ms,
        "graph_split_ms": split,
        "plain_graph_ms": plain_graph_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        # no single PyTorch call computes the flagship's ELBO
        "library_ms": None,
    }


def _k3_inputs(m, b: int, lat: int, moments: bool, seed: int):
    """x (b, 784) of synthetic MNIST, eps, the model's params and moments
    (random and non-zero with count 3, or zero with count 0), on the card."""
    import torch

    from hyperbolic_vae_tpu_torch.data import synthetic_mnist_arrays
    from hyperbolic_vae_tpu_torch.ops import flagship_fused as ff

    g = torch.Generator().manual_seed(seed)
    x = torch.from_numpy(synthetic_mnist_arrays(b, 1, seed=seed)[0].reshape(b, -1)).cuda()
    eps = torch.randn(b, lat, generator=g).cuda()
    params = [p.detach().clone() for p in ff.params_tuple(m)]
    if moments:
        mom = [(0.01 * torch.randn(p.shape, generator=g)).cuda() for p in params]
        vel = [(1e-4 * torch.rand(p.shape, generator=g)).cuda() for p in params]
    else:
        mom = [torch.zeros_like(p) for p in params]
        vel = [torch.zeros_like(p) for p in params]
    count = torch.full((), 3 if moments else 0, dtype=torch.int32, device="cuda")
    return x, eps, params, mom, vel, count


def k3_phase() -> dict:
    """K3 against its plain version on CUDA tensors: B in {1, 37, 256,
    1024}, c in {0.5, 1}, latent in {2, 3}, interior and at the projection
    margin (as the K2 phase), from non-zero moments with count 3.
    Tolerances: the metrics by ``_k3_close`` and skipped equal; the new
    params and both moments rtol 5e-3, atol 3e-4 (JAX's fused-step
    tolerance). Near the boundary a tensor outside it passes when the
    kernel's max abs error against the float64 step is at most twice the
    plain f32 version's, plus 3e-4 (the float64 rule of K1 and K2); the
    metrics there follow the K2 phase's float64 rule. count must be 4.
    Then, at B = 256 for each (c, latent, region): the first step from zero
    moments, where exp_avg / (1 - b1) of every Euclidean tensor is the
    kernel's gradient, against the plain version's gradients (rtol 1e-3,
    atol 3e-5 of each tensor's largest gradient); a step on a batch with a
    NaN pixel (params and moments bit for bit unchanged, skipped 1, count
    advanced); two launches on the same inputs giving equal bits. Then K3
    and the plain step are timed at B = 256."""
    import torch

    from hyperbolic_vae_tpu_torch.models import GyroplaneVAE
    from hyperbolic_vae_tpu_torch.ops import flagship_fused as ff

    lr = torch.full((), 1e-3, dtype=torch.float32, device="cuda")  # K3 reads it on the card

    def run_kernel(params, mom, vel, x, eps, count, cfg):
        kp, km, kv = ([t.clone() for t in ts] for ts in (params, mom, vel))
        kc = count.clone()
        out = ff.flagship_train_cuda(kp, km, kv, x, eps, kc, lr=lr, **cfg)
        torch.cuda.synchronize()
        return out, kp, km, kv, kc

    err = {"interior": 0.0, "boundary": 0.0}
    n_f64 = 0
    for lat in (2, 3):
        for c in (0.5, 1.0):
            for region in ("interior", "boundary"):
                m = GyroplaneVAE(latent_dim=lat, manifold_curvature=c,
                                 generator=torch.Generator().manual_seed(0))
                if region == "boundary":
                    with torch.no_grad():
                        m.mu[0].weight.mul_(30.0)
                        m.mu[0].bias.add_(2.0)
                        m.scale[0].bias.add_(3.0)
                cfg = ff.fused_config(m)
                tag = f"c={c} L={lat} {region}"
                for b in (1, 37, 256, 1024):
                    x, eps, params, mom, vel, count = _k3_inputs(m, b, lat, True, b)
                    out, kp, km, kv, kc = run_kernel(params, mom, vel, x, eps, count, cfg)
                    ref = ff.flagship_train_step_torch(params, mom, vel, x, eps, lr=lr,
                                                       count=count, **cfg)
                    if int(kc) != 4 or int(ref[4]) != 4:
                        _fail(f"K3 {tag} B={b}: count {int(kc)}, want 4")
                    if not torch.isfinite(out).all() or float(out[3]) != 0.0:
                        _fail(f"K3 {tag} B={b}: bad metrics {out.tolist()}")
                    exact = None
                    if not _k3_close(out[:3], ref[3][:3], cfg["beta"]):
                        if region == "interior":
                            _fail(f"K3 {tag} B={b}: metrics {out.tolist()} vs {ref[3].tolist()}")
                        exact = ff.flagship_train_step_torch(
                            *([t.double() for t in ts] for ts in (params, mom, vel)),
                            x.double(), eps.double(), lr=lr, count=count, **cfg)
                        k_err = ((out[:3].double() - exact[3][:3]).abs() / exact[3][:3].abs()).tolist()
                        p_err = ((ref[3][:3].double() - exact[3][:3]).abs() / exact[3][:3].abs()).tolist()
                        if any(ke > 2.0 * pe + 1e-6 for ke, pe in zip(k_err, p_err)):
                            _fail(f"K3 {tag} B={b}: metrics rel err vs float64 {k_err} > 2 x plain's {p_err}")
                    for j, (got, want) in enumerate(zip((kp, km, kv), ref[:3])):
                        for i, (a, w) in enumerate(zip(got, want)):
                            d = float((a - w).abs().max())
                            err[region] = max(err[region], d)
                            if torch.allclose(a, w, rtol=5e-3, atol=3e-4):
                                continue
                            if region == "interior":
                                _fail(f"K3 {tag} B={b}: tensor {j}/{i} differs by {d}")
                            if exact is None:
                                exact = ff.flagship_train_step_torch(
                                    *([t.double() for t in ts] for ts in (params, mom, vel)),
                                    x.double(), eps.double(), lr=lr, count=count, **cfg)
                            k_err = float((a.double() - exact[j][i]).abs().max())
                            p_err = float((w.double() - exact[j][i]).abs().max())
                            if k_err > 2.0 * p_err + 3e-4:
                                _fail(f"K3 {tag} B={b}: tensor {j}/{i} err vs float64 {k_err} > "
                                      f"2 x plain's {p_err} + 3e-4")
                            n_f64 += 1

                # the first step from zero moments: the kernel's gradients
                x, eps, params, mom, vel, count = _k3_inputs(m, BATCH, lat, False, 5)
                _, _, km, _, _ = run_kernel(params, mom, vel, x, eps, count, cfg)
                grads, _ = ff.flagship_grads_torch(params, x, eps, **cfg)
                for i, (mk, g) in enumerate(zip(km, grads)):
                    if i == ff._MP_POINTS_IDX:
                        continue
                    scale = float(g.abs().max())
                    if not torch.allclose(mk / (1.0 - 0.9), g, rtol=1e-3, atol=3e-5 * scale):
                        _fail(f"K3 {tag}: gradient of parameter {i} differs by "
                              f"{float((mk / 0.1 - g).abs().max())} (scale {scale})")
                # a skipped step, and determinism
                x_bad = x.clone()
                x_bad[3, 100] = float("nan")
                out, kp, km, kv, kc = run_kernel(params, mom, vel, x_bad, eps, count, cfg)
                if float(out[3]) != 1.0 or int(kc) != 1 or not all(
                        torch.equal(a, b) for a, b in zip(kp + km + kv, params + mom + vel)):
                    _fail(f"K3 {tag}: a NaN batch was not skipped cleanly ({out.tolist()}, count {int(kc)})")
                first = run_kernel(params, mom, vel, x, eps, count, cfg)
                second = run_kernel(params, mom, vel, x, eps, count, cfg)
                if not all(torch.equal(a, b) for a, b in zip(
                        [first[0], *first[1], *first[2], *first[3]],
                        [second[0], *second[1], *second[2], *second[3]])):
                    _fail(f"K3 {tag}: two launches on the same inputs differ")
    print(f"kernel flagship_train: max_abs_err vs plain (params, moments): interior "
          f"{err['interior']:.3e}, near boundary {err['boundary']:.3e} ({n_f64} boundary tensors "
          f"held to float64); first-step gradients, skipped step and determinism held", flush=True)

    # timing at the training batch, flagship config, in turns: plain, kernel, kernel, plain
    m = GyroplaneVAE(generator=torch.Generator().manual_seed(0))
    cfg = ff.fused_config(m)
    x, eps, params, mom, vel, count = _k3_inputs(m, BATCH, D, True, 1)

    def kernel():
        return ff.flagship_train_cuda(params, mom, vel, x, eps, count, lr=lr, **cfg)

    def plain():
        return ff.flagship_train_step_torch(params, mom, vel, x, eps, lr=lr, count=count, **cfg)

    plain_a, ms_a, ms_b, plain_b, graph_ms, plain_graph_ms = _in_turns(kernel, plain)
    ms, plain_ms = (ms_a + ms_b) / 2, (plain_a + plain_b) / 2
    split = _graph_split(kernel)
    _print_split("flagship_train", split)
    n_par = sum(t.numel() for t in params)
    n_bytes = 4 * (BATCH * DATA + BATCH * D + 6 * n_par + 4) + 8
    h1, h2 = ff.HIDDEN
    n_mac = DATA * h1 + h1 * h2 + 2 * h2 * D + P * D + h2 * h1 + h1 * DATA
    fwd_ops = (2 * n_mac + DATA * K2_PIXEL_OPS + (2 * h1 + 2 * h2) * K2_GELU_OPS
               + P * GYRO_EPILOGUE_OPS + K2_LATENT_OPS)
    # the backward: weight gradients (n_mac) and input gradients of every
    # layer but the first (n_mac - DATA * h1), then the elementwise chain
    bwd_ops = (2 * (2 * n_mac - DATA * h1) + DATA * K3_PIXEL_OPS
               + (2 * h1 + 2 * h2) * K3_GELU_OPS + P * K3_GYRO_OPS + K3_LATENT_OPS)
    n_ops = BATCH * (fwd_ops + bwd_ops) + n_par * K3_ADAM_OPS
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_FLOP_PER_S * 1e3
    print(f"kernel flagship_train at B={BATCH}: called from Python {ms_a:.5f} ms, "
          f"{ms_b:.5f} ms; plain {plain_a:.5f} ms, {plain_b:.5f} ms; replayed from a "
          f"CUDA graph {graph_ms:.5f} ms, plain {plain_graph_ms:.5f} ms; "
          f"{n_bytes} bytes, {n_ops} flops", flush=True)
    return {
        "name": "flagship_train",
        "route": "cuda",
        "source": "hyperbolic_vae_tpu_torch/csrc/flagship_train.cu",
        "replaces": "hyperbolic_vae_tpu/ops/flagship_fused.py:376",
        "max_abs_err": err["interior"],
        "max_abs_err_boundary": err["boundary"],
        "ms": ms,
        "kernel_ms": ms,
        "graph_ms": graph_ms,
        "graph_split_ms": split,
        "plain_graph_ms": plain_graph_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        # no single PyTorch call computes a training step
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


def _shaped(h, body):
    """An octet-stream reply as the array its ``X-Shape`` names."""
    return np.frombuffer(body, "<f4").reshape(tuple(int(s_) for s_ in h["X-Shape"].split(",")))


def _batchwise(inf, x):
    """The served model's decode of its posterior mean, batch by batch on
    the card (what the engine's reconstruct must equal bit for bit)."""
    import torch

    with torch.inference_mode():
        out = [inf.model.decode(inf.model.posterior_mean(torch.from_numpy(x[i:i + BATCH]).cuda()))
               for i in range(0, len(x), BATCH)]
    return torch.cat(out).cpu().numpy()


def serve_phase() -> dict:
    """The flagship over HTTP on the card. Returns launches per kernel."""
    import torch

    from hyperbolic_vae_tpu_torch.data import synthetic_mnist_arrays
    from hyperbolic_vae_tpu_torch.interop import (
        gyroplane_vae_from_state_dict,
        state_dict_from_jax_params,
    )
    from hyperbolic_vae_tpu_torch.models import GyroplaneVAE
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
        _reset_launches()
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
        launches = _launches()
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
    if launches != {"gyroplane_distances": 15, "flagship_fused": 0, "flagship_train": 0}:
        _fail(f"serve launches {launches}, want 15 of the gyroplane kernel and no other")
    print(f"serve: launches {json.dumps(launches)}", flush=True)
    return launches


def _launches() -> dict:
    from hyperbolic_vae_tpu_torch.ops import launch_counters

    return {name: c.count for name, c in launch_counters().items()}


def _reset_launches() -> None:
    from hyperbolic_vae_tpu_torch.ops import launch_counters

    for c in launch_counters().values():
        c.reset()


def train_phase(n_train: int = 60000, n_test: int = 10000, device: str = "cuda") -> dict:
    """The training path on the card. Returns launches per path.
    ``device="cpu"`` (and small ``n_train``) rehearses it on the CPU, where
    the launch counts stay 0."""
    import torch

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    from hyperbolic_vae_tpu_torch.data import make_data_module
    from hyperbolic_vae_tpu_torch.interop import gyroplane_vae_from_state_dict
    from hyperbolic_vae_tpu_torch.models import GyroplaneVAE
    from hyperbolic_vae_tpu_torch.ops import flagship_fused as ff
    from hyperbolic_vae_tpu_torch.optim import RiemannianAdam, cosine_schedule
    from hyperbolic_vae_tpu_torch.train import Trainer
    from hyperbolic_vae_tpu_torch.train.cuda_graph import run_eagerly
    from hyperbolic_vae_tpu_torch.train.epoch_program import train_step

    t0 = time.perf_counter()
    dm = make_data_module(batch_size=BATCH, synthetic=True, n_train=n_train, n_test=n_test)
    print(f"train: data module {dm.x_train.shape[0]} train, {dm.x_val.shape[0]} val rows "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)

    # (a) five steps of fused loss -> backward -> RiemannianAdam, card vs CPU.
    # JAX's fused-step tolerance (tests/test_fused_train_step.py): rtol 5e-3, atol 3e-4
    card = GyroplaneVAE(generator=torch.Generator().manual_seed(0), device=device)
    cpu = gyroplane_vae_from_state_dict({k: v.cpu() for k, v in card.state_dict().items()},
                                        device="cpu")
    cfg = ff.fused_config(card)
    opts = [RiemannianAdam(mod.parameters(), lr=1e-3, ball=mod.ball) for mod in (card, cpu)]
    rng = np.random.default_rng(7)
    for _ in range(5):
        xb = dm.x_train[rng.integers(0, dm.x_train.shape[0], BATCH)]
        eps = rng.normal(size=(BATCH, D)).astype(np.float32)
        for mod, opt in zip((card, cpu), opts):
            dev = mod.device
            lt, _, _ = ff.fused_flagship_loss(ff.params_tuple(mod), torch.from_numpy(xb).to(dev),
                                              torch.from_numpy(eps).to(dev), **cfg)
            opt.zero_grad()
            lt.backward()
            opt.step()
    worst = 0.0
    for (name, p), q in zip(card.named_parameters(), cpu.parameters()):
        pairs = [(p, q)] + [(opts[0].state[p][k], opts[1].state[q][k])
                            for k in ("exp_avg", "exp_avg_sq")]
        for a, b in pairs:
            a, b = a.detach().cpu(), b.detach()
            if not torch.allclose(a, b, rtol=5e-3, atol=3e-4):
                _fail(f"train (a): {name} differs card vs CPU by {float((a - b).abs().max())}")
            worst = max(worst, float((a - b).abs().max()))
    if int(opts[0].count) != 5 or int(opts[1].count) != 5:
        _fail("train (a): step count is not 5")
    print(f"train (a): 5 fused steps card vs CPU: params and moments max abs diff {worst:.3e} "
          f"(rtol 5e-3, atol 3e-4)", flush=True)

    # (a3) five K3 steps from the same weights on the same batches and
    # draws: the kernel on the card (``flagship_train_cuda``), the plain
    # version on the CPU (``flagship_train_step_torch``), each on its
    # optimizer's moments and count
    card = GyroplaneVAE(generator=torch.Generator().manual_seed(0), device=device)
    cpu = gyroplane_vae_from_state_dict({k: v.cpu() for k, v in card.state_dict().items()},
                                        device="cpu")
    opts = [RiemannianAdam(mod.parameters(), lr=1e-3, ball=mod.ball) for mod in (card, cpu)]
    worst = 0.0
    with torch.no_grad():
        for _ in range(5):
            xb = torch.from_numpy(dm.x_train[rng.integers(0, dm.x_train.shape[0], BATCH)].reshape(BATCH, -1))
            eps = torch.from_numpy(rng.normal(size=(BATCH, D)).astype(np.float32))
            for mod, opt in zip((card, cpu), opts):
                params = ff.params_tuple(mod)
                mom, vel = zip(*(opt.moments(p) for p in params))
                xd, ed = xb.to(mod.device), eps.to(mod.device)
                if mod.device.type == "cuda":
                    ff.flagship_train_cuda(params, mom, vel, xd, ed, opt.count,
                                           lr=opt.param_groups[0]["lr"], **cfg)
                    continue
                new = ff.flagship_train_step_torch(params, mom, vel, xd, ed, lr=1e-3,
                                                   count=opt.count, **cfg)
                for dst, src in zip((*params, *mom, *vel), (*new[0], *new[1], *new[2])):
                    dst.copy_(src)
                opt.count.copy_(new[4])
    for (name, p), q in zip(card.named_parameters(), cpu.parameters()):
        pairs = [(p, q)] + [(opts[0].state[p][k], opts[1].state[q][k])
                            for k in ("exp_avg", "exp_avg_sq")]
        for a, b in pairs:
            a, b = a.detach().cpu(), b.detach()
            if not torch.allclose(a, b, rtol=5e-3, atol=3e-4):
                _fail(f"train (a3): {name} differs card vs CPU by {float((a - b).abs().max())}")
            worst = max(worst, float((a - b).abs().max()))
    if int(opts[0].count) != 5 or int(opts[1].count) != 5:
        _fail("train (a3): step count is not 5")
    print(f"train (a3): 5 K3 steps card vs CPU: params and moments max abs diff {worst:.3e} "
          f"(rtol 5e-3, atol 3e-4)", flush=True)

    steps = dm.x_train.shape[0] // BATCH
    n_val = dm.x_val.shape[0]
    per_epoch = steps + n_val // BATCH + (1 if n_val % BATCH else 0)

    def fit(path, epochs, k=1, eager=False, **kw):
        """A fresh flagship (seed 0) trained by ``Trainer.fit`` on ``path``:
        graphed on the card, or the eager run of the same program."""
        model = GyroplaneVAE(generator=torch.Generator().manual_seed(0), device=device)
        kw.setdefault("early_stopping_patience", None)
        trainer = Trainer(model, max_epochs=epochs, shuffle="row", epochs_per_dispatch=k,
                          loss_fn=ff.make_fused_loss_fn(model) if path != "train_default" else None,
                          train_step_fn=ff.make_fused_train_step(model) if path == "train_k3" else None,
                          device=device, **kw)
        sync()
        t0 = time.perf_counter()
        with run_eagerly() if eager else contextlib.nullcontext():
            res = trainer.fit(dm)
        sync()
        return res, trainer, time.perf_counter() - t0

    out = {}
    for path, epochs in (("train_fused", 2), ("train_k3", 2), ("train_default", 1)):
        # the main path's run: graphed on the card, counted through replays
        _reset_launches()
        res, trainer, wall = fit(path, epochs)
        out[path] = _launches()
        hist = res.history
        for row in hist:
            if not all(np.isfinite(v) for v in row.values()):
                _fail(f"{path}: non-finite metrics {row}")
        print(f"{path}: history {json.dumps(hist)}", flush=True)
        if path == "train_fused":
            want = {"flagship_fused": epochs * per_epoch, "gyroplane_distances": 0,
                    "flagship_train": 0}
        elif path == "train_k3":  # K3 every step, K2 every val batch
            want = {"flagship_fused": epochs * (per_epoch - steps), "gyroplane_distances": 0,
                    "flagship_train": epochs * steps}
        else:
            want = {"flagship_fused": 0, "gyroplane_distances": epochs * per_epoch,
                    "flagship_train": 0}
        if out[path] != want:
            _fail(f"{path}: launches {out[path]}, want {want}")
        if path != "train_default" and hist[1]["val/loss_total"] >= hist[0]["val/loss_total"]:
            _fail(f"{path}: val/loss_total did not fall from epoch 0 to 1")
        # the eager run of the same program: the same history, bit for bit
        eres, etrainer, ewall = fit(path, epochs, eager=True)
        _same_fit(path, res, eres, "graphed", "eager")
        graph = _profile_train(trainer.program, device)
        eager = _profile_train(etrainer.program, device)
        print(f"{path}: {epochs} epochs graphed in {wall:.3f} s ({wall / epochs:.4f} s/epoch with the "
              f"capture), eager {ewall:.3f} s ({ewall / epochs:.4f} s/epoch); launches "
              f"{json.dumps(out[path])}; {trainer.program.program.graph_launches} graph launches "
              f"an epoch (eager: {sum(s.repeat * len(s.pieces) for s in etrainer.program.program.segments)} "
              f"pieces an epoch)", flush=True)
        for label, p in (("graphed", graph), ("eager", eager)):
            print(f"{path} {label}: {p['what']}: wall {p['wall_ms']:.4f} ms/step, device busy "
                  f"{p['busy_ms']:.4f} ms/step, idle share {p['idle']}, {p['kernels']:.1f} kernels/step; "
                  f"{BATCH / p['wall_ms'] * 1e3:.1f} train samples/s", flush=True)

    # (f) K3 path, five epochs: K = 5 against K = 1 (graphed) and against the
    # eager run, with the in-graph plateau halving lr inside the chunk
    # (monitor train/skipped_steps, always 0, patience 0), then a cosine lr
    # schedule in one chunk of five
    drop = dict(monitor="train/skipped_steps", plateau_patience=0, plateau_factor=0.5)
    r5, _, w5 = fit("train_k3", 5, k=5, **drop)
    r1, _, w1 = fit("train_k3", 5, k=1, **drop)
    e5, _, _ = fit("train_k3", 5, k=5, eager=True, **drop)
    _same_fit("train_k3 plateau", r5, r1, "K=5", "K=1")
    _same_fit("train_k3 plateau", r5, e5, "graphed", "eager")
    lrs = [h["lr"] for h in r5.history]
    if lrs != [float(np.float32(v)) for v in (1e-3, 1e-3, 5e-4, 2.5e-4, 1.25e-4)]:
        _fail(f"train_k3 plateau: lr column {lrs}: want a halving after each epoch from the second")
    print(f"train_k3 plateau: K=5 ({w5:.3f} s) == K=1 ({w1:.3f} s) == eager, bit for bit; "
          f"lr column {lrs}", flush=True)
    sched = cosine_schedule(1e-3, total_epochs=5, warmup_epochs=1, min_lr=1e-5)
    c5, _, _ = fit("train_k3", 5, k=5, lr_schedule=sched)
    ce5, _, _ = fit("train_k3", 5, k=5, eager=True, lr_schedule=sched)
    _same_fit("train_k3 cosine", c5, ce5, "graphed", "eager")
    lrs = [h["lr"] for h in c5.history]
    if lrs != [float(sched(e)) for e in range(5)]:
        _fail(f"train_k3 cosine: lr column {lrs} is not the schedule's")
    print(f"train_k3 cosine: graphed == eager, bit for bit; lr column {lrs}", flush=True)

    # (d) one step split into its parts (host clock, synchronised around each)
    model = GyroplaneVAE(generator=torch.Generator().manual_seed(0), device=device)
    opt = RiemannianAdam(model.parameters(), lr=1e-3, ball=model.ball)
    loss_fn = ff.make_fused_loss_fn(model)
    gen = torch.Generator(device=device).manual_seed(0)
    xb = torch.from_numpy(dm.x_train[:BATCH]).to(device)
    parts = {"K2 forward": [], "autograd backward": [], "guard + RiemannianAdam": [], "step": []}
    for i in range(60):
        sync()
        t0 = time.perf_counter()
        m = loss_fn(model, xb, gen)
        sync()
        t1 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        m["loss_total"].backward()
        sync()
        t2 = time.perf_counter()
        grads = [p.grad for p in model.parameters()]
        ok = torch.isfinite(m["loss_total"]) & torch.isfinite(torch.stack([(g * g).sum() for g in grads]).sum())
        opt.step(ok=ok)
        sync()
        t3 = time.perf_counter()
        train_step(model, opt, xb, gen, loss_fn)
        sync()
        t4 = time.perf_counter()
        if i >= 10:
            for k, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                parts[k].append(dt * 1e3)
    print("train step split (median ms of 50, synchronised after each part): " + ", ".join(
        f"{k} {statistics.median(v):.4f}" for k, v in parts.items()), flush=True)

    # (d3) one K3 step (eps draw, checks, kernel), synchronised around it
    k3_step = ff.make_fused_train_step(model)
    k3_ms = []
    for i in range(60):
        sync()
        t0 = time.perf_counter()
        k3_step(model, opt, xb, gen)
        sync()
        if i >= 10:
            k3_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"train (d3): one K3 step (median ms of 50, synchronised) {statistics.median(k3_ms):.4f}",
          flush=True)

    return out


def _same_fit(what: str, a, b, la: str, lb: str) -> None:
    """Fails unless two fits' histories and final and best parameters are
    equal bit for bit."""
    import torch

    if len(a.history) != len(b.history) or any(
            not np.array_equal(x[k], y[k], equal_nan=True) for x, y in zip(a.history, b.history)
            for k in x):
        _fail(f"{what}: {la} history {a.history} differs from {lb} {b.history}")
    for d in ("params", "best_params"):
        for k, v in getattr(a, d).items():
            w = getattr(b, d)[k]
            if not torch.equal(v, w):
                _fail(f"{what}: {la} {d}[{k}] differs from {lb} by {float((v - w).abs().max())}")


def _profile_train(prog, device) -> dict:
    """Per step of a fitted program, after the fit: the wall time (host
    clock, synchronised), then the device's busy time (the kernels' time
    from torch.profiler, whose tracing slows the host, so the window is
    run again under it) and the idle share 1 - busy / wall. On the K3 path
    the window is one train epoch (one graph on the card), else the
    epoch's begin and 20 steps (20 replays of the step graph; fewer if an
    epoch has fewer)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    on_card = str(device).startswith("cuda")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    gp = prog.program
    whole = "train epoch" in [s.name for s in gp.segments]
    n = prog.ep.steps if whole else min(20, prog.ep.steps)

    def window():
        if whole:
            gp.replay("train epoch")
            return
        gp.replay("begin epoch")
        sync()
        for _ in range(n):
            gp.replay("train step")

    window()  # warm
    sync()
    t0 = time.perf_counter()
    window()
    sync()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU]) as prof:
        window()
        sync()
    rows = [(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)), e.count,
             e.key) for e in prof.key_averages() if str(e.device_type).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False) and "#" not in e.key]
    rows = [r for r in rows if r[0] > 0]
    busy_ms = sum(r[0] for r in rows) / 1e3 / n
    what = f"one train epoch ({n} steps)" if whole else f"{n} train steps"
    if not rows:
        return {"what": what, "wall_ms": wall_ms, "busy_ms": float("nan"), "kernels": float("nan"),
                "idle": "not measured (the profiler saw no kernel)", "top": []}
    # the kernels that take most of the busy time: (name, ms a step, launches a step)
    top = [(k[:60], us / 1e3 / n, c / n) for us, c, k in sorted(rows, reverse=True)[:6]]
    return {"what": what, "wall_ms": wall_ms, "busy_ms": busy_ms,
            "kernels": sum(r[1] for r in rows) / n, "idle": f"{1 - busy_ms / wall_ms:.4f}",
            "top": top}


def northstar_phase(device: str = "cuda") -> dict:
    """The reference protocol on the graphed K3 path: at most 300 epochs,
    early stopping patience 10, ReduceLROnPlateau(0.2, 20, 5e-5), batch 256,
    lr 1e-3, ``epochs_per_dispatch=10``, synthetic MNIST at
    ``runs/flagship_r5``'s sizes (54,000 train, 6,000 val rows). Fails
    unless the best val/loss_total is within 1 % of the JAX flagship's
    -923.698, i.e. <= -914.46."""
    import torch

    from hyperbolic_vae_tpu_torch.data import make_data_module
    from hyperbolic_vae_tpu_torch.models import GyroplaneVAE
    from hyperbolic_vae_tpu_torch.ops import flagship_fused as ff
    from hyperbolic_vae_tpu_torch.train import Trainer

    dm = make_data_module(batch_size=BATCH, synthetic=True)
    model = GyroplaneVAE(generator=torch.Generator().manual_seed(0), device=device)
    trainer = Trainer(model, lr=1e-3, max_epochs=300, early_stopping_patience=10,
                      plateau_factor=0.2, plateau_patience=20, plateau_min_lr=5e-5,
                      epochs_per_dispatch=10, loss_fn=ff.make_fused_loss_fn(model),
                      train_step_fn=ff.make_fused_train_step(model), device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = trainer.fit(dm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    best_epoch = min(range(len(res.history)), key=lambda e: res.history[e]["val/loss_total"])
    lrs = sorted({h["lr"] for h in res.history}, reverse=True)
    print(f"northstar: {res.epochs_run} epochs in {wall:.3f} s ({wall / res.epochs_run * 1e3:.3f} ms "
          f"an epoch, {res.samples_per_sec:.1f} train samples/s after the first chunk); best "
          f"val/loss_total {res.best_metric:.4f} at epoch {best_epoch} (JAX flagship -923.698, "
          f"within 1 %: <= -914.46); lr values {lrs}; last row {json.dumps(res.history[-1])}",
          flush=True)
    if not res.best_metric <= -914.46:
        _fail(f"northstar: best val/loss_total {res.best_metric} is not within 1 % of -923.698")
    return trainer, dm, res.best_params


def eval_phase(trainer, dm, best, k: int = 5000) -> dict:
    """The flagship's evaluation path on the card, from the north-star fit's
    trainer and best params ``best``, on its 10,000-row test split:

      (a) ``iwae_from_eps`` on 256 test rows with K = 500 draws made on the
          host, on the card and on the CPU (the plain K1): rtol 1e-5,
          atol 1e-3 on the (B,) bound;
      (b) ``Trainer.evaluate_iwae(k=5000)``: the eval path's run, exactly
          400 K1 launches (40 batch chunks x 10 k chunks of 500) and no
          other kernel; finite and at least the ELBO that ``Trainer.evaluate``
          gives on the split; its wall time, then K1's device time in a
          second run under torch.profiler;
      (c) ``encode_split`` and ``evaluate_probe(k=10)``, card against CPU:
          embeddings within 1e-5, accuracies within 1 / n_test;
      (d) ``evaluate`` of a trainer whose beta warm-up (10 epochs) is longer
          than its max_epochs (2): equal, bit for bit, to ``evaluate`` of
          the model with the static beta beta_schedule(2);
      (e) a one-epoch K3 fit with ``GenerateCallback``, ``LatentGridCallback``
          and ``LatentInterpolationCallback`` at every_n_epochs=1 into a
          temporary log_dir: PNGs that decode to their mosaics' shapes.

    Returns the launches of (b) by kernel."""
    import copy
    import tempfile
    from pathlib import Path

    import torch
    from torch.profiler import ProfilerActivity, profile

    from hyperbolic_vae_tpu_torch.interop import gyroplane_vae_from_state_dict
    from hyperbolic_vae_tpu_torch.models import GyroplaneVAE
    from hyperbolic_vae_tpu_torch.ops import flagship_fused as ff
    from hyperbolic_vae_tpu_torch.optim import beta_warmup_schedule
    from hyperbolic_vae_tpu_torch.train import (
        GenerateCallback,
        LatentGridCallback,
        LatentInterpolationCallback,
        Trainer,
    )
    from hyperbolic_vae_tpu_torch.train.metrics import read_png

    n_test = dm.x_test.shape[0]
    best_cpu = {k: v.cpu() for k, v in best.items()}
    card = copy.deepcopy(trainer.model)
    card.load_state_dict(best)
    cpu = gyroplane_vae_from_state_dict(best_cpu, device="cpu")

    # (a) the bound on host-drawn eps, card against CPU
    eps = np.random.default_rng(9).normal(size=(IWAE_K, BATCH, D)).astype(np.float32)
    xb = torch.from_numpy(dm.x_test[:BATCH])
    t0 = time.perf_counter()
    with torch.no_grad():
        on_card = card.iwae_from_eps(xb.cuda(), torch.from_numpy(eps).cuda()).cpu()
        on_cpu = cpu.iwae_from_eps(xb, torch.from_numpy(eps))
    err = float((on_card - on_cpu).abs().max())
    print(f"eval (a): iwae_from_eps at K={IWAE_K}, B={BATCH}, card vs CPU max abs diff {err:.3e} "
          f"(rtol 1e-5, atol 1e-3; {time.perf_counter() - t0:.2f} s with the CPU's)", flush=True)
    if not (torch.isfinite(on_card).all() and torch.allclose(on_card, on_cpu, rtol=1e-5, atol=1e-3)):
        _fail(f"eval (a): the bound on the card differs from the CPU's by {err}")

    # (b) the eval path's run: evaluate_iwae at k = 5000
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    bound = trainer.evaluate_iwae(dm, best, k=k)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    elbo = -trainer.evaluate(dm, best)["test/loss_total"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.evaluate_iwae(dm, best, k=k)
        torch.cuda.synchronize()
    k1_ms = busy_ms = 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
        if str(e.device_type).endswith("CUDA") and us > 0 and "#" not in e.key:
            busy_ms += us / 1e3
            if "gyroplane" in e.key:
                k1_ms += us / 1e3
    share = f"{k1_ms / busy_ms:.6f}" if busy_ms else "not measured (the profiler saw no kernel)"
    print(f"eval (b): evaluate_iwae k={k} on {n_test} test rows: {bound:.4f} nats a row (ELBO "
          f"{elbo:.4f}); wall {wall:.3f} s; launches {json.dumps(launches)}; under torch.profiler "
          f"K1 {k1_ms:.4f} ms of {busy_ms:.3f} ms of kernel time (share {share})", flush=True)
    want = {"gyroplane_distances": -(-n_test // BATCH) * -(-k // IWAE_K), "flagship_fused": 0,
            "flagship_train": 0}
    if launches != want:
        _fail(f"eval (b): launches {launches}, want {want}")
    if not (np.isfinite(bound) and bound >= elbo):
        _fail(f"eval (b): the bound {bound} is not finite or below the ELBO {elbo}")

    # (c) embeddings and probes, card against CPU
    cpu_trainer = Trainer(cpu, seed=trainer.seed, device="cpu")
    z_card, y_card = trainer.encode_split(dm, best, "test")
    z_cpu, y_cpu = cpu_trainer.encode_split(dm, best_cpu, "test")
    err = float(np.abs(z_card - z_cpu).max())
    t0 = time.perf_counter()
    acc = trainer.evaluate_probe(dm, best, k=10)
    probe_s = time.perf_counter() - t0
    acc_cpu = cpu_trainer.evaluate_probe(dm, best_cpu, k=10)
    print(f"eval (c): encode_split test embeddings card vs CPU max abs diff {err:.3e}; probe on "
          f"the card {json.dumps(acc)} in {probe_s:.3f} s, on the CPU {json.dumps(acc_cpu)}",
          flush=True)
    if z_card.shape != (n_test, D) or err > 1e-5 or not np.array_equal(y_card, y_cpu):
        _fail(f"eval (c): embeddings {z_card.shape} differ card vs CPU by {err}")
    if acc.keys() != acc_cpu.keys() or any(abs(acc[k] - acc_cpu[k]) > 1.0 / n_test + 1e-12
                                           for k in acc):
        _fail(f"eval (c): probe accuracies differ card vs CPU: {acc} vs {acc_cpu}")

    # (d) evaluate under a beta warm-up longer than the fit
    sched = beta_warmup_schedule(1.0, warmup_epochs=10)
    model = GyroplaneVAE(device="cuda")
    got = Trainer(model, max_epochs=2, beta_schedule=sched).evaluate(dm, best)
    static = copy.deepcopy(model)
    static.beta = float(sched(2))
    want = Trainer(static, max_epochs=2).evaluate(dm, best)
    unscheduled = Trainer(model, max_epochs=2).evaluate(dm, best)
    print(f"eval (d): evaluate with beta warm-up 10 > max_epochs 2: {json.dumps(got)} (beta "
          f"{static.beta}); with the model's beta {model.beta}: {json.dumps(unscheduled)}", flush=True)
    if got != want or model.beta != 1.0 or got["test/loss_total"] == unscheduled["test/loss_total"]:
        _fail(f"eval (d): the scheduled evaluate {got} is not the static beta's {want}")

    # (e) the figure callbacks through a fit on the card
    with tempfile.TemporaryDirectory() as log_dir:
        model = GyroplaneVAE(generator=torch.Generator().manual_seed(0), device="cuda")
        Trainer(model, max_epochs=1, early_stopping_patience=None, log_dir=log_dir,
                loss_fn=ff.make_fused_loss_fn(model), train_step_fn=ff.make_fused_train_step(model),
                callbacks=[GenerateCallback(every_n_epochs=1), LatentGridCallback(every_n_epochs=1),
                           LatentInterpolationCallback(every_n_epochs=1)]).fit(dm)
        shapes = {}
        for name, shape in (("reconstructions", (56, 224)), ("latent_grid", (308, 308)),
                            ("latent_interpolation", (168, 336))):
            path = Path(log_dir) / f"{name}_00000.png"
            img = read_png(path) if path.exists() else None
            if img is None or img.shape != shape or img.dtype != np.uint8:
                _fail(f"eval (e): {path.name}: {None if img is None else img.shape}, want {shape}")
            shapes[name] = img.shape
    print(f"eval (e): callbacks wrote {json.dumps(shapes)}", flush=True)
    return launches


# the RNA-seq family at its realistic width (benchmarks/bench_rnaseq.py's
# "GSE115978-realistic config"): genes, hidden units (= K1's planes), cells
RNA_GENES, RNA_HIDDEN, RNA_CELLS = 20480, 256, 8192
RNA_FIT_EPOCHS = 20  # two chunks of 10 (cut from 30 to make room for shard_phase)
RNA_IWAE_K = 5000
RNA_K_CHUNK = 100  # evaluate_iwae's k_chunk here: a chunk's decode is 100 x 256 rows
# a training step's wide products: five of 2 B G H flops (the forward's
# two, their weight gradients, and the decoder's input gradient; the
# encoder's input needs none). bench_rnaseq.py counts 3 x the forward's two.
RNA_PRODUCT_FLOP = 2 * BATCH * RNA_GENES * RNA_HIDDEN
RNA_STEP_FLOP, RNA_BENCH_STEP_FLOP = 5 * RNA_PRODUCT_FLOP, 6 * RNA_PRODUCT_FLOP
# (b)'s parameter rule after five Adam steps card vs CPU: the largest share
# of a tensor's elements outside rtol/atol. Gradients that differ by
# rounding (a few 1e-6 of their largest) leave 0.1-1 % outside (where a
# moment is within rounding of zero, Adam steps either way); a planted
# error of 1e-4 of each gradient's largest at every step (the gradient
# rule's own limit), the control, leaves ~10 % outside.
RNA_RTOL, RNA_ATOL, RNA_SHARE_LIMIT, RNA_CONTROL_NOISE = 5e-3, 3e-4, 2.5e-2, 1e-4


@functools.cache
def _rnaseq_data():
    """``make_rnaseq_data_module(fake=True, n_samples=RNA_CELLS,
    n_genes=RNA_GENES, structured_fake=True)``, drawn once (~14 s on the
    host) for the RNA-seq and pvae phases."""
    from hyperbolic_vae_tpu_torch.data import make_rnaseq_data_module

    return make_rnaseq_data_module(batch_size=BATCH, fake=True, n_samples=RNA_CELLS,
                                   n_genes=RNA_GENES, structured_fake=True)


def _dense_tree(rng, n_in: int, n_out: int) -> dict:
    """A flax Dense's parameters as its init draws them (lecun-normal
    kernel (in, out), zero bias), in numpy."""
    kernel = rng.standard_normal((n_in, n_out), dtype=np.float32) / np.float32(np.sqrt(n_in))
    return {"kernel": kernel, "bias": np.zeros(n_out, np.float32)}


def _rnaseq_jax_tree(seed: int) -> dict:
    """Seeded weights in the JAX ``RNASeqVAE``'s tree layout (numpy,
    kernels (in, out)), drawn as flax initialises them: lecun-normal
    kernels, zero biases, gyroplane points expmap0(unit direction x N(0,
    1)) on the c = 1 ball, gyroplane biases U(-1, 1), ``nb_log_theta`` 0."""
    import torch

    from hyperbolic_vae_tpu_torch.manifolds import PoincareBall

    rng = np.random.default_rng(seed)
    v = rng.standard_normal((RNA_HIDDEN, D))
    v *= rng.standard_normal((RNA_HIDDEN, 1)) / np.linalg.norm(v, axis=-1, keepdims=True)
    points = PoincareBall(1.0).expmap0(torch.from_numpy(v.astype(np.float32))).numpy()
    return {"enc": _dense_tree(rng, RNA_GENES, RNA_HIDDEN), "mu": _dense_tree(rng, RNA_HIDDEN, D),
            "scale": _dense_tree(rng, RNA_HIDDEN, D),
            "gyroplanes": {"mp_points": points,
                           "bias": rng.uniform(-1, 1, RNA_HIDDEN).astype(np.float32)},
            "dec_out": _dense_tree(rng, RNA_HIDDEN, RNA_GENES),
            "nb_log_theta": np.zeros(RNA_GENES, np.float32)}


def _rnaseq_ll_elbo(metrics: dict, split: str, recon: str, genes: int) -> float:
    """The ELBO a row under the bound's likelihood, from ``evaluate``'s
    means at beta = 1: the ``mse`` loss is a sum of squares, the bound's a
    unit Gaussian, -0.5 sum (x - x_hat)^2 - 0.5 G log(2 pi); ``nb``'s are
    the same density."""
    rec, kl = metrics[f"{split}/loss_recon"], metrics[f"{split}/loss_kl"]
    if recon == "nb":
        return -(rec + kl)
    return -(0.5 * rec + 0.5 * genes * np.log(2.0 * np.pi) + kl)


def _share_outside(a, b, rtol: float, atol: float) -> float:
    """The share of elements of a and b (tensors) outside allclose's rule."""
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float(((a - b).abs() > atol + rtol * b.abs()).double().mean())


def _five_steps(make, draws, on: str, noise: float = 0.0):
    """Five eager steps (``loss_from_eps``, autograd backward,
    RiemannianAdam lr 1e-3) of ``make(on)`` on ``draws`` (batch, eps; or
    batch and a tuple of the posterior's draws, which ``loss_from_noise``
    takes): (losses, first-step gradients, parameters after five steps),
    the tensors copied to the CPU. With ``noise``, each gradient gets N(0,
    noise x its largest magnitude) an element before each step."""
    import torch

    from hyperbolic_vae_tpu_torch.optim import RiemannianAdam

    m = make(on)
    opt = RiemannianAdam(m.parameters(), lr=1e-3, betas=(0.9, 0.999), ball=m.ball)
    gen = torch.Generator().manual_seed(13)
    losses, grads = [], None
    for xb, eps in draws:
        x = torch.from_numpy(xb).to(on)
        if isinstance(eps, tuple):
            loss = m.loss_from_noise(x, tuple(torch.from_numpy(e).to(on) for e in eps))
        else:
            loss = m.loss_from_eps(x, torch.from_numpy(eps).to(on))
        opt.zero_grad()
        loss["loss_total"].backward()
        if grads is None:
            grads = {n: q.grad.detach().cpu().clone() for n, q in m.named_parameters()}
        for q in m.parameters() if noise else ():
            q.grad += noise * q.grad.abs().max() * torch.randn(q.shape, generator=gen).to(on)
        opt.step()
        losses.append(float(loss["loss_total"].detach()))
    return losses, grads, {n: q.detach().cpu() for n, q in m.named_parameters()}


def _card_vs_cpu(what: str, make, draws, share_limit: float = RNA_SHARE_LIMIT) -> None:
    """Five steps (``_five_steps``) on the card and on the CPU from the same
    weights, batches and eps: every loss, first-step gradient and parameter
    finite; the first step's gradients within 1e-4 of each tensor's
    largest; each step's loss rtol 1e-4; after five steps at most
    ``share_limit`` (default ``RNA_SHARE_LIMIT``) of any tensor's elements
    outside ``RNA_RTOL``/``RNA_ATOL``, and the control (the card's five
    steps with ``RNA_CONTROL_NOISE`` planted at every step) over it."""
    import torch

    card, cpu = _five_steps(make, draws, "cuda"), _five_steps(make, draws, "cpu")
    control = _five_steps(make, draws, "cuda", RNA_CONTROL_NOISE)
    for run_name, (losses, grads, params) in (("card", card), ("CPU", cpu), ("control", control)):
        if not (np.isfinite(losses).all()
                and all(torch.isfinite(t).all() for t in (*grads.values(), *params.values()))):
            _fail(f"{what}: a non-finite loss, gradient or parameter on the {run_name} run "
                  f"(losses {losses})")
    grad_err = np.max([float((card[1][n] - g_).abs().max() / g_.abs().max())
                       for n, g_ in cpu[1].items()])
    loss_err = np.max([abs(a - b) / abs(b) for a, b in zip(card[0], cpu[0])])
    share, control_share = (max(_share_outside(run[2][n], p_, RNA_RTOL, RNA_ATOL)
                                for n, p_ in cpu[2].items()) for run in (card, control))
    print(f"{what}: 5 eager f32 steps card vs CPU: losses {json.dumps([card[0], cpu[0]])} "
          f"(largest relative difference {loss_err:.3e}); first step's gradients max abs diff "
          f"{grad_err:.3e} of each tensor's largest; after 5 steps the largest share of a "
          f"tensor's elements outside rtol {RNA_RTOL}/atol {RNA_ATOL} {share:.4e} (limit "
          f"{share_limit}; the control with {RNA_CONTROL_NOISE} of each gradient's largest "
          f"planted at every step {control_share:.4e})", flush=True)
    if not grad_err <= 1e-4:
        _fail(f"{what}: first-step gradients card vs CPU differ by {grad_err} of their scale")
    if not loss_err <= 1e-4:
        _fail(f"{what}: losses card vs CPU differ by {loss_err} of their size")
    if not share <= share_limit:
        _fail(f"{what}: {share} of a tensor's elements card vs CPU outside rtol {RNA_RTOL}/"
              f"atol {RNA_ATOL} after 5 steps, over {share_limit}")
    if not control_share > share_limit:
        _fail(f"{what}: the control's share {control_share} is within {share_limit}: the "
              "rule does not see an error at the gradient rule's limit")


def rnaseq_phase():
    """The RNA-seq family (``RNASeqVAE``, genes -> hidden 256 -> 2-D ball,
    c = 1 -> 256 gyroplanes -> genes, batch 256) on the card, from seed-0
    weights in the JAX tree's layout (``_rnaseq_jax_tree``) carried through
    ``state_dict_from_jax_params``, on ``make_rnaseq_data_module(fake=True,
    n_samples=8192, n_genes=20480, structured_fake=True)`` (5,734 train,
    1,228 val, 1,230 test rows, z-scored):

      (a) K1 at 256 planes against its plain version (``_k1_check``'s
          rules) at B = 256 (every training, validation and serving batch)
          and 25,600 (the IWAE decode), at both on the wide kernel and
          bit for bit the fallback kernel's (``_k1_wide_check``), timed
          from Python and from graph replay beside an empty launch of its
          grid;
      (b) five eager f32 steps (``loss_from_eps``, autograd backward,
          RiemannianAdam) on the card and on the CPU from the same weights,
          batches and eps: every loss, first-step gradient and parameter
          finite; the first step's gradients within 1e-4 of each tensor's
          largest (f32 sums over 20,480 genes in another order); each
          step's loss rtol 1e-4; after five steps at most 2.5 % of any
          tensor's elements outside rtol 5e-3 / atol 3e-4 (``RNA_RTOL``'s
          note), and a control that must exceed that share: the card's
          five steps again with an error of 1e-4 of each gradient's
          largest planted at every step;
      (c) ``Trainer.fit`` graphed against eager, two epochs each, bit for
          bit, in three arms: f32; ``compute_dtype=param_dtype="bfloat16"``;
          ``recon="nb"`` on raw counts (``rnaseq_normalize_method=None``, a
          quarter of the cells), whose trained model then takes a z-scored
          batch: its loss is NaN and the finite guard skips the step
          (nothing changes). Each graphed fit launches K1 once a training
          step and val batch;
      (d) the f32 and bf16 graphed steps' wall, busy, idle share and
          kernels a step (``_profile_train``), and TFLOP/s from the five
          wide products' 13.4 GFLOP a step (and from bench_rnaseq.py's
          16.1);
      (e) a ``RNA_FIT_EPOCHS``-epoch graphed f32 fit (``epochs_per_dispatch=10``,
          ``checkpoint_dir``): its best val loss_total below its first;
      (f) ``Inferencer.from_checkpoint(dir, "best")`` behind
          ``InferenceServer`` on 127.0.0.1: embed, decode, reconstruct (2,048
          rows as octet-stream) and generate, the reconstruct equal, bit for
          bit, to the restored model's decode of its posterior mean batch by
          batch on the card; one latency a request;
      (g) ``evaluate_iwae(k=5000, batch_chunk=256, k_chunk=100)`` on the
          test split: exactly 250 K1 launches (5 batch chunks x 50 k
          chunks), the bound at least the ELBO under the same likelihood;
          its wall time, then K1's device time under torch.profiler.

    Returns (K1's entry at 256 planes, launches by path)."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from hyperbolic_vae_tpu_torch.data import make_rnaseq_data_module
    from hyperbolic_vae_tpu_torch.interop import state_dict_from_jax_params
    from hyperbolic_vae_tpu_torch.models import RNASeqVAE
    from hyperbolic_vae_tpu_torch.serve import Inferencer
    from hyperbolic_vae_tpu_torch.serve_http import InferenceServer
    from hyperbolic_vae_tpu_torch.train import Trainer
    from hyperbolic_vae_tpu_torch.train.cuda_graph import run_eagerly
    from hyperbolic_vae_tpu_torch.train.epoch_program import train_step

    t_phase = time.perf_counter()
    data_kw = dict(batch_size=BATCH, fake=True, n_samples=RNA_CELLS, n_genes=RNA_GENES,
                   structured_fake=True)
    dm = _rnaseq_data()
    # the nb arm's raw counts on a quarter of the cells (drawing them is the
    # host's slowest set-up)
    counts = make_rnaseq_data_module(**{**data_kw, "n_samples": RNA_CELLS // 4},
                                     rnaseq_normalize_method=None)
    print(f"rnaseq: data {dm.x_train.shape[0]} train, {dm.x_val.shape[0]} val, "
          f"{dm.x_test.shape[0]} test rows of {RNA_GENES} genes, z-scored; "
          f"{counts.x_train.shape[0]} train rows of raw counts "
          f"({time.perf_counter() - t_phase:.2f} s)", flush=True)

    sd = state_dict_from_jax_params(_rnaseq_jax_tree(0), model="rnaseq")

    def make(recon="mse", dtype="float32", on="cuda"):
        m = RNASeqVAE(RNA_GENES, RNA_HIDDEN, recon=recon, compute_dtype=dtype, param_dtype=dtype,
                      device=on)
        m.load_state_dict({k_: v for k_, v in sd.items() if recon == "nb" or k_ != "nb_log_theta"})
        return m

    # (a) K1 at 256 planes
    rng = np.random.default_rng(11)
    iwae_rows = RNA_K_CHUNK * BATCH
    err_in, err_bd = _k1_check(rng, (BATCH, iwae_rows), RNA_HIDDEN)
    print(f"rnaseq (a): K1 at P={RNA_HIDDEN}: max_abs_err vs plain: interior {err_in:.3e}, "
          f"near boundary {err_bd:.3e}", flush=True)
    _k1_wide_check("rnaseq (a)", (BATCH, iwae_rows), RNA_HIDDEN, (1.0,), seed=13)
    k1 = _k1_entry(err_in, err_bd, _k1_times(rng, BATCH, RNA_HIDDEN),
                   _k1_times(rng, iwae_rows, RNA_HIDDEN))

    # (b) five eager f32 steps, card against CPU, and the control
    rng = np.random.default_rng(12)
    draws = [(dm.x_train[rng.integers(0, dm.x_train.shape[0], BATCH)],
              rng.normal(size=(BATCH, D)).astype(np.float32)) for _ in range(5)]
    _card_vs_cpu("rnaseq (b)", lambda on: make(on=on), draws)

    steps = dm.x_train.shape[0] // BATCH
    n_val = dm.x_val.shape[0]
    per_epoch = steps + n_val // BATCH + (1 if n_val % BATCH else 0)

    def fit(data, epochs, eager=False, recon="mse", dtype="float32", **kw):
        model = make(recon, dtype)
        trainer = Trainer(model, max_epochs=epochs, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with run_eagerly() if eager else contextlib.nullcontext():
            res = trainer.fit(data)
        torch.cuda.synchronize()
        return res, trainer, time.perf_counter() - t0

    # (c) graphed against eager, three arms
    paths, graphed = {}, {}
    for arm, data, kw in (("f32", dm, {}), ("bf16", dm, dict(dtype="bfloat16")),
                          ("nb", counts, dict(recon="nb"))):
        _reset_launches()
        res, trainer, wall = fit(data, 2, early_stopping_patience=None, **kw)
        launches = _launches()
        eres, _, ewall = fit(data, 2, eager=True, early_stopping_patience=None, **kw)
        _same_fit(f"rnaseq {arm}", res, eres, "graphed", "eager")
        if not all(np.isfinite(v) for row in res.history for v in row.values()):
            _fail(f"rnaseq (c) {arm}: non-finite metrics {res.history}")
        n_v = data.x_val.shape[0]
        per = data.x_train.shape[0] // BATCH + n_v // BATCH + (1 if n_v % BATCH else 0)
        want = {"gyroplane_distances": 2 * per, "flagship_fused": 0, "flagship_train": 0}
        if launches != want:
            _fail(f"rnaseq (c) {arm}: launches {launches}, want {want}")
        paths[f"rnaseq_fit_{arm}"] = launches
        graphed[arm] = trainer
        print(f"rnaseq (c) {arm}: 2 epochs graphed {wall:.3f} s, eager {ewall:.3f} s, bit for bit; "
              f"launches {json.dumps(launches)}; val/loss_total "
              f"{[h['val/loss_total'] for h in res.history]}", flush=True)
    # the nb model on a z-scored batch: NaN, skipped, nothing changes
    trainer = graphed["nb"]
    model, opt = trainer.model, trainer.optimizer
    before = [t.detach().clone() for t in list(model.state_dict().values())
              + [s_ for st in opt.state.values() for s_ in st.values()] + [opt.count]]
    gen = torch.Generator(device="cuda").manual_seed(5)
    m = train_step(model, opt, torch.from_numpy(dm.x_train[:BATCH]).cuda(), gen)
    after = list(model.state_dict().values()) + [s_ for st in opt.state.values()
                                                 for s_ in st.values()] + [opt.count]
    if not (np.isnan(float(m["loss_total"])) and float(m["skipped_steps"]) == 1.0
            and all(torch.equal(a, b) for a, b in zip(before, after))):
        _fail(f"rnaseq (c) nb: a z-scored batch gave {({k_: float(v) for k_, v in m.items()})}, "
              "or the skipped step changed the state")
    print("rnaseq (c) nb: a z-scored batch: loss NaN, skipped_steps 1, state unchanged", flush=True)

    # (d) the graphed steps' time
    for arm in ("f32", "bf16"):
        prof = _profile_train(graphed[arm].program, "cuda")
        print(f"rnaseq (d) {arm} graphed: {prof['what']}: wall {prof['wall_ms']:.4f} ms/step, "
              f"device busy {prof['busy_ms']:.4f} ms/step, idle share {prof['idle']}, "
              f"{prof['kernels']:.1f} kernels/step; {BATCH / prof['wall_ms'] * 1e3:.1f} train "
              f"samples/s; {RNA_STEP_FLOP / (prof['wall_ms'] * 1e-3) / 1e12:.2f} TFLOP/s from the "
              f"five wide products' {RNA_STEP_FLOP / 1e9:.1f} GFLOP a step "
              f"({RNA_BENCH_STEP_FLOP / (prof['wall_ms'] * 1e-3) / 1e12:.2f} from bench_rnaseq.py's "
              f"{RNA_BENCH_STEP_FLOP / 1e9:.1f})", flush=True)
    del graphed, trainer, model, opt

    with tempfile.TemporaryDirectory() as ckpt:
        # (e) the fit
        _reset_launches()
        res, trainer, wall = fit(dm, RNA_FIT_EPOCHS, epochs_per_dispatch=10, checkpoint_dir=ckpt)
        paths["rnaseq_fit"] = _launches()
        vals = [h["val/loss_total"] for h in res.history]
        print(f"rnaseq (e): {res.epochs_run} epochs graphed in {wall:.3f} s "
              f"({res.samples_per_sec:.1f} train samples/s after the first chunk); val/loss_total "
              f"first {vals[0]:.4f}, best {res.best_metric:.4f} at epoch {int(np.argmin(vals))}; "
              f"launches {json.dumps(paths['rnaseq_fit'])}", flush=True)
        if not res.best_metric < vals[0]:
            _fail(f"rnaseq (e): best val/loss_total {res.best_metric} not below the first {vals[0]}")
        if paths["rnaseq_fit"]["gyroplane_distances"] != res.epochs_run * per_epoch:
            _fail(f"rnaseq (e): launches {paths['rnaseq_fit']}, want {res.epochs_run * per_epoch}")

        # (f) served from the best checkpoint
        inf = Inferencer.from_checkpoint(ckpt, "best", batch_size=BATCH)
        for key, v in res.best_params.items():
            if not torch.equal(inf.model.state_dict()[key], v):
                _fail(f"rnaseq (f): the best checkpoint's {key} is not the fit's best params")
        t0 = time.perf_counter()
        inf.warmup()
        torch.cuda.synchronize()
        print(f"rnaseq (f): warmup {time.perf_counter() - t0:.3f} s, {inf.n_programs} programs",
              flush=True)
        x = dm.x_test[:1]
        xr = np.ascontiguousarray(np.concatenate([dm.x_test, dm.x_val])[:2048], "<f4")
        z = np.random.default_rng(1).uniform(-0.6, 0.6, size=(64, D)).astype(np.float32)
        octet = {"Content-Type": "application/octet-stream",
                 "Accept": "application/octet-stream"}
        server = InferenceServer(inf, host="127.0.0.1", port=0).start()
        lat = {}
        try:
            _reset_launches()
            jhdr = {"Content-Type": "application/json"}
            _, body, lat["POST /v1/embed 1 row json"] = _http(
                server, "/v1/embed", json.dumps({"data": x.tolist()}).encode(), jhdr)
            emb = np.asarray(json.loads(body)["outputs"][0], np.float32)
            h, body, lat["POST /v1/decode 64 latents octet-stream"] = _http(
                server, "/v1/decode", z.tobytes(), {**octet, "X-Shape": "64,2"})
            dec = np.frombuffer(body, "<f4").reshape(tuple(int(s_) for s_ in h["X-Shape"].split(",")))
            h, body, lat["POST /v1/reconstruct 2048 rows octet-stream"] = _http(
                server, "/v1/reconstruct", xr.tobytes(),
                {**octet, "X-Shape": ",".join(map(str, xr.shape))})
            rec = np.frombuffer(body, "<f4").reshape(tuple(int(s_) for s_ in h["X-Shape"].split(",")))
            gens = []
            for i in range(2):
                h, body, lat[f"POST /v1/generate n=512 seed=3 octet-stream ({i + 1})"] = _http(
                    server, "/v1/generate", json.dumps({"n": 512, "seed": 3}).encode(),
                    {**jhdr, "Accept": "application/octet-stream"})
                gens.append(np.frombuffer(body, "<f4").reshape(
                    tuple(int(s_) for s_ in h["X-Shape"].split(","))))
            paths["rnaseq_serve"] = _launches()
        finally:
            server.shutdown()
        for name, ms in lat.items():
            print(f"rnaseq (f) latency {name}: {ms:.3f} ms", flush=True)
        for name, a, shape in (("embed", emb, (1, D)), ("decode", dec, (64, RNA_GENES)),
                               ("reconstruct", rec, (2048, RNA_GENES)),
                               ("generate", gens[0], (512, RNA_GENES))):
            if a.shape != shape or not np.all(np.isfinite(a)):
                _fail(f"rnaseq (f): {name}: shape {a.shape} (want {shape}) or non-finite values")
        if not np.array_equal(gens[0], gens[1]):
            _fail("rnaseq (f): generate(n=512, seed=3) differs between two requests")
        with torch.inference_mode():
            want = torch.cat([inf.model.decode(inf.model.encode(
                torch.from_numpy(xr[i:i + BATCH]).cuda())[0]) for i in range(0, 2048, BATCH)])
        if not np.array_equal(rec, want.cpu().numpy()):
            _fail(f"rnaseq (f): the served reconstruct differs from the model's by "
                  f"{float(np.abs(rec - want.cpu().numpy()).max())}")
        # one K1 launch a decoded batch: 1 (decode 64), 8 (reconstruct 2048),
        # 2 x 2 (generate 512 twice); embed decodes nothing
        want_l = {"gyroplane_distances": 13, "flagship_fused": 0, "flagship_train": 0}
        if paths["rnaseq_serve"] != want_l:
            _fail(f"rnaseq (f): launches {paths['rnaseq_serve']}, want {want_l}")
        print(f"rnaseq (f): reconstruct of 2048 rows equal to the model's, bit for bit; launches "
              f"{json.dumps(paths['rnaseq_serve'])}", flush=True)
        del inf, server

    # (g) the bound
    best = res.best_params
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    bound = trainer.evaluate_iwae(dm, best, k=RNA_IWAE_K, batch_chunk=BATCH, k_chunk=RNA_K_CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    paths["rnaseq_eval"] = _launches()
    elbo = _rnaseq_ll_elbo(trainer.evaluate(dm, best), "test", "mse", RNA_GENES)
    n_test = dm.x_test.shape[0]
    chunks = -(-n_test // BATCH) * -(-RNA_IWAE_K // RNA_K_CHUNK)
    want_l = {"gyroplane_distances": chunks, "flagship_fused": 0, "flagship_train": 0}
    if paths["rnaseq_eval"] != want_l:
        _fail(f"rnaseq (g): launches {paths['rnaseq_eval']}, want {want_l}")
    if not (np.isfinite(bound) and bound >= elbo):
        _fail(f"rnaseq (g): the bound {bound} is not finite or below the ELBO {elbo}")
    k1_ms = busy_ms = 0.0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.evaluate_iwae(dm, best, k=RNA_IWAE_K, batch_chunk=BATCH, k_chunk=RNA_K_CHUNK)
        torch.cuda.synchronize()
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
        if str(e.device_type).endswith("CUDA") and us > 0 and "#" not in e.key:
            busy_ms += us / 1e3
            if "gyroplane" in e.key:
                k1_ms += us / 1e3
    share = f"{k1_ms / busy_ms:.6f}" if busy_ms else "not measured (the profiler saw no kernel)"
    print(f"rnaseq (g): evaluate_iwae k={RNA_IWAE_K} (k_chunk {RNA_K_CHUNK}) on {n_test} test rows: "
          f"{bound:.4f} nats a row (ELBO under the same likelihood {elbo:.4f}); wall {wall:.3f} s; "
          f"launches {json.dumps(paths['rnaseq_eval'])}; under torch.profiler K1 {k1_ms:.4f} ms of "
          f"{busy_ms:.3f} ms of kernel time (share {share}, {k1_ms / chunks * 1e3:.3f} us "
          f"a launch)", flush=True)
    print(f"rnaseq: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return k1, {p_: n["gyroplane_distances"] for p_, n in paths.items()}


# experiment 5 (experiments/train_vae_hyperbolic_mnist.py): MNIST padded to
# 32 x 32, conv widths 16 -> 32 -> 32, a Mobius encoder head, 512 gyroplanes
# (K1's planes) on the c = 1.4 ball, sum-MSE, batch 256
CONV_C, CONV_BASE, CONV_SHAPE = 1.4, 16, (32, 32, 1)
CONV_P = 2 * CONV_BASE * (CONV_SHAPE[0] // 8) * (CONV_SHAPE[1] // 8)
EXP5 = dict(data_shape=CONV_SHAPE, latent_dim=D, manifold_curvature=CONV_C,
            encoder_last_layer_module="mobius", decoder_first_layer_module="geoopt_gyroplane",
            loss_recon="mse", base_channels=CONV_BASE)
# the fit's epochs: 10 until PR 13, cut to 6 (two chunks of 3) to make room for data_mesh_phase
CONV_FIT_EPOCHS, CONV_IWAE_K, CONV_TEST_ROWS = 6, 5000, 1024


def _top(prof: dict) -> str:
    """``_profile_train``'s top kernels as text: ms and launches a step."""
    return "; ".join(f"{k} {ms:.4f} ms x{c:.1f}" for k, ms, c in prof["top"])


def _exp5_jax_tree(seed: int) -> dict:
    """Seeded weights in the JAX ``HyperbolicImageVAE``'s tree layout at
    experiment 5's config (numpy; conv kernels (kh, kw, in, out)), drawn as
    flax and the JAX layers initialise them: lecun-normal kernels, zero
    biases, the Mobius head's kaiming (a = sqrt 5) weight and U(+-4/sqrt(in))
    scalar bias, gyroplane points expmap0(unit direction x N(0, 1)) on the
    c = 1.4 ball, gyroplane biases U(-1, 1)."""
    import torch

    from hyperbolic_vae_tpu_torch.manifolds import PoincareBall

    rng = np.random.default_rng(seed)
    m = CONV_BASE

    def conv(n_in, n_out):
        k = rng.standard_normal((3, 3, n_in, n_out), dtype=np.float32) / np.float32(np.sqrt(9 * n_in))
        return {"kernel": k, "bias": np.zeros(n_out, np.float32)}

    v = rng.standard_normal((CONV_P, D))
    v *= rng.standard_normal((CONV_P, 1)) / np.linalg.norm(v, axis=-1, keepdims=True)
    points = PoincareBall(CONV_C).expmap0(torch.from_numpy(v.astype(np.float32))).numpy()
    return {
        "conv1": conv(1, m), "conv2": conv(m, 2 * m), "conv3": conv(2 * m, 2 * m),
        "mu_mobius": {
            "weight_t0": (rng.standard_normal((D, CONV_P)) * np.sqrt(1 / 3 / CONV_P)).astype(np.float32),
            "bias_scalar": rng.uniform(-4, 4, (D, 1)).astype(np.float32) / np.float32(np.sqrt(CONV_P))},
        "log_var": {"kernel": rng.standard_normal((CONV_P, D), dtype=np.float32)
                    / np.float32(np.sqrt(CONV_P)), "bias": np.zeros(D, np.float32)},
        "dec_first": {"mp_points": points, "bias": rng.uniform(-1, 1, CONV_P).astype(np.float32)},
        "deconv1": conv(2 * m, 2 * m), "conv4": conv(2 * m, 2 * m), "deconv2": conv(2 * m, m),
        "conv5": conv(m, m), "deconv3": conv(m, 1),
    }


def conv_phase():
    """The conv image families on the card (cuDNN deterministic, TF32 off,
    as ``main()`` sets them), experiment 5's ``HyperbolicImageVAE`` (K1 at
    512 planes, c = 1.4 in every decode) on synthetic MNIST padded to 32 x 32
    (54,000 train, 6,000 val, 1,024 test rows), ``EuclideanVAE`` at
    experiment 2's width (hidden 32, latent 128) and ``Autoencoder`` at
    experiment 1's (base 32, latent 128) on synthetic CIFAR-10 (45,000 /
    5,000 rows), batch 256:

      (a) K1 at 512 planes, c = 1.4, against its plain version
          (``_k1_check``'s rules) at B = 256 (every training, validation and
          serving batch) and 128,000 (the IWAE decode, k_chunk 500 x 256
          rows), at both on the wide kernel and bit for bit the fallback
          kernel's (``_k1_wide_check``), and timed (``_k1_times``, beside
          an empty launch);
      (b) five eager f32 steps of experiment 5 card vs CPU from numpy-seeded
          weights in JAX's tree (``_exp5_jax_tree``) carried through
          ``state_dict_from_jax_params`` (``_card_vs_cpu``'s rules);
      (c) ``Trainer.fit`` graphed against eager, two epochs each, bit for
          bit, for experiment 5 (f32 and ``compute_dtype="bfloat16"``), the
          EuclideanVAE and the Autoencoder; each graphed step's wall, busy,
          idle share and kernels a step (``_profile_train``); experiment
          5's step once more from a graphed epoch with cuDNN free to pick
          non-deterministic algorithms (what determinism costs);
      (d) a ``CONV_FIT_EPOCHS``-epoch graphed fit of experiment 5
          (``epochs_per_dispatch=5``, checkpoints), its best checkpoint
          served over HTTP (embed, decode, reconstruct of 2,048 rows,
          generate), reconstruct equal bit for bit to the restored model
          batch by batch; the EuclideanVAE's and the Autoencoder's
          checkpoints from (c) served too (reconstruct bit for bit;
          generate, and 404 for the Autoencoder);
      (e) ``evaluate_iwae(k=5000, batch_chunk=256, k_chunk=500)`` on the
          1,024 test rows from (d)'s best params: exactly 40 K1 launches
          (4 batch chunks x 10 k chunks), the bound at least
          ``evaluate_iwae(k=1)``'s; its wall time, then K1's share of the
          kernel time under torch.profiler.

    Cuts: 1,024 test rows, not 10,000; a 6-epoch fit, not a converged one;
    two epochs a graphed/eager pair. Returns (K1's entry at 512 planes,
    launches by path)."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from hyperbolic_vae_tpu_torch.data import cifar10, make_data_module, pad_to_32
    from hyperbolic_vae_tpu_torch.interop import state_dict_from_jax_params
    from hyperbolic_vae_tpu_torch.models import Autoencoder, EuclideanVAE, HyperbolicImageVAE
    from hyperbolic_vae_tpu_torch.serve import Inferencer
    from hyperbolic_vae_tpu_torch.serve_http import InferenceServer
    from hyperbolic_vae_tpu_torch.train import Trainer
    from hyperbolic_vae_tpu_torch.train.cuda_graph import run_eagerly

    device = "cuda"
    sync = torch.cuda.synchronize
    t_phase = time.perf_counter()
    mnist = pad_to_32(make_data_module(batch_size=BATCH, synthetic=True, n_test=CONV_TEST_ROWS))
    cifar = cifar10.make_data_module(batch_size=BATCH, synthetic=True, n_test=CONV_TEST_ROWS)
    print(f"conv: data: MNIST padded {mnist.x_train.shape[0]} / {mnist.x_val.shape[0]} / "
          f"{mnist.x_test.shape[0]} rows of {mnist.input_shape}; CIFAR "
          f"{cifar.x_train.shape[0]} / {cifar.x_val.shape[0]} rows of {cifar.input_shape} "
          f"({time.perf_counter() - t_phase:.2f} s); cuDNN deterministic "
          f"{torch.backends.cudnn.deterministic}, benchmark {torch.backends.cudnn.benchmark}, "
          f"TF32 {torch.backends.cudnn.allow_tf32}", flush=True)
    sd = state_dict_from_jax_params(_exp5_jax_tree(0), "HyperbolicImageVAE")

    def make_exp5(on=device, **kw):
        m = HyperbolicImageVAE(**{**EXP5, **kw}, device=on)
        m.load_state_dict(sd)
        return m

    # (a) K1 at 512 planes, c = 1.4
    rng = np.random.default_rng(21)
    err_in, err_bd = _k1_check(rng, (BATCH, IWAE_ROWS), CONV_P, curvatures=(CONV_C,))
    print(f"conv (a): K1 at P={CONV_P}, c={CONV_C}: max_abs_err vs plain: interior "
          f"{err_in:.3e}, near boundary {err_bd:.3e}", flush=True)
    _k1_wide_check("conv (a)", (BATCH, IWAE_ROWS), CONV_P, (CONV_C,), seed=23)
    k1 = _k1_entry(err_in, err_bd, _k1_times(rng, BATCH, CONV_P, CONV_C),
                   _k1_times(rng, IWAE_ROWS, CONV_P, CONV_C))

    # (b) five eager f32 steps, card against CPU, and the control
    rng = np.random.default_rng(22)
    draws = [(mnist.x_train[rng.integers(0, mnist.x_train.shape[0], BATCH)],
              rng.normal(size=(BATCH, D)).astype(np.float32)) for _ in range(5)]
    _card_vs_cpu("conv (b)", lambda on: make_exp5(on), draws)

    def fit(model, data, epochs, eager=False, **kw):
        trainer = Trainer(model, max_epochs=epochs, early_stopping_patience=None,
                          device=device, **kw)
        sync()
        t0 = time.perf_counter()
        with run_eagerly() if eager else contextlib.nullcontext():
            res = trainer.fit(data)
        sync()
        return res, trainer, time.perf_counter() - t0

    def per_epoch(data):
        n_v = data.x_val.shape[0]
        return data.x_train.shape[0] // BATCH + n_v // BATCH + (1 if n_v % BATCH else 0)

    def no_launches():
        return {"gyroplane_distances": 0, "flagship_fused": 0, "flagship_train": 0}

    def want_k1(n):
        return {**no_launches(), "gyroplane_distances": n}

    # (c) graphed against eager, four arms
    paths = {}
    ckpts = {arm: tempfile.TemporaryDirectory() for arm in ("euclidean", "autoencoder")}
    arms = (
        ("exp5", mnist, lambda: make_exp5(), True, {}),
        ("exp5_bf16", mnist, lambda: make_exp5(compute_dtype="bfloat16"), True, {}),
        ("euclidean", cifar, lambda: EuclideanVAE(
            (32, 32, 3), hidden_size=32, latent_dim=128, device=device,
            generator=torch.Generator().manual_seed(0)), False,
         {"checkpoint_dir": ckpts["euclidean"].name}),
        ("autoencoder", cifar, lambda: Autoencoder(
            (32, 32, 3), base_channel_size=32, latent_dim=128, device=device,
            generator=torch.Generator().manual_seed(0)), False,
         {"checkpoint_dir": ckpts["autoencoder"].name}),
    )
    for arm, data, make, gyro, kw in arms:
        _reset_launches()
        res, trainer, wall = fit(make(), data, 2, **kw)
        launches = _launches()
        eres, _, ewall = fit(make(), data, 2, eager=True)
        _same_fit(f"conv (c) {arm}", res, eres, "graphed", "eager")
        if not all(np.isfinite(v) for row in res.history for v in row.values()):
            _fail(f"conv (c) {arm}: non-finite metrics {res.history}")
        want = want_k1(2 * per_epoch(data)) if gyro else no_launches()
        if launches != want:
            _fail(f"conv (c) {arm}: launches {launches}, want {want}")
        paths[f"conv_fit_{arm}"] = launches
        prof = _profile_train(trainer.program, device)
        print(f"conv (c) {arm}: 2 epochs graphed {wall:.3f} s, eager {ewall:.3f} s, bit for bit; "
              f"launches {json.dumps(launches)}; val/loss_total "
              f"{[h['val/loss_total'] for h in res.history]}; graphed {prof['what']}: wall "
              f"{prof['wall_ms']:.4f} ms/step, device busy {prof['busy_ms']:.4f} ms/step, idle "
              f"share {prof['idle']}, {prof['kernels']:.1f} kernels/step; "
              f"{BATCH / prof['wall_ms'] * 1e3:.1f} train samples/s; top kernels "
              f"{_top(prof)}", flush=True)
        del res, eres, trainer
    # what determinism costs: cuDNN free to pick any algorithm
    torch.backends.cudnn.deterministic = False
    try:
        _reset_launches()
        _, trainer, wall = fit(make_exp5(), mnist, 1)
        paths["conv_fit_exp5_nondeterministic"] = _launches()
        prof = _profile_train(trainer.program, device)
    finally:
        torch.backends.cudnn.deterministic = True
    print(f"conv (c) exp5 with cuDNN non-deterministic: 1 epoch graphed {wall:.3f} s; "
          f"{prof['what']}: wall {prof['wall_ms']:.4f} ms/step, device busy "
          f"{prof['busy_ms']:.4f} ms/step, idle share {prof['idle']}, "
          f"{prof['kernels']:.1f} kernels/step; top kernels {_top(prof)}", flush=True)
    del trainer

    octet = {"Content-Type": "application/octet-stream", "Accept": "application/octet-stream"}
    jhdr = {"Content-Type": "application/json"}

    with tempfile.TemporaryDirectory() as ckpt:
        # (d) the fit, and serving its best checkpoint
        _reset_launches()
        res, trainer, wall = fit(make_exp5(), mnist, CONV_FIT_EPOCHS, epochs_per_dispatch=3,
                                 checkpoint_dir=ckpt)
        paths["conv_fit"] = _launches()
        vals = [h["val/loss_total"] for h in res.history]
        print(f"conv (d): {res.epochs_run} epochs graphed in {wall:.3f} s "
              f"({res.samples_per_sec:.1f} train samples/s after the first chunk); val/loss_total "
              f"first {vals[0]:.4f}, best {res.best_metric:.4f} at epoch {int(np.argmin(vals))}; "
              f"launches {json.dumps(paths['conv_fit'])}", flush=True)
        if not res.best_metric < vals[0]:
            _fail(f"conv (d): best val/loss_total {res.best_metric} not below the first {vals[0]}")
        if paths["conv_fit"] != want_k1(res.epochs_run * per_epoch(mnist)):
            _fail(f"conv (d): launches {paths['conv_fit']}, want "
                  f"{res.epochs_run * per_epoch(mnist)} K1")
        inf = Inferencer.from_checkpoint(ckpt, "best", batch_size=BATCH, device=device)
        for key, v in res.best_params.items():
            if not torch.equal(inf.model.state_dict()[key], v):
                _fail(f"conv (d): the best checkpoint's {key} is not the fit's best params")
        t0 = time.perf_counter()
        inf.warmup()
        sync()
        print(f"conv (d): warmup {time.perf_counter() - t0:.3f} s, {inf.n_programs} programs",
              flush=True)
        xr = np.ascontiguousarray(np.concatenate([mnist.x_test, mnist.x_val])[:2048], "<f4")
        z = np.random.default_rng(1).uniform(-0.5, 0.5, size=(64, D)).astype(np.float32)
        server = InferenceServer(inf, host="127.0.0.1", port=0).start()
        lat = {}
        try:
            _reset_launches()
            _, body, lat["POST /v1/embed 1 row json"] = _http(
                server, "/v1/embed", json.dumps({"data": xr[:1].tolist()}).encode(), jhdr)
            emb = np.asarray(json.loads(body)["outputs"][0], np.float32)
            h, body, lat["POST /v1/decode 64 latents octet-stream"] = _http(
                server, "/v1/decode", z.tobytes(), {**octet, "X-Shape": "64,2"})
            dec = _shaped(h, body)
            h, body, lat["POST /v1/reconstruct 2048 rows octet-stream"] = _http(
                server, "/v1/reconstruct", xr.tobytes(),
                {**octet, "X-Shape": ",".join(map(str, xr.shape))})
            rec = _shaped(h, body)
            gens = []
            for i in range(2):
                h, body, lat[f"POST /v1/generate n=512 seed=3 octet-stream ({i + 1})"] = _http(
                    server, "/v1/generate", json.dumps({"n": 512, "seed": 3}).encode(),
                    {**jhdr, "Accept": "application/octet-stream"})
                gens.append(_shaped(h, body))
            paths["conv_serve"] = _launches()
        finally:
            server.shutdown()
        for name, ms in lat.items():
            print(f"conv (d) latency {name}: {ms:.3f} ms", flush=True)
        for name, a, shape in (("embed", emb, (1, D)), ("decode", dec, (64,) + CONV_SHAPE),
                               ("reconstruct", rec, (2048,) + CONV_SHAPE),
                               ("generate", gens[0], (512,) + CONV_SHAPE)):
            if a.shape != shape or not np.all(np.isfinite(a)):
                _fail(f"conv (d): {name}: shape {a.shape} (want {shape}) or non-finite values")
        if not np.linalg.norm(emb, axis=-1).max() < 1.0 / np.sqrt(CONV_C):
            _fail("conv (d): the embedding lies outside the ball")
        if not np.array_equal(gens[0], gens[1]):
            _fail("conv (d): generate(n=512, seed=3) differs between two requests")
        want = _batchwise(inf, xr)
        if not np.array_equal(rec, want):
            _fail(f"conv (d): the served reconstruct differs from the model's by "
                  f"{float(np.abs(rec - want).max())}")
        # one K1 launch a decoded batch: 1 (decode 64), 8 (reconstruct 2048),
        # 2 x 2 (generate 512 twice); embed decodes nothing
        if paths["conv_serve"] != want_k1(13):
            _fail(f"conv (d): launches {paths['conv_serve']}, want 13 K1")
        print(f"conv (d): reconstruct of 2048 rows equal to the model's, bit for bit; launches "
              f"{json.dumps(paths['conv_serve'])}", flush=True)
        del inf, server

    # the Euclidean controls from their checkpoints of (c): the EuclideanVAE
    # generates, the Autoencoder (no prior) answers 404
    xc = np.ascontiguousarray(cifar.x_test[:512], "<f4")
    for arm, ckpt_dir in ckpts.items():
        inf = Inferencer.from_checkpoint(ckpt_dir.name, "best", batch_size=BATCH, device=device)
        server = InferenceServer(inf, host="127.0.0.1", port=0).start()
        try:
            _reset_launches()
            h, body, ms = _http(server, "/v1/reconstruct", xc.tobytes(),
                                {**octet, "X-Shape": ",".join(map(str, xc.shape))})
            rec = _shaped(h, body)
            try:
                h, body, _ = _http(server, "/v1/generate", json.dumps({"n": 8, "seed": 0}).encode(),
                                   {**jhdr, "Accept": "application/octet-stream"})
                gen, gen_code = _shaped(h, body), 200
            except urllib.error.HTTPError as e:
                gen, gen_code = None, e.code
            paths[f"conv_serve_{arm}"] = _launches()
        finally:
            server.shutdown()
            ckpt_dir.cleanup()
        if not np.array_equal(rec, _batchwise(inf, xc)):
            _fail(f"conv (d): the {arm}'s served reconstruct differs from the model's")
        want_gen = 404 if arm == "autoencoder" else 200
        if gen_code != want_gen or paths[f"conv_serve_{arm}"] != no_launches():
            _fail(f"conv (d): the {arm}'s generate answered {gen_code} (want {want_gen}), "
                  f"launches {paths[f'conv_serve_{arm}']}")
        if gen is not None and (gen.shape != (8, 32, 32, 3) or not np.all(np.abs(gen) <= 1.0)):
            _fail(f"conv (d): the {arm}'s generate gave shape {gen.shape} or values outside [-1, 1]")
        print(f"conv (d): {arm} from its checkpoint: reconstruct 512 rows of {xc.shape[1:]} "
              f"octet-stream {ms:.3f} ms, bit for bit; generate {gen_code}", flush=True)
        del inf, server

    # (e) the bound
    best = res.best_params
    sync()
    _reset_launches()
    t0 = time.perf_counter()
    bound = trainer.evaluate_iwae(mnist, best, k=CONV_IWAE_K, batch_chunk=BATCH, k_chunk=500)
    sync()
    wall = time.perf_counter() - t0
    paths["conv_eval"] = _launches()
    _reset_launches()
    bound_1 = trainer.evaluate_iwae(mnist, best, k=1, batch_chunk=BATCH, k_chunk=500)
    paths["conv_eval_k1"] = _launches()
    n_t = mnist.x_test.shape[0]
    chunks = -(-n_t // BATCH) * -(-CONV_IWAE_K // 500)
    if paths["conv_eval"] != want_k1(chunks) or paths["conv_eval_k1"] != want_k1(-(-n_t // BATCH)):
        _fail(f"conv (e): launches {paths['conv_eval']} and {paths['conv_eval_k1']} (k = 1), "
              f"want {chunks} and {-(-n_t // BATCH)} K1")
    if not (np.isfinite(bound) and bound >= bound_1):
        _fail(f"conv (e): the bound {bound} is not finite or below k = 1's {bound_1}")
    k1_ms = busy_ms = 0.0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.evaluate_iwae(mnist, best, k=CONV_IWAE_K, batch_chunk=BATCH, k_chunk=500)
        sync()
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
        if str(e.device_type).endswith("CUDA") and us > 0 and "#" not in e.key:
            busy_ms += us / 1e3
            if "gyroplane" in e.key:
                k1_ms += us / 1e3
    share = f"{k1_ms / busy_ms:.6f}" if busy_ms else "not measured (the profiler saw no kernel)"
    print(f"conv (e): evaluate_iwae k={CONV_IWAE_K} (k_chunk 500) on {n_t} test rows: {bound:.4f} "
          f"nats a row (k = 1: {bound_1:.4f}); wall {wall:.3f} s; launches "
          f"{json.dumps(paths['conv_eval'])}; under torch.profiler K1 {k1_ms:.4f} ms of "
          f"{busy_ms:.3f} ms of kernel time (share {share}, {k1_ms / chunks * 1e3:.3f} us a "
          f"launch)", flush=True)
    print(f"conv: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return k1, {p_: n["gyroplane_distances"] for p_, n in paths.items()}


# experiment 9 (experiments/pvae_replicate.py, runs/README.md's round-3
# grid): synthetic MNIST, 784 -> 600 (ReLU) -> 2-D ball (c = 1), batch 128,
# lr 5e-4, 80 epochs, no early stopping, IWAE-5000; JAX's converged numbers
# of its riemannian_c1.0_d2 cell (runs/pvae_replicate_r3/replicate_results.json)
PVAE_HIDDEN, PVAE_BATCH, PVAE_LR, PVAE_EPOCHS, PVAE_WRAPPED_EPOCHS = 600, 128, 5e-4, 80, 10
PVAE_JAX_BEST_VAL, PVAE_JAX_IWAE, PVAE_IWAE_K = 319.970, -320.655, 5000
PVAE_CHECK_ROWS = 10000  # (c)'s graphed/eager pairs: 9,000 train and 1,000 val rows
# (b)'s share limit: a tenth of RNA_SHARE_LIMIT. Five steps card vs CPU
# leave no element of these four models outside RNA_RTOL/RNA_ATOL, and the
# control of the same planted error shows far less on the Euclidean
# UnifiedVAE (0.5 %; the others 3.7-13 %), whose gradients have few
# elements near zero for the error to flip
PVAE_SHARE_LIMIT = RNA_SHARE_LIMIT / 10
# experiment 8 (experiments/train_vaes_rnaseq.py:24-31): UnifiedVAE on the
# z-scored fake Jerby-Arnon data, hidden 100 (K1's planes), latent 2, c = 1,
# prior scale 2, beta 0.5, logmap0_analytic KL, sigmoid output, MSE, batch 64
# UnifiedVAE's fits: 10 epochs until PR 13, cut to 6 (two chunks of 3) for data_mesh_phase
UNI_HIDDEN, UNI_BATCH, UNI_FIT_EPOCHS, UNI_K_CHUNK = 100, 64, 6, 100
EXP8 = dict(hidden_layer_dim=UNI_HIDDEN, latent_dim=D, prior_scale=2.0,
            posterior_scale="learned", learning_rate=1e-3, beta=0.5,
            kl_loss_method="logmap0_analytic", last_activation="sigmoid",
            loss_recon_method="MSE")


def _pvae_jax_tree(seed: int, posterior: str) -> dict:
    """Seeded weights in the JAX ``PvaeMLPVAE``'s tree (experiment 9's
    widths, the geodesic decoder): Dense layers as flax draws them; the
    GeodesicLayer's ``weight_t0`` kaiming-normal (a = sqrt 5) and
    ``bias_scalar`` U(+-4/sqrt(in))."""
    rng = np.random.default_rng(seed)
    return {
        "enc": _dense_tree(rng, DATA, PVAE_HIDDEN), "mu": _dense_tree(rng, PVAE_HIDDEN, D),
        "scale": _dense_tree(rng, PVAE_HIDDEN, D if posterior == "wrapped" else 1),
        "dec_geodesic": {
            "weight_t0": (rng.standard_normal((PVAE_HIDDEN, D)) * np.sqrt(1 / 3 / D)).astype(
                np.float32),
            "bias_scalar": (rng.uniform(-4, 4, (PVAE_HIDDEN, 1)) / np.sqrt(D)).astype(np.float32)},
        "dec_out": _dense_tree(rng, PVAE_HIDDEN, DATA),
    }


def _unified_jax_tree(seed: int, ball: bool) -> dict:
    """Seeded weights in the JAX ``UnifiedVAE``'s tree at experiment 8's
    widths (20,480 genes, hidden 100): Dense layers as flax draws them;
    on the ball, gyroplane points expmap0(unit direction x N(0, 1)) and
    biases U(-1, 1); else a Dense first decoder layer."""
    import torch

    from hyperbolic_vae_tpu_torch.manifolds import PoincareBall

    rng = np.random.default_rng(seed)
    tree = {"enc": _dense_tree(rng, RNA_GENES, UNI_HIDDEN), "mu": _dense_tree(rng, UNI_HIDDEN, D),
            "scale": _dense_tree(rng, UNI_HIDDEN, D)}
    if ball:
        v = rng.standard_normal((UNI_HIDDEN, D))
        v *= rng.standard_normal((UNI_HIDDEN, 1)) / np.linalg.norm(v, axis=-1, keepdims=True)
        tree["gyroplanes"] = {
            "mp_points": PoincareBall(1.0).expmap0(torch.from_numpy(v.astype(np.float32))).numpy(),
            "bias": rng.uniform(-1, 1, UNI_HIDDEN).astype(np.float32)}
    else:
        tree["dec_first"] = _dense_tree(rng, D, UNI_HIDDEN)
    tree["dec_out"] = _dense_tree(rng, UNI_HIDDEN, RNA_GENES)
    return tree


def pvae_phase():
    """The last two model families on the card (TF32 off, as ``main()``
    sets it): ``PvaeMLPVAE`` at experiment 9's protocol (784 -> 600 -> 2-D
    ball, c = 1, the geodesic decoder, batch 128, lr 5e-4, synthetic MNIST:
    54,000 train, 6,000 val, 10,000 test rows) with the Riemannian and the
    wrapped posterior, and ``UnifiedVAE`` at experiment 8's config (20,480
    genes -> hidden 100 -> 2-D ball, c = 1, prior scale 2, beta 0.5,
    logmap0_analytic, sigmoid, MSE; K1 at 100 planes, on its wide
    kernel) on the z-scored fake Jerby-Arnon data (8,192 cells: 5,734 train,
    1,228 val, 1,230 test rows), batch 64, and its Euclidean arm
    (``latent_curvature=None``):

      (a) K1 at P = 100, D = 2, c = 1 against its plain version
          (``_k1_check``'s rules) at B = 64 (every UnifiedVAE training and
          validation batch) and 25,600 (its IWAE decode, k_chunk 100 x 256
          rows), at both on the wide kernel and bit for bit the fallback
          kernel's (``_k1_wide_check``), timed from Python and from graph
          replay beside an empty launch of its grid (``_k1_times``);
      (b) five eager f32 steps card vs CPU from numpy-seeded weights in
          JAX's tree (``_pvae_jax_tree``, ``_unified_jax_tree``) carried
          through ``state_dict_from_jax_params``, the same batches and
          posterior draws (``_card_vs_cpu``'s rules, the share limit
          ``PVAE_SHARE_LIMIT``), for four arms: PvaeMLPVAE wrapped and
          Riemannian, UnifiedVAE on the ball and Euclidean;
      (c) for each arm ``Trainer.fit`` graphed against eager, two epochs
          each, bit for bit (PvaeMLPVAE on 10,000 synthetic rows); the
          graphed step's wall, busy, idle share, kernels a step and top
          kernels (``_profile_train``); K1 once a step and val batch on
          the ball, never elsewhere;
      (d) experiment 9's protocol to convergence on the Riemannian
          posterior: ``Trainer(lr=5e-4, max_epochs=80, seed=42,
          early_stopping_patience=None, epochs_per_dispatch=10)``; fails
          unless its best val/loss_total is within 1 % of JAX's 319.970,
          then unless ``evaluate_iwae(k=5000)`` on the test split is within
          1 % of JAX's -320.655 and at least the split's mean ELBO
          (``evaluate(split="test")``);
      (e) the wrapped posterior at the same protocol for 10 epochs with
          checkpoints, its best served over HTTP: embed, and reconstruct
          of 2,048 rows as octet-stream (bit for bit the restored model's
          decode of its posterior mean, batch by batch); generate 404;
      (f) UnifiedVAE: a 6-epoch graphed fit with checkpoints, its best
          served over HTTP (embed, decode, reconstruct of 2,048 rows,
          generate), ``evaluate_iwae(k=5000, k_chunk=100)`` on the test
          split (exactly 250 K1 launches: 5 batch chunks x 50 k chunks;
          the bound at least k = 1's), and the Euclidean arm's same fit
          with no K1 launch.

    Returns (K1's entry at 100 planes, launches by path)."""
    import tempfile

    import torch

    from hyperbolic_vae_tpu_torch.data import make_data_module
    from hyperbolic_vae_tpu_torch.interop import state_dict_from_jax_params
    from hyperbolic_vae_tpu_torch.models import PvaeMLPVAE, UnifiedVAE
    from hyperbolic_vae_tpu_torch.serve import Inferencer
    from hyperbolic_vae_tpu_torch.serve_http import InferenceServer
    from hyperbolic_vae_tpu_torch.train import Trainer
    from hyperbolic_vae_tpu_torch.train.cuda_graph import run_eagerly

    device = "cuda"
    sync = torch.cuda.synchronize
    t_phase = time.perf_counter()
    mnist = make_data_module(batch_size=PVAE_BATCH, synthetic=True, n_train=60000)
    mnist_small = make_data_module(batch_size=PVAE_BATCH, synthetic=True,
                                   n_train=PVAE_CHECK_ROWS, n_test=PVAE_BATCH)
    rna = dataclasses.replace(_rnaseq_data(), batch_size=UNI_BATCH)
    print(f"pvae: data: MNIST {mnist.x_train.shape[0]} / {mnist.x_val.shape[0]} / "
          f"{mnist.x_test.shape[0]} rows (the graphed/eager pairs on "
          f"{mnist_small.x_train.shape[0]} / {mnist_small.x_val.shape[0]}); RNA-seq "
          f"{rna.x_train.shape[0]} / {rna.x_val.shape[0]} / {rna.x_test.shape[0]} rows of "
          f"{RNA_GENES} genes, z-scored ({time.perf_counter() - t_phase:.2f} s)", flush=True)

    def make_pvae(posterior, on=device):
        m = PvaeMLPVAE(hidden_dim=PVAE_HIDDEN, latent_dim=D, posterior=posterior, lr=PVAE_LR,
                       device=on)
        m.load_state_dict(state_dict_from_jax_params(_pvae_jax_tree(0, posterior), m))
        return m

    def make_unified(ball, on=device):
        m = UnifiedVAE((RNA_GENES,), latent_curvature=1.0 if ball else None, **EXP8, device=on)
        m.load_state_dict(state_dict_from_jax_params(_unified_jax_tree(1, ball), m))
        return m

    def no_launches():
        return {"gyroplane_distances": 0, "flagship_fused": 0, "flagship_train": 0}

    def want_k1(n):
        return {**no_launches(), "gyroplane_distances": n}

    def per_epoch(data):
        n_v, b = data.x_val.shape[0], data.batch_size
        return data.x_train.shape[0] // b + n_v // b + (1 if n_v % b else 0)

    def fit(model, data, epochs, eager=False, **kw):
        trainer = Trainer(model, max_epochs=epochs, early_stopping_patience=None,
                          device=device, **kw)
        sync()
        t0 = time.perf_counter()
        with run_eagerly() if eager else contextlib.nullcontext():
            res = trainer.fit(data)
        sync()
        return res, trainer, time.perf_counter() - t0

    # (a) K1 at 100 planes
    rng = np.random.default_rng(31)
    iwae_rows = UNI_K_CHUNK * BATCH
    err_in, err_bd = _k1_check(rng, (UNI_BATCH, iwae_rows), UNI_HIDDEN, curvatures=(1.0,))
    print(f"pvae (a): K1 at P={UNI_HIDDEN}: max_abs_err vs plain: interior {err_in:.3e}, "
          f"near boundary {err_bd:.3e}", flush=True)
    _k1_wide_check("pvae (a)", (UNI_BATCH, iwae_rows), UNI_HIDDEN, (1.0,), seed=33)
    k1 = _k1_entry(err_in, err_bd, _k1_times(rng, UNI_BATCH, UNI_HIDDEN),
                   _k1_times(rng, iwae_rows, UNI_HIDDEN))

    # (b) five eager f32 steps card vs CPU, four arms
    rng = np.random.default_rng(32)
    arms = (("pvae_wrapped", mnist, lambda on: make_pvae("wrapped", on)),
            ("pvae_riemannian", mnist, lambda on: make_pvae("riemannian", on)),
            ("unified_ball", rna, lambda on: make_unified(True, on)),
            ("unified_euclidean", rna, lambda on: make_unified(False, on)))
    for arm, data, make in arms:
        b = data.batch_size
        draws = []
        for _ in range(5):
            xb = data.x_train[rng.integers(0, data.x_train.shape[0], b)]
            g = rng.normal(size=(b, D)).astype(np.float32)
            if arm == "pvae_wrapped":
                draws.append((xb, (g[None],)))
            elif arm == "pvae_riemannian":
                draws.append((xb, (g[None], rng.uniform(1e-6, 1 - 1e-6, (1, b)).astype(np.float32))))
            else:
                draws.append((xb, g))
        _card_vs_cpu(f"pvae (b) {arm}", make, draws, PVAE_SHARE_LIMIT)

    # (c) graphed against eager, each arm
    paths = {}
    for arm, data, make in arms:
        data = mnist_small if arm.startswith("pvae") else data
        _reset_launches()
        res, trainer, wall = fit(make(device), data, 2)
        launches = _launches()
        eres, _, ewall = fit(make(device), data, 2, eager=True)
        _same_fit(f"pvae (c) {arm}", res, eres, "graphed", "eager")
        if not all(np.isfinite(v) for row in res.history for v in row.values()):
            _fail(f"pvae (c) {arm}: non-finite metrics {res.history}")
        want = want_k1(2 * per_epoch(data)) if arm == "unified_ball" else no_launches()
        if launches != want:
            _fail(f"pvae (c) {arm}: launches {launches}, want {want}")
        paths[f"pvae_fit_{arm}"] = launches
        prof = _profile_train(trainer.program, device)
        print(f"pvae (c) {arm}: 2 epochs graphed {wall:.3f} s, eager {ewall:.3f} s, bit for bit; "
              f"launches {json.dumps(launches)}; val/loss_total "
              f"{[h['val/loss_total'] for h in res.history]}; graphed {prof['what']}: wall "
              f"{prof['wall_ms']:.4f} ms/step, device busy {prof['busy_ms']:.4f} ms/step, idle "
              f"share {prof['idle']}, {prof['kernels']:.1f} kernels/step; "
              f"{data.batch_size / prof['wall_ms'] * 1e3:.1f} train samples/s; top kernels "
              f"{_top(prof)}", flush=True)
        del res, eres, trainer

    # (d) experiment 9's protocol to convergence, Riemannian posterior
    model = PvaeMLPVAE(latent_dim=D, manifold_curvature=1.0, posterior="riemannian",
                       generator=torch.Generator().manual_seed(0), device=device)
    trainer = Trainer(model, lr=PVAE_LR, max_epochs=PVAE_EPOCHS, seed=42,
                      early_stopping_patience=None, epochs_per_dispatch=10, device=device)
    _reset_launches()
    sync()
    t0 = time.perf_counter()
    res = trainer.fit(mnist)
    sync()
    fit_wall = time.perf_counter() - t0
    paths["pvae_fit_riemannian_protocol"] = _launches()
    vals = [h["val/loss_total"] for h in res.history]
    skipped = sum(h["train/skipped_steps"] for h in res.history)
    lrs = sorted({h["lr"] for h in res.history}, reverse=True)
    print(f"pvae (d): experiment 9, riemannian: {res.epochs_run} epochs graphed in {fit_wall:.3f} s "
          f"({fit_wall / res.epochs_run * 1e3:.1f} ms an epoch, {res.samples_per_sec:.1f} train "
          f"samples/s after the first chunk); best val/loss_total {res.best_metric:.4f} at epoch "
          f"{int(np.argmin(vals))} (JAX {PVAE_JAX_BEST_VAL}, within 1 %); lr values {lrs}; "
          f"skipped steps {skipped}; last row {json.dumps(res.history[-1])}", flush=True)
    if not abs(res.best_metric - PVAE_JAX_BEST_VAL) <= 0.01 * PVAE_JAX_BEST_VAL:
        _fail(f"pvae (d): best val/loss_total {res.best_metric} is not within 1 % of JAX's "
              f"{PVAE_JAX_BEST_VAL}")
    best = res.best_params
    sync()
    t0 = time.perf_counter()
    bound = trainer.evaluate_iwae(mnist, best, k=PVAE_IWAE_K)
    sync()
    eval_wall = time.perf_counter() - t0
    test = trainer.evaluate(mnist, best, split="test")
    elbo = test["test/elbo"]
    print(f"pvae (d): evaluate_iwae k={PVAE_IWAE_K} on {mnist.x_test.shape[0]} test rows: "
          f"{bound:.4f} nats a row (JAX {PVAE_JAX_IWAE}, within 1 %); the test ELBO {elbo:.4f}; "
          f"wall {eval_wall:.3f} s", flush=True)
    if not (np.isfinite(bound) and abs(bound - PVAE_JAX_IWAE) <= 0.01 * abs(PVAE_JAX_IWAE)):
        _fail(f"pvae (d): the bound {bound} is not within 1 % of JAX's {PVAE_JAX_IWAE}")
    if not bound >= elbo:
        _fail(f"pvae (d): the bound {bound} is below the test ELBO {elbo}")
    if paths["pvae_fit_riemannian_protocol"] != no_launches():
        _fail(f"pvae (d): launches {paths['pvae_fit_riemannian_protocol']}, want none")
    del trainer, model, res, best

    octet = {"Content-Type": "application/octet-stream", "Accept": "application/octet-stream"}
    jhdr = {"Content-Type": "application/json"}

    # (e) the wrapped posterior, 10 epochs, served from its best checkpoint
    with tempfile.TemporaryDirectory() as ckpt:
        model = PvaeMLPVAE(latent_dim=D, manifold_curvature=1.0, posterior="wrapped",
                           generator=torch.Generator().manual_seed(0), device=device)
        _reset_launches()
        res, _, wall = fit(model, mnist, PVAE_WRAPPED_EPOCHS, lr=PVAE_LR, seed=42,
                           epochs_per_dispatch=5, checkpoint_dir=ckpt)
        paths["pvae_fit_wrapped"] = _launches()
        vals = [h["val/loss_total"] for h in res.history]
        print(f"pvae (e): wrapped, {res.epochs_run} epochs graphed in {wall:.3f} s; val/loss_total "
              f"first {vals[0]:.4f}, best {res.best_metric:.4f}", flush=True)
        if not res.best_metric < vals[0]:
            _fail(f"pvae (e): best val/loss_total {res.best_metric} not below the first {vals[0]}")
        inf = Inferencer.from_checkpoint(ckpt, "best", batch_size=BATCH, device=device)
        for key, v in res.best_params.items():
            if not torch.equal(inf.model.state_dict()[key], v):
                _fail(f"pvae (e): the best checkpoint's {key} is not the fit's best params")
        inf.warmup()
        xr = np.ascontiguousarray(np.concatenate([mnist.x_test, mnist.x_val])[:2048], "<f4")
        server = InferenceServer(inf, host="127.0.0.1", port=0).start()
        lat = {}
        try:
            _reset_launches()
            _, body, lat["POST /v1/embed 1 row json"] = _http(
                server, "/v1/embed", json.dumps({"data": xr[:1].tolist()}).encode(), jhdr)
            emb = np.asarray(json.loads(body)["outputs"][0], np.float32)
            h, body, lat["POST /v1/reconstruct 2048 rows octet-stream"] = _http(
                server, "/v1/reconstruct", xr.tobytes(),
                {**octet, "X-Shape": ",".join(map(str, xr.shape))})
            rec = _shaped(h, body)
            try:
                _http(server, "/v1/generate", json.dumps({"n": 8, "seed": 0}).encode(), jhdr)
                gen_code = 200
            except urllib.error.HTTPError as e:
                gen_code = e.code
            paths["pvae_serve"] = _launches()
        finally:
            server.shutdown()
        for name, ms in lat.items():
            print(f"pvae (e) latency {name}: {ms:.3f} ms", flush=True)
        if emb.shape != (1, D) or not np.linalg.norm(emb) < 1.0:
            _fail(f"pvae (e): embed gave {emb}")
        want = _batchwise(inf, xr)
        if rec.shape != (2048, DATA) or not np.array_equal(rec, want):
            _fail(f"pvae (e): the served reconstruct (shape {rec.shape}) differs from the model's")
        if gen_code != 404 or paths["pvae_serve"] != no_launches():
            _fail(f"pvae (e): generate answered {gen_code} (want 404), launches "
                  f"{paths['pvae_serve']}")
        print(f"pvae (e): reconstruct of 2048 rows equal to the model's, bit for bit; generate "
              f"{gen_code}", flush=True)
        del inf, server, model, res

    # (f) UnifiedVAE at experiment 8's config, and its Euclidean arm
    with tempfile.TemporaryDirectory() as ckpt:
        _reset_launches()
        res, trainer, wall = fit(make_unified(True), rna, UNI_FIT_EPOCHS, epochs_per_dispatch=3,
                                 checkpoint_dir=ckpt)
        paths["unified_fit"] = _launches()
        vals = [h["val/loss_total"] for h in res.history]
        print(f"pvae (f): UnifiedVAE, {res.epochs_run} epochs graphed in {wall:.3f} s "
              f"({res.samples_per_sec:.1f} train samples/s after the first chunk); val/loss_total "
              f"first {vals[0]:.4f}, best {res.best_metric:.4f}; launches "
              f"{json.dumps(paths['unified_fit'])}", flush=True)
        if not res.best_metric < vals[0]:
            _fail(f"pvae (f): best val/loss_total {res.best_metric} not below the first {vals[0]}")
        if paths["unified_fit"] != want_k1(res.epochs_run * per_epoch(rna)):
            _fail(f"pvae (f): launches {paths['unified_fit']}, want "
                  f"{res.epochs_run * per_epoch(rna)} K1")
        inf = Inferencer.from_checkpoint(ckpt, "best", batch_size=BATCH, device=device)
        inf.warmup()
        xr = np.ascontiguousarray(np.concatenate([rna.x_test, rna.x_val])[:2048], "<f4")
        z = np.random.default_rng(1).uniform(-0.6, 0.6, size=(64, D)).astype(np.float32)
        server = InferenceServer(inf, host="127.0.0.1", port=0).start()
        lat = {}
        try:
            _reset_launches()
            _, body, lat["POST /v1/embed 1 row json"] = _http(
                server, "/v1/embed", json.dumps({"data": xr[:1].tolist()}).encode(), jhdr)
            emb = np.asarray(json.loads(body)["outputs"][0], np.float32)
            h, body, lat["POST /v1/decode 64 latents octet-stream"] = _http(
                server, "/v1/decode", z.tobytes(), {**octet, "X-Shape": "64,2"})
            dec = _shaped(h, body)
            h, body, lat["POST /v1/reconstruct 2048 rows octet-stream"] = _http(
                server, "/v1/reconstruct", xr.tobytes(),
                {**octet, "X-Shape": ",".join(map(str, xr.shape))})
            rec = _shaped(h, body)
            gens = []
            for i in range(2):
                h, body, lat[f"POST /v1/generate n=512 seed=3 octet-stream ({i + 1})"] = _http(
                    server, "/v1/generate", json.dumps({"n": 512, "seed": 3}).encode(),
                    {**jhdr, "Accept": "application/octet-stream"})
                gens.append(_shaped(h, body))
            paths["unified_serve"] = _launches()
        finally:
            server.shutdown()
        for name, ms in lat.items():
            print(f"pvae (f) latency {name}: {ms:.3f} ms", flush=True)
        for name, a, shape in (("embed", emb, (1, D)), ("decode", dec, (64, RNA_GENES)),
                               ("reconstruct", rec, (2048, RNA_GENES)),
                               ("generate", gens[0], (512, RNA_GENES))):
            if a.shape != shape or not np.all(np.isfinite(a)):
                _fail(f"pvae (f): {name}: shape {a.shape} (want {shape}) or non-finite values")
        if not np.array_equal(gens[0], gens[1]):
            _fail("pvae (f): generate(n=512, seed=3) differs between two requests")
        if not np.array_equal(rec, _batchwise(inf, xr)):
            _fail("pvae (f): the served reconstruct differs from the model's")
        # one K1 launch a decoded batch: 1 (decode 64), 8 (reconstruct 2048),
        # 2 x 2 (generate 512 twice); embed decodes nothing
        if paths["unified_serve"] != want_k1(13):
            _fail(f"pvae (f): launches {paths['unified_serve']}, want 13 K1")
        print(f"pvae (f): served from its best checkpoint, reconstruct bit for bit; launches "
              f"{json.dumps(paths['unified_serve'])}", flush=True)
        del inf, server

    best = res.best_params
    sync()
    _reset_launches()
    t0 = time.perf_counter()
    bound = trainer.evaluate_iwae(rna, best, k=PVAE_IWAE_K, batch_chunk=BATCH, k_chunk=UNI_K_CHUNK)
    sync()
    wall = time.perf_counter() - t0
    paths["unified_eval"] = _launches()
    _reset_launches()
    bound_1 = trainer.evaluate_iwae(rna, best, k=1, batch_chunk=BATCH, k_chunk=UNI_K_CHUNK)
    paths["unified_eval_k1"] = _launches()
    n_t = rna.x_test.shape[0]
    chunks = -(-n_t // BATCH) * -(-PVAE_IWAE_K // UNI_K_CHUNK)
    print(f"pvae (f): evaluate_iwae k={PVAE_IWAE_K} (k_chunk {UNI_K_CHUNK}) on {n_t} test rows: "
          f"{bound:.4f} nats a row (k = 1: {bound_1:.4f}); wall {wall:.3f} s; launches "
          f"{json.dumps(paths['unified_eval'])}", flush=True)
    if paths["unified_eval"] != want_k1(chunks) or (
            paths["unified_eval_k1"] != want_k1(-(-n_t // BATCH))):
        _fail(f"pvae (f): launches {paths['unified_eval']} and {paths['unified_eval_k1']} "
              f"(k = 1), want {chunks} and {-(-n_t // BATCH)} K1")
    if not (np.isfinite(bound) and bound >= bound_1):
        _fail(f"pvae (f): the bound {bound} is not finite or below k = 1's {bound_1}")
    del trainer, res, best
    _reset_launches()
    res, _, wall = fit(make_unified(False), rna, UNI_FIT_EPOCHS, epochs_per_dispatch=3)
    paths["unified_fit_euclidean"] = _launches()
    vals = [h["val/loss_total"] for h in res.history]
    print(f"pvae (f): the Euclidean UnifiedVAE, {res.epochs_run} epochs graphed in {wall:.3f} s; "
          f"val/loss_total first {vals[0]:.4f}, best {res.best_metric:.4f}; launches "
          f"{json.dumps(paths['unified_fit_euclidean'])}", flush=True)
    if paths["unified_fit_euclidean"] != no_launches() or not res.best_metric < vals[0]:
        _fail(f"pvae (f): the Euclidean fit launched {paths['unified_fit_euclidean']} or did not "
              f"improve ({vals})")
    print(f"pvae: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return k1, {p_: n["gyroplane_distances"] for p_, n in paths.items()}


# the reference user's path (interop_phase): their Lightning .ckpt of the
# flagship, built on the machine in geoopt's form, into the port; then
# experiments 5 and 8 (2 epochs each) and 1, 2, 3 (one epoch each, experiment
# 1 at one latent) through their CLIs at full width
INTEROP_ROWS = (60000, 10000)  # synthetic MNIST: 54,000 train, 6,000 val, 10,000 test rows
INTEROP_FIT_EPOCHS, INTEROP_IWAE_K, INTEROP_PROBE_K = 2, 5000, 10
INTEROP_EXP_EPOCHS, INTEROP_SMALL_EPOCHS, INTEROP_EXP1_LATENT = 2, 1, 128
INTEROP_EXP8_CELLS = 1000  # experiment 8's fake cells (batch 64: 700 / 150 / 150 rows)
INTEROP_CIFAR_ROWS = (50000, 10000)  # synthetic CIFAR-10: 45,000 train, 5,000 val, 10,000 test


def interop_phase():
    """The reference's own checkpoints into the port, on the card (TF32
    off, cuDNN deterministic, as ``main()`` sets them), at the flagship's
    published width (784 -> 64 -> 16 -> 2-D ball, c = 1, 16 gyroplanes) on
    synthetic MNIST (54,000 train, 6,000 val, 10,000 test rows), batch 256:

      (a) a reference checkpoint in geoopt's form, built here from a seeded
          port flagship with a zero gyroplane bias: exported
          (``export_torch_state_dict``), the bias dropped (geoopt's layer
          has none), ``manifold.k = -1`` and ``decoder.0.ball.k = [-1]``
          added, every key under ``model.``, wrapped as Lightning does
          (``state_dict``, ``hyper_parameters`` with ``data_shape`` [1, 28,
          28], ``epoch``) and ``torch.save``d as a ``.ckpt``;
      (b) ``load_torch_state_dict`` + ``import_torch_state_dict``: the
          source model's state_dict, bit for bit, on the card;
      (c) served from the ``.ckpt`` (``Inferencer.from_state_dict``, the
          ``serve_http --state-dict`` route) over HTTP on 127.0.0.1: embed
          (300 rows, JSON), decode (64 latents, JSON), reconstruct (300
          rows, octet-stream) each bit for bit the source model's
          ``Inferencer``; exactly 3 K1 launches (decode 1, reconstruct 2);
      (d) ``import_torch_checkpoint`` on the ``.ckpt``, then a 2-epoch
          graphed fit from the imported parameters on the K3 path
          (``train_step_fn``; K2 for val): finite losses, exactly 420 K3
          and 48 K2 launches (as ``train_phase``);
      (e) ``eval_checkpoints --iwae 5000 --probe 10`` on the imported
          checkpoint over the 10,000 test rows: the bound at least the
          ELBO, exactly 400 K1 launches in the bound (as ``eval_phase``)
          and 40 in the CLI's test pass; its wall time;
      (f) ``export_torch_state_dict`` of the imported checkpoint: (a)'s
          export, zero bias included, exactly;
      (g) experiment 5 (K1 at 512 planes, c = 1.4, MNIST padded to 32) and
          experiment 8 (20,480 genes, hidden 100: K1 at 100 planes) through
          their CLIs for 2 epochs: finite results, K1 once a training step,
          val and test batch; experiments 1 (latent 128 only, run twice:
          the second skips the fit), 2 and 3 for one epoch.

    Cuts: 2 epochs (fine-tune, experiments 5 and 8) and 1 (experiments 1,
    2, 3) where the protocols run up to 300; experiment 1 at one latent of
    its four. Returns (the flagship's launches by path, K1's at 512 planes
    by path, K1's at 100 planes by path)."""
    import tempfile
    from pathlib import Path

    import torch

    from hyperbolic_vae_tpu_torch.data import make_data_module, split_three_way, synthetic_mnist_arrays
    from hyperbolic_vae_tpu_torch.experiments import (
        eval_checkpoints,
        export_torch_state_dict,
        import_torch_checkpoint,
        train_ae_euclidean_cifar10,
        train_vae_euclidean_cifar10,
        train_vae_euclidean_mnist,
        train_vae_hyperbolic_mnist,
        train_vaes_rnaseq,
    )
    from hyperbolic_vae_tpu_torch.interop import (
        export_torch_state_dict as export_sd,
        import_torch_state_dict,
        load_torch_state_dict,
    )
    from hyperbolic_vae_tpu_torch.models import GyroplaneVAE
    from hyperbolic_vae_tpu_torch.ops import flagship_fused as ff
    from hyperbolic_vae_tpu_torch.serve import Inferencer
    from hyperbolic_vae_tpu_torch.serve_http import InferenceServer
    from hyperbolic_vae_tpu_torch.train import Trainer
    from hyperbolic_vae_tpu_torch.train.checkpoint import restore_model

    def k1_only(n):
        return {"gyroplane_distances": n, "flagship_fused": 0, "flagship_train": 0}

    t_phase = time.perf_counter()
    quiet = ["--log-level", "WARNING"]
    paths, conv_paths, uni_paths = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # (a) the reference checkpoint, geoopt's form
        source = GyroplaneVAE(generator=torch.Generator().manual_seed(0), device="cuda")
        with torch.no_grad():
            source.decoder[0].bias.zero_()
        src = export_sd(source)
        sd = {k: torch.from_numpy(v) for k, v in src.items() if k != "decoder.0.bias"}
        sd["manifold.k"] = torch.tensor(-1.0)
        sd["decoder.0.ball.k"] = torch.tensor([-1.0])
        ckpt = tmp / "epoch=3.ckpt"
        torch.save({"state_dict": {f"model.{k}": v for k, v in sd.items()},
                    "hyper_parameters": {"data_shape": [1, 28, 28], "manifold_curvature": 1.0,
                                         "beta": 1.0, "prior_scale": 1.0},
                    "epoch": 3}, ckpt)
        print(f"interop (a): {ckpt.name}: {len(sd)} tensors under model. (geoopt's: no "
              f"decoder.0.bias; manifold.k, decoder.0.ball.k), {ckpt.stat().st_size} bytes",
              flush=True)

        # (b) import, bit for bit on the card
        t0 = time.perf_counter()
        model = import_torch_state_dict(GyroplaneVAE(device="cuda"), load_torch_state_dict(ckpt))
        for k, v in source.state_dict().items():
            if not torch.equal(model.state_dict()[k], v):
                _fail(f"interop (b): imported {k} differs from the source model's")
        print(f"interop (b): load + import {time.perf_counter() - t0:.3f} s: the source model's "
              f"{len(source.state_dict())} tensors, bit for bit on the card", flush=True)

        # (c) served from the .ckpt: every reply the source model's Inferencer's
        inf = Inferencer.from_state_dict(ckpt, batch_size=BATCH, device="cuda")
        ref = Inferencer(source, batch_size=BATCH, device="cuda")
        inf.warmup()
        ref.warmup()
        x = synthetic_mnist_arrays(n_train=300, n_test=1, seed=0)[0]
        z = np.random.default_rng(1).uniform(-0.6, 0.6, size=(64, 2)).astype(np.float32)
        server = InferenceServer(inf, host="127.0.0.1", port=0).start()
        lat = {}
        try:
            jhdr = {"Content-Type": "application/json"}
            _reset_launches()
            _, body, lat["embed 300 rows json"] = _http(
                server, "/v1/embed", json.dumps({"data": x.tolist()}).encode(), jhdr)
            emb = np.asarray(json.loads(body)["outputs"][0], np.float32)
            _, body, lat["decode 64 latents json"] = _http(
                server, "/v1/decode", json.dumps({"data": z.tolist()}).encode(), jhdr)
            dec = np.asarray(json.loads(body)["outputs"][0], np.float32)
            xr = np.ascontiguousarray(x, "<f4")
            h, body, lat["reconstruct 300 rows octet-stream"] = _http(
                server, "/v1/reconstruct", xr.tobytes(),
                {"Content-Type": "application/octet-stream", "X-Shape": ",".join(map(str, xr.shape))})
            rec = _shaped(h, body)
            torch.cuda.synchronize()
            paths["interop_serve"] = _launches()
        finally:
            server.shutdown()
        for name, got, want in (("embed", emb, ref.embed(x)), ("decode", dec, ref.decode(z)),
                                ("reconstruct", rec, ref.reconstruct(x))):
            if got.shape != want.shape or not np.array_equal(got, want):
                _fail(f"interop (c): served {name} differs from the source model's Inferencer")
        print("interop (c): served from the .ckpt, embed / decode / reconstruct bit for bit the "
              "source model's; " + ", ".join(f"{k} {v:.3f} ms" for k, v in lat.items())
              + f"; launches {json.dumps(paths['interop_serve'])}", flush=True)
        if paths["interop_serve"] != k1_only(3):
            _fail(f"interop (c): launches {paths['interop_serve']}, want 3 K1 and no other")

        # (d) the import CLI, then a graphed K3-path fine-tune from its parameters
        out = tmp / "imported"
        import_torch_checkpoint.main([str(ckpt), "--out", str(out)] + quiet)
        tuned, params, meta = restore_model(str(out), "best", device="cuda")
        if meta.get("imported_from") != str(ckpt) or any(
                not torch.equal(params[k], v) for k, v in source.state_dict().items()):
            _fail("interop (d): the imported checkpoint is not the source model's weights")
        n_train, n_test = INTEROP_ROWS
        dm = make_data_module(batch_size=BATCH, synthetic=True, n_train=n_train, n_test=n_test)
        steps = dm.x_train.shape[0] // BATCH
        val_b, test_b = -(-dm.x_val.shape[0] // BATCH), -(-dm.x_test.shape[0] // BATCH)
        trainer = Trainer(tuned, max_epochs=INTEROP_FIT_EPOCHS, early_stopping_patience=None,
                          loss_fn=ff.make_fused_loss_fn(tuned),
                          train_step_fn=ff.make_fused_train_step(tuned), device="cuda")
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        res = trainer.fit(dm, params=params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        paths["interop_finetune"] = _launches()
        print(f"interop (d): fine-tune of the imported flagship, {res.epochs_run} epochs graphed "
              f"on the K3 path in {wall:.3f} s (capture included); history "
              f"{json.dumps(res.history)}; launches {json.dumps(paths['interop_finetune'])}",
              flush=True)
        if any(not np.isfinite(v) for row in res.history for v in row.values()):
            _fail(f"interop (d): non-finite metrics {res.history}")
        want = {"gyroplane_distances": 0, "flagship_train": INTEROP_FIT_EPOCHS * steps,
                "flagship_fused": INTEROP_FIT_EPOCHS * val_b}
        if paths["interop_finetune"] != want:
            _fail(f"interop (d): launches {paths['interop_finetune']}, want {want}")

        # (e) the eval CLI on the imported checkpoint, the bound's launches
        # read around Trainer.evaluate_iwae inside the CLI
        bound = {}
        evaluate_iwae = Trainer.evaluate_iwae

        def counted(self, *a, **kw):
            torch.cuda.synchronize()
            before, t_b = _launches(), time.perf_counter()
            value = evaluate_iwae(self, *a, **kw)
            torch.cuda.synchronize()
            bound["wall"] = time.perf_counter() - t_b
            bound["launches"] = {k: n - before[k] for k, n in _launches().items()}
            return value

        Trainer.evaluate_iwae = counted
        try:
            torch.cuda.synchronize()
            _reset_launches()
            t0 = time.perf_counter()
            evals = eval_checkpoints.main(
                ["--glob", str(out), "--synthetic", "--n-train", str(n_train), "--n-test",
                 str(n_test), "--iwae", str(INTEROP_IWAE_K), "--probe", str(INTEROP_PROBE_K),
                 "--run-dir", str(tmp / "eval")] + quiet)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            paths["interop_eval"] = _launches()
        finally:
            Trainer.evaluate_iwae = evaluate_iwae
        row = evals.get(str(out), {})
        iwae, elbo = row.get(f"test/iwae_{INTEROP_IWAE_K}"), -row.get("test/loss_total", np.nan)
        print(f"interop (e): eval_checkpoints --iwae {INTEROP_IWAE_K} --probe {INTEROP_PROBE_K} on "
              f"{n_test} test rows in {wall:.3f} s (data included): {json.dumps(row)}; the bound "
              f"{bound.get('wall', float('nan')):.3f} s wall, launches "
              f"{json.dumps(bound.get('launches'))}; the CLI's launches "
              f"{json.dumps(paths['interop_eval'])}", flush=True)
        if not (iwae is not None and np.isfinite(iwae) and iwae >= elbo):
            _fail(f"interop (e): the bound {iwae} is not finite or below the ELBO {elbo}")
        k_chunks = -(-INTEROP_IWAE_K // IWAE_K)
        if bound.get("launches") != k1_only(test_b * k_chunks):
            _fail(f"interop (e): the bound's launches {bound.get('launches')}, want "
                  f"{test_b * k_chunks} K1")
        if paths["interop_eval"] != k1_only(test_b * k_chunks + test_b):
            _fail(f"interop (e): launches {paths['interop_eval']}, want "
                  f"{test_b * k_chunks + test_b} K1 (the bound's and the test pass's)")

        # (f) exported back: (a)'s export exactly
        back = export_torch_state_dict.main([str(out), "--out", str(tmp / "back.npz"),
                                             "--run-dir", str(tmp / "export")] + quiet)
        with np.load(tmp / "back.npz") as f:
            if sorted(f.files) != sorted(src) or sorted(back) != sorted(src) or any(
                    not np.array_equal(f[k], src[k]) for k in src):
                _fail("interop (f): the export of the imported checkpoint differs from (a)'s")
        print(f"interop (f): exported back, {len(src)} tensors equal to (a)'s export (zero "
              "decoder.0.bias included)", flush=True)

        # (g) experiments 5 and 8 (2 epochs), then 1, 2 and 3 (one epoch)
        small = ["--synthetic"] + quiet
        mnist_rows = ["--n-train", str(n_train), "--n-test", str(n_test)]

        def run(name, cli, argv, run_dir=None):
            torch.cuda.synchronize()
            _reset_launches()
            t0 = time.perf_counter()
            result = cli.main(argv + ["--run-dir", str(tmp / (run_dir or name))] + small)
            torch.cuda.synchronize()
            n = _launches()
            print(f"interop (g): {name} in {time.perf_counter() - t0:.3f} s: {json.dumps(result)}; "
                  f"launches {json.dumps(n)}", flush=True)
            rows = result.values() if name.startswith("exp1") else [result]
            if any(not np.isfinite(v) for r in rows for v in r.values()):
                _fail(f"interop (g): {name} gave non-finite results {result}")
            return result, n

        exp5, n = run("exp5", train_vae_hyperbolic_mnist,
                      ["--epochs", str(INTEROP_EXP_EPOCHS)] + mnist_rows)
        conv_paths["interop_exp5"] = n["gyroplane_distances"]
        want = int(exp5["epochs"]) * (steps + val_b) + test_b
        if n != k1_only(want):
            _fail(f"interop (g): experiment 5 launched {n}, want {want} K1")
        exp8, n = run("exp8", train_vaes_rnaseq,
                      ["--epochs", str(INTEROP_EXP_EPOCHS), "--n-genes", str(RNA_GENES),
                       "--structured-fake"])
        uni_paths["interop_exp8"] = n["gyroplane_distances"]
        (tr, _), (va, _), (te, _) = split_three_way(np.zeros((INTEROP_EXP8_CELLS, 1)),
                                                    np.zeros(INTEROP_EXP8_CELLS), seed=42)
        want = (int(exp8["epochs"]) * (len(tr) // UNI_BATCH + -(-len(va) // UNI_BATCH))
                + -(-len(te) // UNI_BATCH))
        if n != k1_only(want):
            _fail(f"interop (g): experiment 8 launched {n}, want {want} K1")
        one = ["--epochs", str(INTEROP_SMALL_EPOCHS), "--n-train", str(INTEROP_CIFAR_ROWS[0]),
               "--n-test", str(INTEROP_CIFAR_ROWS[1])]
        run("exp2", train_vae_euclidean_cifar10, one)
        run("exp3", train_vae_euclidean_mnist, ["--epochs", str(INTEROP_SMALL_EPOCHS)] + mnist_rows)
        first, _ = run("exp1", train_ae_euclidean_cifar10,
                       one + ["--latent-dims", str(INTEROP_EXP1_LATENT)])
        again, _ = run("exp1_again", train_ae_euclidean_cifar10,
                       one + ["--latent-dims", str(INTEROP_EXP1_LATENT)], run_dir="exp1")
        tag = f"latent_{INTEROP_EXP1_LATENT}"
        if first[tag]["epochs"] != INTEROP_SMALL_EPOCHS or again[tag]["epochs"] != 0 or any(
                again[tag][k] != v for k, v in first[tag].items() if k != "epochs"):
            _fail(f"interop (g): experiment 1's second run did not skip the fit: {first} {again}")
    print(f"interop: cuts: {INTEROP_FIT_EPOCHS}-epoch fine-tune, experiments 5 and 8 at "
          f"{INTEROP_EXP_EPOCHS} epochs, 1, 2 and 3 at {INTEROP_SMALL_EPOCHS}, experiment 1 at "
          f"latent {INTEROP_EXP1_LATENT} only; phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return paths, conv_paths, uni_paths


# the sweeps: the parity protocol's 8 seeds (PARITY.json), experiment 7's
# curvature x beta grid of its (mobius, geoopt_gyroplane) shape group
# (experiments/train_vae_hyperbolic_mnist_grid.py), experiment 9's curvature
# lanes (experiments/pvae_replicate.py --lane-sweep)
SWEEP_SEEDS = [42, 7, 123, 0, 1, 2, 3, 11]
SWEEP_DEFAULT_EPOCHS, SWEEP_K3_EPOCHS = 3, 10
GRID_CURVATURES, GRID_BETAS, GRID_EPOCHS = (0.5, 1.0, 1.4), (1.0, 3.0), 2
PVAE_SWEEP_CURVATURES, PVAE_SWEEP_EPOCHS, PVAE_SWEEP_IWAE_K = (0.5, 1.0, 1.4), 2, 500
SWEEP_ROWS = (60000, 10000)  # synthetic MNIST: 54,000 train, 6,000 val, 10,000 test rows


def _kernel_busy(prof) -> dict:
    """From a torch.profiler run: the kernels' summed time, the time at
    least one kernel ran (the union of their intervals: kernels of
    concurrent streams overlap) and the traced span from the first
    kernel's start to the last one's end, in ms; idle share 1 - union /
    span (torch.profiler's tracing stretches a window of graph replays, so
    the union is read against the traced span, not the untraced wall)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if str(e.device_type).endswith("CUDA") and e.time_range.end > e.time_range.start)
    if not spans:
        return {"sum_ms": float("nan"), "union_ms": float("nan"), "span_ms": float("nan"),
                "kernels": 0, "idle": "not measured (the profiler saw no kernel)"}
    union, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            union, lo, hi = union + hi - lo, a, b
        else:
            hi = max(hi, b)
    union = (union + hi - lo) / 1e3
    span = (max(b for _, b in spans) - spans[0][0]) / 1e3
    return {"sum_ms": sum(b - a for a, b in spans) / 1e3, "union_ms": union, "span_ms": span,
            "kernels": len(spans), "idle": f"{1 - union / span:.4f}"}


def _lanes_window(progs) -> dict:
    """``_profile_train``'s window over every lane of a fitted sweep, the
    lanes' replays in turn, each on its lane's stream, as the sweep queues
    them: on the K3 path one train epoch a lane, else each lane's epoch
    begin and then 20 train steps a lane (fewer if an epoch has fewer). Its wall (host clock,
    synchronised, after one warm window) and train samples/s, then the same
    window under torch.profiler (``_kernel_busy``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    whole = "train epoch" in [s.name for s in progs[0].program.segments]
    n = progs[0].ep.steps if whole else min(20, progs[0].ep.steps)

    def replay(name, times=1):
        for _ in range(times):
            for p in progs:
                with p.on_stream():
                    p.program.replay(name)

    def queue():
        """The window's replays, no host sync; returns an event that
        completes with every lane's part."""
        if whole:
            replay("train epoch")
        else:
            replay("begin epoch")
            replay("train step", n)
        current, done = torch.cuda.current_stream(), torch.cuda.Event()
        for p in progs:
            if p.stream is not None:
                current.wait_stream(p.stream)
        done.record(current)
        return done

    def window():
        queue()
        torch.cuda.synchronize()

    window()
    t0 = time.perf_counter()
    window()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        window()
    return {"what": f"{n} train steps a lane", "wall_ms": wall_ms,
            "samples_per_sec": len(progs) * n * BATCH / wall_ms * 1e3, **_kernel_busy(prof),
            **_smi_busy(queue)}


def _smi_busy(queue, seconds: float = 4.0, settle: float = 1.0) -> dict:
    """The card's own busy reading of a window, with no tracer to stretch
    it: ``queue`` (the window's replays, no host sync; returns an event of
    their end) is queued again and again for ``seconds``, two windows in
    flight, and from ``settle`` s in, ``nvidia-smi`` samples
    utilization.gpu (the share of its sample period, 1/6 to 1 s, in which
    at least one kernel ran) every 100 ms. Idle share 1 - the median
    sample / 100, integer percent."""
    import torch

    uuid = str(torch.cuda.get_device_properties(torch.cuda.current_device()).uuid)
    uuid = uuid if uuid.startswith("GPU-") else f"GPU-{uuid}"
    smi, inflight = None, []
    t0 = time.perf_counter()
    try:
        while time.perf_counter() - t0 < seconds:
            inflight.append(queue())
            if len(inflight) > 2:
                inflight.pop(0).synchronize()
            if smi is None and time.perf_counter() - t0 > settle:
                smi = subprocess.Popen(
                    ["nvidia-smi", "-i", uuid, "--query-gpu=utilization.gpu",
                     "--format=csv,noheader,nounits", "-lms", "100"],
                    stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    finally:
        out = ""
        if smi is not None:
            smi.terminate()
            out = smi.communicate(timeout=10)[0]
        torch.cuda.synchronize()
    samples = [int(v) for v in out.split() if v.isdigit()]
    if not samples:
        return {"smi_samples": 0, "smi_idle": "not measured (nvidia-smi gave no sample)"}
    median = float(statistics.median(samples))
    return {"smi_samples": len(samples), "smi_util_median": median,
            "smi_util_range": [min(samples), max(samples)], "smi_idle": f"{1 - median / 100:.2f}"}


def sweep_phase():
    """Seed ensembles and hyperparameter-lane sweeps on the card
    (``Trainer.fit_ensemble``, ``fit_lane_sweep``, ``evaluate_lanes``:
    every lane its own captured program on its own CUDA stream), TF32 off
    and cuDNN deterministic as ``main()`` sets them:

      (a) K1 at 512 planes against its plain version (``_k1_check``'s
          rules) at c = 0.5 and 1.0, B = 256 and 128,000: experiment 7's
          lanes put the ball's radius at 1.41 and 1;
      (b) experiment 6's flagship (784 -> 64 -> 16 -> 2-D ball -> 16
          gyroplanes) on synthetic MNIST (54,000 train, 6,000 val rows),
          batch 256, as 8 seed lanes (the parity protocol's seeds) on the
          default path, 3 epochs in one chunk: exactly 8 x 3 x 234 K1
          launches; seeds 42 and 11 each equal to their own graphed
          ``fit`` bit for bit (history with lr, best, params, best params);
      (c) the same 8 seeds on the K3 path, 10 epochs in one chunk: exactly
          8 x 10 x 210 K3 and 8 x 10 x 24 K2 launches; seeds 42 and 11
          equal to their fits;
      (d) aggregate train samples/s (the sweep's, from a replay of its
          one chunk) at S = 1, 2, 4 (and 8: (b), (c)) lanes on both paths,
          beside S sequential fits (one fit's throughput: a second chunk
          of (b)'s and (c)'s sequential fits, timed); for S = 8,
          ``_lanes_window``: the steps' wall, then under torch.profiler
          the kernel time (summed, and their union: streams overlap) and
          the idle share, and the card's own busy reading of the window
          queued for 3 s (``_smi_busy``: ``nvidia-smi`` utilization.gpu,
          no tracer);
      (e) experiment 7's (mobius, geoopt_gyroplane) shape group as 6
          lanes (c in 0.5, 1.0, 1.4 x beta in 1, 3) of
          ``HyperbolicImageVAE`` on MNIST padded to 32 x 32, batch 256,
          2 epochs: exactly 6 x 2 x 234 K1 launches at 512 planes; the
          c = 0.5, beta = 3 lane equal to its fit bit for bit;
          ``evaluate_lanes`` on the 10,000 test rows (exactly 6 x 40 K1
          launches), finite;
      (f) experiment 9's CLI with ``--lane-sweep``: the Riemannian
          posterior's lanes at c in 0.5, 1.0, 1.4, 2 epochs, each lane's
          ``evaluate_iwae(k=500)`` on the test split finite and at least
          its ELBO (no kernel on this path: the geodesic decoder);
      (g) graceful stops: a K3-path sweep of seeds 42 and 11 with
          ``max_wall_seconds=0`` stops after its first chunk
          (``interrupted``), ``resume=True`` finishes it, and the two
          equal the uninterrupted sweep bit for bit.

    Cuts: 3 and 10 epochs a seed sweep (the protocol runs to convergence),
    2 epochs a grid or experiment 9 lane, the bound at k = 500. Returns
    (K1's errors at 512 planes (interior, boundary), the flagship's
    launches by path, K1's at 512 planes by path)."""
    import copy
    import itertools
    import tempfile

    import torch

    from hyperbolic_vae_tpu_torch.data import make_data_module, pad_to_32
    from hyperbolic_vae_tpu_torch.experiments import pvae_replicate
    from hyperbolic_vae_tpu_torch.models import GyroplaneVAE, HyperbolicImageVAE
    from hyperbolic_vae_tpu_torch.ops import flagship_fused as ff
    from hyperbolic_vae_tpu_torch.train import Trainer, evaluate_lanes

    device = "cuda"

    def sync():
        torch.cuda.synchronize()

    t_phase = time.perf_counter()
    n_train, n_test = SWEEP_ROWS
    dm = make_data_module(batch_size=BATCH, synthetic=True, n_train=n_train, n_test=n_test)
    steps = dm.x_train.shape[0] // BATCH
    n_val = dm.x_val.shape[0]
    val_batches = n_val // BATCH + (1 if n_val % BATCH else 0)
    per_epoch = steps + val_batches

    def no_launches():
        return {"gyroplane_distances": 0, "flagship_fused": 0, "flagship_train": 0}

    # (a) K1 at 512 planes on the grid's other balls
    rng = np.random.default_rng(31)
    err_in, err_bd = _k1_check(rng, (BATCH, IWAE_ROWS), CONV_P, curvatures=(0.5, 1.0))
    print(f"sweep (a): K1 at P={CONV_P}, c in (0.5, 1.0), B in ({BATCH}, {IWAE_ROWS}): "
          f"max_abs_err vs plain: interior {err_in:.3e}, near boundary {err_bd:.3e} "
          f"({time.perf_counter() - t_phase:.1f} s into the phase)", flush=True)

    def trainer(path, epochs, k, seed=42, **kw):
        m = GyroplaneVAE(generator=torch.Generator().manual_seed(0), device=device)
        if path == "k3":
            kw.update(loss_fn=ff.make_fused_loss_fn(m), train_step_fn=ff.make_fused_train_step(m))
        return Trainer(m, max_epochs=epochs, epochs_per_dispatch=k, seed=seed,
                       early_stopping_patience=None, device=device, **kw)

    def sweep(path, seeds, epochs, k=None, **kw):
        tr = trainer(path, epochs, k or epochs, **kw)
        sync()
        t0 = time.perf_counter()
        res = tr.fit_ensemble(dm, seeds)
        sync()
        return res, tr, time.perf_counter() - t0

    def sequential(path, seed, epochs):
        """``seed``'s own graphed fit, then one more chunk of its captured
        program, timed: one fit's train samples/s."""
        tr = trainer(path, epochs, epochs, seed=seed)
        res = tr.fit(dm, params=tr.init_params(seed))
        sync()
        t0 = time.perf_counter()
        tr.program.run(epochs)
        sync()
        return res, steps * BATCH * epochs / (time.perf_counter() - t0)

    paths, sps, seq_sps, windows = {}, {}, {}, {}
    for tag, path, epochs, want in (
            ("b", "default", SWEEP_DEFAULT_EPOCHS,
             {**no_launches(), "gyroplane_distances": 8 * SWEEP_DEFAULT_EPOCHS * per_epoch}),
            ("c", "k3", SWEEP_K3_EPOCHS,
             {**no_launches(), "flagship_train": 8 * SWEEP_K3_EPOCHS * steps,
              "flagship_fused": 8 * SWEEP_K3_EPOCHS * val_batches})):
        _reset_launches()
        res, tr, wall = sweep(path, SWEEP_SEEDS, epochs)
        paths[f"sweep_{path}"] = _launches()
        if paths[f"sweep_{path}"] != want:
            _fail(f"sweep ({tag}): launches {paths[f'sweep_{path}']}, want {want}")
        for r in res:
            if r.epochs_run != epochs or not all(np.isfinite(v) for h in r.history
                                                 for v in h.values()):
                _fail(f"sweep ({tag}): a lane ran {r.epochs_run} epochs or has non-finite "
                      f"metrics: {r.history}")
        seq_sps[path] = []
        for seed in (SWEEP_SEEDS[0], SWEEP_SEEDS[-1]):
            seq, one = sequential(path, seed, epochs)
            lane = res[SWEEP_SEEDS.index(seed)]
            _same_fit(f"sweep ({tag}) seed {seed}", lane, seq, "lane", "its fit")
            if lane.best_metric != seq.best_metric:
                _fail(f"sweep ({tag}) seed {seed}: best {lane.best_metric} != {seq.best_metric}")
            seq_sps[path].append(one)
        sps[(path, 8)] = res[0].samples_per_sec
        windows[path] = _lanes_window(tr.lane_programs)
        print(f"sweep ({tag}): {path} path, 8 seed lanes x {epochs} epochs in {wall:.3f} s (the "
              f"captures included); {res[0].samples_per_sec:.1f} aggregate train samples/s (a "
              f"replay of the chunk); launches {json.dumps(paths[f'sweep_{path}'])}; seeds "
              f"{SWEEP_SEEDS[0]} and {SWEEP_SEEDS[-1]} equal their fits bit for bit; best "
              f"val/loss_total by seed {[round(r.best_metric, 4) for r in res]} "
              f"({time.perf_counter() - t_phase:.1f} s into the phase)", flush=True)
        del res, tr

    # (d) throughput by lanes
    for path, epochs in (("default", SWEEP_DEFAULT_EPOCHS), ("k3", SWEEP_K3_EPOCHS)):
        for s in (1, 2, 4):
            res, _, _ = sweep(path, SWEEP_SEEDS[:s], epochs)
            sps[(path, s)] = res[0].samples_per_sec
        one = sum(seq_sps[path]) / len(seq_sps[path])
        w = windows[path]
        print(f"sweep (d): {path} path, aggregate train samples/s by lanes S (a stream a lane; S "
              f"sequential fits: {one:.1f}, one fit's, from {[round(v, 1) for v in seq_sps[path]]}): "
              + ", ".join(f"S={s} {sps[(path, s)]:.1f} ({sps[(path, s)] / one:.3f}x)"
                          for s in (1, 2, 4, 8))
              + f"; S=8, {w['what']}: wall {w['wall_ms']:.3f} ms ({w['samples_per_sec']:.1f} train "
              f"samples/s); under torch.profiler {w['kernels']} kernels, kernel time summed "
              f"{w['sum_ms']:.3f} ms, union {w['union_ms']:.3f} ms of a {w['span_ms']:.3f} ms span, "
              f"idle share {w['idle']}; nvidia-smi utilization.gpu over {w['smi_samples']} "
              f"samples over the last 3 s of the window queued for 4 s: median {w.get('smi_util_median')} % "
              f"(range {w.get('smi_util_range')}), idle share {w['smi_idle']} "
              f"({time.perf_counter() - t_phase:.1f} s into the phase)",
              flush=True)

    # (e) experiment 7's shape group as lanes, K1 at 512 planes
    mnist32 = pad_to_32(copy.copy(dm))  # the same rows, padded

    def grid_model(hp, seed=None):
        return HyperbolicImageVAE(
            data_shape=mnist32.input_shape, latent_dim=D, manifold_curvature=hp["manifold_curvature"],
            encoder_last_layer_module="mobius", decoder_first_layer_module="geoopt_gyroplane",
            beta=hp["beta"], lr=1e-3, device=device,
            generator=None if seed is None else torch.Generator().manual_seed(seed))

    lanes = [{"manifold_curvature": c, "beta": b, "seed": 42}
             for c, b in itertools.product(GRID_CURVATURES, GRID_BETAS)]
    grid = Trainer(grid_model(lanes[0]), hp_model_fn=grid_model, max_epochs=GRID_EPOCHS, seed=42,
                   early_stopping_patience=10, device=device)
    _reset_launches()
    sync()
    t0 = time.perf_counter()
    res = grid.fit_lane_sweep(mnist32, lanes)
    sync()
    wall = time.perf_counter() - t0
    grid_paths = {"sweep_grid": _launches()["gyroplane_distances"]}
    want = len(lanes) * GRID_EPOCHS * per_epoch
    if _launches() != {**no_launches(), "gyroplane_distances": want}:
        _fail(f"sweep (e): launches {_launches()}, want {want} K1")
    check = lanes.index({"manifold_curvature": 0.5, "beta": 3.0, "seed": 42})
    one = Trainer(grid_model(lanes[check]), max_epochs=GRID_EPOCHS, seed=42,
                  early_stopping_patience=10, device=device)
    seq = one.fit(mnist32, params=one.init_params(42))
    _same_fit("sweep (e) c=0.5 beta=3", res[check], seq, "lane", "its fit")
    if res[check].best_metric != seq.best_metric:
        _fail(f"sweep (e): best {res[check].best_metric} != its fit's {seq.best_metric}")
    _reset_launches()
    t0 = time.perf_counter()
    tests = evaluate_lanes(grid, mnist32, res, lanes, "test")
    sync()
    eval_wall = time.perf_counter() - t0
    grid_paths["sweep_grid_eval"] = _launches()["gyroplane_distances"]
    n_t = mnist32.x_test.shape[0]
    want = len(lanes) * (n_t // BATCH + (1 if n_t % BATCH else 0))
    if _launches() != {**no_launches(), "gyroplane_distances": want}:
        _fail(f"sweep (e): evaluate_lanes launches {_launches()}, want {want} K1")
    for lane, r, t in zip(lanes, res, tests):
        if not (all(np.isfinite(v) for h in r.history for v in h.values())
                and all(np.isfinite(v) for v in t.values())):
            _fail(f"sweep (e): non-finite metrics in lane {lane}: {r.history} {t}")
    print(f"sweep (e): experiment 7's (mobius, geoopt_gyroplane) group, {len(lanes)} lanes x "
          f"{GRID_EPOCHS} epochs in {wall:.3f} s ({res[0].samples_per_sec:.1f} aggregate train "
          f"samples/s after the first chunk); {grid_paths['sweep_grid']} K1 launches; the c=0.5 "
          f"beta=3 lane equals its fit bit for bit; evaluate_lanes on {n_t} test rows in "
          f"{eval_wall:.3f} s, {grid_paths['sweep_grid_eval']} K1 launches; test/loss_total by "
          f"lane {[(l['manifold_curvature'], l['beta'], round(t['test/loss_total'], 3)) for l, t in zip(lanes, tests)]} "
          f"({time.perf_counter() - t_phase:.1f} s into the phase)", flush=True)
    del res, grid, one, seq, mnist32

    # (f) experiment 9's CLI, --lane-sweep
    with tempfile.TemporaryDirectory() as run_dir:
        _reset_launches()
        sync()
        t0 = time.perf_counter()
        out = pvae_replicate.main([
            "--posteriors", "riemannian", "--curvatures", *map(str, PVAE_SWEEP_CURVATURES),
            "--epochs", str(PVAE_SWEEP_EPOCHS), "--iwae-k", str(PVAE_SWEEP_IWAE_K),
            "--n-train", str(n_train), "--n-test", str(n_test), "--lane-sweep",
            "--device", device, "--run-dir", run_dir])
        sync()
        wall = time.perf_counter() - t0
        paths["sweep_pvae"] = _launches()
    key = f"iwae_{PVAE_SWEEP_IWAE_K}"
    if sorted(out) != sorted(f"riemannian_c{c}_d2" for c in PVAE_SWEEP_CURVATURES):
        _fail(f"sweep (f): cells {sorted(out)}")
    for tag, r in out.items():
        if not (np.isfinite(r[key]) and np.isfinite(r["best_val"]) and r[key] >= r["test_elbo"]):
            _fail(f"sweep (f): {tag}: the bound {r[key]} is not finite or below the ELBO "
                  f"{r['test_elbo']}")
    if paths["sweep_pvae"] != no_launches():
        _fail(f"sweep (f): launches {paths['sweep_pvae']}, want none")
    print(f"sweep (f): experiment 9 --lane-sweep, riemannian, c in {PVAE_SWEEP_CURVATURES}, "
          f"{PVAE_SWEEP_EPOCHS} epochs and IWAE-{PVAE_SWEEP_IWAE_K} a lane in {wall:.3f} s: "
          f"{json.dumps(out)} ({time.perf_counter() - t_phase:.1f} s into the phase)", flush=True)

    # (g) a graceful stop after the first chunk, resumed bit for bit
    pair = [SWEEP_SEEDS[0], SWEEP_SEEDS[-1]]
    ref, _, _ = sweep("k3", pair, 4, k=2)
    with tempfile.TemporaryDirectory() as ckpt:
        _reset_launches()
        cut = trainer("k3", 4, 2, checkpoint_dir=ckpt, max_wall_seconds=0).fit_ensemble(dm, pair)
        if not all(r.interrupted and "wall-clock" in r.stop_reason and r.epochs_run == 2
                   for r in cut):
            _fail(f"sweep (g): not stopped after the first chunk: "
                  f"{[(r.interrupted, r.stop_reason, r.epochs_run) for r in cut]}")
        rest = trainer("k3", 4, 2, checkpoint_dir=ckpt).fit_ensemble(dm, pair, resume=True)
        paths["sweep_preempt"] = _launches()
    want = {**no_launches(), "flagship_train": 2 * 4 * steps, "flagship_fused": 2 * 4 * val_batches}
    if paths["sweep_preempt"] != want:
        _fail(f"sweep (g): launches {paths['sweep_preempt']}, want {want}")
    for a, b, r in zip(cut, rest, ref):
        if b.interrupted:
            _fail("sweep (g): the resumed sweep was interrupted")
        b.history = a.history + b.history
        _same_fit("sweep (g)", b, r, "stopped and resumed", "uninterrupted")
        if b.best_metric != r.best_metric:
            _fail(f"sweep (g): best {b.best_metric} != the uninterrupted {r.best_metric}")
    print(f"sweep (g): max_wall_seconds=0 stopped the sweep after epoch 1 ({cut[0].stop_reason}); "
          f"resume=True finished it; equal to the uninterrupted sweep bit for bit; launches "
          f"{json.dumps(paths['sweep_preempt'])}", flush=True)
    print(f"sweep: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return (err_in, err_bd), paths, grid_paths


# the deployment paths: RNASeqVAE at rnaseq_phase's width with
# 8,192 train cells (11,703 fake cells drawn: 8,192 / 1,755 / 1,756 rows),
# streamed whole and in 4 blocks of 2,048 rows (167.8 MB each); the
# flagship on the K3 path streamed whole and in 4 blocks; experiment 8's
# CLI streamed in blocks of 500 cells; the flagship's bundle with dispatch
# buckets {1, 2, 4}
DEPLOY_CELLS, DEPLOY_TRAIN, DEPLOY_BLOCK = 11703, 8192, 2048
DEPLOY_EPOCHS, DEPLOY_CAP, DEPLOY_EVAL_BLOCK, DEPLOY_EXP8_BLOCK = 2, 4, 1000, 500
DEPLOY_REQUESTS = (100, DEPLOY_CAP * BATCH)  # rows: a row bucket (128), a 4-batch dispatch
DEPLOY_AE_ROWS = 10000  # the Autoencoder's test split for the deterministic streamed evaluate

# the bundle served in a fresh process that never imports the model classes
_BUNDLE_CLIENT = r"""
import json, sys, time, urllib.request
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from hyperbolic_vae_tpu_torch.ops import launch_counters
from hyperbolic_vae_tpu_torch.serve import ExportedInferencer
from hyperbolic_vae_tpu_torch.serve_http import InferenceServer, load_engines, parse_args

bundle, io = sys.argv[2], np.load(sys.argv[3])
t0 = time.perf_counter()
exp = ExportedInferencer.load(bundle)  # its programs load at their first use
load_s = time.perf_counter() - t0

def calls():
    out = {}
    for n in json.loads(sys.argv[5]):
        out[f"encode_{n}_mean"], out[f"encode_{n}_scale"] = exp.encode(io[f"x_{n}"])
        out[f"decode_{n}"] = exp.decode(io[f"z_{n}"])
        out[f"reconstruct_{n}"] = exp.reconstruct(io[f"x_{n}"])
        out[f"generate_{n}"] = exp.generate(n, seed=7)
    return out

for c in launch_counters().values():
    c.reset()
t0 = time.perf_counter()
out = calls()
first_s = time.perf_counter() - t0
launches = {k: c.count for k, c in launch_counters().items()}
np.savez(sys.argv[4], **out)
lat = {}
for n in json.loads(sys.argv[5]):
    for name, fn in (("encode", lambda: exp.encode(io[f"x_{n}"])),
                     ("decode", lambda: exp.decode(io[f"z_{n}"])),
                     ("reconstruct", lambda: exp.reconstruct(io[f"x_{n}"])),
                     ("generate", lambda: exp.generate(n, seed=7))):
        ts = []
        for _ in range(21):
            t = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t) * 1e3)
        lat[f"{name} {n}"] = sorted(ts)[10]
# each request at 100 rows: what it must answer is the direct call's (the same program)
x, z = io["x_100"], io["z_100"]
want = {"encode": out["encode_100_mean"], "embed": out["encode_100_mean"],
        "decode": out["decode_100"], "reconstruct": out["reconstruct_100"],
        "generate": out["generate_100"]}
server = InferenceServer(load_engines(parse_args(["--bundle", bundle])),
                         host="127.0.0.1", port=0).start()
for c in launch_counters().values():
    c.reset()
http = {}
try:
    for method, body in (("encode", {"data": x.tolist()}), ("embed", {"data": x.tolist()}),
                         ("decode", {"data": z.tolist()}),
                         ("reconstruct", {"data": x.tolist()}), ("generate", {"n": 100, "seed": 7})):
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/v1/{method}", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            got = np.asarray(json.loads(r.read())["outputs"][0], np.float32)
        http[method] = bool(np.array_equal(got, want[method]))
finally:
    server.shutdown()
http_launches = {k: c.count for k, c in launch_counters().items()}
models = sorted(m for m in sys.modules if m.startswith("hyperbolic_vae_tpu_torch.models"))
print(json.dumps({"load_s": load_s, "first_calls_s": first_s, "programs": exp.n_programs,
                  "launches": launches, "latency_ms": lat, "http": http,
                  "http_launches": http_launches, "model_modules": models}))
"""


def _fake_cells(n_cells: int, seed: int = 42):
    """``make_rnaseq_data_module(fake=True, structured_fake=True)``'s kind
    of data at ``RNA_GENES`` genes, drawn on the card (numpy's draws of
    11,703 x 20,480 take the host ~20 s): cell types uniform over the nine,
    each with a module of genes / 20 marker genes at Poisson rate 300 (100
    elsewhere), z-scored per gene (ddof 0, in float64), then split 70 / 15
    / 15 by ``split_three_way`` on the host, where the split stays."""
    import torch

    from hyperbolic_vae_tpu_torch.data import ArrayDataModule
    from hyperbolic_vae_tpu_torch.data.core import split_three_way

    gen = torch.Generator(device="cuda").manual_seed(seed)
    types = torch.randint(0, 9, (n_cells,), generator=gen, device="cuda")
    module = RNA_GENES // 20
    rates = torch.full((9, RNA_GENES), 100.0, device="cuda")
    for t in range(9):
        lo = (t * module) % (RNA_GENES - module)
        rates[t, lo:lo + module] = 300.0
    x = torch.poisson(rates[types], generator=gen).double()
    x = (x - x.mean(0, keepdim=True)) / x.std(0, keepdim=True, unbiased=False).clamp_min(1e-12)
    (x_tr, y_tr), (x_va, y_va), (x_te, y_te) = split_three_way(
        x.float().cpu().numpy(), types.int().cpu().numpy(), seed=seed)
    return ArrayDataModule(x_tr, y_tr, x_va, y_va, x_te, y_te, batch_size=BATCH)


def _overlap(prog) -> dict:
    """From a streamed fit's program (``StreamedProgram.copy_spans`` and
    ``compute_spans``, the latest 64 of each): each copy's and compute
    span's interval (ms from the first copy's start), the share of the
    copies' time inside some compute span (blocks and val passes), and the
    means."""
    ref = prog.copy_spans[0][0]
    copies = [(ref.elapsed_time(a), ref.elapsed_time(b)) for a, b in prog.copy_spans]
    computes = [(ref.elapsed_time(a), ref.elapsed_time(b)) for a, b in prog.compute_spans]
    total = sum(b - a for a, b in copies)
    inside = sum(max(0.0, min(b, e) - max(a, s)) for a, b in copies for s, e in computes)
    return {"copies": len(copies), "compute_spans": len(computes),
            "copy_ms_mean": total / len(copies),
            "compute_ms_mean": sum(e - s for s, e in computes) / len(computes),
            "copy_overlap_share": inside / total}


def deploy_phase():
    """The deployment paths on the card:

      (a) K1 through its ``torch.library`` op
          (``torch.ops.hvae_torch.gyroplane_distances``, what every model's
          decoder and every exported program calls) against the plain
          version (``_k1_check``'s rules, at c = 1 and at 512 planes 1.4)
          at P = 16, 100, 256 and 512, at B = 256 and each one's
          evaluation B, and equal bit for bit to the direct ctypes call; the host's time for one op call against one
          ctypes call (in turns);
      (b) ``RNASeqVAE`` at 20,480 genes, hidden 256 (K1 at 256 planes),
          8,192 train cells, batch 256: ``fit_streamed(block_rows=8,192)``
          equal to ``fit`` bit for bit, both graphed, 2 epochs; with
          ``hbm_limit_bytes`` between the streamed and the resident memory
          estimates, ``fit`` refused naming ``fit_streamed`` and
          ``fit_streamed(block_rows=2,048)`` (4 blocks) run 2 epochs: its
          train samples/s against the resident fit's, the share of its copy
          stream's time inside block compute (CUDA events); exactly one K1
          launch a step and val batch; the same 4-block fit under
          ``run_eagerly()`` equal to it bit for bit (the copy stream, its
          events, the second buffer's graphs and the mean of the block
          means against plain calls); ``evaluate(stream_block_rows=1,000)``
          on the test split (within 5 % of the resident evaluate: the draws
          differ), and of an ``Autoencoder`` (no draws) on 10,000 rows
          within 1e-5 of the resident evaluate (the order of the sums);
      (c) the flagship on the K3 path (``train_step_fn``), synthetic MNIST
          (54,000 / 6,000 rows): ``fit_streamed`` at ``block_rows =
          n_train`` equal to ``fit`` bit for bit, then 4 blocks, equal bit for
          bit to the same fit under ``run_eagerly()``, K3 and K2 launches
          counted;
      (d) experiment 8's CLI with ``--stream-block-rows 500`` on its 1,000
          fake cells at 20,480 genes (K1 at 100 planes), 2 epochs;
      (e) the flagship's bundle: ``export_serving_bundle.py`` from a seeded
          model's state_dict (batch 256, dispatch buckets {1, 2, 4}, every
          endpoint, for cuda); loaded in a fresh process that never imports
          the model classes, where encode, decode, reconstruct and generate
          at a row bucket (100 rows) and a 4-batch dispatch (1,024 rows)
          equal the live ``Inferencer``'s bit for bit (K1 launches counted),
          each endpoint's latency beside the live one's, and ``serve_http
          --bundle``'s engines answer one request of each method over
          HTTP; an ``RNASeqVAE`` bf16 bundle's parameters round-trip
          exactly.

    Returns launches by path for K1 at 16, 256 and 100 planes, K2 and K3,
    and K1's op checks by plane count."""
    import tempfile
    from pathlib import Path

    import torch

    from hyperbolic_vae_tpu_torch.data import make_data_module
    from hyperbolic_vae_tpu_torch.data.core import split_three_way
    from hyperbolic_vae_tpu_torch.experiments import export_serving_bundle, train_vaes_rnaseq
    from hyperbolic_vae_tpu_torch.interop import state_dict_from_jax_params
    from hyperbolic_vae_tpu_torch.data import ArrayDataModule
    from hyperbolic_vae_tpu_torch.models import Autoencoder, GyroplaneVAE, RNASeqVAE
    from hyperbolic_vae_tpu_torch.ops import gyroplane as g
    from hyperbolic_vae_tpu_torch.ops import make_fused_loss_fn, make_fused_train_step
    from hyperbolic_vae_tpu_torch.serve import ExportedInferencer, Inferencer
    from hyperbolic_vae_tpu_torch.train import Trainer
    from hyperbolic_vae_tpu_torch.train.cuda_graph import run_eagerly

    t_phase = time.perf_counter()
    paths = {"k1_16": {}, "k1_256": {}, "k1_100": {}, "flagship_fused": {}, "flagship_train": {}}

    # (a) K1 through the op
    op = torch.ops.hvae_torch.gyroplane_distances
    rng = np.random.default_rng(21)
    via_op = {}
    for p, eval_b in ((P, IWAE_ROWS), (UNI_HIDDEN, UNI_K_CHUNK * BATCH),
                      (RNA_HIDDEN, RNA_K_CHUNK * BATCH), (CONV_P, IWAE_ROWS)):
        # the op calls the wrapper (checked equal below), which kernel_phase
        # and the families' phases hold at three curvatures: one here
        err_in, err_bd = _k1_check(rng, (BATCH, eval_b), p, (CONV_C if p == CONV_P else 1.0,),
                                   kernel=lambda x, pts, c, sg, b: op(x, pts, b, c, sg))
        x = torch.from_numpy(_points(rng, BATCH, 1.0, "interior")).cuda()
        pts = torch.from_numpy(_points(rng, p, 1.0, "interior")).cuda()
        bias = torch.from_numpy(rng.uniform(-1, 1, p).astype(np.float32)).cuda()
        direct = g.gyroplane_distances_cuda(x, pts, 1.0, True, bias)
        if not torch.equal(op(x, pts, bias, 1.0, True), direct):
            _fail(f"deploy (a): the op differs from the ctypes call at P={p}")
        via_op[p] = {"max_abs_err": err_in, "max_abs_err_boundary": err_bd, "B": [BATCH, eval_b]}
        print(f"deploy (a): K1 through the op at P={p}, B={BATCH} and {eval_b}, c = "
              f"{CONV_C if p == CONV_P else 1.0}: max_abs_err vs "
              f"plain interior {err_in:.3e}, near boundary {err_bd:.3e}; equal to the ctypes "
              f"call", flush=True)
    x = torch.from_numpy(_points(rng, BATCH, 1.0, "interior")).cuda()
    pts = torch.from_numpy(_points(rng, P, 1.0, "interior")).cuda()
    bias = torch.from_numpy(rng.uniform(-1, 1, P).astype(np.float32)).cuda()

    def host_us(fn, n=2000):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / n * 1e6

    host = [host_us(lambda: op(x, pts, bias, 1.0, True)),
            host_us(lambda: g.gyroplane_distances_cuda(x, pts, 1.0, True, bias)),
            host_us(lambda: g.gyroplane_distances_cuda(x, pts, 1.0, True, bias)),
            host_us(lambda: op(x, pts, bias, 1.0, True))]
    via_op[P].update(op_host_us=(host[0] + host[3]) / 2, ctypes_host_us=(host[1] + host[2]) / 2)
    print(f"deploy (a): host time a call at B={BATCH}, P={P} (2,000 back to back, in turns): "
          f"op {host[0]:.3f}, {host[3]:.3f} us; ctypes {host[1]:.3f}, {host[2]:.3f} us", flush=True)

    print(f"deploy (a): {time.perf_counter() - t_phase:.1f} s", flush=True)

    # (b) RNASeqVAE streamed
    t0 = time.perf_counter()
    rna = _fake_cells(DEPLOY_CELLS)
    n_tr, n_val = rna.x_train.shape[0], rna.x_val.shape[0]
    print(f"deploy (b): fake cells drawn on the card: {n_tr} train, {n_val} val, "
          f"{rna.x_test.shape[0]} test rows of {RNA_GENES} genes, z-scored "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    if n_tr != DEPLOY_TRAIN:
        _fail(f"deploy (b): {n_tr} train rows, want {DEPLOY_TRAIN}")
    sd = state_dict_from_jax_params(_rnaseq_jax_tree(0), model="rnaseq")

    def rna_model(dtype="float32"):
        m = RNASeqVAE(RNA_GENES, RNA_HIDDEN, compute_dtype=dtype, param_dtype=dtype)
        m.load_state_dict({k: v for k, v in sd.items() if k != "nb_log_theta"})
        return m

    def run(call, *args, **kw):
        """``call(*args, **kw)``'s result, wall and launches (counted from 0)."""
        torch.cuda.synchronize()
        _reset_launches()
        t = time.perf_counter()
        res = call(*args, **kw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t, _launches()

    val_b = -(-n_val // BATCH)
    want_k1 = DEPLOY_EPOCHS * (n_tr // BATCH + val_b)
    k1_only = lambda n: {"gyroplane_distances": n, "flagship_fused": 0, "flagship_train": 0}  # noqa: E731
    resident, wall_r, _ = run(Trainer(rna_model(), max_epochs=DEPLOY_EPOCHS).fit, rna)
    whole, wall_1, n = run(Trainer(rna_model(), max_epochs=DEPLOY_EPOCHS).fit_streamed,
                           rna, block_rows=n_tr)
    _same_fit("deploy (b) fit_streamed(block_rows=n_train)", whole, resident, "streamed",
              "resident")
    if n != k1_only(want_k1):
        _fail(f"deploy (b): the single-block streamed fit launched {n}, want {want_k1} K1")
    paths["k1_256"]["deploy_rnaseq_stream_whole"] = n["gyroplane_distances"]
    limited = Trainer(rna_model(), max_epochs=DEPLOY_EPOCHS)
    est = {rows: limited.memory_estimate(rna, [limited.model], stream_rows=rows)["total"]
           for rows in (None, DEPLOY_BLOCK)}
    limited.hbm_limit_bytes = (est[None] + est[DEPLOY_BLOCK]) // 2
    try:
        limited.fit(rna)
        _fail("deploy (b): fit ran past a memory limit below its estimate")
    except RuntimeError as e:
        if "fit_streamed" not in str(e):
            _fail(f"deploy (b): the preflight's remedy does not name fit_streamed: {e}")
    blocks, wall_4, n = run(limited.fit_streamed, rna, block_rows=DEPLOY_BLOCK)
    if n != k1_only(want_k1):
        _fail(f"deploy (b): the 4-block streamed fit launched {n}, want {want_k1} K1")
    paths["k1_256"]["deploy_rnaseq_stream_blocks"] = n["gyroplane_distances"]
    losses = [h["train/loss_total"] for h in blocks.history]
    if not np.all(np.isfinite(losses)):
        _fail(f"deploy (b): the 4-block fit's losses {losses}")
    ov = _overlap(limited.program)
    ratio = blocks.samples_per_sec / resident.samples_per_sec
    with run_eagerly():
        eager = Trainer(rna_model(), max_epochs=DEPLOY_EPOCHS).fit_streamed(
            rna, block_rows=DEPLOY_BLOCK)
    _same_fit(f"deploy (b) fit_streamed(block_rows={DEPLOY_BLOCK})", blocks, eager, "graphed",
              "eager")
    print(f"deploy (b): RNASeqVAE {DEPLOY_EPOCHS} epochs: resident fit {wall_r:.3f} s, "
          f"{resident.samples_per_sec:.1f} train samples/s; fit_streamed(block_rows={n_tr}) "
          f"{wall_1:.3f} s, {whole.samples_per_sec:.1f}/s, bit for bit the resident fit; "
          f"fit_streamed(block_rows={DEPLOY_BLOCK}) {wall_4:.3f} s, "
          f"{blocks.samples_per_sec:.1f}/s ({ratio:.4f} of resident), bit for bit under "
          f"run_eagerly(); memory estimates "
          f"resident {est[None]} B, streamed {est[DEPLOY_BLOCK]} B, limit "
          f"{limited.hbm_limit_bytes} B: fit refused naming fit_streamed; K1 {want_k1} a fit; "
          f"copies {json.dumps(ov)}", flush=True)
    ev_res = Trainer(rna_model()).evaluate(rna, split="test")
    ev_st, wall_e, n = run(Trainer(rna_model()).evaluate, rna, split="test",
                           stream_block_rows=DEPLOY_EVAL_BLOCK)
    n_te = rna.x_test.shape[0]
    want_e = sum(-(-min(DEPLOY_EVAL_BLOCK, n_te - s) // BATCH)
                 for s in range(0, n_te, DEPLOY_EVAL_BLOCK))
    if n != k1_only(want_e) or any(
            not np.isfinite(ev_st[k]) or abs(ev_st[k] - v) > 0.05 * abs(v) for k, v in ev_res.items()):
        _fail(f"deploy (b): evaluate(stream_block_rows={DEPLOY_EVAL_BLOCK}) {ev_st} against "
              f"{ev_res}, launches {n} (want {want_e} K1)")
    paths["k1_256"]["deploy_rnaseq_eval_stream"] = n["gyroplane_distances"]
    print(f"deploy (b): evaluate(stream_block_rows={DEPLOY_EVAL_BLOCK}) {wall_e:.3f} s: "
          f"{json.dumps(ev_st)} (resident {json.dumps(ev_res)})", flush=True)
    # a loss with no draws: the streamed evaluate is the resident one but
    # for the order of its sums
    xa = np.random.default_rng(8).uniform(0.0, 1.0, (DEPLOY_AE_ROWS, 32, 32, 3)).astype(np.float32)
    ya = np.zeros(DEPLOY_AE_ROWS, np.int32)
    ae = Trainer(Autoencoder(generator=torch.Generator().manual_seed(0)))
    ae_dm = ArrayDataModule(xa[:BATCH], ya[:BATCH], xa[:BATCH], ya[:BATCH], xa, ya,
                            batch_size=BATCH)
    ev_res = ae.evaluate(ae_dm, split="test")
    ev_st = ae.evaluate(ae_dm, split="test", stream_block_rows=DEPLOY_EVAL_BLOCK)
    rel = max(abs(ev_st[k] - v) / max(abs(v), 1e-30) for k, v in ev_res.items())
    if ev_st.keys() != ev_res.keys() or not rel <= 1e-5:
        _fail(f"deploy (b): the Autoencoder's evaluate(stream_block_rows={DEPLOY_EVAL_BLOCK}) "
              f"{ev_st} against the resident {ev_res} (largest relative difference {rel})")
    print(f"deploy (b): Autoencoder, {DEPLOY_AE_ROWS} test rows: evaluate(stream_block_rows="
          f"{DEPLOY_EVAL_BLOCK}) {json.dumps(ev_st)} against resident {json.dumps(ev_res)}: "
          f"largest relative difference {rel:.3e} (limit 1e-5)", flush=True)
    del xa, ae_dm
    del rna, resident, whole, blocks, limited, eager

    # (c) the flagship on the K3 path, streamed
    t0 = time.perf_counter()
    mnist = make_data_module(batch_size=BATCH, synthetic=True, n_train=60000, n_test=10000)
    m_tr, m_val = mnist.x_train.shape[0], mnist.x_val.shape[0]
    print(f"deploy (c): synthetic MNIST {m_tr} train, {m_val} val rows "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)

    def k3():
        m = GyroplaneVAE(generator=torch.Generator().manual_seed(0))
        return Trainer(m, max_epochs=DEPLOY_EPOCHS, early_stopping_patience=None,
                       loss_fn=make_fused_loss_fn(m), train_step_fn=make_fused_train_step(m))

    k2_want = DEPLOY_EPOCHS * -(-m_val // BATCH)
    resident, wall_r, _ = run(k3().fit, mnist)
    out = {}
    for name, rows in (("whole", m_tr), ("blocks", m_tr // 4)):
        res, wall, n = run(k3().fit_streamed, mnist, block_rows=rows)
        want = {"gyroplane_distances": 0, "flagship_fused": k2_want,
                "flagship_train": DEPLOY_EPOCHS * (m_tr // rows) * (rows // BATCH)}
        if n != want:
            _fail(f"deploy (c): fit_streamed(block_rows={rows}) launched {n}, want {want}")
        paths["flagship_fused"][f"deploy_k3_stream_{name}"] = n["flagship_fused"]
        paths["flagship_train"][f"deploy_k3_stream_{name}"] = n["flagship_train"]
        out[name] = (res, wall)
    _same_fit("deploy (c) K3 fit_streamed(block_rows=n_train)", out["whole"][0], resident,
              "streamed", "resident")
    with run_eagerly():
        eager = k3().fit_streamed(mnist, block_rows=m_tr // 4)
    _same_fit(f"deploy (c) K3 fit_streamed(block_rows={m_tr // 4})", out["blocks"][0], eager,
              "graphed", "eager")
    print(f"deploy (c): the flagship on the K3 path, {DEPLOY_EPOCHS} epochs: resident "
          f"{wall_r:.3f} s, {resident.samples_per_sec:.1f} train samples/s; streamed whole "
          f"{out['whole'][1]:.3f} s, {out['whole'][0].samples_per_sec:.1f}/s, bit for bit; "
          f"4 blocks of {m_tr // 4} rows {out['blocks'][1]:.3f} s, "
          f"{out['blocks'][0].samples_per_sec:.1f}/s, bit for bit under run_eagerly(); "
          f"val/loss_total "
          f"{out['blocks'][0].history[-1]['val/loss_total']:.4f}", flush=True)
    del mnist

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # (d) experiment 8's CLI, streamed
        res, wall, n = run(train_vaes_rnaseq.main, [
            "--synthetic", "--epochs", str(DEPLOY_EPOCHS), "--n-genes", str(RNA_GENES),
            "--structured-fake", "--stream-block-rows", str(DEPLOY_EXP8_BLOCK),
            "--run-dir", str(tmp / "exp8"), "--log-level", "WARNING"])
        (tr, _), (va, _), (te, _) = split_three_way(np.zeros((INTEROP_EXP8_CELLS, 1)),
                                                    np.zeros(INTEROP_EXP8_CELLS), seed=42)
        want = (DEPLOY_EPOCHS * (DEPLOY_EXP8_BLOCK // UNI_BATCH + -(-len(va) // UNI_BATCH))
                + -(-len(te) // UNI_BATCH))
        if n != k1_only(want) or not all(np.isfinite(v) for v in res.values()):
            _fail(f"deploy (d): experiment 8 streamed gave {res}, launches {n} (want {want} K1)")
        paths["k1_100"]["deploy_exp8_stream"] = n["gyroplane_distances"]
        print(f"deploy (d): experiment 8 with --stream-block-rows {DEPLOY_EXP8_BLOCK} "
              f"({len(tr)} train cells: one block, {len(tr) - DEPLOY_EXP8_BLOCK} left out) "
              f"{wall:.3f} s: {json.dumps(res)}; {want} K1", flush=True)

        # (e) the flagship's bundle
        seeded = GyroplaneVAE(generator=torch.Generator().manual_seed(0))
        torch.save({k: v.cpu() for k, v in seeded.state_dict().items()}, tmp / "flagship.pt")
        bundle = tmp / "bundle"
        t0 = time.perf_counter()
        export_serving_bundle.main([
            "--state-dict", str(tmp / "flagship.pt"), "--out", str(bundle),
            "--batch-size", str(BATCH), "--max-batches-per-dispatch", str(DEPLOY_CAP),
            "--methods", "encode", "decode", "reconstruct", "generate", "--platforms", "cuda"])
        export_s = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in bundle.iterdir())
        n_prog = len(list(bundle.glob("*.pt2")))
        live = Inferencer.from_state_dict(tmp / "flagship.pt", batch_size=BATCH,
                                          max_batches_per_dispatch=DEPLOY_CAP)
        live.warmup()
        xs = make_data_module(batch_size=BATCH, synthetic=True, n_train=2000, n_test=1).x_train
        zs = np.random.default_rng(3).uniform(-0.6, 0.6, (max(DEPLOY_REQUESTS), D)).astype(np.float32)
        io = {}
        for r in DEPLOY_REQUESTS:
            io[f"x_{r}"], io[f"z_{r}"] = xs[:r], zs[:r]
        np.savez(tmp / "io.npz", **io)
        torch.cuda.synchronize()
        _reset_launches()
        want_out = {}
        for r in DEPLOY_REQUESTS:
            want_out[f"encode_{r}_mean"], want_out[f"encode_{r}_scale"] = live.encode(io[f"x_{r}"])
            want_out[f"decode_{r}"] = live.decode(io[f"z_{r}"])
            want_out[f"reconstruct_{r}"] = live.reconstruct(io[f"x_{r}"])
            want_out[f"generate_{r}"] = live.generate(r, seed=7)
        live_launches = _launches()
        live_lat = {}
        for r in DEPLOY_REQUESTS:
            for name, fn in (("encode", lambda: live.encode(io[f"x_{r}"])),
                             ("decode", lambda: live.decode(io[f"z_{r}"])),
                             ("reconstruct", lambda: live.reconstruct(io[f"x_{r}"])),
                             ("generate", lambda: live.generate(r, seed=7))):
                ts = []
                for _ in range(21):
                    t = time.perf_counter()
                    fn()
                    ts.append((time.perf_counter() - t) * 1e3)
                live_lat[f"{name} {r}"] = sorted(ts)[10]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", _BUNDLE_CLIENT, str(Path(__file__).resolve().parent),
             str(bundle), str(tmp / "io.npz"), str(tmp / "got.npz"),
             json.dumps(list(DEPLOY_REQUESTS))],
            capture_output=True, text=True, timeout=300)
        client_s = time.perf_counter() - t0
        if proc.returncode != 0:
            _fail(f"deploy (e): the bundle's process failed: {proc.stderr[-3000:]}")
        client = json.loads(proc.stdout.strip().splitlines()[-1])
        with np.load(tmp / "got.npz") as got:
            for k, v in want_out.items():
                if not np.array_equal(got[k], v):
                    _fail(f"deploy (e): the bundle's {k} differs from the live engine's by "
                          f"{float(np.abs(got[k] - v).max())}")
        # one K1 a decoded batch: decode, reconstruct and generate at 1 and 4 batches
        want_k1 = 3 * sum(-(-r // BATCH) for r in DEPLOY_REQUESTS)
        if client["launches"] != k1_only(want_k1) or live_launches != k1_only(want_k1):
            _fail(f"deploy (e): launches {client['launches']} (live {live_launches}), want "
                  f"{want_k1} K1")
        if client["model_modules"] or not all(client["http"].values()) or len(client["http"]) != 5:
            _fail(f"deploy (e): the bundle's process imported {client['model_modules']} or "
                  f"answered over HTTP {client['http']}")
        if client["http_launches"] != k1_only(3):
            _fail(f"deploy (e): serve_http --bundle launched {client['http_launches']}, want 3 K1")
        paths["k1_16"]["deploy_bundle"] = client["launches"]["gyroplane_distances"]
        paths["k1_16"]["deploy_bundle_http"] = client["http_launches"]["gyroplane_distances"]
        for k in live_lat:
            print(f"deploy (e): latency {k} rows (median of 21): bundle "
                  f"{client['latency_ms'][k]:.4f} ms, live {live_lat[k]:.4f} ms", flush=True)
        print(f"deploy (e): bundle {n_prog} programs, {size} bytes, exported in {export_s:.3f} s; "
              f"its process {client_s:.3f} s (load {client['load_s']:.3f} s, the first calls "
              f"with their {client['programs']} programs' loads {client['first_calls_s']:.3f} s); "
              f"every endpoint bit for bit the live engine's; {want_k1} K1; serve_http --bundle "
              f"answered {sorted(client['http'])}, 3 K1", flush=True)

        # (e) the RNA-seq family's bf16 parameters through a bundle
        bf = rna_model("bfloat16")
        inf = Inferencer(bf, batch_size=BATCH, max_batches_per_dispatch=1, sub_batch_buckets=False)
        inf.export_programs(tmp / "rna_bf16", methods=("encode",), platforms=("cuda",))
        exp = ExportedInferencer.load(tmp / "rna_bf16")
        for k, v in bf.state_dict().items():
            if exp.params[k].dtype != v.dtype or not torch.equal(exp.params[k], v):
                _fail(f"deploy (e): the bf16 bundle's {k} differs from the model's")
        xr = np.random.default_rng(4).normal(size=(BATCH, RNA_GENES)).astype(np.float32)
        if not np.array_equal(exp.embed(xr), inf.embed(xr)):
            _fail("deploy (e): the bf16 bundle's embed differs from the live engine's")
        print(f"deploy (e): RNASeqVAE bf16 bundle: {len(exp.params)} parameters round-trip "
              f"exactly ({sum(v.dtype == torch.bfloat16 for v in exp.params.values())} bf16); "
              f"embed bit for bit", flush=True)
    print(f"deploy: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return paths, via_op


# data_mesh_phase: (a)'s GEO pair at the realistic 20,480 genes, cut from
# GSE115978's ~7,186 cells to 2,048 (~170 MB of text) for the phase's time
MESH_CELLS, MESH_EPOCHS = 2048, 2
MESH_MNIST = (20000, 2000)  # (c)'s synthetic MNIST: 18,000 train, 2,000 val rows
MESH_RNA_CELLS = 4096  # (c)'s RNASeqVAE cells: 2,867 train, 614 val rows
MESH_SEEDS = ["42", "7"]
def _write_geo_pair(d, x, cell_types, cell_ids, genes) -> list:
    """GEO's layout of GSE115978 in ``d``: ``annotations.csv`` (cells,
    cell.types, samples; the types with '?', NA spellings and the
    vocabulary's synonyms) and ``tpm.csv`` (genes as rows, an empty first
    header field, the counts as integers), the text built with numpy.
    Returns the cell types as a reader must give them."""
    from hyperbolic_vae_tpu_torch.data.jerby_arnon import nice_to_weirds

    want, spelled = [], []
    for i, t in enumerate(cell_types):
        t = str(t)
        if i % 13 == 0:
            spelled.append(["?", "NA", "", "N/A", "null"][i // 13 % 5])
            want.append("Unknown")
        elif i % 3 == 0 and nice_to_weirds[t]:
            spelled.append(nice_to_weirds[t][i % len(nice_to_weirds[t])])
            want.append(t)
        else:
            spelled.append(t)
            want.append(t)
    with open(d / "annotations.csv", "w") as f:
        f.write("cells,cell.types,samples\n")
        f.writelines(f'{c},"{t}",Mel{i % 31}\n' for i, (c, t) in enumerate(zip(cell_ids, spelled)))
    counts = x.T.astype(np.int64)  # (genes, cells)
    if counts.min() < 0 or counts.max() > 999 or {len(g) for g in genes} != {10}:
        _fail("data_mesh (a): the writer takes counts of up to 3 digits and 10-character genes")
    n_genes, n_cells = counts.shape
    buf = np.empty((n_genes, 11 + 4 * n_cells), np.uint8)
    keep = np.ones(buf.shape, bool)
    buf[:, :11] = np.frombuffer("".join(g + "," for g in genes).encode(), np.uint8).reshape(-1, 11)
    body, kb = buf[:, 11:].reshape(n_genes, n_cells, 4), keep[:, 11:].reshape(n_genes, n_cells, 4)
    for k, place in enumerate((100, 10, 1)):  # the digits, most significant first
        body[..., k] = 48 + counts // place % 10
    body[..., 3] = ord(",")
    body[:, -1, 3] = ord("\n")
    kb[..., 0], kb[..., 1] = counts >= 100, counts >= 10
    with open(d / "tpm.csv", "wb") as f:
        f.write(("," + ",".join(cell_ids) + "\n").encode())
        f.write(buf[keep].tobytes())
    return want


def _collective_window(prog, n: int = 20, eager: bool = True) -> dict:
    """After a fit: the step's graph (the K3 path's: its epoch graph)
    replayed ``n`` times under torch.profiler (the device's kernels a step
    and the NCCL kernels among them), and (``eager``) 3 steps of the same
    pieces run eagerly under it with the host's ops, where an issued
    collective shows as ``nccl:all_reduce`` whether or not it launches a
    kernel. A fit under a parameter layout has put its model's layers
    back, so only its graphs replay (``eager=False``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    gp = prog.program
    names = [s.name for s in gp.segments]
    name = "train epoch" if "train epoch" in names else "train step"
    # an epoch's steps at most after its begin (the step counter indexes them)
    n, per = (n, prog.ep.steps) if name == "train epoch" else (min(n, prog.ep.steps), 1)
    if name == "train step":
        gp.replay("begin epoch")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            gp.replay(name)
        torch.cuda.synchronize()
    rows = [(e.key, getattr(e, "self_device_time_total", 0.0), e.count)
            for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    nccl = [r for r in rows if "nccl" in r[0].lower()]
    steps = n * per
    out = {"graph": name, "nccl_kernels_a_step": sum(r[2] for r in nccl) / steps,
           "nccl_ms_a_step": sum(r[1] for r in nccl) / 1e3 / steps,
           "kernels_a_step": sum(r[2] for r in rows) / steps,
           "nccl_kernels": sorted({r[0][:40] for r in nccl})}
    if not eager:
        return out
    prog.ep.begin()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as eager:
        for _ in range(3):
            prog.ep.step()
        torch.cuda.synchronize()
    out["eager_nccl_a_step"] = {e.key: e.count / 3 for e in eager.key_averages()
                                if "nccl" in e.key.lower()}
    return out


def data_mesh_phase():
    """The Jerby-Arnon data paths and data and seed parallelism at world
    size 1 over NCCL:

      (a) the port's C++ CSV parser built with g++ (``data/native.py``;
          ``is_available()`` must hold); GEO's pair written from
          ``make_fake_arrays(structured=True)`` at 20,480 genes x 2,048
          cells (``_write_geo_pair``); ``read_csv_matrix`` timed (wall, MB/s,
          the host's CPUs) and held bit for bit to Python's ``float`` of 16
          sampled rows; ``make_rnaseq_data_module(data_dir=...)`` with pandas
          made unimportable, equal bit for bit to the module built from
          the written arrays (sorted by cell id, the NA spellings
          "Unknown", the synonyms their names, z-scored, split), its load
          wall;
      (b) experiment 8's CLI with ``--rnaseq-dir`` and ``--use-mesh`` on that
          pair, 2 epochs (UnifiedVAE, K1 at 100 planes), its K1 launches
          counted;
      (c) graphed fits of 2 epochs with ``mesh=make_mesh()`` (NCCL, world
          size 1) against the same fits without a mesh, bit for bit
          (history, best and final parameters): the flagship's default path
          (K1 at 16 planes), ``RNASeqVAE`` at 20,480 genes and hidden 256
          (K1 at 256) and the flagship's K3 path (whole batch, no
          collective); for each the step graph's node kinds meshed and
          not, the NCCL kernels a step under torch.profiler, and the step's
          wall meshed against unmeshed;
      (d) experiment 6's CLI with ``--seeds 42 7 --seed-mesh 1`` against
          the same sweep without it, bit for bit.

    Returns launches by path for K1 at 16, 256 and 100 planes, K2 and K3."""
    import importlib.util
    import os
    import tempfile
    from pathlib import Path

    import torch
    import torch.distributed as dist

    from hyperbolic_vae_tpu_torch.data import (
        ArrayDataModule,
        filter_gene_symbols,
        make_data_module,
        make_fake_arrays,
        make_rnaseq_data_module,
        native,
        normalize_rnaseq,
    )
    from hyperbolic_vae_tpu_torch.data.core import split_three_way
    from hyperbolic_vae_tpu_torch.data.jerby_arnon import _labels_to_int
    from hyperbolic_vae_tpu_torch.experiments import (
        train_vae_hyperbolic_mnist_gyroplane,
        train_vaes_rnaseq,
    )
    from hyperbolic_vae_tpu_torch.models import GyroplaneVAE, RNASeqVAE
    from hyperbolic_vae_tpu_torch.ops import make_fused_loss_fn, make_fused_train_step
    from hyperbolic_vae_tpu_torch.parallel import make_mesh
    from hyperbolic_vae_tpu_torch.train import Trainer

    t_phase = time.perf_counter()
    paths = {"k1_16": {}, "k1_256": {}, "k1_100": {}, "flagship_fused": {}, "flagship_train": {}}
    # NCCL's bootstrap of a world of one on the loopback (the machine has no network)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")

    def run(call, *args, **kw):
        """``call(*args, **kw)``'s result, wall and launches (counted from 0)."""
        torch.cuda.synchronize()
        _reset_launches()
        t = time.perf_counter()
        res = call(*args, **kw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t, _launches()

    def k1_only(n):
        return {"gyroplane_distances": n, "flagship_fused": 0, "flagship_train": 0}

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # (a) the native parse and the pandas-free load
        t0 = time.perf_counter()
        if not native.is_available():
            _fail(f"data_mesh (a): the C++ CSV parser did not build: {native.build_error()}")
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        x, types, genes, cells = make_fake_arrays(MESH_CELLS, RNA_GENES, structured=True)
        want_types = _write_geo_pair(tmp, x, types, cells, genes)
        write_s = time.perf_counter() - t0
        tpm = tmp / "tpm.csv"
        size = tpm.stat().st_size
        t0 = time.perf_counter()
        m = native.read_csv_matrix(tpm)
        parse_s = time.perf_counter() - t0
        if m.shape != (RNA_GENES, MESH_CELLS):
            _fail(f"data_mesh (a): parsed {m.shape}, want {(RNA_GENES, MESH_CELLS)}")
        sampled = set(np.random.default_rng(5).choice(RNA_GENES, 16, replace=False).tolist())
        with open(tpm) as f:
            f.readline()
            for i, line in enumerate(f):
                if i in sampled:
                    plain = np.array([float(v) for v in line.rstrip("\n").split(",")[1:]],
                                     np.float32)
                    if not np.array_equal(plain.view(np.uint32), m[i].view(np.uint32)):
                        _fail(f"data_mesh (a): row {i} differs from Python's parse")
        del m
        cpus = len(os.sched_getaffinity(0))
        print(f"data_mesh (a): the C++ parser built in {build_s:.2f} s; wrote GEO's pair "
              f"({size / 1e6:.1f} MB tpm.csv, {RNA_GENES} genes x {MESH_CELLS} cells) in "
              f"{write_s:.2f} s; read_csv_matrix {parse_s:.3f} s = {size / 1e6 / parse_s:.1f} MB/s "
              f"on {cpus} CPUs (os.cpu_count {os.cpu_count()}); 16 sampled rows bit for bit "
              f"Python's float", flush=True)
        # the module make_rnaseq_data_module builds from these arrays: cells in
        # id order, the gene filter (which keeps every fake gene), z-scores
        order = sorted(range(MESH_CELLS), key=lambda i: cells[i])
        xw = normalize_rnaseq(filter_gene_symbols(x[order], genes)[0], "z_score").astype(np.float32)
        y, vocab = _labels_to_int(np.asarray(want_types, dtype=object)[order])
        (x_tr, y_tr), (x_va, y_va), (x_te, y_te) = split_three_way(xw, y, seed=42)
        want = ArrayDataModule(x_tr, y_tr, x_va, y_va, x_te, y_te, batch_size=UNI_BATCH,
                               label_names=vocab, name="jerby_arnon")
        has_pandas = "pandas" in sys.modules or importlib.util.find_spec("pandas") is not None
        blocked = sys.modules.get("pandas", "absent")
        sys.modules["pandas"] = None  # the pandas-free route, whatever the machine has
        try:
            t0 = time.perf_counter()
            got = make_rnaseq_data_module(batch_size=UNI_BATCH, data_dir=str(tmp))
            load_s = time.perf_counter() - t0
            for split in ("train", "val", "test"):
                for a in ("x", "y"):
                    g, w = getattr(got, f"{a}_{split}"), getattr(want, f"{a}_{split}")
                    if g.dtype != w.dtype or not np.array_equal(g, w):
                        _fail(f"data_mesh (a): {a}_{split} differs from the written arrays'")
            if list(got.label_names) != vocab or got.name != want.name:
                _fail(f"data_mesh (a): labels {got.label_names}, want {vocab}")
            print(f"data_mesh (a): make_rnaseq_data_module(data_dir=...) without pandas "
                  f"{load_s:.3f} s, bit for bit the written arrays' module ({len(got.x_train)} / "
                  f"{len(got.x_val)} / {len(got.x_test)} cells, {got.x_train.shape[1]} genes, "
                  f"labels {vocab}); pandas on this machine: {has_pandas}",
                  flush=True)

            # (b) experiment 8 on the CSVs, data parallel at world size 1
            res, wall, n = run(train_vaes_rnaseq.main, [
                "--rnaseq-dir", str(tmp), "--use-mesh", "--epochs", str(MESH_EPOCHS),
                "--run-dir", str(tmp / "exp8"), "--log-level", "WARNING"])
        finally:
            if blocked == "absent":
                del sys.modules["pandas"]
            else:
                sys.modules["pandas"] = blocked
        if not dist.is_initialized() or "nccl" not in str(dist.get_backend()):
            _fail("data_mesh (b): --use-mesh did not start an NCCL world")
        want_k1 = (int(res["epochs"]) * (len(x_tr) // UNI_BATCH + -(-len(x_va) // UNI_BATCH))
                   + -(-len(x_te) // UNI_BATCH))
        if n != k1_only(want_k1) or not all(np.isfinite(v) for v in res.values()):
            _fail(f"data_mesh (b): experiment 8 gave {res}, launches {n} (want {want_k1} K1)")
        paths["k1_100"]["data_mesh_exp8_csv"] = n["gyroplane_distances"]
        print(f"data_mesh (b): experiment 8 --rnaseq-dir --use-mesh (NCCL, world size "
              f"{dist.get_world_size()}) {wall:.3f} s: {json.dumps(res)}; {want_k1} K1 at "
              f"{UNI_HIDDEN} planes", flush=True)

        # (c) graphed data-parallel fits at world size 1 against unmeshed ones
        mesh = make_mesh()
        mnist = make_data_module(batch_size=BATCH, synthetic=True, n_train=MESH_MNIST[0],
                                 n_test=MESH_MNIST[1])
        rna = _fake_cells(MESH_RNA_CELLS)

        def flagship(m, k3=False):
            model = GyroplaneVAE(generator=torch.Generator().manual_seed(0))
            # the K3 path's val batches through K2, as train_phase's K3 fit
            kw = ({"train_step_fn": make_fused_train_step(model),
                   "loss_fn": make_fused_loss_fn(model)} if k3 else {})
            return Trainer(model, max_epochs=MESH_EPOCHS, early_stopping_patience=None, mesh=m,
                           **kw)

        def rnaseq(m):
            model = RNASeqVAE(RNA_GENES, RNA_HIDDEN, generator=torch.Generator().manual_seed(0))
            return Trainer(model, max_epochs=MESH_EPOCHS, early_stopping_patience=None, mesh=m)

        def steps_of(dm):
            return len(dm.x_train) // dm.batch_size, -(-len(dm.x_val) // dm.batch_size)

        for label, make, dm, key, want_fn in (
                ("flagship default path", flagship, mnist, "k1_16",
                 lambda s, v: k1_only(MESH_EPOCHS * (s + v))),
                ("RNASeqVAE 20,480 genes", rnaseq, rna, "k1_256",
                 lambda s, v: k1_only(MESH_EPOCHS * (s + v))),
                ("flagship K3 path", functools.partial(flagship, k3=True), mnist, "flagship_train",
                 lambda s, v: {"gyroplane_distances": 0, "flagship_fused": MESH_EPOCHS * v,
                               "flagship_train": MESH_EPOCHS * s})):
            t_meshed, t_plain = make(mesh), make(None)
            r_meshed, wall_m, n = run(t_meshed.fit, dm)
            r_plain, wall_p, _ = run(t_plain.fit, dm)
            _same_fit(f"data_mesh (c) {label}", r_meshed, r_plain, "meshed", "unmeshed")
            if n != want_fn(*steps_of(dm)):
                _fail(f"data_mesh (c) {label}: launches {n}, want {want_fn(*steps_of(dm))}")
            if key == "flagship_train":
                paths["flagship_train"]["data_mesh_k3"] = n["flagship_train"]
                paths["flagship_fused"]["data_mesh_k3"] = n["flagship_fused"]
            else:
                paths[key][f"data_mesh_{label.split()[0].lower()}"] = n["gyroplane_distances"]
            pm = _profile_train(t_meshed.program, "cuda")
            pp = _profile_train(t_plain.program, "cuda")
            cm, cp = _collective_window(t_meshed.program), _collective_window(t_plain.program)
            issued = sum(cm["eager_nccl_a_step"].values())
            # a row-split step issues one all-reduce (K3's path none), unmeshed none
            if issued != (0 if key == "flagship_train" else 1) or cp["eager_nccl_a_step"]:
                _fail(f"data_mesh (c) {label}: NCCL ops a step {cm['eager_nccl_a_step']} meshed, "
                      f"{cp['eager_nccl_a_step']} unmeshed")
            print(f"data_mesh (c) {label}: meshed = unmeshed bit for bit ({MESH_EPOCHS} epochs, "
                  f"fits {wall_m:.3f} / {wall_p:.3f} s, launches {json.dumps(n)}); "
                  f"replaying the {cm['graph']} graph: NCCL kernels a step "
                  f"{cm['nccl_kernels_a_step']:.2f} ({cm['nccl_ms_a_step']:.5f} ms), kernels a "
                  f"step {cm['kernels_a_step']:.1f} against {cp['kernels_a_step']:.1f}; eager, "
                  f"NCCL ops a step {json.dumps(cm['eager_nccl_a_step'])} against "
                  f"{json.dumps(cp['eager_nccl_a_step'])}; step wall "
                  f"{pm['wall_ms']:.4f} ms meshed against {pp['wall_ms']:.4f} ms ({pm['what']}), "
                  f"busy {pm['busy_ms']:.4f} / {pp['busy_ms']:.4f} ms", flush=True)
            del t_meshed, t_plain, r_meshed, r_plain

        # (d) experiment 6's seed sweep on a seed mesh of one rank
        argv = ["--synthetic", "--epochs", str(MESH_EPOCHS), "--n-train", str(MESH_MNIST[0]),
                "--n-test", str(MESH_MNIST[1]), "--seeds", *MESH_SEEDS, "--log-level", "WARNING"]
        meshed, wall_m, n = run(train_vae_hyperbolic_mnist_gyroplane.main,
                                argv + ["--seed-mesh", "1", "--run-dir", str(tmp / "exp6m")])
        plain, wall_p, _ = run(train_vae_hyperbolic_mnist_gyroplane.main,
                               argv + ["--run-dir", str(tmp / "exp6")])
        for seed, a, b in zip(MESH_SEEDS, meshed, plain):
            _same_fit(f"data_mesh (d) seed {seed}", a, b, "seed mesh", "no mesh")
        s, v = len(mnist.x_train) // BATCH, -(-len(mnist.x_val) // BATCH)
        if n != k1_only(len(MESH_SEEDS) * MESH_EPOCHS * (s + v)):
            _fail(f"data_mesh (d): launches {n}")
        paths["k1_16"]["data_mesh_seed_mesh"] = n["gyroplane_distances"]
        print(f"data_mesh (d): experiment 6 --seeds {' '.join(MESH_SEEDS)} --seed-mesh 1 = the "
              f"sweep without it, bit for bit ({wall_m:.3f} / {wall_p:.3f} s; "
              f"{n['gyroplane_distances']} K1)", flush=True)
    dist.destroy_process_group()  # the world (b) started: NCCL's watchdog stops with it
    print(f"data_mesh: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return paths


# shard_phase: K1 on the plane shards that a 2- or 4-way model axis gives
# the repo's gyroplane decoders (RNASeqVAE's 256 planes, UnifiedVAE's 100,
# the flagship's 16), at the model's batch and at an IWAE decode's rows
SHARD_PLANES = {RNA_HIDDEN: 25600, UNI_HIDDEN: 25600, P: IWAE_ROWS}
SHARD_WAYS = (2, 4)
SHARD_CELLS, SHARD_EPOCHS = 4096, 2  # (b)'s RNASeqVAE: 2,867 train, 614 val rows


class _AsIfData:
    """A mesh's shape with its data axis taken as ``n``: the specs a rule
    gives over n data ranks, applied to the real mesh (here of one rank),
    so that FSDP's slices, gathers and reduce-scatters are in the step."""

    def __init__(self, mesh, n: int):
        self.shape = dict(mesh.shape, data=n)


def _at_offset(t, lo: int):
    """``t`` as rows [lo, lo + len(t)) of a larger tensor: a plane shard's
    view, its data pointer offset as ``points[lo:hi]``'s is."""
    import torch

    if t is None:
        return None
    whole = torch.full((lo + t.shape[0] + 3,) + tuple(t.shape[1:]), float("nan"),
                       dtype=t.dtype, device=t.device)
    whole[lo:lo + t.shape[0]] = t
    return whole[lo:lo + t.shape[0]]


def _k1_shards(rng) -> list:
    """(a): for each plane count and split, at the model's batch and the
    IWAE decode's rows: every shard's launch (``points[lo:hi]``,
    ``bias[lo:hi]``) bit for bit the whole launch's columns; each shard's
    shape held to the plain version (``_k1_check``'s tolerances, c = 1,
    its points and bias at the shard's offset); its kernel path, graph
    time, an empty launch of its grid and its bound."""
    import torch

    from hyperbolic_vae_tpu_torch.ops import gyroplane as g
    from hyperbolic_vae_tpu_torch.parallel.mesh import share

    out = []
    for planes, rows in SHARD_PLANES.items():
        for ways in SHARD_WAYS:
            for b in (BATCH, rows):
                x = torch.from_numpy(_points(rng, b, 1.0, "interior")).cuda()
                pts = torch.from_numpy(_points(rng, planes, 1.0, "interior")).cuda()
                bias = torch.from_numpy(rng.uniform(-1, 1, planes).astype(np.float32)).cuda()
                whole = g.gyroplane_distances_cuda(x, pts, 1.0, True, bias)
                paths = set()
                for i in range(ways):
                    lo, hi = share(planes, ways, i)
                    part = g.gyroplane_distances_cuda(x, pts[lo:hi], 1.0, True, bias[lo:hi])
                    paths.add(g.kernel_path(x, pts[lo:hi]))
                    if not torch.equal(part.view(torch.int32),
                                       whole[:, lo:hi].contiguous().view(torch.int32)):
                        _fail(f"shard (a): K1 on planes [{lo}, {hi}) of {planes} at B={b} differs "
                              f"from the whole launch's columns")
                p = planes // ways
                lo = p * (ways - 1)  # the last shard's offset
                err_in, err_bd = _k1_check(
                    rng, (b,), p, curvatures=(1.0,),
                    kernel=lambda xx, pp, c, s, bb: g.gyroplane_distances_cuda(
                        xx, _at_offset(pp, lo), c, s, _at_offset(bb, lo)))
                xs, ps, bs = x, pts[lo:], bias[lo:]
                graph_ms = _graph_ms(lambda: g.gyroplane_distances_cuda(xs, ps, 1.0, True, bs))
                plain_graph_ms = _graph_ms(lambda: g.gyroplane_distances(xs, ps, 1.0, True, bs))
                floor_ms = _graph_ms(_empty_launch(b, p))
                n_bytes = 4 * (b * D + p * D + p + b * p)
                n_ops = b * p * (2 * D + GYRO_EPILOGUE_OPS) + 2 * D * (b + p)
                t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_FLOP_PER_S * 1e3
                rec = {"planes": planes, "ways": ways, "P": p, "B": b, "path": sorted(paths),
                       "graph_ms": graph_ms, "plain_graph_ms": plain_graph_ms,
                       "launch_floor_ms": floor_ms, "bound_ms": max(t_bytes, t_ops),
                       "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                       "max_abs_err": err_in, "max_abs_err_boundary": err_bd}
                out.append(rec)
                print(f"shard (a): K1 on {ways} shards of {planes} planes (P={p}) at B={b}: "
                      f"path {'/'.join(sorted(paths))}; every shard bit for bit the whole "
                      f"launch's columns; against the plain version at offset {lo}: interior "
                      f"{err_in:.3e}, near the boundary {err_bd:.3e}; replayed from a CUDA graph "
                      f"{graph_ms:.7f} ms (plain {plain_graph_ms:.7f} ms), an empty launch of its "
                      f"grid {floor_ms:.7f} ms; {n_bytes} bytes, {n_ops} flops: bound "
                      f"{max(t_bytes, t_ops):.7f} ms", flush=True)
    return out


def shard_phase():
    """Parameter sharding (``parallel/``: the layouts, tensor parallelism,
    FSDP) at world size 1 over NCCL:

      (a) K1 on plane shards (``_k1_shards``): 256, 100 and 16 planes split
          2 and 4 ways, at B = 256 and at an IWAE decode's rows;
      (b) graphed 2-epoch fits of ``RNASeqVAE`` at 20,480 genes and hidden
          256 on ``make_mesh(n_data=1, n_model=1)`` under
          ``tp_param_shardings`` (the tensor-parallel layers, K1 on the
          plane shard, their gathers and all-reduces in the graph),
          ``fsdp_param_shardings`` and ``fsdp_tp_param_shardings`` (their
          specs as over 2 data ranks, so the slices, gathers and
          reduce-scatters are in the step), each bit for bit its unsharded
          twin, K1's launches counted; each step's wall, busy time and
          kernels against the twin's (``_profile_train``), and the NCCL ops
          a step issues eagerly;
      (c) experiment 8's CLI with ``--tp 1 --fsdp`` (UnifiedVAE, K1 at 100
          planes), 2 epochs, against the run without the flags.

    Returns ((a)'s records, launches by path for K1 at 256 and 100 planes)."""
    import os
    import tempfile
    from pathlib import Path

    import torch
    import torch.distributed as dist

    from hyperbolic_vae_tpu_torch.experiments import train_vaes_rnaseq
    from hyperbolic_vae_tpu_torch.models import RNASeqVAE
    from hyperbolic_vae_tpu_torch.parallel import (
        fsdp_param_shardings,
        fsdp_tp_param_shardings,
        make_mesh,
        tp_param_shardings,
    )
    from hyperbolic_vae_tpu_torch.train import Trainer

    t_phase = time.perf_counter()
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    paths = {"k1_256": {}, "k1_100": {}}
    shards = _k1_shards(np.random.default_rng(15))

    def run(call, *args, **kw):
        torch.cuda.synchronize()
        _reset_launches()
        t = time.perf_counter()
        res = call(*args, **kw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t, _launches()

    mesh = make_mesh(n_data=1, n_model=1)
    rna = _fake_cells(SHARD_CELLS)
    s, v = len(rna.x_train) // BATCH, -(-len(rna.x_val) // BATCH)
    want = {"gyroplane_distances": SHARD_EPOCHS * (s + v), "flagship_fused": 0,
            "flagship_train": 0}

    def fit(m, rule):
        model = RNASeqVAE(RNA_GENES, RNA_HIDDEN, generator=torch.Generator().manual_seed(0))
        return Trainer(model, max_epochs=SHARD_EPOCHS, early_stopping_patience=None, mesh=m,
                       param_sharding_fn=rule)

    twin = fit(None, None)
    r_twin, wall_t, n = run(twin.fit, rna)
    if n != want:
        _fail(f"shard (b): the unsharded fit's launches {n}, want {want}")
    pt = _profile_train(twin.program, "cuda")
    rules = {"tp": tp_param_shardings,
             "fsdp": lambda m, mesh: fsdp_param_shardings(m, _AsIfData(mesh, 2)),
             "fsdp_tp": lambda m, mesh: fsdp_tp_param_shardings(m, _AsIfData(mesh, 2))}
    for name, rule in rules.items():
        t = fit(mesh, rule)
        r, wall, n = run(t.fit, rna)
        _same_fit(f"shard (b) {name}", r, r_twin, name, "unsharded")
        if n != want:
            _fail(f"shard (b) {name}: launches {n}, want {want}")
        paths["k1_256"][f"shard_{name}"] = n["gyroplane_distances"]
        ps = _profile_train(t.program, "cuda")
        cw = _collective_window(t.program, eager=False)
        print(f"shard (b) RNASeqVAE {RNA_GENES} genes under {name} (NCCL, world size 1): bit for "
              f"bit the unsharded fit ({SHARD_EPOCHS} epochs, fits {wall:.3f} / {wall_t:.3f} s, "
              f"{n['gyroplane_distances']} K1); replaying the step graph: NCCL kernels a step "
              f"{cw['nccl_kernels_a_step']:.2f} ({cw['nccl_ms_a_step']:.5f} ms; "
              f"{', '.join(cw['nccl_kernels']) or 'none'}); step "
              f"wall {ps['wall_ms']:.4f} ms against {pt['wall_ms']:.4f} ms ({ps['what']}), busy "
              f"{ps['busy_ms']:.4f} / {pt['busy_ms']:.4f} ms, kernels a step {ps['kernels']:.1f} / "
              f"{pt['kernels']:.1f}, idle {ps['idle']} / {pt['idle']}", flush=True)
        del t, r

    # (c) experiment 8 with --tp 1 --fsdp, against the run without them
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--fake", "--epochs", str(SHARD_EPOCHS), "--log-level", "WARNING"]
        got, wall, n = run(train_vaes_rnaseq.main,
                           argv + ["--tp", "1", "--fsdp", "--run-dir", str(Path(tmp) / "s")])
        plain, wall_p, _ = run(train_vaes_rnaseq.main, argv + ["--run-dir", str(Path(tmp) / "p")])
    if got != plain or not all(np.isfinite(v) for v in got.values()) or not n["gyroplane_distances"]:
        _fail(f"shard (c): experiment 8 --tp 1 --fsdp gave {got} ({n}), without {plain}")
    paths["k1_100"]["shard_exp8_fsdp"] = n["gyroplane_distances"]
    print(f"shard (c): experiment 8 --tp 1 --fsdp (world size {dist.get_world_size()}) "
          f"{wall:.3f} s = the run without them ({wall_p:.3f} s): {json.dumps(got)}; "
          f"{n['gyroplane_distances']} K1 at {UNI_HIDDEN} planes", flush=True)
    dist.destroy_process_group()
    print(f"shard: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return shards, paths


def _rows_kernel_fit() -> None:
    """The rows kernels' shared memory at the flagship's 784 pixels against
    the wrapper's bound (which must not be below it), and how many of their
    clusters the card holds at once (a batch of 256 makes 15)."""
    import ctypes

    from hyperbolic_vae_tpu_torch.ops import _build
    from hyperbolic_vae_tpu_torch.ops import flagship_fused as ff

    for name, train in (("flagship_fused", False), ("flagship_train", True)):
        lib = _build.load_library(name)
        smem, fit = getattr(lib, f"{name}_smem_bytes"), getattr(lib, f"{name}_max_clusters")
        smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_long
        fit.argtypes, fit.restype = [ctypes.c_int], ctypes.c_int
        got, bound, n = smem(DATA), ff._rows_smem_bytes(DATA, train), fit(DATA)
        print(f"rows kernel of {name}: {got} bytes of shared memory per CTA at D={DATA} (the "
              f"wrapper's bound {bound}); {n} clusters of 8 CTAs resident at once", flush=True)
        if got > bound or n < 1:
            _fail(f"{name}: shared memory {got} over the wrapper's bound {bound}, or no cluster fits")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card",
              file=sys.stderr)
        return 1
    from hyperbolic_vae_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # graphed = eager bit for bit needs cuDNN's deterministic algorithms
    # (some weight-gradient and transposed-conv algorithms accumulate with
    # atomics); conv_phase (c) also times a step without them
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(card, flush=True)  # name, power limit: as nvidia-smi gives them
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    _build.load_libraries(["gyroplane", "flagship_fused", "flagship_train"])
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for name, (secs, log) in _build.build_log.items():
        print(f"build {name}: nvcc {secs:.2f} s", flush=True)
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"  {line.strip()}", flush=True)
    _rows_kernel_fit()
    seconds = {"build": round(time.perf_counter() - t0, 1)}

    def timed(name, phase, *args):
        t = time.perf_counter()
        out = phase(*args)
        seconds[name] = round(time.perf_counter() - t, 1)
        return out

    kernels = [timed("kernel", kernel_phase), timed("k2", k2_phase), timed("k3", k3_phase)]
    paths = {"serve": timed("serve", serve_phase)}
    paths.update(timed("train", train_phase))
    paths["eval"] = timed("eval", eval_phase, *timed("northstar", northstar_phase))
    for k in kernels:
        k["launches_by_path"] = {p: n[k["name"]] for p, n in paths.items()}
        k["launches"] = sum(k["launches_by_path"].values())
    # K1 at the RNA-seq family's 256 planes: its own entry, counted on its paths
    k1_rna, rna_paths = timed("rnaseq", rnaseq_phase)
    k1_rna["launches_by_path"] = rna_paths
    k1_rna["launches"] = sum(rna_paths.values())
    kernels.append(k1_rna)
    # K1 at the conv family's 512 planes, c = 1.4: its own entry, counted on its paths
    k1_conv, conv_paths = timed("conv", conv_phase)
    k1_conv["launches_by_path"] = conv_paths
    k1_conv["launches"] = sum(conv_paths.values())
    kernels.append(k1_conv)
    # K1 at UnifiedVAE's 100 planes: its own entry, counted on this phase's paths
    k1_pvae, pvae_paths = timed("pvae", pvae_phase)
    k1_pvae["launches_by_path"] = pvae_paths
    k1_pvae["launches"] = sum(pvae_paths.values())
    kernels.append(k1_pvae)
    # the reference user's path: K1 at 16 planes, K2 and K3 on the flagship's
    # entries; experiment 5's K1 at 512 planes and experiment 8's at 100 on theirs
    interop_paths, interop_conv, interop_uni = timed("interop", interop_phase)
    for k in kernels[:3]:
        k["launches_by_path"].update({p: n[k["name"]] for p, n in interop_paths.items()})
    k1_conv["launches_by_path"].update(interop_conv)
    k1_pvae["launches_by_path"].update(interop_uni)
    # the sweeps: the flagship's paths on K1 at 16 planes, K2 and K3; the
    # grid's on K1 at 512 planes, whose entry also takes (a)'s curvatures
    (err_in, err_bd), sweep_paths, grid_paths = timed("sweep", sweep_phase)
    for k in kernels[:3]:
        k["launches_by_path"].update({p: n[k["name"]] for p, n in sweep_paths.items()})
    k1_conv["launches_by_path"].update(grid_paths)
    k1_conv["max_abs_err"] = max(k1_conv["max_abs_err"], err_in)
    k1_conv["max_abs_err_boundary"] = max(k1_conv["max_abs_err_boundary"], err_bd)
    k1_conv["curvatures_checked"] = [0.5, 1.0, CONV_C]
    # the deployment paths: streamed fits and evaluation, the bundle; K1
    # held through its op at each plane count
    deploy_paths, via_op = timed("deploy", deploy_phase)
    for k, key in ((kernels[0], "k1_16"), (k1_rna, "k1_256"), (k1_pvae, "k1_100"),
                   (kernels[1], "flagship_fused"), (kernels[2], "flagship_train")):
        k["launches_by_path"].update(deploy_paths[key])
    for k, p in ((kernels[0], P), (k1_pvae, UNI_HIDDEN), (k1_rna, RNA_HIDDEN), (k1_conv, CONV_P)):
        k["via_op"] = via_op[p]
    # the CSV path and data and seed parallelism at world size 1 over NCCL
    mesh_paths = timed("data_mesh", data_mesh_phase)
    for k, key in ((kernels[0], "k1_16"), (k1_rna, "k1_256"), (k1_pvae, "k1_100"),
                   (kernels[1], "flagship_fused"), (kernels[2], "flagship_train")):
        k["launches_by_path"].update(mesh_paths[key])
    # parameter sharding at world size 1 over NCCL: K1 on plane shards
    shards, shard_paths = timed("shard", shard_phase)
    for k, key in ((k1_rna, "k1_256"), (k1_pvae, "k1_100")):
        k["launches_by_path"].update(shard_paths[key])
    for k, planes in ((kernels[0], P), (k1_rna, RNA_HIDDEN), (k1_pvae, UNI_HIDDEN)):
        k["plane_shards"] = [r for r in shards if r["planes"] == planes]
    for k in kernels:
        k["launches"] = sum(k["launches_by_path"].values())
    print(f"phase seconds (build: from the start of the build): {json.dumps(seconds)}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
