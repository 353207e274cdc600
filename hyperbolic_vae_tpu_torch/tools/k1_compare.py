"""Two designs of K1 (the gyroplane-distance kernel) side by side on one card.

    python -m hyperbolic_vae_tpu_torch.tools.k1_compare --other DIR
        [--planes P [P ...]] [--c C [C ...]] [--out FILE]

Builds ``csrc/gyroplane.cu`` of the package and ``DIR/gyroplane.cu`` (for
example an earlier design's sources unpacked from git: ``git archive
<commit> hyperbolic_vae_tpu_torch/csrc | tar -x -C _chipwork/parent``)
with the package's nvcc flags into the git-ignored
``_chipwork/k1_compare/``, and for each:

  * its registers (ptxas) and, where ``cuobjdump`` is in the toolkit, the
    instructions and MUFU (special-function) instructions in the SASS of
    each of its kernels;
  * for each P of ``--planes`` (default 16; D = 2), at the model's batch and
    at the IWAE decode's rows (``SHAPES``: 16 and 512 planes (256, 128,000),
    256 planes (256, 25,600), 100 planes (64, 25,600)), for each c of ``--c``
    (default 1, 0.5, 2): its error against the plain PyTorch version
    (signed, with bias): interior max abs error, and near the boundary its
    error against float64 over the plain version's (the kernel's rule is
    <= 2x + 1e-5);
  * above 64 planes, whether the two designs give the same bits at both
    batches, every c, interior and near the boundary, signed and unsigned,
    with and without bias;
  * its device time at both batches in graph replay (50 calls captured in
    one CUDA graph) at the first c, the two designs in turns (other, this,
    this, other), each beside an empty kernel of its own launch shape,
    with the bound.

Prints the card's name and power limit first. Needs a card and nvcc. The
sources themselves are never edited.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

D = 2
# planes -> (the model's batch, the IWAE decode's k_chunk x batch_chunk rows)
SHAPES = {16: (256, 500 * 256), 512: (256, 500 * 256), 256: (256, 100 * 256),
          100: (64, 100 * 256)}
HBM_BYTES_PER_S = 3.35e12


def _build(src: Path, out: Path) -> tuple:
    from hyperbolic_vae_tpu_torch.ops import _build as build

    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    regs = [line.strip() for line in (proc.stdout + proc.stderr).splitlines() if "registers" in line]
    sass = {}
    dump = Path(build._nvcc()).parent / "cuobjdump"
    if dump.exists():
        text = subprocess.run([str(dump), "-sass", str(out)], capture_output=True, text=True).stdout
        for part in text.split("Function : ")[1:]:
            name = part.split("\n", 1)[0].strip()
            lines = [ln for ln in part.splitlines() if ln.strip().startswith("/*") and ";" in ln]
            sass[name] = {"instructions": len(lines), "mufu": sum("MUFU" in ln for ln in lines)}
    lib = ctypes.CDLL(str(out))
    fn = lib.gyroplane_distances_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_double, ctypes.c_int,
                                                                ctypes.c_void_p]
    fn.restype = ctypes.c_int
    empty = lib.gyroplane_empty_launch
    empty.argtypes, empty.restype = [ctypes.c_int] * 3 + [ctypes.c_void_p], ctypes.c_int
    return fn, empty, regs, sass


def _points(rng, n, c, region):
    import torch

    u = rng.normal(size=(n, D))
    u /= (u * u).sum(-1, keepdims=True) ** 0.5
    lo, hi = (0.0, 0.7) if region == "interior" else (0.95, 1.0 - 4e-3)
    return torch.from_numpy((u * rng.uniform(lo, hi, size=(n, 1)) / c ** 0.5).astype("float32")).cuda()


def _call(fn, x, pts, bias, c, out, signed=True):
    import torch

    err = fn(x.data_ptr(), pts.data_ptr(), None if bias is None else bias.data_ptr(),
             out.data_ptr(), x.shape[0], pts.shape[0], D, c, int(signed),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: cudaError {err}")
    return out


def _errors(fn, rng, p: int, curvatures) -> dict:
    import torch

    from hyperbolic_vae_tpu_torch.ops import gyroplane as g

    res = {}
    for b in SHAPES.get(p, SHAPES[16]):
        interior, ratio = 0.0, 0.0
        for c in curvatures:
            for region in ("interior", "boundary"):
                x, pts = _points(rng, b, c, region), _points(rng, p, c, region)
                bias = torch.from_numpy(rng.uniform(-1, 1, p).astype("float32")).cuda()
                out = _call(fn, x, pts, bias, c, torch.empty((b, p), device="cuda"))
                ref = g.gyroplane_distances(x, pts, c, True, bias)
                if region == "interior":
                    interior = max(interior, float((out - ref).abs().max()))
                    continue
                exact = g.gyroplane_distances(x.double(), pts.double(), c, True, bias.double())
                k_err = float((out.double() - exact).abs().max())
                p_err = float((ref.double() - exact).abs().max())
                ratio = max(ratio, k_err / p_err)
        res[b] = {"interior_max_abs_err": interior, "boundary_err_over_plain": ratio}
    return res


def _bitwise(designs: dict, rng, p: int, curvatures) -> dict:
    """Whether the two designs give the same bits at P = p: at both batches,
    each c, interior and near the boundary, signed and unsigned, with and
    without bias. Returns the calls compared and the elements that differ."""
    import torch

    calls = differ = 0
    for b in SHAPES.get(p, SHAPES[16]):
        for c in curvatures:
            for region in ("interior", "boundary"):
                x, pts = _points(rng, b, c, region), _points(rng, p, c, region)
                bias = torch.from_numpy(rng.uniform(-1, 1, p).astype("float32")).cuda()
                for signed in (True, False):
                    for bb in (None, bias):
                        a, o = (_call(designs[n][0], x, pts, bb, c,
                                      torch.empty((b, p), device="cuda"), signed)
                                for n in ("this", "other"))
                        calls += 1
                        differ += int((a.view(torch.int32) != o.view(torch.int32)).sum())
    return {"bit_for_bit": differ == 0, "calls": calls, "elements_differing": differ}


def _graph_ms(fn, n: int = 50) -> float:
    """Device time of one call: n calls captured in one CUDA graph, the
    graph replayed (median of 21 means of 5 replays, after 5), over n."""
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
    for _ in range(5):
        graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(21):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 5 / n)
    return statistics.median(times)


def _times(designs: dict, rng, p: int, c: float) -> dict:
    import torch

    res = {}
    for b in SHAPES.get(p, SHAPES[16]):
        x, pts = _points(rng, b, c, "interior"), _points(rng, p, c, "interior")
        bias = torch.from_numpy(rng.uniform(-1, 1, p).astype("float32")).cuda()
        dst = torch.empty((b, p), device="cuda")
        ms = {n: [] for n in designs}
        for name in ("other", "this", "this", "other"):
            fn = designs[name][0]
            ms[name].append(_graph_ms(lambda fn=fn: _call(fn, x, pts, bias, c, dst)))
        floor = {}
        for name, (_, empty, _, _) in designs.items():
            def call(empty=empty):
                if empty(b, p, D, torch.cuda.current_stream().cuda_stream):
                    raise RuntimeError("the empty kernel did not launch")
            floor[name] = _graph_ms(call)
        n_bytes = 4 * (b * D + p * D + p + b * p)
        row = {"graph_ms": ms, "empty_launch_ms": floor, "bytes": n_bytes,
               "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3}
        res[f"B={b}"] = row
        print(f"P={p} B={b} c={c}: {json.dumps(row)}", flush=True)
    return res


def _run(args) -> dict:
    import numpy as np
    import torch

    from hyperbolic_vae_tpu_torch.ops import _build as build

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    work = build._PKG.parent / "_chipwork" / "k1_compare"
    designs = {"other": _build(Path(args.other).resolve() / "gyroplane.cu", work / "libother.so"),
               "this": _build(build.CSRC / "gyroplane.cu", work / "libthis.so")}
    out = {"card": card, "other": str(Path(args.other).resolve())}
    for name, (_, _, regs, sass) in designs.items():
        out[name] = {"registers": regs, "sass": sass}
        print(f"{name}: {json.dumps(out[name])}", flush=True)
    rng = np.random.default_rng(0)
    for p in args.planes:
        res = {"errors": {n: _errors(designs[n][0], rng, p, args.c) for n in designs}}
        print(f"P={p} errors: {json.dumps(res['errors'])}", flush=True)
        if p > 64:
            res["same_bits"] = _bitwise(designs, rng, p, args.c)
            print(f"P={p} the two designs bit for bit: {json.dumps(res['same_bits'])}", flush=True)
        res["times"] = _times(designs, rng, p, args.c[0])
        out[f"P={p}"] = res
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--other", required=True, help="a directory holding another design's gyroplane.cu")
    p.add_argument("--planes", type=int, nargs="+", default=[16],
                   help="the numbers of planes P to compare at (D = 2)")
    p.add_argument("--c", type=float, nargs="+", default=[1.0, 0.5, 2.0],
                   help="the curvatures of the checks; the times at the first")
    p.add_argument("--out", help="also write the result as JSON to this file")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("k1_compare: needs a CUDA card", file=sys.stderr)
        return 1
    out = _run(args)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
