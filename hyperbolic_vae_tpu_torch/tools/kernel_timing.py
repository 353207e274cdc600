"""Time the inside of the flagship's K2 and K3 kernels on a CUDA card.

    python -m hyperbolic_vae_tpu_torch.tools.kernel_timing phases [--csrc DIR]
    python -m hyperbolic_vae_tpu_torch.tools.kernel_timing timeline [--csrc DIR]

Copies the kernel sources (``csrc/`` of the package, or DIR: for example
an earlier design's sources unpacked from git) into the git-ignored
``_chipwork/kernel_timing/`` of the checkout, inserts timestamps by text
substitution, builds the copies with the package's nvcc flags, runs the
package's own wrappers on the flagship at B = 256 (seeded random weights,
synthetic MNIST) and prints what the timestamps say:

  phases    ``clock64()`` by thread 0 of the first 16 CTAs after every
            ``__syncthreads()`` and cluster barrier of the rows kernels
            (and of ``cluster_forward``, where the sources have it): the
            median time of each interval over 16 CTAs and 20 launches.
  timeline  ``%globaltimer`` by thread 0 of every block at its entry, after
            its ``griddepcontrol.wait`` and at its exit, for each kernel of
            one K2 and one K3 call: when each kernel's blocks start and end
            relative to the call's first block, and how long they wait.

The sources themselves are never edited. Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

NBLK, NST, NTL = 16, 64, 4096
PHASE_FUNCS = {  # function bodies to stamp, per source
    "flagship_common.cuh": ["cluster_forward"],
    "flagship_fused.cu": ["flagship_rows_kernel"],
    "flagship_train.cu": ["train_rows_kernel"],
}
TIMELINE_KERNELS = {
    "flagship_train.cu": ["train_rows_kernel", "train_grad_kernel", "train_finalize_kernel",
                          "train_update_kernel"],
    "flagship_fused.cu": ["flagship_rows_kernel", "flagship_mean_kernel"],
}
SYNCS = ("__syncthreads();", "hopper::cluster_sync();", "hopper::cluster_wait();")


def _globals() -> str:
    return f"""
__device__ unsigned long long kt_clk[{NBLK}][{NST}];
__device__ unsigned long long kt_gt[{NBLK}][2];
__device__ int kt_sn[{NBLK}];
__device__ int kt_n;
__device__ unsigned long long kt_tl[4][{NTL}][3];
__device__ __forceinline__ unsigned long long kt_gtimer() {{
  unsigned long long t; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); return t; }}
#define KT_STAMP() do {{ if (threadIdx.x == 0 && blockIdx.x < {NBLK}) \\
  kt_clk[blockIdx.x][kt_sn[blockIdx.x]++] = clock64(); }} while (0)
#define KT_TL(k, i) do {{ if (threadIdx.x == 0 && blockIdx.x < {NTL}) \\
  kt_tl[k][blockIdx.x][i] = kt_gtimer(); }} while (0)
"""


_READERS = f"""
extern "C" int kt_read(unsigned long long* clk, unsigned long long* gt, int* n,
                       unsigned long long* tl) {{
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(clk, kt_clk, sizeof(kt_clk));
  cudaMemcpyFromSymbol(gt, kt_gt, sizeof(kt_gt));
  cudaMemcpyFromSymbol(tl, kt_tl, sizeof(kt_tl));
  return (int)cudaMemcpyFromSymbol(n, kt_n, sizeof(int));
}}
extern "C" int kt_clear() {{
  static unsigned long long z[4][{NTL}][3];
  return (int)cudaMemcpyToSymbol(kt_tl, z, sizeof(z));
}}
"""


def _body(text: str, fname: str):
    """(index of the opening brace, index of the closing brace) of the
    first definition of fname in text."""
    at = 0
    while True:
        s = text.index(fname + "(", at)
        b0 = text.index("{", s)
        if ";" not in text[s:b0]:  # a definition, not a call or declaration
            break
        at = s + 1
    depth, i = 0, b0
    while True:
        depth += {"{": 1, "}": -1}.get(text[i], 0)
        if depth == 0:
            return b0, i
        i += 1


def _stamp_phases(text: str, fname: str, first: bool, last: bool) -> str:
    b0, b1 = _body(text, fname)
    seg = text[b0 + 1:b1]
    for pat in SYNCS:
        seg = seg.replace(pat, pat + " KT_STAMP();")
    head = (" if (threadIdx.x == 0 && blockIdx.x < %d) { kt_sn[blockIdx.x] = 0; "
            "kt_gt[blockIdx.x][0] = kt_gtimer(); } KT_STAMP();" % NBLK) if first else ""
    tail = (" __syncthreads(); KT_STAMP(); if (threadIdx.x == 0 && blockIdx.x < %d) "
            "{ kt_gt[blockIdx.x][1] = kt_gtimer(); if (blockIdx.x == 0) kt_n = kt_sn[0]; }\n"
            % NBLK) if last else ""
    return text[:b0 + 1] + head + seg + tail + text[b1:]


def _stamp_timeline(text: str, fname: str, k: int) -> str:
    if fname + "(" not in text:
        return text
    b0, b1 = _body(text, fname)
    seg = text[b0 + 1:b1]
    for wait in ("hopper::grid_dependency_wait();", "cudaGridDependencySynchronize();"):
        seg = seg.replace(wait, wait + f" KT_TL({k}, 1);", 1)
    seg = seg.replace("return;", f"{{ KT_TL({k}, 2); return; }}")
    return text[:b0 + 1] + f" KT_TL({k}, 0);" + seg + f" KT_TL({k}, 2);\n" + text[b1:]


def instrument(src: Path, dst: Path, mode: str) -> None:
    """Instrumented copies of the sources in src, written to dst."""
    dst.mkdir(parents=True, exist_ok=True)
    files = {f.name: f.read_text() for f in src.iterdir() if f.suffix in (".cu", ".cuh")}
    has_common = "flagship_common.cuh" in files
    for name, text in files.items():
        if name in TIMELINE_KERNELS:  # K2's and K3's sources; the others are copied as they are
            if mode == "phases":
                funcs = PHASE_FUNCS[name]
                text = _stamp_phases(text, funcs[0], first=not has_common, last=True)
            else:
                for k, fname in enumerate(TIMELINE_KERNELS[name]):
                    text = _stamp_timeline(text, fname, k)
            text += _READERS
            if not has_common:  # the globals go before the sources' code
                text = text.replace("namespace {", _globals() + "\nnamespace {", 1)
        elif name == "flagship_common.cuh":
            if mode == "phases":
                text = _stamp_phases(text, "cluster_forward", first=True, last=False)
            text = text.replace("#include \"hopper.cuh\"\n", "#include \"hopper.cuh\"\n" + _globals(), 1)
        (dst / name).write_text(text)


def _run(args) -> dict:
    import torch

    from hyperbolic_vae_tpu_torch.data import synthetic_mnist_arrays
    from hyperbolic_vae_tpu_torch.models import GyroplaneVAE
    from hyperbolic_vae_tpu_torch.ops import _build
    from hyperbolic_vae_tpu_torch.ops import flagship_fused as ff

    root = _build._PKG.parent
    src = Path(args.csrc).resolve() if args.csrc else _build.CSRC
    work = root / "_chipwork" / "kernel_timing" / f"{args.mode}-{_build.source_digest(src / 'flagship_train.cu')}"
    instrument(src, work / "csrc", args.mode)
    _build.CSRC, _build.BUILD_DIR = work / "csrc", work / "build"
    _build._libs.clear()
    ff._fn, ff._train_lib = None, None
    libs = _build.load_libraries(["flagship_fused", "flagship_train"])
    for lib in libs.values():
        lib.kt_read.argtypes = [ctypes.c_void_p] * 4
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    B = 256
    m = GyroplaneVAE(generator=torch.Generator().manual_seed(0))
    cfg = ff.fused_config(m)
    params = [p.detach().clone() for p in ff.params_tuple(m)]
    x = torch.from_numpy(synthetic_mnist_arrays(B, 1, seed=1)[0].reshape(B, -1)).cuda()
    eps = torch.randn(B, 2, generator=torch.Generator().manual_seed(1)).cuda()
    mom = [torch.zeros_like(p) for p in params]
    vel = [torch.zeros_like(p) for p in params]
    count = torch.zeros((), dtype=torch.int32, device="cuda")
    lr = torch.zeros((), dtype=torch.float32, device="cuda")
    calls = {
        "K2": (libs["flagship_fused"], lambda: ff.flagship_fused_cuda(params, x, eps, **cfg),
               TIMELINE_KERNELS["flagship_fused.cu"]),
        "K3": (libs["flagship_train"],
               lambda: ff.flagship_train_cuda(params, mom, vel, x, eps, count, lr=lr, **cfg),
               TIMELINE_KERNELS["flagship_train.cu"]),
    }
    out = {"card": card, "sources": str(src), "mode": args.mode, "B": B}
    print(card, flush=True)
    for name, (lib, call, kernels) in calls.items():
        clk = (ctypes.c_ulonglong * (NBLK * NST))()
        gt = (ctypes.c_ulonglong * (NBLK * 2))()
        tl = (ctypes.c_ulonglong * (4 * NTL * 3))()
        n = ctypes.c_int()
        per, tls = [], []
        for rep in range(30):
            lib.kt_clear()
            torch.cuda.synchronize()
            call()
            lib.kt_read(clk, gt, ctypes.byref(n), tl)
            if rep < 10:
                continue
            if args.mode == "phases":
                for b in range(NBLK):
                    c = [clk[b * NST + i] for i in range(n.value)]
                    ns = gt[b * 2 + 1] - gt[b * 2]
                    k = ns / max(1, c[-1] - c[0])
                    per.append(([(c[i + 1] - c[i]) * k / 1e3 for i in range(len(c) - 1)], ns / 1e3, k))
            else:
                tls.append([[tuple(tl[(kk * NTL + b) * 3 + i] for i in range(3)) for b in range(NTL)]
                            for kk in range(len(kernels))])
        if args.mode == "phases":
            nph = len(per[0][0])
            res = {"phase_us": [statistics.median(p[0][i] for p in per) for i in range(nph)],
                   "cta_us": statistics.median(p[1] for p in per),
                   "sm_ghz": 1 / statistics.median(p[2] for p in per)}
            print(f"{name} rows kernel, per-phase us (median over {NBLK} CTAs x 20 launches): "
                  + ", ".join(f"{i + 1}:{v:.3f}" for i, v in enumerate(res["phase_us"]))
                  + f" | a CTA {res['cta_us']:.3f} us, SM clock {res['sm_ghz']:.3f} GHz", flush=True)
        else:
            res = {}
            for kk, kname in enumerate(kernels):
                rows = []
                for rep in tls:
                    t0 = min(b[0] for k in rep for b in k if b[0])
                    blocks = [b for b in rep[kk] if b[0]]
                    if not blocks:
                        break
                    waits = [b[1] - b[0] for b in blocks if b[1]]
                    rows.append(dict(blocks=len(blocks),
                                     first_start_us=(min(b[0] for b in blocks) - t0) / 1e3,
                                     last_start_us=(max(b[0] for b in blocks) - t0) / 1e3,
                                     end_us=(max(b[2] for b in blocks) - t0) / 1e3,
                                     wait_max_us=max(waits) / 1e3 if waits else 0.0,
                                     life_median_us=statistics.median(b[2] - b[0] for b in blocks) / 1e3))
                if rows:
                    res[kname] = {k: (statistics.median(r[k] for r in rows)) for k in rows[0]}
                    last = tls[-1][kk]  # the slowest blocks of the last call: (block, start, wait, life)
                    t0 = min(b[0] for k in tls[-1] for b in k if b[0])
                    slow = sorted(((i, (b[0] - t0) / 1e3, (b[1] - b[0]) / 1e3 if b[1] else 0.0,
                                    (b[2] - b[0]) / 1e3) for i, b in enumerate(last) if b[0]),
                                  key=lambda r: -r[3])[:6]
                    res[kname]["slowest_blocks"] = slow
                    print(f"{name} {kname}: " + ", ".join(
                        f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}" for k, v in res[kname].items()
                        if k != "slowest_blocks")
                        + " (median of 20 calls; times from the call's first block); slowest blocks of "
                        "the last call (block, start, wait, life): " + "; ".join(
                            "%d %.2f %.2f %.2f" % r for r in res[kname]["slowest_blocks"]), flush=True)
        out[name] = res
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("mode", choices=("phases", "timeline"))
    p.add_argument("--csrc", help="the kernel sources to instrument (default: the package's csrc)")
    p.add_argument("--out", help="also write the result as JSON to this file")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("kernel_timing: needs a CUDA card", file=sys.stderr)
        return 1
    out = _run(args)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
