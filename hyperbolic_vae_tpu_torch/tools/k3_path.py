"""Time the flagship's K3 training path of one source tree on a CUDA card.

    python hyperbolic_vae_tpu_torch/tools/k3_path.py [--tree DIR] [--label NAME]

Imports ``hyperbolic_vae_tpu_torch`` from DIR (default: this checkout),
builds its kernels, and measures on synthetic MNIST (54,000 train and
6,000 val rows, batch 256): three two-epoch ``Trainer`` fits on the K3
path (K3 every step, K2 every val batch; the first fit of a process pays
one-time costs), one K3 step synchronised around itself (median of 50),
200 back-to-back steps, and K3 and K2 alone replayed from a CUDA graph at
B = 256. Prints one JSON line. To compare two trees on one card, run it in
turns in one command, for example with an earlier tree unpacked from git:

    git archive HEAD~1 hyperbolic_vae_tpu_torch | tar -x -C _chipwork/parent
    for t in _chipwork/parent . . _chipwork/parent; do
        python hyperbolic_vae_tpu_torch/tools/k3_path.py --tree $t; done

Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path


def _graph_ms(fn, n: int = 50, reps: int = 21) -> float:
    """Device time of one call of fn: n calls captured in one CUDA graph,
    replayed 5 times per CUDA-event timing, median of reps, over n."""
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
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 5 / n)
    return statistics.median(times)


def measure(label: str) -> dict:
    import torch

    from hyperbolic_vae_tpu_torch.data import make_data_module
    from hyperbolic_vae_tpu_torch.models import GyroplaneVAE
    from hyperbolic_vae_tpu_torch.ops import _build
    from hyperbolic_vae_tpu_torch.ops import flagship_fused as ff
    from hyperbolic_vae_tpu_torch.optim import RiemannianAdam
    from hyperbolic_vae_tpu_torch.train import Trainer

    _build.load_libraries(["flagship_fused", "flagship_train"])
    out = {"label": label, "package": str(Path(_build.__file__).parents[1]),
           "card": torch.cuda.get_device_name(0)}
    dm = make_data_module(batch_size=256, synthetic=True, n_train=60000, n_test=10000)
    steps = dm.x_train.shape[0] // 256
    out["fits"] = []
    for _ in range(3):
        model = GyroplaneVAE(generator=torch.Generator().manual_seed(0))
        trainer = Trainer(model, max_epochs=2, early_stopping_patience=None, shuffle="row",
                          loss_fn=ff.make_fused_loss_fn(model),
                          train_step_fn=ff.make_fused_train_step(model))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = trainer.fit(dm)
        torch.cuda.synchronize()
        out["fits"].append({"train_samples_per_s": 2 * steps * 256 / (time.perf_counter() - t0),
                            "after_first_epoch": res.samples_per_sec,
                            "val_loss_total": res.history[-1]["val/loss_total"]})

    model = GyroplaneVAE(generator=torch.Generator().manual_seed(0))
    opt = RiemannianAdam(model.parameters(), lr=1e-3, ball=model.ball)
    step = ff.make_fused_train_step(model)
    gen = torch.Generator(device="cuda").manual_seed(0)
    xb = torch.from_numpy(dm.x_train[:256]).cuda()
    ms = []
    for i in range(60):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(model, opt, xb, gen)
        torch.cuda.synchronize()
        if i >= 10:
            ms.append((time.perf_counter() - t0) * 1e3)
    out["step_synchronised_ms"] = statistics.median(ms)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        step(model, opt, xb, gen)
    torch.cuda.synchronize()
    out["step_back_to_back_ms"] = (time.perf_counter() - t0) * 1e3 / 200

    m = GyroplaneVAE(generator=torch.Generator().manual_seed(0))
    cfg = ff.fused_config(m)
    g = torch.Generator().manual_seed(1)
    params = [p.detach().clone() for p in ff.params_tuple(m)]
    mom = [(0.01 * torch.randn(p.shape, generator=g)).cuda() for p in params]
    vel = [(1e-4 * torch.rand(p.shape, generator=g)).cuda() for p in params]
    count = torch.full((), 3, dtype=torch.int32, device="cuda")
    x = torch.from_numpy(dm.x_train[256:512].reshape(256, -1)).cuda()
    eps = torch.randn(256, 2, generator=g).cuda()
    out["k3_graph_ms"] = _graph_ms(lambda: ff.flagship_train_cuda(params, mom, vel, x, eps, count,
                                                                  lr=1e-3, **cfg))
    out["k2_graph_ms"] = _graph_ms(lambda: ff.flagship_fused_cuda(params, x, eps, **cfg))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]),
                   help="the source tree whose hyperbolic_vae_tpu_torch is timed")
    p.add_argument("--label", help="a name for the JSON line (default: the tree)")
    args = p.parse_args(argv)
    tree = str(Path(args.tree).resolve())
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("k3_path: needs a CUDA card", file=sys.stderr)
        return 1
    print(json.dumps(measure(args.label or tree)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
