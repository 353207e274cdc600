"""Time the flagship's plain K2 and K3 versions from Python by two methods
in one process, on a CUDA card.

    python -m hyperbolic_vae_tpu_torch.tools.plain_timing

``chip_smoke.py`` times a plain version over a millisecond a call as the
median of 11 means of 3 back-to-back calls; before, as the median of 51
means of 20. This runs both on the same inputs, in turns (20, 3, 3, 20),
and 1 call too, at the training batch (B = 256, seeded flagship weights,
synthetic MNIST): K2's plain version (``flagship_forward_torch``) and
K3's (``flagship_train_step_torch``). For each it prints, per call, the
time between CUDA events around the calls (what ``chip_smoke.py``
reports) and the host's time to issue them, up to the last launch. Where
the host issues the calls faster than the card runs them, the calls of
a batch queue up and the event time is the card's; where the host is
slower, the card waits and the event time is the host's. Prints one JSON
line. Needs a card; builds no kernel.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

BATCH, METHODS = 256, ((51, 20), (11, 3), (11, 3), (51, 20), (51, 1))


def _time(fn, reps: int, inner: int) -> dict:
    """Medians over ``reps`` of the per-call event time and host issue
    time of ``inner`` back-to-back calls, after 20 calls of warm-up."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    event, host = [], []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        host.append((time.perf_counter() - t0) * 1e3 / inner)
        end.record()
        torch.cuda.synchronize()
        event.append(start.elapsed_time(end) / inner)
    return {"reps": reps, "inner": inner, "event_ms": statistics.median(event),
            "host_issue_ms": statistics.median(host)}


def main() -> dict:
    import torch

    from hyperbolic_vae_tpu_torch.data import synthetic_mnist_arrays
    from hyperbolic_vae_tpu_torch.models import GyroplaneVAE
    from hyperbolic_vae_tpu_torch.ops import flagship_fused as ff

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = GyroplaneVAE(generator=torch.Generator().manual_seed(0))
    cfg = ff.fused_config(m)
    g = torch.Generator().manual_seed(1)
    x = torch.from_numpy(synthetic_mnist_arrays(BATCH, 1, seed=1)[0].reshape(BATCH, -1)).cuda()
    eps = torch.randn(BATCH, cfg["latent_dim"], generator=g).cuda()
    params = [p.detach().clone().cuda() for p in ff.params_tuple(m)]
    mom = [(0.01 * torch.randn(p.shape, generator=g)).cuda() for p in params]
    vel = [(1e-4 * torch.rand(p.shape, generator=g)).cuda() for p in params]
    count = torch.full((), 3, dtype=torch.int32, device="cuda")
    lr = torch.full((), 1e-3, dtype=torch.float32, device="cuda")

    @torch.no_grad()
    def k2_plain():
        return ff.flagship_forward_torch(params, x, eps, **cfg)

    def k3_plain():
        return ff.flagship_train_step_torch(params, mom, vel, x, eps, lr=lr, count=count, **cfg)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    out = {"card": card, "torch": torch.__version__, "batch": BATCH}
    for name, fn in (("k2_plain", k2_plain), ("k3_plain", k3_plain)):
        out[name] = [_time(fn, reps, inner) for reps, inner in METHODS]
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
