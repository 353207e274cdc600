"""The plain reference's training: Riemannian Adam, the draw schedule,
and a short fit that the comparison reads.

Riemannian Adam (Becigneul and Ganea, arXiv:1810.00760) with bias
correction: Euclidean leaves take Adam; a leaf of points on the ball
takes the Riemannian gradient g / lambda^2, the second moment in the
metric (lambda^2 g_r^2), the step exp_p(-lr * direction) kept inside the
ball, and its first moment carried to the new point by parallel
transport.

The draw schedule, a frozen copy of the one the measured Trainer follows
(one generator on the device, seeded with the fit's seed): each epoch
draws its row order (``randperm`` over the train rows, cut to whole
batches), then each train step one eps (B, latent) ~ N(0, I), then each
val batch (min(B, n_val) rows, in order) one eps of its rows, then the
val tail (the n_val % batch rows left) one eps of its rows. The val
means fold the tail in by row count.

``precision``: "float32" runs every product in f32 with TF32 off (what
the configurations state); "tf32" is the control, the same with TF32
products (on a card torch's TF32 mode, elsewhere the products' operands
rounded to TF32's 10-bit mantissa).
"""

from __future__ import annotations

import contextlib
import importlib
from typing import Optional

import torch
import torch.nn.functional as F

from portbench.reference import _ball as ball

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


def module(config_name: str):
    """The plain reference of a configuration: ``reference/<name>.py``."""
    return importlib.import_module(f"portbench.reference.{config_name}")


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (1 sign, 8 exponent, 10 mantissa bits), nearest even."""
    i = x.detach().contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return x + (i.view(torch.float32) - x).detach()


@contextlib.contextmanager
def precision(name: str, device: torch.device):
    """The products' precision inside the block (see the module's docstring)."""
    if name not in ("float32", "tf32"):
        raise ValueError(f"precision must be float32 or tf32, got {name!r}")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    linear = F.linear
    tf32 = name == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    if tf32 and device.type != "cuda":
        F.linear = lambda x, w, b=None: linear(_round_tf32(x), _round_tf32(w), b)
    try:
        yield
    finally:
        F.linear = linear
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@torch.no_grad()
def adam_step(params: dict, grads: dict, moments: dict, count: int, lr: torch.Tensor,
              manifold: tuple, c: float) -> None:
    """One Riemannian Adam step of every leaf, in place; ``count`` is the
    step's number (1 for the first)."""
    cf = torch.tensor(float(count), dtype=torch.float32, device=lr.device)
    bc1, bc2 = 1.0 - torch.pow(B1, cf), 1.0 - torch.pow(B2, cf)
    for name, p in params.items():
        g = grads[name]
        m, v = moments[name]
        if name in manifold:
            lam2 = ball.lam(p, c) ** 2
            g = g / lam2
            m_new = B1 * m + (1.0 - B1) * g
            v_new = B2 * v + (1.0 - B2) * lam2 * g * g
            direction = (m_new / bc1) / (torch.sqrt(v_new / bc2) + ADAM_EPS)
            q = ball.expmap(p, -lr * direction, c)
            m_new = ball.transport(p, q, m_new, c)
            p_new = ball.project(q, c)
        else:
            m_new = B1 * m + (1.0 - B1) * g
            v_new = B2 * v + (1.0 - B2) * g * g
            p_new = p - lr * (m_new / bc1) / (torch.sqrt(v_new / bc2) + ADAM_EPS)
        p.copy_(p_new)
        m.copy_(m_new)
        v.copy_(v_new)


def _val_means(ref, params, x_val, batch: int, latent: int, gen, model_cfg) -> dict:
    names = ref.METRICS + ("loss_scale",)
    n = x_val.shape[0]
    eb = min(batch, n)
    steps = max(n // eb, 1)
    rem = n - steps * eb
    rows = []
    for s in range(steps):
        eps = torch.randn((eb, latent), generator=gen, device=x_val.device, dtype=torch.float32)
        m = ref.loss(params, x_val[s * eb:(s + 1) * eb], eps, model_cfg)
        rows.append(torch.stack([m[k] for k in names]))
    means = torch.stack(rows).mean(dim=0)
    if rem:
        eps = torch.randn((rem, latent), generator=gen, device=x_val.device, dtype=torch.float32)
        m = ref.loss(params, x_val[steps * eb:], eps, model_cfg)
        means = means * (steps * eb / n) + torch.stack([m[k] for k in names]) * (rem / n)
    return dict(zip(names, means.tolist()))


def follow(config_name: str, config: dict, params0: dict, x_train: torch.Tensor,
           x_val: torch.Tensor, batch: int, epochs: int, seed: int, lr: float,
           precision_name: str = "float32", fault: Optional[str] = None) -> dict:
    """Train the plain reference from ``params0`` for ``epochs`` epochs on
    ``x_train`` (the benchmark's check: one epoch over one batch, and
    one over three), on the device of the inputs, under the draw
    schedule. Returns the readings the comparison reads: ``loss`` (each
    epoch's mean train loss_total, as the program's history holds it),
    ``loss_scale`` (each epoch's mean of the magnitudes summed into its
    steps' losses), ``val`` (each epoch's val means by metric,
    ``loss_scale`` among them), ``m1`` (each leaf's first moment after
    the first step, by name), ``params`` (the leaves after the last
    step). ``fault`` plants a fault for calibration: "half_batch" (each
    train step's loss over the first half of its rows), "frozen" (no
    step changes the parameters or the moments), "first_batch" (every
    step of an epoch fed the epoch's first batch) or "altered" (each
    reported train loss 1 % high)."""
    ref = module(config_name)
    model_cfg = config["model"]
    dev = x_train.device
    latent = int(config["latent_dim"])
    c = float(config["curvature"])
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    params = {k: v.detach().clone().to(dev).requires_grad_(True) for k, v in params0.items()}
    moments = {k: (torch.zeros_like(v), torch.zeros_like(v)) for k, v in params0.items()}
    lr_t = torch.tensor(lr, dtype=torch.float32, device=dev)
    out = {"loss": [], "loss_scale": [], "val": [], "m1": None}
    count = 0
    with precision(precision_name, dev):
        for _ in range(epochs):
            n = x_train.shape[0]
            steps = n // batch
            order = torch.randperm(n, generator=gen, device=dev)[:steps * batch].view(steps, batch)
            losses, scales = [], []
            for s in range(steps):
                xb = x_train.index_select(0, order[0 if fault == "first_batch" else s])
                eps = torch.randn((batch, latent), generator=gen, device=dev, dtype=torch.float32)
                if fault == "half_batch":
                    xb, eps = xb[:batch // 2], eps[:batch // 2]
                metrics = ref.loss(params, xb, eps, model_cfg)
                grads = dict(zip(params, torch.autograd.grad(metrics["loss_total"],
                                                             list(params.values()))))
                count += 1
                if fault != "frozen":
                    adam_step(params, grads, moments, count, lr_t, ref.MANIFOLD, c)
                loss = float(metrics["loss_total"].detach())
                losses.append(loss * 1.01 if fault == "altered" else loss)
                scales.append(float(metrics["loss_scale"].detach()))
                if out["m1"] is None:
                    out["m1"] = {k: m.clone() for k, (m, _) in moments.items()}
            out["loss"].append(sum(losses) / steps)
            out["loss_scale"].append(sum(scales) / steps)
            with torch.no_grad():
                out["val"].append(_val_means(ref, params, x_val, batch, latent, gen, model_cfg))
    out["params"] = {k: v.detach() for k, v in params.items()}
    return out
