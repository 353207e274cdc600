"""Riemannian Adam as a ``torch.optim.Optimizer``.

Port of ``hyperbolic_vae_tpu/optim/riemannian_adam.py``. Per tensor:

  * Euclidean parameters: Adam with bias correction.
  * :class:`ManifoldParameter` rows (points on the Poincare ball ``ball``):
      1. riemannian gradient  g_r = egrad / lambda_x^2
      2. exp_avg    <- b1 exp_avg    + (1 - b1) g_r
      3. exp_avg_sq <- b2 exp_avg_sq + (1 - b2) lambda_x^2 g_r^2
      4. direction = exp_avg_hat / (sqrt(exp_avg_sq_hat) + eps)
      5. new point = expmap_x(-lr direction), exp_avg transported there
      6. project the new point into the ball.

JAX tags manifold leaves by an ``mp_`` name; here the dispatch is on the
parameter's type. The step ``count`` is one tensor shared by all
parameters, as in JAX's ``RiemannianAdamState``, and lives on the
parameters' device. Every parameter lands on ``p + (new - p)``, the
arithmetic of ``optax.apply_updates``.

``step(ok=...)`` takes a boolean 0-d tensor on the device and keeps the
parameters, both moments and ``count`` unchanged where it is false (the
Trainer's finite guard), with ``torch.where`` and no host sync.
``moment_dtype`` and ``ema_decay`` are still to port.
"""

from __future__ import annotations

from typing import Optional

import torch

from hyperbolic_vae_tpu_torch.manifolds import PoincareBall
from hyperbolic_vae_tpu_torch.nn.layers import is_manifold_param


class RiemannianAdam(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, ball: Optional[PoincareBall] = None):
        defaults = dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay)
        super().__init__(params, defaults)
        self.ball = ball or PoincareBall(c=1.0)
        first = self.param_groups[0]["params"][0]
        self.count = torch.zeros((), dtype=torch.int32, device=first.device)

    @torch.no_grad()
    def step(self, closure=None, ok: Optional[torch.Tensor] = None):
        """One update from each parameter's ``.grad``. With ``ok`` (a bool
        0-d tensor), parameters, moments and ``count`` change only where
        ``ok`` is true."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        count = self.count + 1
        cf = count.float()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            bc1 = 1.0 - torch.pow(b1, cf)
            bc2 = 1.0 - torch.pow(b2, cf)
            for p in group["params"]:
                if p.grad is None:
                    continue
                m, v = self.moments(p)
                g = p.grad
                if wd:
                    g = g + wd * p
                if is_manifold_param(p):
                    g = self.ball.egrad2rgrad(p, g)
                    new_m = b1 * m + (1.0 - b1) * g
                    new_v = b2 * v + (1.0 - b2) * self.ball.component_inner(p, g)
                    direction = (new_m / bc1) / (torch.sqrt(new_v / bc2) + eps)
                    new_p, new_m = self.ball.retr_transp(p, -lr * direction, new_m)
                    update = self.ball.project(new_p) - p
                else:
                    new_m = b1 * m + (1.0 - b1) * g
                    new_v = b2 * v + (1.0 - b2) * g * g
                    update = -lr * (new_m / bc1) / (torch.sqrt(new_v / bc2) + eps)
                new_p = p + update
                if ok is not None:
                    new_p = torch.where(ok, new_p, p)
                    new_m = torch.where(ok, new_m, m)
                    new_v = torch.where(ok, new_v, v)
                p.copy_(new_p)
                m.copy_(new_m)
                v.copy_(new_v)
        self.count = count if ok is None else torch.where(ok, count, self.count)
        return loss

    def moments(self, p):
        """(exp_avg, exp_avg_sq) of parameter ``p``, zeros on first use."""
        state = self.state[p]
        if not state:
            state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        return state["exp_avg"], state["exp_avg_sq"]

    def state_dict(self):
        sd = super().state_dict()
        sd["count"] = self.count.clone()
        return sd

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        count = state_dict.pop("count")
        super().load_state_dict(state_dict)
        self.count = torch.as_tensor(count, dtype=torch.int32).to(self.count.device).clone()

    def load_moments(self, moments: dict) -> None:
        """Set ``count`` and each parameter's moments from
        ``{"count": int, "state": {param: {"exp_avg": t, "exp_avg_sq": t}}}``
        (the form ``interop.optimizer_state_from_jax`` returns)."""
        self.count = torch.as_tensor(moments["count"], dtype=torch.int32).to(self.count.device).clone()
        for p, st in moments["state"].items():
            self.state[p] = {k: t.to(device=p.device, dtype=p.dtype).clone() for k, t in st.items()}
