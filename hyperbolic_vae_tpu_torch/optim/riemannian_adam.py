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
parameters' device. As in JAX, the gradient, the parameter and the
moments are read in at least f32 whatever their storage, the update is
cast to the parameter's stored type and added in that type (the
arithmetic of ``optax.apply_updates``), and the EMA reads that rounded
sum, so a bf16 parameter rounds where JAX's does.

Nothing here waits for the device or binds a new tensor after
construction, so a step can be captured in a CUDA graph: each group's
``lr`` is a 0-d f32 tensor on the device (float64 for float64
parameters; ``set_lr`` and the Trainer's controller write it in place),
``count``, the moments and the EMA are updated with
``copy_``, and ``step(ok=...)`` takes a boolean 0-d tensor on the device
and keeps the parameters, both moments, the EMA and ``count`` unchanged
where it is false (the Trainer's finite guard).

``moment_dtype`` (e.g. ``"bfloat16"``) stores both moments in that type
while every step computes in f32 (JAX ``moment_dtype``). ``ema_decay``
keeps an f32 EMA of the parameters, from their values at construction:
Euclidean tensors average linearly, manifold points in the tangent space
at the origin (logmap0, lerp, expmap0, project), as JAX does;
``ema_params()`` returns it.

Under a parameter layout (``parallel/fsdp.py``) the Trainer builds it over
the layout's masters, so each parameter's moments and EMA live with its
slice on its rank, and records each master's spec in ``param_specs``
(``parallel.opt_state_shardings`` reads it); ``count`` and ``lr`` stay
replicated 0-d tensors.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from hyperbolic_vae_tpu_torch.manifolds import PoincareBall
from hyperbolic_vae_tpu_torch.nn.layers import is_manifold_param


def _dtype(d: Union[str, torch.dtype, None]) -> Optional[torch.dtype]:
    return getattr(torch, d) if isinstance(d, str) else d


def _write(dst: torch.Tensor, value) -> None:
    """``value`` (a number or a tensor) into the 0-d ``dst``, in place."""
    if isinstance(value, torch.Tensor):
        dst.copy_(value)
    else:
        dst.fill_(float(value))


class RiemannianAdam(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, ball: Optional[PoincareBall] = None,
                 moment_dtype: Union[str, torch.dtype, None] = None,
                 ema_decay: Optional[float] = None):
        defaults = dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay)
        super().__init__(params, defaults)
        self.ball = ball or PoincareBall(c=1.0)
        self.moment_dtype = _dtype(moment_dtype)
        self.ema_decay = ema_decay
        self.param_specs: dict = {}  # parameter -> its layout's spec, when it has one
        first = self.param_groups[0]["params"][0]
        device = first.device
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        # f32 on the main path; float64 parameters keep a float64 lr
        lr_dtype = torch.promote_types(torch.float32, first.dtype)
        for group in self.param_groups:
            group["lr"] = torch.full((), float(group["lr"]), dtype=lr_dtype, device=device)
            for p in group["params"]:
                self.moments(p)
                if ema_decay is not None:
                    self.state[p]["ema"] = p.detach().to(torch.float32, copy=True)

    def set_lr(self, lr) -> None:
        """Write ``lr`` (a number or a 0-d tensor) into every group's lr
        tensor, in place."""
        for group in self.param_groups:
            _write(group["lr"], lr)

    @torch.no_grad()
    def step(self, closure=None, ok: Optional[torch.Tensor] = None):
        """One update from each parameter's ``.grad``. With ``ok`` (a bool
        0-d tensor), parameters, moments, the EMA and ``count`` change only
        where ``ok`` is true."""
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
                # JAX's leaf_update, op for op: g, p and both moments in at
                # least f32 whatever their storage; the update cast to the
                # stored type and added in it (optax.apply_updates)
                compute = torch.promote_types(torch.float32, p.dtype)
                g, pf, mf, vf = (t.to(compute) for t in (p.grad, p, m, v))
                if wd:
                    g = g + wd * pf
                if is_manifold_param(p):
                    g = self.ball.egrad2rgrad(pf, g)
                    new_m = b1 * mf + (1.0 - b1) * g
                    new_v = b2 * vf + (1.0 - b2) * self.ball.component_inner(pf, g)
                    direction = (new_m / bc1) / (torch.sqrt(new_v / bc2) + eps)
                    new_pt, new_m = self.ball.retr_transp(pf, -lr * direction, new_m)
                    update = self.ball.project(new_pt) - pf
                else:
                    new_m = b1 * mf + (1.0 - b1) * g
                    new_v = b2 * vf + (1.0 - b2) * g * g
                    update = -lr * (new_m / bc1) / (torch.sqrt(new_v / bc2) + eps)
                new_p = p + update.to(p.dtype)
                if self.ema_decay is not None:
                    e = self.state[p]["ema"]
                    new_e = self._ema(e, new_p.to(torch.float32), is_manifold_param(p))
                    e.copy_(new_e if ok is None else torch.where(ok, new_e, e))
                if ok is not None:
                    new_p = torch.where(ok, new_p, p)
                    new_m = torch.where(ok, new_m.to(m.dtype), m)
                    new_v = torch.where(ok, new_v.to(v.dtype), v)
                p.copy_(new_p)
                m.copy_(new_m)
                v.copy_(new_v)
        self.count.copy_(count if ok is None else torch.where(ok, count, self.count))
        return loss

    def _ema(self, e, new_p, manifold: bool):
        """JAX's ``ema_leaf``: d e + (1 - d) new_p, for manifold points in
        the tangent space at the origin; the coefficients in f32."""
        d = float(np.float32(self.ema_decay))
        omd = float(np.float32(1.0) - np.float32(self.ema_decay))
        if manifold:
            t = d * self.ball.logmap0(e) + omd * self.ball.logmap0(new_p)
            return self.ball.project(self.ball.expmap0(t))
        return d * e + omd * new_p

    def moments(self, p):
        """(exp_avg, exp_avg_sq) of parameter ``p``, zeros (in
        ``moment_dtype`` if set) on first use."""
        state = self.state[p]
        if "exp_avg" not in state:
            dt = self.moment_dtype or p.dtype
            state["exp_avg"] = torch.zeros_like(p, dtype=dt, memory_format=torch.preserve_format)
            state["exp_avg_sq"] = torch.zeros_like(p, dtype=dt, memory_format=torch.preserve_format)
        return state["exp_avg"], state["exp_avg_sq"]

    def ema_params(self) -> Dict[torch.Tensor, torch.Tensor]:
        """The EMA of each parameter, keyed by the parameter. Raises
        without ``ema_decay``."""
        if self.ema_decay is None:
            raise ValueError("no parameter EMA: construct with ema_decay=...")
        return {p: self.state[p]["ema"] for g in self.param_groups for p in g["params"]}

    def state_dict(self):
        sd = super().state_dict()
        sd["count"] = self.count.clone()
        return sd

    def load_state_dict(self, state_dict):
        """Load values into the live tensors (lr, count, moments, EMA), so
        that what a captured graph reads keeps its address and the moments
        their storage type."""
        state_dict = dict(state_dict)
        count = state_dict.pop("count")
        live = [(g["lr"], [dict(self.state[p]) for p in g["params"]]) for g in self.param_groups]
        super().load_state_dict(state_dict)
        for group, (lr, states) in zip(self.param_groups, live):
            _write(lr, group["lr"])
            group["lr"] = lr
            for p, old in zip(group["params"], states):
                for k, t in old.items():
                    t.copy_(self.state[p][k])
                self.state[p] = old
        self.count.copy_(torch.as_tensor(count, dtype=torch.int32))

    def load_moments(self, moments: dict) -> None:
        """Set ``count`` and each parameter's moments from
        ``{"count": int, "state": {param: {"exp_avg": t, "exp_avg_sq": t}}}``
        (the form ``interop.optimizer_state_from_jax`` returns)."""
        self.count.fill_(int(moments["count"]))
        for p, st in moments["state"].items():
            for k, t in st.items():
                self.moments(p)[("exp_avg", "exp_avg_sq").index(k)].copy_(t)
