"""The flagship GyroplaneVAE's whole forward pass and ELBO as one op.

Port of the loss half of ``hyperbolic_vae_tpu/ops/flagship_fused.py``
(K2; the fused train step, K3, is still to port). Pieces:

  * ``params_tuple(model)``: the 14 parameter tensors in the JAX
    ``_params_tuple`` order, taken from the port's modules with no copy
    (weights in nn.Linear's (out, in) layout).
  * ``flagship_forward_torch``: the plain PyTorch version. It follows
    ``_body`` and ``flagship_forward_jnp`` op by op, with the same helpers:
    its own ``_artanh`` (clipped at 1.19e-7, via log1p), guarded-log
    ``_arsinh`` and tanh-GELU formula, and the ball's ``tanh`` (clamped at
    15), ``log_sinh_ratio`` series and ``mobius_add``. Its ``_artanh`` and
    ``_arsinh`` are not the model's, so it matches
    ``GyroplaneVAE.loss_from_eps`` to rtol ~2e-4, and the kernel is held to
    it, not to the model.
  * ``flagship_fused_cuda``: the wrapper of the hand-written CUDA kernel
    (``csrc/flagship_fused.cu``), with a launch counter. CUDA tensors only.
  * ``FusedFlagshipLoss`` / ``fused_flagship_loss``: forward by the kernel
    for CUDA tensors and by the plain version for CPU tensors; backward by
    autograd through the plain version, recomputed from the inputs, as the
    JAX ``custom_vjp`` differentiates its jnp mirror.
  * ``supports_fused`` and ``make_fused_loss_fn(model)``: the Trainer's
    ``loss_fn`` hook.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch

from hyperbolic_vae_tpu_torch.distributions.relaxed_bernoulli import softplus as _softplus
from hyperbolic_vae_tpu_torch.distributions.wrapped_normal import MAX_SAMPLE_RADIUS
from hyperbolic_vae_tpu_torch.manifolds import BOUNDARY_EPS, MIN_NORM, PoincareBall, log_sinh_ratio
from hyperbolic_vae_tpu_torch.manifolds import tanh as _tanh
from hyperbolic_vae_tpu_torch.manifolds.poincare import _norm
from hyperbolic_vae_tpu_torch.ops.gyroplane import LaunchCounter

_LOG_2PI = math.log(2.0 * math.pi)
HIDDEN = (64, 16)  # the widths the kernel is written for
MAX_LATENT = 8  # the kernel keeps per-row latent vectors in registers
_ROWS_PER_BLOCK = 4  # csrc/flagship_fused.cu kRows
_MAX_SMEM = 200 * 1024  # bytes of x the kernel may stage per block


def params_tuple(model) -> tuple:
    """The flagship's 14 parameter tensors in the JAX ``_params_tuple``
    order: enc_0, enc_1, mu, scale (weight, bias each), gyroplane points
    and bias, dec_0, out. No copies."""
    enc0, enc1 = model.encoder[1], model.encoder[3]
    gyro, dec0, out = model.decoder[0], model.decoder[2], model.decoder[4]
    return (
        enc0.weight, enc0.bias, enc1.weight, enc1.bias,
        model.mu[0].weight, model.mu[0].bias, model.scale[0].weight, model.scale[0].bias,
        gyro.points, gyro.bias, dec0.weight, dec0.bias, out.weight, out.bias,
    )


# ---------------------------------------------------------------------- #
# The plain version.


def _artanh(x):
    x = x.clamp(-1.0 + 1.19e-7, 1.0 - 1.19e-7)
    return 0.5 * (torch.log1p(x) - torch.log1p(-x))


def _arsinh(y):
    a = y.abs()
    a_small = a.clamp_max(1e10)
    small = torch.log(a_small + torch.sqrt(a_small * a_small + 1.0))
    big = torch.log(a.clamp_min(1e-30)) + math.log(2.0)
    return torch.sign(y) * torch.where(a > 1e10, big, small)


def _gelu(x):
    c0 = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c0 * (x + 0.044715 * x * x * x)))


def flagship_forward_torch(
    params: Sequence[torch.Tensor], x: torch.Tensor, eps: torch.Tensor, *,
    c: float, beta: float, prior_scale: float, latent_dim: int, data_numel: int,
):
    """(loss_total, mean recon, mean kl) of the flagship for the batch x
    (B, ...) and the standard-normal draws eps (B, latent_dim). Runs in
    the inputs' dtype (f32 on the main path; float64 for a reference)."""
    (w1, b1, w2, b2, wm, bm, ws, bs, pts, pb, w4, b4, w5, b5) = params
    mobius_add = PoincareBall(c).mobius_add
    sqrt_c = math.sqrt(c)
    max_norm = (1.0 - BOUNDARY_EPS) / sqrt_c
    d_max = 2.0 / sqrt_c * math.atanh(1.0 - BOUNDARY_EPS)

    xf = x.reshape(x.shape[0], -1)
    h = _gelu(xf @ w1.T + b1)
    h = _gelu(h @ w2.T + b2)
    mu_e = h @ wm.T + bm
    # expmap0 + project
    mu_n = _norm(mu_e)
    mu = _tanh(sqrt_c * mu_n) * mu_e / (sqrt_c * mu_n)
    mu = mu * (max_norm / _norm(mu)).clamp_max(1.0)
    scale = (_softplus(h @ ws.T + bs) + 1e-3).clamp(1e-3, 10.0)

    # wrapped normal rsample (truncated tangent draw)
    mu2 = (mu * mu).sum(dim=-1, keepdim=True)
    dist0_mu = 2.0 / sqrt_c * _artanh(sqrt_c * torch.sqrt(mu2.clamp_min(MIN_NORM**2)))
    r_allowed = (d_max - dist0_mu).clamp_min(1e-2).clamp_max(MAX_SAMPLE_RADIUS)
    v = scale * eps
    v_norm = torch.sqrt((v * v).sum(dim=-1, keepdim=True).clamp_min(1e-24))
    v = v * (r_allowed / v_norm).clamp_max(1.0)
    v = v / 2.0
    lam_mu = 2.0 / (1.0 - c * mu2).clamp_min(MIN_NORM)
    u = v * (1.0 - c * mu2).clamp_min(MIN_NORM)  # transp0
    # expmap(mu, u)
    u_n = _norm(u)
    second = _tanh(sqrt_c * lam_mu * u_n / 2.0) * u / (sqrt_c * u_n)
    z = mobius_add(mu, second)
    z = z * (max_norm / _norm(z)).clamp_max(1.0)

    # gyroplane distances (analytic epilogue) -> decoder
    z2 = (z * z).sum(dim=-1, keepdim=True)
    p2 = (pts * pts).sum(dim=-1)[None, :]
    zp = z @ pts.T
    den = (1.0 - 2.0 * c * zp + c * c * p2 * z2).clamp_min(MIN_NORM)
    alpha = (1.0 - 2.0 * c * zp + c * z2) / den
    betaa = (1.0 - c * p2) / den
    sc_diff = -alpha * p2 + betaa * zp
    max_d2 = (1.0 - 1e-4) ** 2 / c
    dn2 = (alpha * alpha * p2 - 2.0 * alpha * betaa * zp + betaa * betaa * z2).clamp(MIN_NORM, max_d2)
    p_norm = torch.sqrt(p2.clamp_min(MIN_NORM**2))
    dists = _arsinh(2.0 * sqrt_c * sc_diff / ((1.0 - c * dn2) * p_norm).clamp_min(MIN_NORM)) / sqrt_c
    hd = _gelu(dists + pb)
    hd = _gelu(hd @ w4.T + b4)
    xhat = torch.sigmoid(hd @ w5.T + b5)

    # recon: RelaxedBernoulli(T=1, probs=xhat).log_prob(x)
    pclip = xhat.clamp(1e-7, 1.0 - 1e-7)
    logits = torch.log(pclip) - torch.log1p(-pclip)
    tiny = 1.1754944e-38
    epsf = 1.1920929e-7
    xc = xf.clamp(tiny, 1.0 - epsf)
    y = torch.log(xc) - torch.log1p(-xc)
    diff = logits - y
    base = diff - 2.0 * _softplus(diff)
    lp = base - torch.log(xc) - torch.log1p(-xc)
    recon = -lp.sum(dim=-1, keepdim=True)  # (B, 1)

    # log q(z | mu, scale) and log p(z | 0, prior_scale); all (B, 1)
    def wn_log_prob(loc, loc2, sc, zz):
        sub = mobius_add(-loc, zz)
        sub_n = _norm(sub)
        lam = 2.0 / (1.0 - c * loc2).clamp_min(MIN_NORM)
        vv = 2.0 / (sqrt_c * lam) * _artanh(sqrt_c * sub_n) * sub / sub_n
        uu = vv * lam  # transp0back * 2
        npdf = (-(uu * uu) / (2.0 * sc * sc) - torch.log(sc) - 0.5 * _LOG_2PI).sum(
            dim=-1, keepdim=True)
        dist = 2.0 / sqrt_c * _artanh(sqrt_c * sub_n)
        ld = (latent_dim - 1) * log_sinh_ratio(sqrt_c * dist)
        return npdf - ld

    log_q = wn_log_prob(mu, mu2, scale, z)
    log_p = wn_log_prob(torch.zeros_like(mu), torch.zeros_like(mu2),
                        torch.full_like(scale, prior_scale), z)
    kl = log_q - log_p
    return (recon + beta * kl).mean(), recon.mean(), kl.mean()


# ---------------------------------------------------------------------- #
# The CUDA kernel.

launches = LaunchCounter()
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        from hyperbolic_vae_tpu_torch.ops._build import load_library

        fn = load_library("flagship_fused").flagship_fused_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_double] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _expected_shapes(d: int, latent: int) -> list:
    h1, h2 = HIDDEN
    return [
        (h1, d), (h1,), (h2, h1), (h2,), (latent, h2), (latent,), (latent, h2), (latent,),
        (h2, latent), (h2,), (h1, h2), (h1,), (d, h1), (d,),
    ]


def flagship_fused_cuda(
    params: Sequence[torch.Tensor], x: torch.Tensor, eps: torch.Tensor, *,
    c: float, beta: float, prior_scale: float, latent_dim: int, data_numel: int,
) -> torch.Tensor:
    """The CUDA kernel: x (B, data_numel), eps (B, latent_dim) and the 14
    parameter tensors (``params_tuple`` order and layout), all contiguous
    f32 on one CUDA device -> (3,) f32: (loss_total, mean recon, mean kl)."""
    tensors = [x, eps, *params]
    for t in tensors:
        if not t.is_cuda or t.device != x.device:
            raise ValueError("flagship kernel: tensors must be on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"flagship kernel: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("flagship kernel: tensors must be contiguous")
    if not 1 <= latent_dim <= MAX_LATENT:
        raise ValueError(f"flagship kernel: latent_dim {latent_dim} outside [1, {MAX_LATENT}]")
    if 4 * _ROWS_PER_BLOCK * data_numel > _MAX_SMEM:
        raise ValueError(f"flagship kernel: data_numel {data_numel} exceeds shared memory")
    if x.dim() != 2 or x.shape[1] != data_numel or x.shape[0] == 0:
        raise ValueError(f"flagship kernel: x must be (B > 0, {data_numel}), got {tuple(x.shape)}")
    B = x.shape[0]
    if tuple(eps.shape) != (B, latent_dim):
        raise ValueError(f"flagship kernel: eps must be ({B}, {latent_dim}), got {tuple(eps.shape)}")
    if len(params) != 14:
        raise ValueError(f"flagship kernel: 14 parameter tensors, got {len(params)}")
    for i, (t, want) in enumerate(zip(params, _expected_shapes(data_numel, latent_dim))):
        if tuple(t.shape) != want:
            raise ValueError(f"flagship kernel: parameter {i} must be {want}, got {tuple(t.shape)}")
    out = torch.empty(3, dtype=torch.float32, device=x.device)
    rows = torch.empty((B, 2), dtype=torch.float32, device=x.device)
    ptrs = (ctypes.c_void_p * 14)(*[t.data_ptr() for t in params])
    fn = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), eps.data_ptr(), ptrs, rows.data_ptr(), out.data_ptr(),
                 B, data_numel, latent_dim, float(c), float(beta), float(prior_scale), stream)
    if err != 0:
        raise RuntimeError(f"flagship kernel launch failed: cudaError {err}")
    launches.add()
    return out


# ---------------------------------------------------------------------- #
# Differentiable dispatch.


class FusedFlagshipLoss(torch.autograd.Function):
    """(3,) = (loss_total, mean recon, mean kl). Forward: the kernel for
    CUDA tensors, the plain version for CPU tensors. Backward: autograd
    through the plain version, recomputed from the saved inputs (the
    counterpart of the JAX ``_ffl_bwd``); no gradient for eps."""

    @staticmethod
    def forward(ctx, cfg: dict, x, eps, *params):
        ctx.cfg = cfg
        ctx.save_for_backward(x, eps, *params)
        if x.is_cuda:
            return flagship_fused_cuda(params, x, eps, **cfg)
        if x.device.type != "cpu":
            raise ValueError(f"fused flagship loss: no path for device {x.device}")
        return torch.stack(flagship_forward_torch(params, x, eps, **cfg))

    @staticmethod
    def backward(ctx, g):
        x, eps, *params = ctx.saved_tensors
        need_x = ctx.needs_input_grad[1]
        need_p = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            p_in = [p.detach().requires_grad_(n) for p, n in zip(params, need_p)]
            x_in = x.detach().requires_grad_(need_x)
            out = torch.stack(flagship_forward_torch(p_in, x_in, eps, **ctx.cfg))
            wrt = [t for t in (x_in, *p_in) if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, g) if wrt else ())
        dx = next(grads) if need_x else None
        dps = [next(grads) if n else None for n in need_p]
        return (None, dx, None, *dps)


def fused_flagship_loss(
    params: Sequence[torch.Tensor], x: torch.Tensor, eps: torch.Tensor, *,
    c: float, beta: float, prior_scale: float, latent_dim: int, data_numel: int,
):
    """Differentiable (loss_total, mean recon, mean kl) for the batch x
    (B, ...) and draws eps (B, latent_dim)."""
    cfg = dict(c=float(c), beta=float(beta), prior_scale=float(prior_scale),
               latent_dim=int(latent_dim), data_numel=int(data_numel))
    xf = x.reshape(x.shape[0], -1).float().contiguous()
    out = FusedFlagshipLoss.apply(cfg, xf, eps.float().contiguous(), *params)
    return out[0], out[1], out[2]


def supports_fused(model) -> bool:
    """The kernel handles the flagship architecture: hidden widths (64, 16)."""
    return (type(model).__name__ == "GyroplaneVAE"
            and tuple(model.hidden_dims) == HIDDEN
            and model.latent_dim <= MAX_LATENT)


def fused_config(model) -> dict:
    return dict(
        c=float(model.manifold_curvature), beta=float(model.beta),
        prior_scale=float(model.prior_scale), latent_dim=int(model.latent_dim),
        data_numel=int(model.data_numel),
    )


def make_fused_loss_fn(model):
    """``fn(model, batch, generator) -> {loss_total, recon_loss, kl_loss}``,
    a drop-in for ``model.loss`` on supported models (the Trainer's
    ``loss_fn`` hook). eps (B, latent_dim) is drawn from ``generator`` on
    the batch's device exactly as ``model.loss`` draws it, so the fused
    and the plain Trainer with one seed see the same draws."""
    if not supports_fused(model):
        raise ValueError("the fused path supports the flagship GyroplaneVAE (hidden dims (64, 16))")
    cfg = fused_config(model)

    def loss_fn(m, batch, generator: Optional[torch.Generator] = None) -> dict:
        eps = torch.randn((batch.shape[0], cfg["latent_dim"]), generator=generator,
                          device=batch.device, dtype=torch.float32)
        lt, rm, km = fused_flagship_loss(params_tuple(m), batch, eps, **cfg)
        return {"loss_total": lt, "recon_loss": rm, "kl_loss": km}

    return loss_fn
