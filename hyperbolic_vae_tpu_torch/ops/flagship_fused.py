"""The flagship GyroplaneVAE's forward pass and ELBO (K2) and its whole
training step (K3), each as one op.

Port of ``hyperbolic_vae_tpu/ops/flagship_fused.py``. Pieces of K2:

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

Pieces of K3 (JAX's ``_train_kernel`` and ``make_fused_train_step``):

  * ``flagship_grads_torch``: the gradient of ``loss_total`` with respect
    to the 14 parameters, derived by hand stage by stage in torch ops (no
    autograd), in the order the kernel computes it. Where a clamp or a
    ``where`` is active the gradient goes where JAX's autodiff sends it:
    ``jnp.maximum`` / ``minimum`` (and so ``clip``) split it half and half
    at an exact tie, ``abs`` and ``sign`` give the guarded-log arsinh a
    zero derivative at 0. eps and x get no gradient.
  * ``riemannian_adam_update_inline``: one leaf's update, op by op as
    ``_riemannian_adam_update_inline``.
  * ``flagship_train_step_torch``: the plain version of the whole step
    (gradients, the finite guard, the update of params and moments,
    ``count + 1``), functional; ``flagship_train_cuda``: the wrapper of the
    hand-written CUDA kernel (``csrc/flagship_train.cu``), in place.
  * ``make_fused_train_step(model)``: the Trainer's ``train_step_fn`` hook.
    As JAX's K3 it advances ``count`` on a skipped step too; only params
    and moments are kept.
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
from hyperbolic_vae_tpu_torch.manifolds.poincare import TANH_CLAMP, _norm
from hyperbolic_vae_tpu_torch.ops.gyroplane import LaunchCounter

_LOG_2PI = math.log(2.0 * math.pi)
HIDDEN = (64, 16)  # the widths the kernel is written for
MAX_LATENT = 8  # the kernel keeps per-row latent vectors in registers
# the rows kernels' shared memory (csrc/flagship_common.cuh rows_smem_bytes):
# per CTA of a cluster, the cluster's rows of x and the CTA's w1 slice
# (padded to a multiple of 4 floats), its w5 slice in rows of 68 floats,
# and per row its pixels' log density terms (and in K3 d loss / d logit),
# after a fixed part of at most _SMEM_FIXED bytes
_CLUSTER = 8  # kCluster: CTAs per cluster
_CLUSTER_ROWS = 18  # kRows: batch rows per cluster
_SMEM_FIXED = 72 * 1024  # kFixedSmem
_MAX_SMEM = 232448  # 227 KB: the most shared memory one H100 block may opt in to


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


def _check_operands(what: str, tensors, device) -> None:
    for t in tensors:
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{what}: tensors must be on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")


def _rows_smem_bytes(data_numel: int, train: bool) -> int:
    """Bytes of shared memory a rows kernel (K3's if ``train``) needs per
    CTA for ``data_numel`` pixels, with the fixed part at its bound."""
    d4 = (data_numel + 3) // 4 * 4
    p5 = -(-data_numel // _CLUSTER)
    p5r = (p5 + 3) // 4 * 4
    floats = (_CLUSTER_ROWS + 64 // _CLUSTER) * d4 + 68 * p5 + (2 if train else 1) * _CLUSTER_ROWS * p5r
    return _SMEM_FIXED + 4 * floats


def _check_shapes(what: str, x, eps, latent_dim: int, data_numel: int, train: bool) -> None:
    """x (B > 0, data_numel) and eps (B, latent_dim) for a rows kernel whose
    staged rows and weight slices must fit one block's shared memory."""
    if not 1 <= latent_dim <= MAX_LATENT:
        raise ValueError(f"{what}: latent_dim {latent_dim} outside [1, {MAX_LATENT}]")
    if _rows_smem_bytes(data_numel, train) > _MAX_SMEM:
        raise ValueError(f"{what}: data_numel {data_numel} exceeds shared memory")
    if x.dim() != 2 or x.shape[1] != data_numel or x.shape[0] == 0:
        raise ValueError(f"{what}: x must be (B > 0, {data_numel}), got {tuple(x.shape)}")
    if tuple(eps.shape) != (x.shape[0], latent_dim):
        raise ValueError(f"{what}: eps must be ({x.shape[0]}, {latent_dim}), got {tuple(eps.shape)}")


def _check_batch(what: str, x, eps, latent_dim: int, data_numel: int, train: bool) -> None:
    """``_check_shapes``, then x and eps contiguous f32 on one CUDA device."""
    _check_shapes(what, x, eps, latent_dim, data_numel, train)
    _check_operands(what, (x, eps), x.device)


def flagship_fused_cuda(
    params: Sequence[torch.Tensor], x: torch.Tensor, eps: torch.Tensor, *,
    c: float, beta: float, prior_scale: float, latent_dim: int, data_numel: int,
) -> torch.Tensor:
    """The CUDA kernel: x (B, data_numel), eps (B, latent_dim) and the 14
    parameter tensors (``params_tuple`` order and layout), all contiguous
    f32 on one CUDA device -> (3,) f32: (loss_total, mean recon, mean kl)."""
    _check_batch("flagship kernel", x, eps, latent_dim, data_numel, False)
    _check_operands("flagship kernel", params, x.device)
    B = x.shape[0]
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

    # K2 has no row split: under a data mesh every rank runs it on the
    # whole global batch (parallel/data_parallel.py)
    loss_fn.whole_batch = True
    return loss_fn


# ---------------------------------------------------------------------- #
# K3: the whole training step. The plain version's backward is derived by
# hand; the kernel follows it stage by stage.

_MP_POINTS_IDX = 8  # position of the gyroplane points in params_tuple
_N_PARAMS = 14
_TINY = 1.1754944e-38
_EPS_F32 = 1.1920929e-7


def _ge(x, lo):
    """d max(x, lo) / dx as JAX's autodiff gives it: 1, 1/2 at a tie, 0."""
    return (x > lo).to(x.dtype) + 0.5 * (x == lo).to(x.dtype)


def _le(x, hi):
    """d min(x, hi) / dx as JAX's autodiff gives it: 1, 1/2 at a tie, 0."""
    return (x < hi).to(x.dtype) + 0.5 * (x == hi).to(x.dtype)


def _clip_grad(x, lo, hi):
    """d clip(x, lo, hi) / dx, clip being min(max(x, lo), hi) as in JAX."""
    return _ge(x, lo) * _le(x.clamp_min(lo), hi)


def _gelu_grad(x):
    c0 = math.sqrt(2.0 / math.pi)
    t = torch.tanh(c0 * (x + 0.044715 * x * x * x))
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * c0 * (1.0 + 3.0 * 0.044715 * x * x)


def _artanh_grad(x):
    """d _artanh(x) / dx: 0.5 (1/(1 + x) + 1/(1 - x)) inside the clip."""
    xc = x.clamp(-1.0 + 1.19e-7, 1.0 - 1.19e-7)
    return 0.5 * (1.0 / (1.0 + xc) + 1.0 / (1.0 - xc)) * _clip_grad(x, -1.0 + 1.19e-7, 1.0 - 1.19e-7)


def _tanh_grad(x, th):
    """d tanh(clip(x, -15, 15)) / dx given th, the value."""
    return (1.0 - th * th) * _clip_grad(x, -TANH_CLAMP, TANH_CLAMP)


def _lsr_grad(t):
    """d log_sinh_ratio(t) / dt, branch by branch."""
    t_safe = t.clamp_min(0.1)
    e = torch.exp(-2.0 * t_safe)
    big = (1.0 + 2.0 * e / (1.0 - e) - 1.0 / t_safe) * _ge(t, 0.1)
    t2 = t * t
    small = (1.0 / 6.0 - 2.0 * t2 / 180.0 + 3.0 * t2 * t2 / 2835.0) * 2.0 * t
    return torch.where(t < 0.2, small, big)


def _sq(v):
    return (v * v).sum(dim=-1, keepdim=True)


def _sqrt_floor_back(d_n, n, v, s, floor):
    """Cotangent of v through n = sqrt(max(|v|^2, floor)) (s = |v|^2)."""
    return d_n / n * v * _ge(s, floor)


def _mobius_fwd(a, b, c):
    """PoincareBall(c).mobius_add(a, b), with what its backward reads."""
    a2, b2 = _sq(a), _sq(b)
    ab = (a * b).sum(dim=-1, keepdim=True)
    ca = 1.0 + 2.0 * c * ab + c * b2
    cb = 1.0 - c * a2
    den_raw = 1.0 + 2.0 * c * ab + c * c * a2 * b2
    den = den_raw.clamp_min(MIN_NORM)
    out = (ca * a + cb * b) / den
    return out, (a, b, a2, b2, ca, cb, den_raw, den, out)


def _mobius_bwd(cache, g, c):
    """(d a, d b) for the cotangent g of mobius_add(a, b)."""
    a, b, a2, b2, ca, cb, den_raw, den, out = cache
    d_num = g / den
    d_den = -(g * out).sum(dim=-1, keepdim=True) / den * _ge(den_raw, MIN_NORM)
    d_ca = (d_num * a).sum(dim=-1, keepdim=True)
    d_cb = (d_num * b).sum(dim=-1, keepdim=True)
    d_ab = 2.0 * c * (d_ca + d_den)
    d_b2 = c * d_ca + c * c * a2 * d_den
    d_a2 = -c * d_cb + c * c * b2 * d_den
    return d_num * ca + 2.0 * a * d_a2 + b * d_ab, d_num * cb + 2.0 * b * d_b2 + a * d_ab


def _wn_fwd(loc, loc2, sc, zz, c, latent_dim):
    """wn_log_prob of ``flagship_forward_torch`` (B, 1), with its cache."""
    sqrt_c = math.sqrt(c)
    sub, mob = _mobius_fwd(-loc, zz, c)
    s_sub = _sq(sub)
    sub_n = torch.sqrt(s_sub.clamp_min(MIN_NORM**2))
    om_raw = 1.0 - c * loc2
    om = om_raw.clamp_min(MIN_NORM)
    lam = 2.0 / om
    xa = sqrt_c * sub_n
    at = _artanh(xa)
    k = 2.0 / (sqrt_c * lam)
    vv = k * at * sub / sub_n
    uu = vv * lam
    npdf = (-(uu * uu) / (2.0 * sc * sc) - torch.log(sc) - 0.5 * _LOG_2PI).sum(dim=-1, keepdim=True)
    t = sqrt_c * (2.0 / sqrt_c * at)
    out = npdf - (latent_dim - 1) * log_sinh_ratio(t)
    return out, (mob, sub, s_sub, sub_n, om_raw, om, lam, xa, at, k, vv, uu, sc, t)


def _wn_bwd(cache, g, c, latent_dim):
    """(d loc, d loc2, d sc, d z) for the cotangent g (B, 1) of _wn_fwd."""
    sqrt_c = math.sqrt(c)
    mob, sub, s_sub, sub_n, om_raw, om, lam, xa, at, k, vv, uu, sc, t = cache
    d_uu = g * -(uu / (sc * sc))
    d_sc = g * (uu * uu / (sc * sc * sc) - 1.0 / sc)
    d_vv = d_uu * lam
    d_lam = (d_uu * vv).sum(dim=-1, keepdim=True)
    d_t = -g * (latent_dim - 1) * _lsr_grad(t)
    d_at = d_t * sqrt_c * (2.0 / sqrt_c)
    d_k = (d_vv * at * sub / sub_n).sum(dim=-1, keepdim=True)
    d_at = d_at + (d_vv * k * sub / sub_n).sum(dim=-1, keepdim=True)
    d_sub = d_vv * (k * at) / sub_n
    d_subn = -(d_vv * vv).sum(dim=-1, keepdim=True) / sub_n
    d_lam = d_lam - d_k * k / lam
    d_subn = d_subn + d_at * _artanh_grad(xa) * sqrt_c
    d_sub = d_sub + _sqrt_floor_back(d_subn, sub_n, sub, s_sub, MIN_NORM**2)
    d_loc2 = -d_lam * lam / om * _ge(om_raw, MIN_NORM) * (-c)
    d_neg, d_z = _mobius_bwd(mob, d_sub, c)
    return -d_neg, d_loc2, d_sc, d_z


@torch.no_grad()
def flagship_grads_torch(
    params: Sequence[torch.Tensor], x: torch.Tensor, eps: torch.Tensor, *,
    c: float, beta: float, prior_scale: float, latent_dim: int, data_numel: int,
):
    """(grads, (loss_total, mean recon, mean kl)): the gradient of
    ``loss_total`` with respect to the 14 parameters (``params_tuple``
    order and layout), derived by hand, and the forward's values, which
    equal ``flagship_forward_torch``'s (the same ops). Runs in the inputs'
    dtype."""
    (w1, b1, w2, b2, wm, bm, ws, bs, pts, pb, w4, b4, w5, b5) = params
    mobius_add = PoincareBall(c).mobius_add
    sqrt_c = math.sqrt(c)
    max_norm = (1.0 - BOUNDARY_EPS) / sqrt_c
    d_max = 2.0 / sqrt_c * math.atanh(1.0 - BOUNDARY_EPS)
    max_d2 = (1.0 - 1e-4) ** 2 / c
    mn2 = MIN_NORM**2
    B = x.shape[0]

    # ---- forward: the ops of flagship_forward_torch, keeping what the
    # backward reads
    xf = x.reshape(B, -1)
    a1 = xf @ w1.T + b1
    h1 = _gelu(a1)
    a2 = h1 @ w2.T + b2
    h2 = _gelu(a2)
    mu_e = h2 @ wm.T + bm
    s_mue = _sq(mu_e)
    mu_n = torch.sqrt(s_mue.clamp_min(mn2))
    th = _tanh(sqrt_c * mu_n)
    mu0 = th * mu_e / (sqrt_c * mu_n)
    s_mu0 = _sq(mu0)
    n_mu0 = torch.sqrt(s_mu0.clamp_min(mn2))
    r1 = max_norm / n_mu0
    f1 = r1.clamp_max(1.0)
    mu = mu0 * f1
    s_se = h2 @ ws.T + bs
    sp = _softplus(s_se)
    scale = (sp + 1e-3).clamp(1e-3, 10.0)

    mu2 = (mu * mu).sum(dim=-1, keepdim=True)
    q = torch.sqrt(mu2.clamp_min(mn2))
    dist0 = 2.0 / sqrt_c * _artanh(sqrt_c * q)
    rr = d_max - dist0
    r_allowed = rr.clamp_min(1e-2).clamp_max(MAX_SAMPLE_RADIUS)
    v0 = scale * eps
    s_v0 = (v0 * v0).sum(dim=-1, keepdim=True)
    v_norm = torch.sqrt(s_v0.clamp_min(1e-24))
    r2 = r_allowed / v_norm
    f2 = r2.clamp_max(1.0)
    v = v0 * f2 / 2.0
    om_raw = 1.0 - c * mu2
    om = om_raw.clamp_min(MIN_NORM)
    lam_mu = 2.0 / om
    u = v * om
    s_u = _sq(u)
    u_n = torch.sqrt(s_u.clamp_min(mn2))
    w_arg = sqrt_c * lam_mu * u_n / 2.0
    tu = _tanh(w_arg)
    second = tu * u / (sqrt_c * u_n)
    z0, mob_z = _mobius_fwd(mu, second, c)
    s_z0 = _sq(z0)
    n_z0 = torch.sqrt(s_z0.clamp_min(mn2))
    r3 = max_norm / n_z0
    f3 = r3.clamp_max(1.0)
    z = z0 * f3

    z2 = (z * z).sum(dim=-1, keepdim=True)
    p2 = (pts * pts).sum(dim=-1)[None, :]
    zp = z @ pts.T
    den_raw = 1.0 - 2.0 * c * zp + c * c * p2 * z2
    den = den_raw.clamp_min(MIN_NORM)
    alpha = (1.0 - 2.0 * c * zp + c * z2) / den
    betaa = (1.0 - c * p2) / den
    sc_diff = -alpha * p2 + betaa * zp
    e_raw = alpha * alpha * p2 - 2.0 * alpha * betaa * zp + betaa * betaa * z2
    dn2 = e_raw.clamp(MIN_NORM, max_d2)
    p_norm = torch.sqrt(p2.clamp_min(mn2))
    q_raw = (1.0 - c * dn2) * p_norm
    q_den = q_raw.clamp_min(MIN_NORM)
    arg = 2.0 * sqrt_c * sc_diff / q_den
    dists = _arsinh(arg) / sqrt_c
    a3 = dists + pb
    hd = _gelu(a3)
    a4 = hd @ w4.T + b4
    h4 = _gelu(a4)
    xhat = torch.sigmoid(h4 @ w5.T + b5)

    pclip = xhat.clamp(1e-7, 1.0 - 1e-7)
    logits = torch.log(pclip) - torch.log1p(-pclip)
    xc = xf.clamp(_TINY, 1.0 - _EPS_F32)
    y = torch.log(xc) - torch.log1p(-xc)
    diff = logits - y
    base = diff - 2.0 * _softplus(diff)
    lp = base - torch.log(xc) - torch.log1p(-xc)
    recon = -lp.sum(dim=-1, keepdim=True)

    log_q, cache_q = _wn_fwd(mu, mu2, scale, z, c, latent_dim)
    log_p, cache_p = _wn_fwd(torch.zeros_like(mu), torch.zeros_like(mu2),
                             torch.full_like(scale, prior_scale), z, c, latent_dim)
    kl = log_q - log_p
    values = ((recon + beta * kl).mean(), recon.mean(), kl.mean())

    # ---- backward of loss_total = mean(recon + beta kl)
    # recon: lp = diff - 2 softplus(diff) + terms of x alone
    d_lp = -1.0 / B
    d_diff = d_lp - 2.0 * d_lp * torch.sigmoid(diff)
    d_pc = d_diff / pclip + d_diff / (1.0 - pclip)
    d_o = d_pc * _clip_grad(xhat, 1e-7, 1.0 - 1e-7) * xhat * (1.0 - xhat)
    g_w5, g_b5 = d_o.T @ h4, d_o.sum(0)
    d_a4 = (d_o @ w5) * _gelu_grad(a4)
    g_w4, g_b4 = d_a4.T @ hd, d_a4.sum(0)
    d_a3 = (d_a4 @ w4) * _gelu_grad(a3)
    g_pb = d_a3.sum(0)

    # the gyroplane epilogue: dists = sign(arg) S(|arg|) / sqrt(c)
    a_abs = arg.abs()
    a_small = a_abs.clamp_max(1e10)
    d_s = torch.where(a_abs > 1e10, 1.0 / a_abs, _le(a_abs, 1e10) / torch.sqrt(a_small * a_small + 1.0))
    d_arg = d_a3 / sqrt_c * d_s * (arg != 0).to(arg.dtype)
    d_scd = d_arg * (2.0 * sqrt_c) / q_den
    d_qraw = -d_arg * arg / q_den * _ge(q_raw, MIN_NORM)
    d_e = d_qraw * (-c) * p_norm * _clip_grad(e_raw, MIN_NORM, max_d2)
    d_alpha = d_e * (2.0 * alpha * p2 - 2.0 * betaa * zp) - d_scd * p2
    d_beta = d_e * (2.0 * betaa * z2 - 2.0 * alpha * zp) + d_scd * zp
    d_p2 = d_e * alpha * alpha - d_scd * alpha
    d_zp = d_e * (-2.0 * alpha * betaa) + d_scd * betaa
    d_z2 = d_e * betaa * betaa
    d_zp = d_zp + d_alpha * (-2.0 * c) / den
    d_z2 = d_z2 + d_alpha * c / den
    d_p2 = d_p2 + d_beta * (-c) / den
    d_den = -(d_alpha * alpha + d_beta * betaa) / den * _ge(den_raw, MIN_NORM)
    d_zp = d_zp + d_den * (-2.0 * c)
    d_p2 = d_p2 + d_den * (c * c) * z2
    d_z2 = d_z2 + d_den * (c * c) * p2
    d_p2 = d_p2 + d_qraw * (1.0 - c * dn2) * 0.5 / p_norm * _ge(p2, mn2)
    g_pts = (2.0 * d_p2[:, :, None] * pts[None] + d_zp[:, :, None] * z[:, None, :]).sum(0)
    d_z = d_zp @ pts + 2.0 * z * d_z2.sum(dim=-1, keepdim=True)

    # both log densities
    g_kl = beta / B
    d_loc_q, d_mu2, d_scale, d_zq = _wn_bwd(cache_q, torch.full_like(kl, g_kl), c, latent_dim)
    _, _, _, d_zpr = _wn_bwd(cache_p, torch.full_like(kl, -g_kl), c, latent_dim)
    d_z = d_z + d_zq + d_zpr

    # z = project(mu (+) second)
    d_f3 = (d_z * z0).sum(dim=-1, keepdim=True)
    d_nz = -d_f3 * _le(r3, 1.0) * r3 / n_z0
    d_z0 = d_z * f3 + _sqrt_floor_back(d_nz, n_z0, z0, s_z0, mn2)
    d_mu, d_second = _mobius_bwd(mob_z, d_z0, c)
    # second = tanh(sqrt(c) lam_mu |u| / 2) u / (sqrt(c) |u|)
    d_tu = (d_second * u).sum(dim=-1, keepdim=True) / (sqrt_c * u_n)
    d_u = d_second * tu / (sqrt_c * u_n)
    d_un = -(d_second * second).sum(dim=-1, keepdim=True) / u_n
    d_w = d_tu * _tanh_grad(w_arg, tu)
    d_lam = d_w * sqrt_c * u_n / 2.0
    d_un = d_un + d_w * sqrt_c * lam_mu / 2.0
    d_u = d_u + _sqrt_floor_back(d_un, u_n, u, s_u, mn2)
    # u = v om, lam_mu = 2 / om, v = v0 f2 / 2
    d_om = (d_u * v).sum(dim=-1, keepdim=True) - d_lam * lam_mu / om
    d_mu2 = d_mu2 + d_om * _ge(om_raw, MIN_NORM) * (-c)
    d_v1 = d_u * om / 2.0
    d_f2 = (d_v1 * v0).sum(dim=-1, keepdim=True)
    d_r2 = d_f2 * _le(r2, 1.0)
    d_vn = -d_r2 * r2 / v_norm
    d_v0 = d_v1 * f2 + _sqrt_floor_back(d_vn, v_norm, v0, s_v0, 1e-24)
    d_scale = d_scale + d_v0 * eps
    # r_allowed = clip(d_max - dist0, 1e-2, MAX_SAMPLE_RADIUS), dist0 of |mu|
    d_dist0 = -(d_r2 / v_norm) * _clip_grad(rr, 1e-2, MAX_SAMPLE_RADIUS)
    d_q = d_dist0 * (2.0 / sqrt_c) * _artanh_grad(sqrt_c * q) * sqrt_c
    d_mu2 = d_mu2 + d_q * 0.5 / q * _ge(mu2, mn2)
    d_mu = d_mu + d_loc_q + 2.0 * mu * d_mu2
    # mu = project(expmap0(mu_e))
    d_f1 = (d_mu * mu0).sum(dim=-1, keepdim=True)
    d_nmu0 = -d_f1 * _le(r1, 1.0) * r1 / n_mu0
    d_mu0 = d_mu * f1 + _sqrt_floor_back(d_nmu0, n_mu0, mu0, s_mu0, mn2)
    d_th = (d_mu0 * mu_e).sum(dim=-1, keepdim=True) / (sqrt_c * mu_n)
    d_mue = d_mu0 * th / (sqrt_c * mu_n)
    d_mun = -(d_mu0 * mu0).sum(dim=-1, keepdim=True) / mu_n
    d_mun = d_mun + d_th * _tanh_grad(sqrt_c * mu_n, th) * sqrt_c
    d_mue = d_mue + _sqrt_floor_back(d_mun, mu_n, mu_e, s_mue, mn2)
    d_se = d_scale * _clip_grad(sp + 1e-3, 1e-3, 10.0) * torch.sigmoid(s_se)

    # the encoder
    g_wm, g_bm = d_mue.T @ h2, d_mue.sum(0)
    g_ws, g_bs = d_se.T @ h2, d_se.sum(0)
    d_a2 = (d_mue @ wm + d_se @ ws) * _gelu_grad(a2)
    g_w2, g_b2 = d_a2.T @ h1, d_a2.sum(0)
    d_a1 = (d_a2 @ w2) * _gelu_grad(a1)
    g_w1, g_b1 = d_a1.T @ xf, d_a1.sum(0)
    grads = (g_w1, g_b1, g_w2, g_b2, g_wm, g_bm, g_ws, g_bs, g_pts, g_pb, g_w4, g_b4, g_w5, g_b5)
    return grads, values


def riemannian_adam_update_inline(p, g, m, v, lr, bc1, bc2, is_manifold: bool, *, c: float,
                                  b1: float = 0.9, b2: float = 0.999, adam_eps: float = 1e-8):
    """(new p, new m, new v) of one leaf, op by op as JAX's
    ``_riemannian_adam_update_inline``: Adam, or for the gyroplane points
    the Riemannian update (g / lambda^2, expmap retraction, projection,
    exp_avg transported by gyr[new_p, -p] lambda_p / lambda_new)."""
    sqrt_c = math.sqrt(c)
    if is_manifold:
        mobius_add = PoincareBall(c).mobius_add
        lam = 2.0 / (1.0 - c * _sq(p)).clamp_min(MIN_NORM)
        g_r = g / (lam * lam)
        new_m = b1 * m + (1.0 - b1) * g_r
        new_v = b2 * v + (1.0 - b2) * (lam * lam) * g_r * g_r
        direction = (new_m / bc1) / (torch.sqrt(new_v / bc2) + adam_eps)
        u = -lr * direction
        u_n = _norm(u)
        second = _tanh(sqrt_c * lam * u_n / 2.0) * u / (sqrt_c * u_n)
        new_p = mobius_add(p, second)
        new_p = new_p * ((1.0 - BOUNDARY_EPS) / sqrt_c / _norm(new_p)).clamp_max(1.0)
        gyr = mobius_add(-mobius_add(new_p, -p), mobius_add(new_p, mobius_add(-p, new_m)))
        lam_new = 2.0 / (1.0 - c * _sq(new_p)).clamp_min(MIN_NORM)
        return new_p, gyr * lam / lam_new, new_v
    new_m = b1 * m + (1.0 - b1) * g
    new_v = b2 * v + (1.0 - b2) * g * g
    new_p = p - lr * (new_m / bc1) / (torch.sqrt(new_v / bc2) + adam_eps)
    return new_p, new_m, new_v


@torch.no_grad()
def flagship_train_step_torch(
    params: Sequence[torch.Tensor], m: Sequence[torch.Tensor], v: Sequence[torch.Tensor],
    x: torch.Tensor, eps: torch.Tensor, *, lr, count, c: float, beta: float,
    prior_scale: float, latent_dim: int, data_numel: int,
    b1: float = 0.9, b2: float = 0.999, adam_eps: float = 1e-8,
):
    """One training step of the flagship, functional: (new params, new
    exp_avg, new exp_avg_sq, metrics (4,) = (loss_total, recon, kl,
    skipped), count + 1). A step whose loss or sum of squared gradients is
    not finite keeps params and moments bit for bit and counts 1 skipped;
    ``count`` advances either way, as in JAX's K3. ``count`` is an int or
    an int32 0-d tensor, ``lr`` a number or a 0-d tensor (the optimizer's,
    as the kernel reads it); lr and the bias corrections enter in f32."""
    grads, (lt, rm, km) = flagship_grads_torch(
        params, x, eps, c=c, beta=beta, prior_scale=prior_scale,
        latent_dim=latent_dim, data_numel=data_numel)
    gnorm2 = sum((g * g).sum() for g in grads)
    ok = torch.isfinite(lt) & torch.isfinite(gnorm2)
    new_count = torch.as_tensor(count, dtype=torch.int32, device=x.device) + 1
    cf = new_count.to(torch.float32)  # the bias corrections in f32, as JAX's K3
    bc1, bc2 = 1.0 - torch.pow(b1, cf), 1.0 - torch.pow(b2, cf)
    lr_t = _lr_tensor(lr, x.device)
    new_p, new_m, new_v = [], [], []
    for i in range(_N_PARAMS):
        p_i, m_i, v_i = riemannian_adam_update_inline(
            params[i], grads[i], m[i], v[i], lr_t, bc1, bc2, i == _MP_POINTS_IDX, c=c,
            b1=b1, b2=b2, adam_eps=adam_eps)
        new_p.append(torch.where(ok, p_i, params[i]))
        new_m.append(torch.where(ok, m_i, m[i]))
        new_v.append(torch.where(ok, v_i, v[i]))
    metrics = torch.stack([lt, rm, km, 1.0 - ok.to(lt.dtype)])
    return tuple(new_p), tuple(new_m), tuple(new_v), metrics, new_count


def _lr_tensor(lr, device) -> torch.Tensor:
    """lr as a 0-d f32 tensor on ``device``: the tensor itself when it is
    one already (the optimizer's, which a controller writes in place)."""
    if isinstance(lr, torch.Tensor):
        return lr.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(lr), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------- #
# The K3 CUDA kernel.

train_launches = LaunchCounter()
_train_lib = None
_train_cache: dict = {}  # "key": the operands' identities, "ptrs": the ctypes array
_train_scratch: dict = {}  # (device, stream, B, D, L) -> scratch tensor


def _train_library():
    global _train_lib
    if _train_lib is None:
        from hyperbolic_vae_tpu_torch.ops._build import load_library

        lib = load_library("flagship_train")
        lib.flagship_train_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_double] * 3 + [ctypes.c_void_p] + [ctypes.c_double] * 3 + [ctypes.c_void_p]
        lib.flagship_train_launch.restype = ctypes.c_int
        lib.flagship_train_scratch_floats.argtypes = [ctypes.c_int] * 3
        lib.flagship_train_scratch_floats.restype = ctypes.c_long
        _train_lib = lib
    return _train_lib


def _train_operands(tensors, count, device, data_numel: int, latent_dim: int):
    """The ctypes array of the 42 operand pointers (params, exp_avg,
    exp_avg_sq), checked once and cached while the same tensors come back
    at the same addresses (checking ~45 tensors costs as much as the
    kernel)."""
    key = tuple(t.data_ptr() for t in tensors) + (count.data_ptr(),)
    hit = _train_cache.get("key")
    if hit is not None and hit[0] == key and all(a is b for a, b in zip(hit[1], tensors)) \
            and hit[2] is count:
        return _train_cache["ptrs"]
    _check_operands("flagship train kernel", tensors, device)
    for i, (t, shape) in enumerate(zip(tensors, _expected_shapes(data_numel, latent_dim) * 3)):
        if tuple(t.shape) != shape:
            raise ValueError(f"flagship train kernel: operand {i} must be {shape}, got {tuple(t.shape)}")
    if count.device != device or count.dtype != torch.int32 or count.dim() != 0:
        raise ValueError("flagship train kernel: count must be a 0-d int32 tensor on the device")
    _train_cache["key"] = (key, tuple(tensors), count)
    _train_cache["ptrs"] = (ctypes.c_void_p * len(tensors))(*key[:-1])
    return _train_cache["ptrs"]


def flagship_train_cuda(
    params: Sequence[torch.Tensor], m: Sequence[torch.Tensor], v: Sequence[torch.Tensor],
    x: torch.Tensor, eps: torch.Tensor, count: torch.Tensor, *, lr, c: float,
    beta: float, prior_scale: float, latent_dim: int, data_numel: int,
    b1: float = 0.9, b2: float = 0.999, adam_eps: float = 1e-8,
) -> torch.Tensor:
    """The CUDA kernel of one training step: x (B, data_numel), eps (B,
    latent_dim), the 14 parameters and their two moments (``params_tuple``
    order and layout) and ``count`` (0-d int32), all contiguous on one CUDA
    device. ``lr`` is a 0-d f32 tensor on that device, which the kernel
    reads when it runs (so a CUDA graph of the step follows what a
    controller writes there), or a number, staged into one. Updates params,
    moments and count in place, with no host sync, and returns metrics (4,)
    f32 = (loss_total, recon, kl, skipped)."""
    _check_batch("flagship train kernel", x, eps, latent_dim, data_numel, True)
    if not isinstance(lr, torch.Tensor):
        lr = _lr_tensor(lr, x.device)
    if lr.device != x.device or lr.dtype != torch.float32 or lr.dim() != 0:
        raise ValueError("flagship train kernel: lr must be a 0-d f32 tensor on the device")
    B = x.shape[0]
    if not len(params) == len(m) == len(v) == _N_PARAMS:
        raise ValueError("flagship train kernel: 14 parameters and 14 of each moment")
    ptrs = _train_operands((*params, *m, *v), count, x.device, data_numel, latent_dim)
    lib = _train_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # one scratch a stream: launches on two streams (a sweep's lanes) may
    # run at once, and the scratch holds a launch's gradient partial sums
    key = (x.device, stream, B, data_numel, latent_dim)
    scratch = _train_scratch.get(key)
    if scratch is None:
        n = lib.flagship_train_scratch_floats(B, data_numel, latent_dim)
        # zeroed once: it holds the gradient kernel's ticket counter, which
        # every launch leaves at 0
        scratch = _train_scratch[key] = torch.zeros(n, dtype=torch.float32, device=x.device)
    out = torch.empty(4, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.flagship_train_launch(
            x.data_ptr(), eps.data_ptr(), ptrs, count.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), B, data_numel, latent_dim, float(c), float(beta),
            float(prior_scale), lr.data_ptr(), float(b1), float(b2), float(adam_eps), stream)
    if err != 0:
        raise RuntimeError(f"flagship train kernel launch failed: cudaError {err}")
    train_launches.add()
    return out


def make_fused_train_step(model, b1: float = 0.9, b2: float = 0.999):
    """``fn(model, optimizer, batch, generator) -> {loss_total, recon_loss,
    kl_loss, skipped_steps}``, the whole training step of a supported model
    as one op (the Trainer's ``train_step_fn`` hook): forward, the gradient
    of the 14 parameters, the finite guard and the Riemannian Adam update
    of params and moments. eps (B, latent_dim) is drawn from ``generator``
    exactly as ``make_fused_loss_fn`` draws it; lr is the optimizer's. The
    optimizer must be a ``RiemannianAdam`` over the model's parameters in
    one group, with weight_decay 0, betas (b1, b2) and a ball of the
    model's curvature. CUDA tensors run the kernel, CPU tensors the plain
    version."""
    from hyperbolic_vae_tpu_torch.optim import RiemannianAdam

    if not supports_fused(model):
        raise ValueError("the fused path supports the flagship GyroplaneVAE (hidden dims (64, 16))")
    cfg = fused_config(model)

    def check(m, optimizer):
        if not isinstance(optimizer, RiemannianAdam) or len(optimizer.param_groups) != 1:
            raise ValueError("the fused train step needs a RiemannianAdam with one parameter group")
        group = optimizer.param_groups[0]
        if group["weight_decay"] != 0:
            raise ValueError("the fused train step has no weight decay (weight_decay must be 0)")
        if tuple(group["betas"]) != (b1, b2):
            raise ValueError(f"the optimizer's betas {tuple(group['betas'])} are not ({b1}, {b2})")
        if optimizer.ball.c != cfg["c"]:
            raise ValueError(f"the optimizer's ball has c = {optimizer.ball.c}, the model {cfg['c']}")
        if len(group["params"]) != _N_PARAMS or not all(
                a is b for a, b in zip(group["params"], m.parameters())):
            raise ValueError("the optimizer must hold the model's parameters")
        return group

    @torch.no_grad()
    def step(m, optimizer, batch, generator: Optional[torch.Generator] = None) -> dict:
        group = check(m, optimizer)
        params = params_tuple(m)
        mom, vel = zip(*(optimizer.moments(p) for p in params))
        eps = torch.randn((batch.shape[0], cfg["latent_dim"]), generator=generator,
                          device=batch.device, dtype=torch.float32)
        xf = batch.reshape(batch.shape[0], -1).float().contiguous()
        hyper = dict(lr=group["lr"], b1=b1, b2=b2, adam_eps=group["eps"], **cfg)
        if xf.is_cuda:
            out = flagship_train_cuda(params, mom, vel, xf, eps, optimizer.count, **hyper)
        elif xf.device.type == "cpu":
            new_p, new_m, new_v, out, count = flagship_train_step_torch(
                params, mom, vel, xf, eps, count=optimizer.count, **hyper)
            for dst, src in zip((*params, *mom, *vel), (*new_p, *new_m, *new_v)):
                dst.copy_(src)
            optimizer.count.copy_(count)
        else:
            raise ValueError(f"fused train step: no path for device {xf.device}")
        return {"loss_total": out[0], "recon_loss": out[1], "kl_loss": out[2],
                "skipped_steps": out[3]}

    return step
