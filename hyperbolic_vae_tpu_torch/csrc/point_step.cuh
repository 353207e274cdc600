// The Riemannian Adam step of one point on the Poincare ball, shared by K3
// (flagship_train.cu: the gyroplane points, computed in its gradient kernel)
// and the port's Riemannian Adam (riemannian_adam.cu: every ManifoldParameter
// row). Built with -fmad=false, as both sources are.

#pragma once

#include "flagship_common.cuh"

namespace flagship {

// Adam's scalars of the step: lr (read from device memory by the caller),
// betas, 1 - betas and eps, each rounded to f32
struct AdamScalars {
  float lr, b1, omb1, b2, omb2, eps;
};

// The step's ten vectors of a point: arrays of N in the thread (K3, rows of
// at most kMaxLatent), or rows of any width L in device scratch (PointRows)
template <int N>
struct PointVecs {
  float p[N], nm[N], uu[N], second[N], np[N], neg_p[N], t1[N], t2[N], t3[N], gyr[N];
};

constexpr int kPointVecs = 10;  // vectors of a point's step

struct PointRows {
  float *p, *nm, *uu, *second, *np, *neg_p, *t1, *t2, *t3, *gyr;
  // w: kPointVecs * L floats of scratch
  __device__ PointRows(float* w, int L)
      : p(w), nm(w + L), uu(w + 2 * L), second(w + 3 * L), np(w + 4 * L), neg_p(w + 5 * L),
        t1(w + 6 * L), t2(w + 7 * L), t3(w + 8 * L), gyr(w + 9 * L) {}
};

// The Riemannian Adam step of one gyroplane point (p, m, v, its gradient g;
// L each) with bias corrections bc1, bc2 -> new p, m, v: g / lambda^2, the
// expmap retraction, projection, exp_avg transported by gyr[new_p, -p].
// w holds the step's vectors; nm_out and nv_out may be mp and vp.
template <class W>
__device__ void point_step(const float* pp, const float* mp, const float* vp, const float* gp,
                           int L, const AdamScalars& f, float bc1, float bc2, const Consts& k,
                           W& w, float* np_out, float* nm_out, float* nv_out) {
  Mob ms;
  float p2 = 0.0f;
  for (int l = 0; l < L; ++l) {
    w.p[l] = pp[l];
    p2 += w.p[l] * w.p[l];
  }
  const float lam = 2.0f / maxn(1.0f - k.c * p2, kMinNorm);
  const float lr = f.lr;
  float su = 0.0f;
  for (int l = 0; l < L; ++l) {
    const float g_r = gp[l] / (lam * lam);
    w.nm[l] = f.b1 * mp[l] + f.omb1 * g_r;
    const float nv = f.b2 * vp[l] + f.omb2 * (lam * lam) * g_r * g_r;
    nv_out[l] = nv;
    const float dir = (w.nm[l] / bc1) / (sqrtf(nv / bc2) + f.eps);
    w.uu[l] = -lr * dir;
    su += w.uu[l] * w.uu[l];
  }
  const float u_n = sqrtf(maxn(su, kMinNorm2));
  const float tu = tanh_c(k.sqrt_c * lam * u_n / 2.0f);
  for (int l = 0; l < L; ++l) w.second[l] = tu * w.uu[l] / (k.sqrt_c * u_n);
  mob_fwd(w.p, w.second, w.np, L, k, ms);
  float s2 = 0.0f;
  for (int l = 0; l < L; ++l) s2 += w.np[l] * w.np[l];
  const float fac = minn(k.max_norm / sqrtf(maxn(s2, kMinNorm2)), 1.0f);
  float np2 = 0.0f;
  for (int l = 0; l < L; ++l) {
    w.np[l] = w.np[l] * fac;
    np2 += w.np[l] * w.np[l];
    w.neg_p[l] = -w.p[l];
  }
  // gyr[new_p, -p] m = -(new_p (+) -p) (+) (new_p (+) (-p (+) m))
  mob_fwd(w.np, w.neg_p, w.t1, L, k, ms);
  for (int l = 0; l < L; ++l) w.t1[l] = -w.t1[l];
  mob_fwd(w.neg_p, w.nm, w.t2, L, k, ms);
  mob_fwd(w.np, w.t2, w.t3, L, k, ms);
  mob_fwd(w.t1, w.t3, w.gyr, L, k, ms);
  const float lam_new = 2.0f / maxn(1.0f - k.c * np2, kMinNorm);
  for (int l = 0; l < L; ++l) {
    np_out[l] = w.np[l];
    nm_out[l] = w.gyr[l] * lam / lam_new;
  }
}

}  // namespace flagship
