// Multistart projected-Newton acquisition solve, one tiny GP per lane.
//
// Replaces the TPU kernel rollout_bo_tpu/ops/pallas_newton.py::
// newton_solve_lanes (body _make_kernel). Per lane (one restart x MC
// trajectory of the rollout) and per start, it runs `iterations` steps of:
// posterior mu / sigma with gradients and Hessians from W = K^{-1}; the
// decision rule's value and five partials; the active-set reduction at the
// box faces; a Gershgorin-damped Newton direction from two Cholesky
// solves; backtracking over 2 directions x 9 steps. Then the best start
// per lane wins (first start on a tie, non-finite values count as -inf).
//
// What bounds it on an H100: per-lane scalar floating-point work. At the
// bench shape (1600 lanes, capacity 24, d 10, 10 starts, 10 iterations)
// one launch does about 5 GFLOP over only ~5 MB of lane state, with
// branches and small dense solves that no tensor core takes. The design
// follows from that:
// - one thread per (lane, start), so every Newton step is sequential
//   scalar code in one thread and the parallelism is lanes x starts;
// - a block holds a few lanes x S starts; each lane's X, W and c are
//   staged once in shared memory and its S threads read them there (the
//   TPU kept them resident in VMEM for the same reason);
// - per-thread scratch rows (k(x, X), psi'/rho, b, K^{-1} k) live in shared
//   memory in thread-fastest order, so a warp's accesses do not conflict;
// - d x d matrices (Hessian, Cholesky factor) are per-thread arrays and
//   may spill to local memory; loops over the data run to the lane's
//   active count n, not the capacity (padding contributes exact zeros).
// d and the capacity are runtime values (d <= MAX_D); kind, rule and the
// loose freeze are runtime switches uniform across a launch, so the build
// is one instantiation per dtype. The math mirrors the plain PyTorch
// version in rollout_bo_tpu_torch/ops/newton_lanes.py and the closed-form
// rules in rollout_bo_tpu_torch/models/decision_rules.py.
//
// Built by rollout_bo_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound through the plain C entry points at the bottom (ctypes).

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>

#define MAX_D 16

namespace {

enum Kind { MATERN52 = 0, MATERN32 = 1, MATERN12 = 2, SQEXP = 3, PERIODIC = 4 };
enum Rule { EI = 0, POI = 1, LCB = 2, LOGEI = 3, LOGPOI = 4 };

constexpr double kEps = 1e-14;
constexpr double kZClamp = 30.0;
constexpr double kInvSqrt2Pi = 0.3989422804014327;
constexpr double kHalfLog2Pi = 0.9189385332046727;
constexpr double kPi = 3.141592653589793;
constexpr int kBacktrack = 9;

__constant__ double kCCoef[13] = {
    7.357126067616959e-05, -0.003030332555429463, -0.9460333971085013,
    -0.5452875891075231,   5.917213284650515,     -13.330680039626309,
    16.136072259524276,    -9.091448506887286,    -3.269217078293205,
    10.285783857545367,    -8.302420084484648,    3.252465210828019,
    -0.5255742944808028};
__constant__ double kQCoef[13] = {
    0.0003553685708074239, -0.015378764422016716, -2.7095052943101523,
    -3.149139485836574,    31.99608533256913,     -93.6622237838578,
    170.23164452827305,    -214.17068623084106,   190.2244261160476,
    -117.22290850693899,   47.60922667911587,     -11.413227140771019,
    1.2151486419508726};

// ---- precision-overloaded math ---------------------------------------------
__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_exp(double x) { return exp(x); }
__device__ __forceinline__ float m_log(float x) { return logf(x); }
__device__ __forceinline__ double m_log(double x) { return log(x); }
__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float m_sin(float x) { return sinf(x); }
__device__ __forceinline__ double m_sin(double x) { return sin(x); }
__device__ __forceinline__ float m_cos(float x) { return cosf(x); }
__device__ __forceinline__ double m_cos(double x) { return cos(x); }
__device__ __forceinline__ float m_expm1(float x) { return expm1f(x); }
__device__ __forceinline__ double m_expm1(double x) { return expm1(x); }
__device__ __forceinline__ float m_log1p(float x) { return log1pf(x); }
__device__ __forceinline__ double m_log1p(double x) { return log1p(x); }
__device__ __forceinline__ float m_cdf(float x) { return normcdff(x); }
__device__ __forceinline__ double m_cdf(double x) { return normcdf(x); }
__device__ __forceinline__ float m_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double m_abs(double x) { return fabs(x); }
// false for +-inf and NaN (every comparison with NaN is false)
__device__ __forceinline__ bool m_finite(float x) { return fabsf(x) <= FLT_MAX; }
__device__ __forceinline__ bool m_finite(double x) { return fabs(x) <= DBL_MAX; }

template <typename T> struct Lim;
template <> struct Lim<float> {
  __device__ static float max() { return FLT_MAX; }
  __device__ static float tiny() { return FLT_MIN; }
};
template <> struct Lim<double> {
  __device__ static double max() { return DBL_MAX; }
  __device__ static double tiny() { return DBL_MIN; }
};

// maximum / minimum that propagate NaN, like torch.clamp and jnp.maximum
template <typename T> __device__ __forceinline__ T jmax(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
template <typename T> __device__ __forceinline__ T jmin(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}
template <typename T> __device__ __forceinline__ T clip(T v, T lo, T hi) {
  return jmin(jmax(v, lo), hi);
}
template <typename T> __device__ __forceinline__ T neg_inf() {
  return -static_cast<T>(INFINITY);
}
template <typename T> __device__ __forceinline__ T finite_or_neg_inf(T v) {
  return m_finite(v) ? v : neg_inf<T>();
}

// ---- radial profiles: psi, a = psi'/rho, b = (psi'' - a)/rho^2, iso -----------
template <typename T>
__device__ void profile_terms(int kind, T rho, T sq, T ell, T period, T& psi,
                              T& a, T& b, T& iso) {
  const bool pos = rho > T(kEps);
  if (kind == PERIODIC) {
    const T c1 = T(2) / (ell * ell);
    const T w = T(kPi) / period;
    const T u = w * rho;
    const T su = m_sin(u);
    psi = m_exp(-c1 * su * su);
    const T s2u = m_sin(T(2) * u);
    const T dpsi = -c1 * w * s2u * psi;
    const T d2psi = (T(-2) * c1 * w * w * m_cos(T(2) * u) + c1 * c1 * w * w * s2u * s2u) * psi;
    const T safe = pos ? rho : T(1);
    a = pos ? dpsi / safe : T(0);
    b = pos ? (d2psi - a) / (safe * safe) : T(0);
    iso = pos ? a : T(-2) * c1 * w * w;
  } else if (kind == MATERN52) {
    const T c = m_sqrt(T(5)) / ell;
    const T s = c * rho;
    const T e = m_exp(-s);
    psi = (T(1) + s * (T(1) + s / T(3))) * e;
    const T apos = -(c * c / T(3)) * (T(1) + s) * e;
    a = pos ? apos : T(0);
    b = pos ? (c * c * c * c / T(3)) * e : T(0);
    iso = apos;
  } else if (kind == MATERN32) {
    const T c = m_sqrt(T(3)) / ell;
    const T s = c * rho;
    const T e = m_exp(-s);
    psi = (T(1) + s) * e;
    const T apos = -c * c * e;
    const T safe = pos ? s : T(1);
    a = pos ? apos : T(0);
    b = pos ? c * c * c * c * e / safe : T(0);
    iso = pos ? apos : -c * c;
  } else if (kind == MATERN12) {
    const T c = T(1) / ell;
    const T e = m_exp(-c * rho);
    psi = e;
    const T safe = pos ? rho : T(1);
    a = pos ? -c * e / safe : T(0);
    b = pos ? (c * c * e - a) / (pos ? sq : T(1)) : T(0);
    iso = pos ? a : c * c;
  } else {  // SQEXP
    const T l2 = ell * ell;
    psi = m_exp(-sq / (T(2) * l2));
    a = -psi / l2;
    b = psi / (l2 * l2);
    iso = a;
  }
}

template <typename T>
__device__ __forceinline__ T profile_psi(int kind, T rho, T sq, T ell, T period) {
  T psi, a, b, iso;
  profile_terms(kind, rho, sq, ell, period, psi, a, b, iso);
  return psi;
}

// ---- decision rules (models/decision_rules.py) ------------------------------
template <typename T> __device__ __forceinline__ T npdf(T z) {
  return T(kInvSqrt2Pi) * m_exp(T(-0.5) * z * z);
}

template <typename T> __device__ T poly(T t, const double* coef) {
  T acc = T(coef[12]);
  for (int i = 11; i >= 0; --i) acc = acc * t + T(coef[i]);
  return acc;
}

template <typename T> __device__ T mills_c(T t) {
  const T t2 = t * t;
  if (t > T(0.1)) return poly(t, kCCoef);
  return m_log1p(t2 * (T(-1) + t2 * (T(3) + t2 * (T(-15) + t2 * T(105)))));
}

template <typename T> __device__ T mills_q(T t) {
  const T t2 = t * t;
  if (t > T(0.1)) return poly(t, kQCoef);
  return m_log1p(t2 * (T(-3) + t2 * (T(15) + t2 * (T(-105) + t2 * T(945)))));
}

template <typename T>
__device__ T rule_value(int rule, T mu, T sigma, T th, T fm, T stol) {
  if (rule == LCB) return th * sigma - mu;
  const T s = jmax(sigma, stol);
  const T imp = fm - mu - th;
  if (rule == EI || rule == POI) {
    const T z = clip(imp / s, T(-kZClamp), T(kZClamp));
    const T val = rule == EI ? imp * m_cdf(z) + s * npdf(z) : m_cdf(z);
    return sigma < stol ? T(0) : val;
  }
  const T z = imp / s;
  const T nz = jmax(-z, T(1));
  const T t = T(1) / nz;
  const T log_phi = T(-0.5) * z * z - T(kHalfLog2Pi);
  if (rule == LOGPOI) {
    const T val = z >= T(-1) ? m_log(jmax(m_cdf(z), T(1e-30)))
                             : log_phi - m_log(nz) + mills_c(t);
    return sigma < stol ? T(-0.25) * Lim<T>::max() : val;
  }
  const T zs = jmax(z, T(-1));
  const T g = zs * m_cdf(zs) + npdf(zs);
  const T lg = z >= T(-1) ? m_log(jmax(g, Lim<T>::tiny()))
                          : log_phi + T(2) * m_log(t) + mills_q(t);
  return m_log(s) + lg;
}

// (gmu, gsig, gmumu, gsigsig, gmusig) with the masks of jax.grad
template <typename T>
__device__ void rule_partials(int rule, T mu, T sigma, T th, T fm, T stol, T* out) {
  if (rule == LCB) {
    out[0] = T(-1); out[1] = th; out[2] = T(0); out[3] = T(0); out[4] = T(0);
    return;
  }
  const T s = jmax(sigma, stol);
  const T s2 = s * s;
  const T dsig = sigma > stol ? T(1) : T(0);
  const T guard = sigma >= stol ? T(1) : T(0);
  const T zraw = (fm - mu - th) / s;
  if (rule == EI || rule == POI) {
    const T z = clip(zraw, T(-kZClamp), T(kZClamp));
    const T live = m_abs(zraw) < T(kZClamp) ? T(1) : T(0);
    const T phi = npdf(z);
    if (rule == EI) {
      out[0] = -m_cdf(z);
      out[1] = phi * dsig;
      out[2] = live * phi / s;
      out[3] = live * z * z * phi / s * dsig * dsig;
      out[4] = live * z * phi / s * dsig;
    } else {
      out[0] = -live * phi / s;
      out[1] = -live * z * phi / s * dsig;
      out[2] = -live * z * phi / s2;
      out[3] = live * z * (T(2) - z * z) * phi / s2 * dsig * dsig;
      out[4] = live * (T(1) - z * z) * phi / s2 * dsig;
    }
    for (int i = 0; i < 5; ++i) out[i] *= guard;
    return;
  }
  const T z = zraw;
  const bool direct = z >= T(-1);
  const T nz = jmax(-z, T(1));
  const T t = T(1) / nz;
  const T c = mills_c(t);
  if (rule == LOGPOI) {
    const T r = direct ? npdf(z) / jmax(m_cdf(z), T(1e-30)) : nz * m_exp(-c);
    const T rp = direct ? -z * r - r * r : r * z * m_expm1(-c);
    out[0] = -r / s;
    out[1] = -z * r / s * dsig;
    out[2] = rp / s2;
    out[3] = (T(2) * z * r + z * z * rp) / s2 * dsig * dsig;
    out[4] = (z * rp + r) / s2 * dsig;
    for (int i = 0; i < 5; ++i) out[i] *= guard;
    return;
  }
  // LOGEI
  T u, up;
  if (direct) {
    const T zs = jmax(z, T(-1));
    const T gd = jmax(zs * m_cdf(zs) + npdf(zs), T(1e-30));
    const T ud = m_cdf(zs) / gd;
    const T wd = npdf(zs) / gd;
    u = ud;
    up = wd - ud * ud;
  } else {
    const T q = mills_q(t);
    u = m_exp(c - q) / t;
    up = -m_exp(-q) / (t * t) * m_expm1(T(2) * c - q);
  }
  out[0] = -u / s;
  out[1] = (T(1) - z * u) / s * dsig;
  out[2] = up / s2;
  out[3] = (T(2) * z * u + z * z * up - T(1)) / s2 * dsig * dsig;
  out[4] = (z * up + u) / s2 * dsig;
}

// ---- one lane, one start ---------------------------------------------------------
template <typename T> struct LaneCtx {
  const T* X;   // (cap, d) in shared memory
  const T* W;   // (cap, cap) in shared memory
  const T* c;   // (cap,) in shared memory
  T* kx;        // per-thread scratch rows, element j at [j * stride]
  T* av;
  T* bv;
  T* wv;
  int stride;
  int n, cap, d, kind, rule;
  T ell, period, k0, iso0, fm, th, stol, sfloor;
};

// mu, sigma at x (the backtracking candidates' value path)
template <typename T> __device__ T lane_value(const LaneCtx<T>& L, const T* x) {
  const int d = L.d;
  T mu = T(0);
  for (int j = 0; j < L.n; ++j) {
    const T* Xj = L.X + j * d;
    T sq = T(0);
    for (int k = 0; k < d; ++k) {
      const T r = x[k] - Xj[k];
      sq += r * r;
    }
    const T psi = profile_psi(L.kind, m_sqrt(jmax(sq, T(0))), sq, L.ell, L.period);
    L.kx[j * L.stride] = psi;
    mu += psi * L.c[j];
  }
  T quad = T(0);
  for (int j = 0; j < L.n; ++j) {
    const T* Wj = L.W + j * L.cap;
    T wj = T(0);
    for (int l = 0; l < L.n; ++l) wj += Wj[l] * L.kx[l * L.stride];
    quad += L.kx[j * L.stride] * wj;
  }
  const T var = jmax(L.k0 - quad, L.sfloor * L.sfloor);
  return rule_value(L.rule, mu, m_sqrt(var), L.th, L.fm, L.stol);
}

// Solve (A + tau I) p = g by Cholesky; NaN entries when not PD.
template <typename T>
__device__ bool chol_solve(const T* A, T tau, const T* g, int d, T* Lc, T* p) {
  for (int j = 0; j < d; ++j) {
    T s = A[j * d + j] + tau;
    for (int k = 0; k < j; ++k) s -= Lc[j * d + k] * Lc[j * d + k];
    Lc[j * d + j] = m_sqrt(s);
    const T inv = T(1) / Lc[j * d + j];
    for (int i = j + 1; i < d; ++i) {
      T t = A[i * d + j];
      for (int k = 0; k < j; ++k) t -= Lc[i * d + k] * Lc[j * d + k];
      Lc[i * d + j] = t * inv;
    }
  }
  T z[MAX_D];
  for (int i = 0; i < d; ++i) {
    T acc = g[i];
    for (int k = 0; k < i; ++k) acc -= Lc[i * d + k] * z[k];
    z[i] = acc / Lc[i * d + i];
  }
  bool finite = true;
  T dot = T(0);
  for (int i = d - 1; i >= 0; --i) {
    T acc = z[i];
    for (int k = i + 1; k < d; ++k) acc -= Lc[k * d + i] * p[k];
    p[i] = acc / Lc[i * d + i];
  }
  for (int i = 0; i < d; ++i) {
    finite = finite && m_finite(p[i]);
    dot += p[i] * g[i];
  }
  return finite && dot > T(0);
}

// One projected-Newton iteration from x; writes the next point to xn and
// returns the current value a0 (non-finite -> -inf) and the best value.
template <typename T>
__device__ void lane_iteration(const LaneCtx<T>& L, const T* x, const T* lb,
                               const T* ub, T scale, T ridge, T* xn, T& a0,
                               T& vbest) {
  const int d = L.d;
  T gm[MAX_D], gs[MAX_D], r[MAX_D], u[MAX_D];
  T H[MAX_D * MAX_D];
  for (int k = 0; k < d; ++k) gm[k] = gs[k] = T(0);

  // pass 1: k(x, X), psi'/rho, b; mu and grad mu; iso . c
  T mu = T(0), iso_c = T(0);
  for (int j = 0; j < L.n; ++j) {
    const T* Xj = L.X + j * d;
    T sq = T(0);
    for (int k = 0; k < d; ++k) {
      r[k] = x[k] - Xj[k];
      sq += r[k] * r[k];
    }
    const T rho = m_sqrt(jmax(sq, T(0)));
    T psi, a, b, iso;
    profile_terms(L.kind, rho, sq, L.ell, L.period, psi, a, b, iso);
    L.kx[j * L.stride] = psi;
    L.av[j * L.stride] = a;
    L.bv[j * L.stride] = b;
    const T cj = L.c[j];
    mu += psi * cj;
    for (int k = 0; k < d; ++k) gm[k] += a * cj * r[k];
    iso_c += cj * (rho > T(kEps) ? a : iso);
  }
  // pass 2: w = K^{-1} k(x, X); variance
  T quad = T(0);
  for (int j = 0; j < L.n; ++j) {
    const T* Wj = L.W + j * L.cap;
    T wj = T(0);
    for (int l = 0; l < L.n; ++l) wj += Wj[l] * L.kx[l * L.stride];
    L.wv[j * L.stride] = wj;
    quad += L.kx[j * L.stride] * wj;
  }
  const T var = jmax(L.k0 - quad, L.sfloor * L.sfloor);
  const T sigma = m_sqrt(var);
  const T ssafe = jmax(sigma, L.sfloor);
  // pass 3: grad sigma, iso . w
  T iso_w = T(0);
  for (int j = 0; j < L.n; ++j) {
    const T* Xj = L.X + j * d;
    const T aj = L.av[j * L.stride], wj = L.wv[j * L.stride];
    T sq = T(0);
    for (int k = 0; k < d; ++k) {
      const T rk = x[k] - Xj[k];
      sq += rk * rk;
      gs[k] += aj * wj * rk;
    }
    iso_w += wj * (m_sqrt(jmax(sq, T(0))) > T(kEps) ? aj : L.iso0);
  }
  for (int k = 0; k < d; ++k) gs[k] = -gs[k] / ssafe;

  a0 = rule_value(L.rule, mu, sigma, L.th, L.fm, L.stol);
  T pr[5];
  rule_partials(L.rule, mu, sigma, L.th, L.fm, L.stol, pr);
  const T gmu = pr[0], gsig = pr[1], gmumu = pr[2], gsigsig = pr[3], gmusig = pr[4];
  const T hs = gsig / ssafe;  // gsig * hess_sigma = hs * (ssafe * hess_sigma)

  // H = gmumu gm gm' + gmu Hmu + gsigsig gs gs' + gsig Hsig + gmusig (gm gs' + gs gm')
  // with Hmu = iso_c I + sum_j c_j b_j r_j r_j' and
  // ssafe Hsig = -gs gs' - G' W G - sum_j w_j b_j r_j r_j' - iso_w I, G_j = a_j r_j
  for (int i = 0; i < d; ++i) {
    for (int k = 0; k < d; ++k) {
      H[i * d + k] = gmumu * gm[i] * gm[k] + gsigsig * gs[i] * gs[k] +
                     gmusig * (gm[i] * gs[k] + gs[i] * gm[k]) - hs * gs[i] * gs[k];
    }
    H[i * d + i] += gmu * iso_c - hs * iso_w;
  }
  for (int j = 0; j < L.n; ++j) {
    const T* Xj = L.X + j * d;
    for (int k = 0; k < d; ++k) {
      r[k] = x[k] - Xj[k];
      u[k] = T(0);
    }
    const T* Wj = L.W + j * L.cap;
    for (int l = 0; l < L.n; ++l) {
      const T wa = Wj[l] * L.av[l * L.stride];
      const T* Xl = L.X + l * d;
      for (int k = 0; k < d; ++k) u[k] += wa * (x[k] - Xl[k]);
    }
    const T bj = L.bv[j * L.stride];
    const T coef = gmu * L.c[j] * bj - hs * L.wv[j * L.stride] * bj;
    const T ga = -hs * L.av[j * L.stride];
    for (int i = 0; i < d; ++i) {
      const T ci = coef * r[i], gi = ga * r[i];
      for (int k = 0; k < d; ++k) H[i * d + k] += ci * r[k] + gi * u[k];
    }
  }

  // active-set reduction at the box faces; A = -Hf overwrites H
  const T btol = T(1e-9) * scale;
  T g[MAX_D], fr[MAX_D], gf[MAX_D];
  for (int k = 0; k < d; ++k) {
    g[k] = gmu * gm[k] + gsig * gs[k];
    const bool lo = (x[k] <= lb[k] + btol) && (g[k] < T(0));
    const bool hi = (x[k] >= ub[k] - btol) && (g[k] > T(0));
    fr[k] = (lo || hi) ? T(0) : T(1);
    gf[k] = g[k] * fr[k];
  }
  T* A = H;
  for (int i = 0; i < d; ++i)
    for (int k = 0; k < d; ++k)
      A[i * d + k] = -(H[i * d + k] * fr[i] * fr[k] - (i == k ? T(1) - fr[i] : T(0)));

  // Gershgorin-damped Newton direction
  T dmax = neg_inf<T>(), offmax = neg_inf<T>();
  for (int i = 0; i < d; ++i) {
    const T aii = A[i * d + i];
    dmax = jmax(dmax, m_abs(aii));
    T row = T(0);
    for (int k = 0; k < d; ++k) row += m_abs(A[i * d + k]);
    offmax = jmax(offmax, row - m_abs(aii) - aii);
  }
  const T s_scale = jmax(dmax, ridge);
  const T tau_g = jmax(offmax, T(0)) + ridge + T(1e-6) * s_scale;
  T Lc[MAX_D * MAX_D], p[MAX_D], p2[MAX_D];
  if (!chol_solve(A, ridge, gf, d, Lc, p)) {
    if (chol_solve(A, tau_g, gf, d, Lc, p2)) {
      for (int k = 0; k < d; ++k) p[k] = p2[k];
    } else {
      for (int k = 0; k < d; ++k) p[k] = gf[k] / s_scale;
    }
  }
  T gnorm2 = T(0), pg = T(0);
  bool finite = true;
  for (int k = 0; k < d; ++k) {
    p[k] *= fr[k];
    finite = finite && m_finite(p[k]);
    pg += p[k] * gf[k];
    gnorm2 += gf[k] * gf[k];
  }
  const bool bad = !finite || pg <= T(0);
  const T gden = jmax(m_sqrt(gnorm2), T(1e-12));
  T gstep[MAX_D];
  for (int k = 0; k < d; ++k) gstep[k] = gf[k] / gden * (T(0.1) * scale);
  T pn2 = T(0);
  for (int k = 0; k < d; ++k) {
    if (bad) p[k] = gstep[k];
    pn2 += p[k] * p[k];
  }
  const T shrink = jmin(T(1), scale / jmax(m_sqrt(pn2), T(1e-30)));
  for (int k = 0; k < d; ++k) p[k] *= shrink;

  // backtracking over both directions; strictly better only
  a0 = finite_or_neg_inf(a0);
  vbest = a0;
  for (int k = 0; k < d; ++k) xn[k] = x[k];
  T cand[MAX_D];
  for (int dir = 0; dir < 2; ++dir) {
    const T* dv = dir == 0 ? p : gstep;
    T t = T(1);
    for (int step = 0; step < kBacktrack; ++step, t *= T(0.5)) {
      for (int k = 0; k < d; ++k) cand[k] = clip(x[k] + t * dv[k], lb[k], ub[k]);
      const T v = finite_or_neg_inf(lane_value(L, cand));
      if (v > vbest) {
        vbest = v;
        for (int k = 0; k < d; ++k) xn[k] = cand[k];
      }
    }
  }
}

template <typename T>
__global__ void newton_lanes_kernel(const T* __restrict__ X, const T* __restrict__ W,
                                    const T* __restrict__ c,
                                    const long long* __restrict__ n_lane,
                                    const T* __restrict__ fmini,
                                    const T* __restrict__ theta0,
                                    const T* __restrict__ params,
                                    const T* __restrict__ lbs, const T* __restrict__ ubs,
                                    const T* __restrict__ xstarts, T* __restrict__ xout,
                                    T* __restrict__ vout, int num_lanes, int cap, int d,
                                    int S, int iterations, int kind, int rule,
                                    int lanes_per_block, T stol, T sfloor, T ridge,
                                    T f_tol, T x_tol) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nth = blockDim.x;
  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * lanes_per_block;
  const int here = min(lanes_per_block, num_lanes - lane0);

  T* sX = reinterpret_cast<T*>(smem_raw);
  T* sW = sX + lanes_per_block * cap * d;
  T* sc = sW + lanes_per_block * cap * cap;
  T* scr = sc + lanes_per_block * cap;
  T* sres = scr + 4 * cap * nth;

  // stage this block's lanes (contiguous in device memory)
  for (int i = tid; i < here * cap * d; i += nth) sX[i] = X[(size_t)lane0 * cap * d + i];
  for (int i = tid; i < here * cap * cap; i += nth) sW[i] = W[(size_t)lane0 * cap * cap + i];
  for (int i = tid; i < here * cap; i += nth) sc[i] = c[(size_t)lane0 * cap + i];
  __syncthreads();

  const int ll = tid / S;
  const int s = tid % S;
  const int lane = lane0 + ll;
  const bool active = ll < here;
  if (active) {
    LaneCtx<T> L;
    L.X = sX + ll * cap * d;
    L.W = sW + ll * cap * cap;
    L.c = sc + ll * cap;
    L.kx = scr + tid;
    L.av = scr + cap * nth + tid;
    L.bv = scr + 2 * cap * nth + tid;
    L.wv = scr + 3 * cap * nth + tid;
    L.stride = nth;
    const long long nl = n_lane[lane];
    L.n = nl < 0 ? 0 : (nl > cap ? cap : static_cast<int>(nl));
    L.cap = cap;
    L.d = d;
    L.kind = kind;
    L.rule = rule;
    L.ell = params[0];
    L.period = params[1];
    T b0, a0_, iso0;
    profile_terms(kind, T(0), T(0), L.ell, L.period, L.k0, a0_, b0, iso0);
    L.iso0 = iso0;
    L.fm = fmini[lane];
    L.th = theta0[lane];
    L.stol = stol;
    L.sfloor = sfloor;

    T lb[MAX_D], ub[MAX_D], x[MAX_D], xn[MAX_D];
    T scale = neg_inf<T>();
    for (int k = 0; k < d; ++k) {
      lb[k] = lbs[k];
      ub[k] = ubs[k];
      scale = jmax(scale, ub[k] - lb[k]);
      x[k] = clip(xstarts[s * d + k], lb[k], ub[k]);
    }
    const bool loose = f_tol > T(0) || x_tol > T(0);
    for (int it = 0; it < iterations; ++it) {
      T a0, vbest;
      lane_iteration(L, x, lb, ub, scale, ridge, xn, a0, vbest);
      bool freeze = false;
      if (loose) {
        // IPNewton-style loose acceptance (reference rbf_optim.jl:26-30);
        // a frozen start keeps its point, so it may stop iterating
        const T improvement = jmax(vbest - a0, T(0));
        T dx2 = T(0);
        for (int k = 0; k < d; ++k) dx2 += (xn[k] - x[k]) * (xn[k] - x[k]);
        freeze = improvement <= f_tol * (m_abs(a0) + f_tol) || m_sqrt(dx2) <= x_tol;
      }
      for (int k = 0; k < d; ++k) x[k] = xn[k];
      if (freeze) break;
    }
    sres[tid] = finite_or_neg_inf(lane_value(L, x));
    for (int k = 0; k < d; ++k) sres[(1 + k) * nth + tid] = x[k];
  }
  __syncthreads();

  // best start per lane, in start order (first start wins a tie)
  if (active && s == 0) {
    T best = neg_inf<T>();
    int arg = -1;
    for (int j = 0; j < S; ++j) {
      const T v = sres[tid + j];
      if (v > best) {
        best = v;
        arg = j;
      }
    }
    for (int k = 0; k < d; ++k)
      xout[(size_t)lane * d + k] = arg < 0 ? T(0) : sres[(1 + k) * nth + tid + arg];
    vout[lane] = best;
  }
}

template <typename T>
int launch(const void* X, const void* W, const void* c, const void* n,
           const void* fmini, const void* theta0, const void* params,
           const void* lbs, const void* ubs, const void* xstarts, void* xout,
           void* vout, int num_lanes, int cap, int d, int S, int iterations,
           int kind, int rule, int lanes_per_block, double stol, double sfloor,
           double ridge, double f_tol, double x_tol, int smem, void* stream) {
  if (d < 1 || d > MAX_D || S < 1 || lanes_per_block < 1) return (int)cudaErrorInvalidValue;
  auto kernel = newton_lanes_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (num_lanes + lanes_per_block - 1) / lanes_per_block;
  kernel<<<blocks, lanes_per_block * S, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(X), static_cast<const T*>(W), static_cast<const T*>(c),
      static_cast<const long long*>(n), static_cast<const T*>(fmini),
      static_cast<const T*>(theta0), static_cast<const T*>(params),
      static_cast<const T*>(lbs), static_cast<const T*>(ubs),
      static_cast<const T*>(xstarts), static_cast<T*>(xout), static_cast<T*>(vout),
      num_lanes, cap, d, S, iterations, kind, rule, lanes_per_block, T(stol),
      T(sfloor), T(ridge), T(f_tol), T(x_tol));
  return (int)cudaGetLastError();
}

}  // namespace

#define NEWTON_LANES_ENTRY(NAME, T)                                                \
  extern "C" int NAME(const void* X, const void* W, const void* c, const void* n, \
                      const void* fmini, const void* theta0, const void* params,  \
                      const void* lbs, const void* ubs, const void* xstarts,      \
                      void* xout, void* vout, int num_lanes, int cap, int d,      \
                      int S, int iterations, int kind, int rule,                  \
                      int lanes_per_block, double stol, double sfloor,            \
                      double ridge, double f_tol, double x_tol, int smem,         \
                      void* stream) {                                             \
    return launch<T>(X, W, c, n, fmini, theta0, params, lbs, ubs, xstarts, xout,  \
                     vout, num_lanes, cap, d, S, iterations, kind, rule,          \
                     lanes_per_block, stol, sfloor, ridge, f_tol, x_tol, smem,    \
                     stream);                                                     \
  }

NEWTON_LANES_ENTRY(newton_lanes_f32, float)
NEWTON_LANES_ENTRY(newton_lanes_f64, double)
