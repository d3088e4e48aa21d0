// Multistart projected-Newton acquisition solve, one tiny GP per lane.
//
// Replaces the TPU kernel rollout_bo_tpu/ops/pallas_newton.py::
// newton_solve_lanes (body _make_kernel). Per lane (one restart x MC
// trajectory of the rollout) and per start, it runs `iterations` steps of:
// posterior mu / sigma with gradients and Hessians from the lane's matrix
// M (below); the decision rule's value and five partials; the active-set
// reduction at the box faces; a Gershgorin-damped Newton direction from two
// Cholesky solves; backtracking over 2 directions x 9 steps. Then the best
// start per lane wins (first start on a tie, non-finite values count as
// -inf).
//
// The form of the variance is fixed per instantiation (kLiForm), as the
// JAX package routes the two dtypes (rollout_bo_tpu/rollout/solvers.py:
// 40-64): float32 lanes to the TPU kernel, float64 lanes to its XLA solver.
// - float reads M = W = K^{-1} = Li^T Li, formed by the wrapper, and
//   computes the TPU kernel's k0 - k^T W k;
// - double reads M = Li = L^{-1}, the lower-triangular inverse of the
//   Cholesky factor that the surrogate state maintains (identity-padded,
//   zero above the diagonal), and computes k0 - |Li k|^2: v = Li k and
//   w = Li^T v = K^{-1} k as triangular products, the Hessian's data term
//   G^T K^{-1} G as the Gram P^T P of P = Li G, a candidate's variance as
//   k0 - |Li k_c|^2. It never forms or reads W, nor Li above its diagonal.
// The W form's rounding grows with cond(K), the Li form's with its square
// root. A step is accepted only when the value rises in floating point, so
// that rounding is the floor at which every argmax stops, and the rollout's
// fantasy draws carry it into its value: in float64 the Li form keeps that
// floor at the JAX package's, which the rollout's gradient checks need. In
// float32 the W form is the TPU kernel's own and the faster one at the
// bench shape.
//
// What bounds it on an H100: operations, not bytes. At the bench shape
// (1600 lanes, capacity 24, d 10, 10 starts, 10 iterations) one launch needs
// about 4.7 GFLOP of scalar floating-point work (ops/newton_lanes.py::
// lane_solve_work) over ~5.4 MB of lane state: ~0.07 ms at the card's 67
// TFLOP/s of float32 outside the tensor cores (float64: half that rate),
// against ~0.002 ms for the bytes. The work is 16,000 independent solves
// of ~29 kFLOP per Newton step, each a chain of
// small reductions, one or two d x d Cholesky solves and data-dependent branches.
// TMA, wgmma and thread-block clusters have no use here: no large tile is
// copied (a lane is a few KB, staged once by plain loads) and no product is
// large enough for a tensor core (the largest is n x n by n x d, n ~ 14).
//
// The design: a group of G cooperating threads (G = 32, one warp) owns one
// (lane, start), so the card sees lanes x starts warps instead of as many
// threads, and no thread holds a d x d array in local memory.
// - A block holds `lanes_per_block` lanes x `groups_per_lane` groups. Each
//   lane's X, M and c are staged once in shared memory, rows padded to an
//   odd stride so that threads on different rows hit different banks; a
//   group loops over the starts ws, ws + groups_per_lane, ... Li keeps W's
//   square layout and only its lower triangle is copied (the packed
//   triangle would halve its words and change the occupancy: left to its
//   own measurement). When one lane's M does not fit, it stays in device
//   memory (template kStageM).
// - Passes over the data (k(x, X), psi'/rho, b; w = W k, or v = Li k by rows
//   l <= j): thread t takes the rows t, t + G, ...; in the Li form w = Li^T
//   v follows by columns, thread t on column l0 + t of each 32-wide slice
//   over the rows j >= l. mu, the variance and the isotropic terms are
//   butterfly reductions by __shfl_xor_sync, a fixed tree, so a run repeats
//   bit for bit and every thread of the group holds the same sum.
// - Gradients: thread k < d owns component k of every d-vector (x, grad mu,
//   grad sigma, the free mask, the directions).
// - Hessian: the rows G_j = a_j r_j are stored once. W form: Q = coef r +
//   ga W G (n x d) is built with one (rows, column) strip per thread; then
//   each thread owns a few of the d (d + 1) / 2 symmetric entries and sums
//   r_j[i] Q_j[k] over the data. Li form: P = Li G by the same strips (row
//   j over l <= j), G's rows then take C_j = coef_j r_j, and each entry sums
//   r_j[i] C_j[k] and P_j[i] P_j[k]. No reduction, no read-modify-write.
// - Cholesky: thread i keeps row i of the factor in registers (loops
//   unrolled to MAX_D, every index a constant), right-looking, the column
//   of each step broadcast by shuffles; the forward solve broadcasts one
//   finished component per step, the backward one reads L' from a copy in
//   shared memory. Which solve is taken (ridge, Gershgorin shift, scaled
//   gradient) is uniform across the group.
// - Backtracking: the 18 candidates x n data rows are dealt to the threads
//   in tiles of 2 points x 2 rows, for k(x_c, X_j) and then for W k (or Li
//   k on the lower triangle); thread c sums candidate c's mu and variance
//   in data order. The winner is the
//   largest value strictly above the current one, the lowest candidate
//   index on a tie: what the sequential strict `>` loop selects.
// - Best start: each group keeps its best (value, start, x) in start order;
//   after a barrier the lane's first group picks the largest value, lowest
//   start on a tie.
// Shared memory per group (words of T, dp = d | 1): 5 cap rows + 2 cap x
// max(dp, 18) (G and Q, or G, C and P; reused for the candidates' k and
// W k or Li k columns) +
// 2 d dp (A and its factor) + 18 dp (candidates) + 7 dp (vectors) + dp + 2
// (result). At the bench shape that is 1,492 words: 5,968 B in float32, so a
// block of one lane x 10 groups (320 threads) takes 63,320 B with the lane's
// 3,640 B. float32 is held to 64 registers (__launch_bounds__), so three
// such blocks, 30 warps, are resident per SM (shared memory would allow
// three as well); float64 keeps 128 registers and one or two blocks.
// rollout_bo_tpu_torch/ops/newton_lanes.py::_block_shape computes the same
// layout and must match `GroupScratch` and the kernel's carve-up below.
//
// d and the capacity are runtime values (d <= MAX_D <= G); kind, rule and the
// loose freeze are runtime switches uniform across a launch. The math
// mirrors the plain PyTorch version in rollout_bo_tpu_torch/ops/
// newton_lanes.py and the closed-form rules in rollout_bo_tpu_torch/models/
// decision_rules.py.
//
// Built by rollout_bo_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound through the plain C entry points at the bottom (ctypes).
// -DNEWTON_LANES_PROFILE adds cycle counts per phase of an iteration, for
// scripts/ab_newton_lanes_cuda.py; the package builds without it.

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
constexpr int kBacktrack = 9;            // steps per direction
constexpr int kCand = 2 * kBacktrack;    // candidates per iteration
constexpr int kG = 32;                   // threads that share one (lane, start): a warp
constexpr int kMaxThreads = 512;         // per block; the wrapper sizes blocks within it
// Blocks of kMaxThreads that an SM must hold. 2 caps float32 at 64 registers,
// so that three 320-thread blocks (30 warps) are resident at the bench shape:
// measured faster than 80, 96 or 128 registers with fewer warps, spills and
// all. float64 keeps 128 registers; its shared memory allows one or two blocks.
template <typename T> constexpr int min_blocks() { return sizeof(T) == 4 ? 2 : 1; }
// The form of the variance per instantiation (see the top of this file):
// double reads Li, float reads W. ops/newton_lanes.py::_lane_matrix passes
// the matching matrix.
template <typename T> constexpr bool kLiForm = sizeof(T) == 8;
static_assert(MAX_D <= kG, "thread k of a group owns component k of a d-vector");

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
__device__ __forceinline__ float m_rsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double m_rsqrt(double x) { return 1.0 / sqrt(x); }
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

// psi alone (the backtracking candidates): the same expressions as above
template <typename T>
__device__ __forceinline__ T profile_psi(int kind, T rho, T sq, T ell, T period) {
  if (kind == PERIODIC) {
    const T su = m_sin(T(kPi) / period * rho);
    return m_exp(-(T(2) / (ell * ell)) * su * su);
  } else if (kind == MATERN52) {
    const T s = m_sqrt(T(5)) / ell * rho;
    return (T(1) + s * (T(1) + s / T(3))) * m_exp(-s);
  } else if (kind == MATERN32) {
    const T s = m_sqrt(T(3)) / ell * rho;
    return (T(1) + s) * m_exp(-s);
  } else if (kind == MATERN12) {
    return m_exp(-(T(1) / ell) * rho);
  }
  return m_exp(-sq / (T(2) * (ell * ell)));
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

#ifdef NEWTON_LANES_PROFILE
// cycles per phase of group_iteration, summed over every group's thread 0
__device__ unsigned long long g_phase_cycles[8];
#define PHASE_MARK(i)                                                   \
  do {                                                                  \
    const long long now_ = clock64();                                   \
    if (t == 0) atomicAdd(&g_phase_cycles[i], (unsigned long long)(now_ - mark_)); \
    mark_ = now_;                                                       \
  } while (0)
#define PHASE_START() long long mark_ = clock64()
#else
#define PHASE_MARK(i)
#define PHASE_START()
#endif

// ---- a group of kG threads: reductions with a fixed butterfly tree -------------
template <typename T> __device__ __forceinline__ T group_sum(unsigned m, T v) {
#pragma unroll
  for (int o = kG / 2; o > 0; o >>= 1) v += __shfl_xor_sync(m, v, o, kG);
  return v;
}
// NaN-propagating maximum, like the sequential jmax chain
template <typename T> __device__ __forceinline__ T group_max(unsigned m, T v) {
#pragma unroll
  for (int o = kG / 2; o > 0; o >>= 1) v = jmax(v, __shfl_xor_sync(m, v, o, kG));
  return v;
}
__device__ __forceinline__ int group_min(unsigned m, int v) {
#pragma unroll
  for (int o = kG / 2; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(m, v, o, kG));
  return v;
}

// ---- one lane and one group's scratch ----------------------------------------------
template <typename T> struct Lane {
  const T* X;  // (cap, dp) in shared memory
  const T* M;  // W or Li, rows at stride mst: shared memory (kStageM) or device memory
  const T* c;  // (cap,) in shared memory
  const T* lb;  // (d,) in shared memory
  const T* ub;
  int n, d, dp, mst, kind, rule;
  T ell, period, k0, fm, th, stol, sfloor;
};

// Offsets into one group's shared memory, in words of T; the Python
// _block_shape counts the same words.
template <typename T> struct GroupScratch {
  T* base;
  int cap, d, dp;
  __device__ __forceinline__ T* kx() const { return base; }  // k(x, X)
  __device__ __forceinline__ T* av() const { return base + cap; }  // psi'/rho (W form)
  __device__ __forceinline__ T* vv() const { return base + cap; }  // Li k (Li form)
  __device__ __forceinline__ T* bv() const { return base + 2 * cap; }
  __device__ __forceinline__ T* wv() const { return base + 3 * cap; }  // K^{-1} k
  __device__ __forceinline__ T* ia() const { return base + 4 * cap; }  // a, or iso at rho = 0
  __device__ __forceinline__ T* Gm() const { return base + 5 * cap; }  // (cap, dp) a_j r_j
  __device__ __forceinline__ T* Q() const { return Gm() + cap * dp; }  // (cap, dp)
  __device__ __forceinline__ T* P() const { return Q(); }  // (cap, dp) Li G (Li form)
  // after Q or P is spent, the candidates' k(x, X) and W k or Li k, (cap, kCand) each
  __device__ __forceinline__ T* kxc() const { return Gm(); }
  __device__ __forceinline__ T* wc() const { return Gm() + cap * kCand; }
  __device__ static int gq_words(int cap, int dp) {
    return cap * (dp > kCand ? 2 * dp : 2 * kCand);
  }
  __device__ __forceinline__ T* A() const { return Gm() + gq_words(cap, dp); }  // (d, dp)
  __device__ __forceinline__ T* Lc() const { return A() + d * dp; }  // (d, dp) its factor
  __device__ __forceinline__ T* cand() const { return Lc() + d * dp; }  // (kCand, dp)
  __device__ __forceinline__ T* vec(int i) const { return cand() + (kCand + i) * dp; }
  __device__ __forceinline__ T* xs() const { return vec(0); }  // current point
  __device__ __forceinline__ T* gm() const { return vec(1); }  // grad mu
  __device__ __forceinline__ T* gs() const { return vec(2); }  // grad sigma
  __device__ __forceinline__ T* fr() const { return vec(3); }  // free mask
  __device__ __forceinline__ T* gf() const { return vec(4); }  // free gradient
  __device__ __forceinline__ T* pv() const { return vec(5); }  // Newton direction
  __device__ __forceinline__ T* gv() const { return vec(6); }  // gradient step
  __device__ __forceinline__ T* res() const { return vec(7); }  // (dp + 2) best of the group
  __device__ static int words(int cap, int d, int dp) {
    return 5 * cap + gq_words(cap, dp) + 2 * d * dp + (kCand + 7) * dp + dp + 2;
  }
};

// The rule's value at kNc points x_c (rows of xc at stride dp), by the whole
// group; thread c gets the value of x_c, c + kG, ... in turn through `take`.
// k(x_c, X_j) and (W k)_j, or (Li k)_j, are computed in tiles of 2 points x
// 2 data rows per thread: four independent chains from four loads per step,
// and half the loads of one (point, row) pair per thread. In the Li form
// the rows of a tile are neighbours j0, j0 + 1, so that their sums over
// l <= j share one loop but for the last term. A tile at the ragged edge
// repeats its last valid row or point. Every sum runs over the data in
// order, as a single thread would.
template <int kNc, typename T, typename F>
__device__ __forceinline__ void candidate_values(const Lane<T>& L, const GroupScratch<T>& S,
                                                 const T* xc, int t, unsigned m, F take) {
  constexpr int kCp = (kNc + 1) / 2;  // point pairs
  const int d = L.d, n = L.n, dp = L.dp, mst = L.mst;
  const int ntiles = ((n + 1) / 2) * kCp;
  T* kxc = S.kxc();
  T* wc = S.wc();
  for (int q = t; q < ntiles; q += kG) {
    const int jp = q / kCp;
    const int c0 = 2 * (q - jp * kCp), c1 = min(c0 + 1, kNc - 1);
    const int j0 = 2 * jp, j1 = min(j0 + 1, n - 1);
    const T* xa = xc + c0 * dp;
    const T* xb = xc + c1 * dp;
    const T* Xa = L.X + j0 * dp;
    const T* Xb = L.X + j1 * dp;
    T saa = T(0), sab = T(0), sba = T(0), sbb = T(0);  // s<point><row>
    for (int k = 0; k < d; ++k) {
      const T xak = xa[k], xbk = xb[k], Xak = Xa[k], Xbk = Xb[k];
      const T raa = xak - Xak, rab = xak - Xbk, rba = xbk - Xak, rbb = xbk - Xbk;
      saa += raa * raa;
      sab += rab * rab;
      sba += rba * rba;
      sbb += rbb * rbb;
    }
    kxc[j0 * kNc + c0] = profile_psi(L.kind, m_sqrt(jmax(saa, T(0))), saa, L.ell, L.period);
    kxc[j1 * kNc + c0] = profile_psi(L.kind, m_sqrt(jmax(sab, T(0))), sab, L.ell, L.period);
    kxc[j0 * kNc + c1] = profile_psi(L.kind, m_sqrt(jmax(sba, T(0))), sba, L.ell, L.period);
    kxc[j1 * kNc + c1] = profile_psi(L.kind, m_sqrt(jmax(sbb, T(0))), sbb, L.ell, L.period);
  }
  __syncwarp(m);
  for (int q = t; q < ntiles; q += kG) {
    const int jp = q / kCp;
    const int c0 = 2 * (q - jp * kCp), c1 = min(c0 + 1, kNc - 1);
    const int j0 = 2 * jp, j1 = min(j0 + 1, n - 1);
    const T* Wa = L.M + j0 * mst;
    const T* Wb = L.M + j1 * mst;
    const T* ka = kxc + c0;
    const T* kb = kxc + c1;
    T waa = T(0), wab = T(0), wba = T(0), wbb = T(0);  // w<point><row>
    if constexpr (kLiForm<T>) {  // rows j0 and j1 of Li over l <= j
      for (int l = 0; l <= j0; ++l) {
        const T kal = ka[l * kNc], kbl = kb[l * kNc], Wal = Wa[l], Wbl = Wb[l];
        waa += Wal * kal;
        wab += Wbl * kal;
        wba += Wal * kbl;
        wbb += Wbl * kbl;
      }
      if (j1 > j0) {  // row j0 + 1's diagonal term
        const T Wbb = Wb[j1];
        wab += Wbb * ka[j1 * kNc];
        wbb += Wbb * kb[j1 * kNc];
      }
    } else {
      for (int l = 0; l < n; ++l) {
        const T kal = ka[l * kNc], kbl = kb[l * kNc], Wal = Wa[l], Wbl = Wb[l];
        waa += Wal * kal;
        wab += Wbl * kal;
        wba += Wal * kbl;
        wbb += Wbl * kbl;
      }
    }
    wc[j0 * kNc + c0] = waa;
    wc[j1 * kNc + c0] = wab;
    wc[j0 * kNc + c1] = wba;
    wc[j1 * kNc + c1] = wbb;
  }
  __syncwarp(m);
  for (int c = t; c < kNc; c += kG) {
    T mu = T(0), quad = T(0);
    for (int j = 0; j < n; ++j) {
      const T kj = kxc[j * kNc + c];
      mu += kj * L.c[j];
      if constexpr (kLiForm<T>) {
        const T vj = wc[j * kNc + c];
        quad += vj * vj;  // |Li k|^2
      } else {
        quad += kj * wc[j * kNc + c];  // k^T W k
      }
    }
    const T var = jmax(L.k0 - quad, L.sfloor * L.sfloor);
    take(c, finite_or_neg_inf(rule_value(L.rule, mu, m_sqrt(var), L.th, L.fm, L.stol)));
  }
}

// Solve (A + tau I) p = g by Cholesky, thread i on row i; g_t and p_t are
// thread t's components. False (on every thread) when the matrix is not
// positive definite or p is no ascent direction. Row t of the factor lives
// in registers (a[], every index a constant after unrolling to MAX_D).
// Right-looking: step j broadcasts column j by shuffles, four at a time
// with no branch between them so that they pipeline, and each thread
// updates its own row; the subtractions reach each entry in the order of
// the left-looking loop. Rows at and beyond d hold exact zeros. The forward
// solve broadcasts one finished component per step; the backward solve
// reads L' from the copy in shared memory (Lc, written once).
template <typename T>
__device__ __noinline__ bool chol_solve(const T* A, T tau, T g_t, int d, int dp, T* Lc, int t,
                                   unsigned m, T& p_t) {
  const bool row = t < d;
  T a[MAX_D];
#pragma unroll
  for (int k = 0; k < MAX_D; ++k)
    a[k] = (row && k <= t) ? A[t * dp + k] + (k == t ? tau : T(0)) : T(0);
  T inv_t = T(1);
#pragma unroll
  for (int j = 0; j < MAX_D; ++j) {
    if (j < d) {
      const T sj = __shfl_sync(m, a[j], j, kG);
      const T inv = m_rsqrt(sj);
      const T l = (row && t > j) ? a[j] * inv : (t == j ? sj * inv : T(0));  // L[t][j]
      if (t == j) inv_t = inv;
      a[j] = l;
#pragma unroll
      for (int k0 = 0; k0 < MAX_D; k0 += 4) {
        if (k0 + 3 > j && k0 < d) {
#pragma unroll
          for (int k = (k0 > j + 1 ? k0 : j + 1); k < k0 + 4; ++k)
            a[k] -= l * __shfl_sync(m, l, k, kG);  // L[t][j] L[k][j]; used where k <= t
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < MAX_D; ++k)
    if (row && k <= t) Lc[t * dp + k] = a[k];
  __syncwarp(m);
  T acc = row ? g_t : T(0);
  T z_t = T(0);
#pragma unroll
  for (int k = 0; k < MAX_D; ++k) {
    if (k < d) {
      const T zk = __shfl_sync(m, acc * inv_t, k, kG);
      if (t == k) z_t = zk;
      if (t > k) acc -= a[k] * zk;
    }
  }
  acc = z_t;
  p_t = T(0);
  for (int k = d - 1; k >= 0; --k) {
    const T pk = __shfl_sync(m, acc * inv_t, k, kG);
    if (t == k) p_t = pk;
    if (t < k) acc -= Lc[k * dp + t] * pk;
  }
  const bool finite = __all_sync(m, m_finite(p_t));
  const T dot = group_sum(m, p_t * g_t);
  __syncwarp(m);  // every read of Lc is done before it is written again
  return finite && dot > T(0);
}

// One projected-Newton iteration of the group's start from x (component t in
// x_t, all of it in S.xs()). Returns the next point's component t in xn_t,
// the current value a0 (non-finite -> -inf) and the best value; all three
// results of a reduction are the same on every thread.
template <typename T>
__device__ void group_iteration(const Lane<T>& L, const GroupScratch<T>& S, int t,
                                unsigned m, T x_t, T scale, T ridge, T& xn_t, T& a0,
                                T& vbest) {
  const int d = L.d, dp = L.dp, n = L.n;
  const bool comp = t < d;
  const T* xs = S.xs();

  PHASE_START();
  // pass 1: k(x, X), psi'/rho, b, G_j = a_j r_j; mu; iso . c
  T mu = T(0), iso_c = T(0);
  for (int j = t; j < n; j += kG) {
    const T* Xj = L.X + j * dp;
    T sq = T(0);
    for (int k = 0; k < d; ++k) {
      const T r = xs[k] - Xj[k];
      sq += r * r;
    }
    const T rho = m_sqrt(jmax(sq, T(0)));
    T psi, a, b, iso;
    profile_terms(L.kind, rho, sq, L.ell, L.period, psi, a, b, iso);
    const T ia = rho > T(kEps) ? a : iso;
    S.kx()[j] = psi;
    if constexpr (!kLiForm<T>) S.av()[j] = a;
    S.bv()[j] = b;
    S.ia()[j] = ia;
    const T cj = L.c[j];
    mu += psi * cj;
    iso_c += cj * ia;
    T* Gj = S.Gm() + j * dp;
    for (int k = 0; k < d; ++k) Gj[k] = a * (xs[k] - Xj[k]);
  }
  mu = group_sum(m, mu);
  iso_c = group_sum(m, iso_c);
  __syncwarp(m);
  // pass 2: w = K^{-1} k(x, X); variance; iso . w
  T quad = T(0), iso_w = T(0);
  if constexpr (kLiForm<T>) {
    // v = Li k, row j over l <= j; the variance k0 - |v|^2
    for (int j = t; j < n; j += kG) {
      const T* Lj = L.M + j * L.mst;
      T vj = T(0);
      for (int l = 0; l <= j; ++l) vj += Lj[l] * S.kx()[l];
      S.vv()[j] = vj;
      quad += vj * vj;
    }
    quad = group_sum(m, quad);
    __syncwarp(m);
    // w = Li^T v, column l over the rows j >= l: thread t takes column
    // l0 + t and every thread walks the same rows (consecutive words of one
    // row, no bank conflict)
    for (int l0 = 0; l0 < n; l0 += kG) {
      const int l = l0 + t;
      T wl = T(0);
      for (int j = l0; j < n; ++j)
        if (j >= l) wl += L.M[j * L.mst + l] * S.vv()[j];
      if (l < n) {
        S.wv()[l] = wl;
        iso_w += wl * S.ia()[l];
      }
    }
    iso_w = group_sum(m, iso_w);
  } else {
    for (int j = t; j < n; j += kG) {
      const T* Wj = L.M + j * L.mst;
      T wj = T(0);
      for (int l = 0; l < n; ++l) wj += Wj[l] * S.kx()[l];
      S.wv()[j] = wj;
      quad += S.kx()[j] * wj;
      iso_w += wj * S.ia()[j];
    }
    quad = group_sum(m, quad);
    iso_w = group_sum(m, iso_w);
  }
  const T var = jmax(L.k0 - quad, L.sfloor * L.sfloor);
  const T sigma = m_sqrt(var);
  const T ssafe = jmax(sigma, L.sfloor);
  __syncwarp(m);
  // pass 3: grad mu and grad sigma, component t
  T gm_t = T(0), gs_t = T(0);
  if (comp) {
    for (int j = 0; j < n; ++j) {
      const T gjt = S.Gm()[j * dp + t];
      gm_t += L.c[j] * gjt;
      gs_t += S.wv()[j] * gjt;
    }
    gs_t = -gs_t / ssafe;
  }

  a0 = rule_value(L.rule, mu, sigma, L.th, L.fm, L.stol);
  T pr[5];
  rule_partials(L.rule, mu, sigma, L.th, L.fm, L.stol, pr);
  const T gmu = pr[0], gsig = pr[1], gmumu = pr[2], gsigsig = pr[3], gmusig = pr[4];
  const T hs = gsig / ssafe;  // gsig * hess_sigma = hs * (ssafe * hess_sigma)

  // gradient and the active set at the box faces, component t
  const T btol = T(1e-9) * scale;
  T fr_t = T(0), gf_t = T(0);
  if (comp) {
    const T g_t = gmu * gm_t + gsig * gs_t;
    const bool lo = (x_t <= L.lb[t] + btol) && (g_t < T(0));
    const bool hi = (x_t >= L.ub[t] - btol) && (g_t > T(0));
    fr_t = (lo || hi) ? T(0) : T(1);
    gf_t = g_t * fr_t;
    S.gm()[t] = gm_t;
    S.gs()[t] = gs_t;
    S.fr()[t] = fr_t;
    S.gf()[t] = gf_t;
  }

  PHASE_MARK(0);  // the three passes, the rule, the active set
  // H = gmumu gm gm' + gmu Hmu + gsigsig gs gs' + gsig Hsig + gmusig (gm gs' + gs gm')
  // with Hmu = iso_c I + sum_j c_j b_j r_j r_j' and
  // ssafe Hsig = -gs gs' - G' K^{-1} G - sum_j w_j b_j r_j r_j' - iso_w I, G_j = a_j r_j.
  const int jstep = kG / d;
  const int tj = t / d, tk = t - tj * d;
  if constexpr (kLiForm<T>) {
    // G' K^{-1} G = P' P, P = Li G; the sums over the data are
    // sum_j r_j C_j' - hs P_j P_j' with C_j = (gmu c_j - hs w_j) b_j r_j.
    // P by strips (rows tj, tj + jstep, ...; column tk), one per thread
    if (tj < jstep) {
      const T* Gk = S.Gm() + tk;
      int j = tj;
      for (; j + jstep < n; j += 2 * jstep) {  // two rows at a time
        const T* La = L.M + j * L.mst;
        const T* Lb = La + jstep * L.mst;
        T ua = T(0), ub = T(0);
        int l = 0;
        for (; l <= j; ++l) {
          const T gl = Gk[l * dp];
          ua += La[l] * gl;
          ub += Lb[l] * gl;
        }
        for (; l <= j + jstep; ++l) ub += Lb[l] * Gk[l * dp];
        S.P()[j * dp + tk] = ua;
        S.P()[(j + jstep) * dp + tk] = ub;
      }
      if (j < n) {
        const T* La = L.M + j * L.mst;
        T ua = T(0);
        for (int l = 0; l <= j; ++l) ua += La[l] * Gk[l * dp];
        S.P()[j * dp + tk] = ua;
      }
    }
    __syncwarp(m);
    // G is spent: its rows take C_j, one entry per thread in turn
    for (int e = t; e < n * d; e += kG) {
      const int j = e / d, k = e - j * d;
      const T bj = S.bv()[j];
      const T coef = gmu * L.c[j] * bj - hs * S.wv()[j] * bj;
      S.Gm()[j * dp + k] = coef * (xs[k] - L.X[j * dp + k]);
    }
  } else {
    // The sums over the data are sum_j r_j Q_j' with
    // Q_j = (gmu c_j - hs w_j) b_j r_j - hs a_j (W G)_j:
    // strip (rows tj, tj + jstep, ...; column tk) of Q per thread
    if (tj < jstep) {
      const T xk = xs[tk];
      const T* Gk = S.Gm() + tk;
      auto store = [&](int j, T u) {
        const T bj = S.bv()[j];
        const T coef = gmu * L.c[j] * bj - hs * S.wv()[j] * bj;
        const T ga = -hs * S.av()[j];
        S.Q()[j * dp + tk] = coef * (xk - L.X[j * dp + tk]) + ga * u;
      };
      int j = tj;
      for (; j + jstep < n; j += 2 * jstep) {  // two rows at a time
        const T* Wa = L.M + j * L.mst;
        const T* Wb = Wa + jstep * L.mst;
        T ua = T(0), ub = T(0);
        for (int l = 0; l < n; ++l) {
          const T gl = Gk[l * dp];
          ua += Wa[l] * gl;
          ub += Wb[l] * gl;
        }
        store(j, ua);
        store(j + jstep, ub);
      }
      if (j < n) {
        const T* Wa = L.M + j * L.mst;
        T ua = T(0);
        for (int l = 0; l < n; ++l) ua += Wa[l] * Gk[l * dp];
        store(j, ua);
      }
    }
  }
  __syncwarp(m);
  PHASE_MARK(1);  // the Q strips (W form); P = Li G and the rows C_j (Li form)
  // symmetric entries (i >= k) of H, a few per thread; A = -Hf on the free
  // set, the identity on the active one
  const int npairs = d * (d + 1) / 2;
  for (int e = t; e < npairs; e += kG) {
    int i = static_cast<int>((sqrtf(8.0f * e + 1.0f) - 1.0f) * 0.5f);
    while (i * (i + 1) / 2 > e) --i;
    while ((i + 1) * (i + 2) / 2 <= e) ++i;
    const int k = e - i * (i + 1) / 2;
    const T gmi = S.gm()[i], gmk = S.gm()[k], gsi = S.gs()[i], gsk = S.gs()[k];
    T h = gmumu * gmi * gmk + gsigsig * gsi * gsk + gmusig * (gmi * gsk + gsi * gmk) -
          hs * gsi * gsk;
    if (i == k) h += gmu * iso_c - hs * iso_w;
    const T xi = xs[i];
    if constexpr (kLiForm<T>) {
      T hc = T(0), hp = T(0);
      for (int j = 0; j < n; ++j) {
        hc += (xi - L.X[j * dp + i]) * S.Gm()[j * dp + k];
        hp += S.P()[j * dp + i] * S.P()[j * dp + k];
      }
      h += hc - hs * hp;
    } else {
      for (int j = 0; j < n; ++j) h += (xi - L.X[j * dp + i]) * S.Q()[j * dp + k];
    }
    const T fi = S.fr()[i], fk = S.fr()[k];
    const T aik = -(h * fi * fk - (i == k ? T(1) - fi : T(0)));
    S.A()[i * dp + k] = aik;
    S.A()[k * dp + i] = aik;
  }
  __syncwarp(m);

  PHASE_MARK(2);  // the entries of H
  // Gershgorin-damped Newton direction
  T adiag = neg_inf<T>(), off = neg_inf<T>();
  if (comp) {
    const T* Ai = S.A() + t * dp;
    const T aii = Ai[t];
    T rowsum = T(0);
    for (int k = 0; k < d; ++k) rowsum += m_abs(Ai[k]);
    adiag = m_abs(aii);
    off = rowsum - m_abs(aii) - aii;
  }
  const T s_scale = jmax(group_max(m, adiag), ridge);
  const T tau_g = jmax(group_max(m, off), T(0)) + ridge + T(1e-6) * s_scale;
  T p_t;
  if (!chol_solve(S.A(), ridge, gf_t, d, dp, S.Lc(), t, m, p_t)) {
    if (!chol_solve(S.A(), tau_g, gf_t, d, dp, S.Lc(), t, m, p_t)) p_t = gf_t / s_scale;
  }
  PHASE_MARK(3);  // Gershgorin and the Cholesky solves
  p_t *= fr_t;
  const bool finite = __all_sync(m, m_finite(p_t));
  const T pg = group_sum(m, p_t * gf_t);
  const T gnorm2 = group_sum(m, gf_t * gf_t);
  const bool bad = !finite || pg <= T(0);
  const T gden = jmax(m_sqrt(gnorm2), T(1e-12));
  const T gstep_t = gf_t / gden * (T(0.1) * scale);
  if (bad) p_t = gstep_t;
  const T pn2 = group_sum(m, p_t * p_t);
  const T shrink = jmin(T(1), scale / jmax(m_sqrt(pn2), T(1e-30)));
  p_t *= shrink;
  if (comp) {
    S.pv()[t] = p_t;
    S.gv()[t] = gstep_t;
  }
  __syncwarp(m);

  PHASE_MARK(4);  // the directions
  // backtracking over both directions, one candidate per thread: direction
  // 0 (Newton) steps 1, 1/2, ... then direction 1 (gradient); strictly
  // better than a0 only, the lowest candidate on a tie
  a0 = finite_or_neg_inf(a0);
  for (int c = t; c < kCand; c += kG) {
    const int dir = c / kBacktrack, step = c - dir * kBacktrack;
    const T* dv = dir == 0 ? S.pv() : S.gv();
    const T tt = T(1) / T(1 << step);
    T* xc = S.cand() + c * dp;
    for (int k = 0; k < d; ++k) xc[k] = clip(xs[k] + tt * dv[k], L.lb[k], L.ub[k]);
  }
  __syncwarp(m);
  T own_v = neg_inf<T>();
  int own_c = kCand;
  candidate_values<kCand>(L, S, S.cand(), t, m, [&](int c, T v) {
    if (v > own_v) {
      own_v = v;
      own_c = c;
    }
  });
  PHASE_MARK(5);  // the candidates' values
  const T vmax = group_max(m, own_v);  // no NaN left: a plain maximum
  const int win = group_min(m, own_v == vmax ? own_c : kCand);
  __syncwarp(m);
  if (vmax > a0 && win < kCand) {
    vbest = vmax;
    xn_t = comp ? S.cand()[win * dp + t] : T(0);
  } else {
    vbest = a0;
    xn_t = x_t;
  }
  PHASE_MARK(6);  // the winner
}

template <typename T, bool kStageM>
__global__ void __launch_bounds__(kMaxThreads, min_blocks<T>())
    newton_lanes_kernel(const T* __restrict__ X, const T* __restrict__ M,
                        const T* __restrict__ c, const long long* __restrict__ n_lane,
                        const T* __restrict__ fmini, const T* __restrict__ theta0,
                        const T* __restrict__ params, const T* __restrict__ lbs,
                        const T* __restrict__ ubs, const T* __restrict__ xstarts,
                        T* __restrict__ xout, T* __restrict__ vout, int num_lanes, int cap,
                        int d, int S, int iterations, int kind, int rule,
                        int lanes_per_block, int groups_per_lane, T stol, T sfloor, T ridge,
                        T f_tol, T x_tol) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nth = blockDim.x;
  const int tid = threadIdx.x;
  const int dp = d | 1;
  const int mst = kStageM ? (cap | 1) : cap;
  const int lane0 = blockIdx.x * lanes_per_block;
  const int here = min(lanes_per_block, num_lanes - lane0);

  // block: X (lanes, cap, dp), M (lanes, cap, mst) when staged, c (lanes, cap),
  // the box (2, dp); then one GroupScratch per group
  T* sX = reinterpret_cast<T*>(smem_raw);
  T* sM = sX + lanes_per_block * cap * dp;
  T* sc = sM + (kStageM ? lanes_per_block * cap * mst : 0);
  T* sbox = sc + lanes_per_block * cap;
  T* sgroups = sbox + 2 * dp;
  const int group_words = GroupScratch<T>::words(cap, d, dp);

  // stage this block's lanes (contiguous in device memory) at padded strides
  for (int i = tid; i < here * cap * d; i += nth) {
    const int r = i / d;
    sX[r * dp + (i - r * d)] = X[(size_t)lane0 * cap * d + i];
  }
  if (kStageM) {
    if constexpr (kLiForm<T>) {  // Li's lower triangle: nothing reads above it
      for (int i = tid; i < here * cap * cap; i += nth) {
        const int r = i / cap, col = i - r * cap;
        if (col <= r % cap) sM[r * mst + col] = M[(size_t)lane0 * cap * cap + i];
      }
    } else {
      for (int i = tid; i < here * cap * cap; i += nth) {
        const int r = i / cap;
        sM[r * mst + (i - r * cap)] = M[(size_t)lane0 * cap * cap + i];
      }
    }
  }
  for (int i = tid; i < here * cap; i += nth) sc[i] = c[(size_t)lane0 * cap + i];
  for (int i = tid; i < d; i += nth) {
    sbox[i] = lbs[i];
    sbox[dp + i] = ubs[i];
  }
  __syncthreads();

  const int t = tid & (kG - 1);
  const int g = tid / kG;
  const int ll = g / groups_per_lane;
  const int ws = g - ll * groups_per_lane;
  const int lane = lane0 + ll;
  const bool active = ll < here;
  const unsigned m = 0xffffffffu;
  GroupScratch<T> Sg;
  Sg.base = sgroups + (size_t)g * group_words;
  Sg.cap = cap;
  Sg.d = d;
  Sg.dp = dp;
  const bool comp = t < d;

  if (active) {
    Lane<T> L;
    L.X = sX + ll * cap * dp;
    L.M = kStageM ? sM + ll * cap * mst : M + (size_t)lane * cap * cap;
    L.c = sc + ll * cap;
    L.lb = sbox;
    L.ub = sbox + dp;
    const long long nl = n_lane[lane];
    L.n = nl < 0 ? 0 : (nl > cap ? cap : static_cast<int>(nl));
    L.d = d;
    L.dp = dp;
    L.mst = mst;
    L.kind = kind;
    L.rule = rule;
    L.ell = params[0];
    L.period = params[1];
    T a_, b_, iso_;
    profile_terms(kind, T(0), T(0), L.ell, L.period, L.k0, a_, b_, iso_);
    L.fm = fmini[lane];
    L.th = theta0[lane];
    L.stol = stol;
    L.sfloor = sfloor;

    const T lb_t = comp ? L.lb[t] : T(0), ub_t = comp ? L.ub[t] : T(0);
    const T scale = group_max(m, comp ? ub_t - lb_t : neg_inf<T>());
    const bool loose = f_tol > T(0) || x_tol > T(0);
    // the group's best start so far, in start order (strict >: first wins)
    T best_v = neg_inf<T>(), best_x = T(0);
    int best_s = -1;
    for (int s = ws; s < S; s += groups_per_lane) {
      T x_t = comp ? clip(xstarts[s * d + t], lb_t, ub_t) : T(0);
      if (comp) Sg.xs()[t] = x_t;
      __syncwarp(m);
      for (int it = 0; it < iterations; ++it) {
        T xn_t, a0, vbest;
        group_iteration(L, Sg, t, m, x_t, scale, ridge, xn_t, a0, vbest);
        bool freeze = false;
        if (loose) {
          // IPNewton-style loose acceptance (reference rbf_optim.jl:26-30);
          // a frozen start keeps its point, so it may stop iterating
          const T improvement = jmax(vbest - a0, T(0));
          const T dx2 = group_sum(m, (xn_t - x_t) * (xn_t - x_t));
          freeze = improvement <= f_tol * (m_abs(a0) + f_tol) || m_sqrt(dx2) <= x_tol;
        }
        x_t = xn_t;
        if (comp) Sg.xs()[t] = x_t;
        __syncwarp(m);
        if (freeze) break;
      }
      T v = T(0);
      candidate_values<1>(L, Sg, Sg.xs(), t, m, [&](int, T v0) { v = v0; });
      v = __shfl_sync(m, v, 0, kG);
      if (v > best_v) {
        best_v = v;
        best_x = x_t;
        best_s = s;
      }
    }
    T* res = Sg.res();
    if (t == 0) {
      res[0] = best_v;
      res[1] = T(best_s);
    }
    if (comp) res[2 + t] = best_x;
  }
  __syncthreads();

  // best start per lane: the largest value, the lowest start on a tie (what
  // a strict > in start order selects); every start -inf gives x = 0
  if (active && ws == 0 && comp) {
    T best = neg_inf<T>();
    int arg = -1, arg_s = 0;
    for (int j = 0; j < groups_per_lane; ++j) {
      const T* res = sgroups + (size_t)(g + j) * group_words + (Sg.res() - Sg.base);
      const T v = res[0];
      const int s = static_cast<int>(res[1]);
      if (s >= 0 && (v > best || (v == best && s < arg_s))) {
        best = v;
        arg = j;
        arg_s = s;
      }
    }
    const T* res = sgroups + (size_t)(g + (arg < 0 ? 0 : arg)) * group_words +
                   (Sg.res() - Sg.base);
    xout[(size_t)lane * d + t] = arg < 0 ? T(0) : res[2 + t];
    if (t == 0) vout[lane] = best;
  }
}

template <typename T, bool kStageM>
int launch_as(const void* X, const void* M, const void* c, const void* n,
              const void* fmini, const void* theta0, const void* params, const void* lbs,
              const void* ubs, const void* xstarts, void* xout, void* vout, int num_lanes,
              int cap, int d, int S, int iterations, int kind, int rule,
              int lanes_per_block, int groups_per_lane, double stol, double sfloor,
              double ridge, double f_tol, double x_tol, int smem, void* stream) {
  auto kernel = newton_lanes_kernel<T, kStageM>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (num_lanes + lanes_per_block - 1) / lanes_per_block;
  const int threads = lanes_per_block * groups_per_lane * kG;
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(X), static_cast<const T*>(M), static_cast<const T*>(c),
      static_cast<const long long*>(n), static_cast<const T*>(fmini),
      static_cast<const T*>(theta0), static_cast<const T*>(params),
      static_cast<const T*>(lbs), static_cast<const T*>(ubs),
      static_cast<const T*>(xstarts), static_cast<T*>(xout), static_cast<T*>(vout),
      num_lanes, cap, d, S, iterations, kind, rule, lanes_per_block, groups_per_lane,
      T(stol), T(sfloor), T(ridge), T(f_tol), T(x_tol));
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* X, const void* M, const void* c, const void* n,
           const void* fmini, const void* theta0, const void* params,
           const void* lbs, const void* ubs, const void* xstarts, void* xout,
           void* vout, int num_lanes, int cap, int d, int S, int iterations,
           int kind, int rule, int lanes_per_block, int groups_per_lane, int stage_m,
           double stol, double sfloor, double ridge, double f_tol, double x_tol,
           int smem, void* stream) {
  if (d < 1 || d > MAX_D || S < 1 || lanes_per_block < 1 || groups_per_lane < 1 ||
      lanes_per_block * groups_per_lane * kG > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  auto fn = stage_m ? launch_as<T, true> : launch_as<T, false>;
  return fn(X, M, c, n, fmini, theta0, params, lbs, ubs, xstarts, xout, vout, num_lanes,
            cap, d, S, iterations, kind, rule, lanes_per_block, groups_per_lane, stol,
            sfloor, ridge, f_tol, x_tol, smem, stream);
}

}  // namespace

#ifdef NEWTON_LANES_PROFILE
// copies the phase cycles to out[8] and sets them to 0
extern "C" int newton_lanes_phase_cycles(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles));
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
}
#endif

// blocks of `threads` threads and `smem` dynamic bytes that one SM holds
extern "C" int newton_lanes_blocks_per_sm(int itemsize, int stage_m, int threads, int smem) {
  int blocks = 0;
  cudaError_t e;
  if (itemsize == 4) {
    auto k = stage_m ? newton_lanes_kernel<float, true> : newton_lanes_kernel<float, false>;
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, threads, smem);
  } else {
    auto k = stage_m ? newton_lanes_kernel<double, true> : newton_lanes_kernel<double, false>;
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, threads, smem);
  }
  return e == cudaSuccess ? blocks : -(int)e;
}

#define NEWTON_LANES_ENTRY(NAME, T)                                                \
  extern "C" int NAME(const void* X, const void* M, const void* c, const void* n, \
                      const void* fmini, const void* theta0, const void* params,  \
                      const void* lbs, const void* ubs, const void* xstarts,      \
                      void* xout, void* vout, int num_lanes, int cap, int d,      \
                      int S, int iterations, int kind, int rule,                  \
                      int lanes_per_block, int groups_per_lane, int stage_m,      \
                      double stol, double sfloor, double ridge, double f_tol,     \
                      double x_tol, int smem, void* stream) {                     \
    return launch<T>(X, M, c, n, fmini, theta0, params, lbs, ubs, xstarts, xout,  \
                     vout, num_lanes, cap, d, S, iterations, kind, rule,          \
                     lanes_per_block, groups_per_lane, stage_m, stol, sfloor,     \
                     ridge, f_tol, x_tol, smem, stream);                          \
  }

NEWTON_LANES_ENTRY(newton_lanes_f32, float)
NEWTON_LANES_ENTRY(newton_lanes_f64, double)
