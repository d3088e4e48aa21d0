// Multistart projected-Newton acquisition solve, one tiny GP per lane.
//
// Replaces the TPU kernel rollout_bo_tpu/ops/pallas_newton.py::
// newton_solve_lanes (body _make_kernel). Per lane (one restart x MC
// trajectory of the rollout, or the myopic loop's one surrogate) and per
// start, it runs `iterations` steps of: posterior mu / sigma with
// gradients and Hessians from the lane's matrix M (below); the decision
// rule's value and five partials; the active-set reduction at the box
// faces; a Gershgorin-damped Newton direction from two Cholesky solves;
// backtracking over 2 directions x 9 steps. Then the best start per lane
// wins (first start on a tie, non-finite values count as -inf).
//
// One kernel per dtype, as the JAX package routes the two dtypes
// (rollout_bo_tpu/rollout/solvers.py:40-64): float32 lanes to the TPU
// kernel, float64 lanes to its XLA solver.
// - newton_lanes_kernel (float) reads M = W = K^{-1} = Li^T Li, formed by
//   the wrapper, and computes the TPU kernel's k0 - k^T W k. Its design is
//   the bench shape's, with the double kernel's fixed-point stop and start
//   blocks (below, "The float kernel").
// - newton_li_kernel_d8 / _d16 (double) read M = Li = L^{-1}, the lower-triangular
//   inverse of the Cholesky factor that the surrogate state maintains
//   (identity-padded, zero above the diagonal), and computes k0 - |Li k|^2:
//   v = Li k and w = Li^T v = K^{-1} k as triangular products, the
//   Hessian's data term G^T K^{-1} G as the Gram P^T P of P = Li G, a
//   candidate's variance as k0 - |Li k_c|^2. It never forms or reads W, nor
//   Li above its diagonal. Its design is the BO loops' (below, "The double
//   kernel").
// The W form's rounding grows with cond(K), the Li form's with its square
// root. A step is accepted only when the value rises in floating point, so
// that rounding is the floor at which every argmax stops, and the rollout's
// fantasy draws carry it into its value: in float64 the Li form keeps that
// floor at the JAX package's, which the rollout's gradient checks need. In
// float32 the W form is the TPU kernel's own and the faster one at the
// bench shape.
//
// What bounds it on an H100: operations, not bytes (ops/newton_lanes.py::
// lane_solve_work; the card's 67 TFLOP/s of float32 and 33.5 of float64
// outside the tensor cores, 3.35 TB/s):
// - the bench shape (float32; 1600 lanes, capacity 24, d 10, 10 starts, 10
//   iterations): 4.7 GFLOP over 5.4 MB, 0.070 ms against 0.0016 ms; 0.49
//   GFLOP, 0.0072 ms, for the one iteration each start needs;
// - the myopic loop (float64; 1 lane, n 104 of capacity 105, d 6, 66
//   starts, 12 iterations): 0.24-0.29 GFLOP (by the iterations the starts
//   need), 0.007-0.009 ms, over 54 KB;
// - the non-myopic loop (float64; 2000 lanes, n 6-21 of capacity 23, d 6,
//   18 starts, 12 iterations): 6.8-8.2 GFLOP, 0.20-0.24 ms, over 7.2 MB.
// Every solve is a chain of small reductions, one or two d x d Cholesky
// solves and data-dependent branches, so latency and the warps an SM can
// hold decide the time, not the card's peak: the kernels reach 0.4-4% of
// these bounds (PERF.md). TMA and clusters have no use here: a lane is at
// most ~50 KB, staged once by plain loads, and the best start across
// blocks is a second, tiny kernel. The float64 tensor cores (DMMA, 8 x 8 x
// 4) are not used: the largest product, one start's Li k_c over its 18
// candidates ((n x n lower) by (n x 18), n <= 104), would fill their tiles
// at the myopic shape, but a lone warp's chain of small steps around it
// is most of that shape's time, and no measurement here shows what DMMA
// would save (PERF.md, open questions).
//
// The float kernel (designed for the bench shape; since then for the
// shapes that run it): a group of G = 32 threads (one warp) owns one (lane,
// start), so the card sees lanes x starts warps instead of as many threads,
// and no thread holds a d x d array in local memory.
// - A block holds `lanes_per_block` lanes x `groups_per_lane` groups. Each
//   lane's X, W and c are staged once in shared memory, rows padded to an
//   odd stride so that threads on different rows hit different banks; a
//   group loops over the starts ws, ws + groups_per_lane, ... When one
//   lane's W does not fit, it stays in device memory (template kStageM).
//   When the lanes fill fewer blocks than the card has SMs, a lane's starts
//   spread over blocks and best_start_kernel picks over them, as in the
//   double kernel below (the myopic loop's one lane at --dtype float32: 66
//   blocks of one warp, not one block of 10 warps on one SM).
// - A fixed point ends a start, as in the double kernel: the iteration is a
//   function of its point and the lane alone, so the result is the one all
//   `iterations` would give (bit for bit). At the bench shape every start
//   stops after its first iteration: the lanes sit on EI plateaus.
// - Passes over the data (k(x, X), psi'/rho, b; w = W k): thread t takes
//   the rows t, t + G, ... mu, the variance and the isotropic terms are
//   butterfly reductions by __shfl_xor_sync, a fixed tree, so a run repeats
//   bit for bit and every thread of the group holds the same sum.
// - Gradients: thread k < d owns component k of every d-vector (x, grad mu,
//   grad sigma, the free mask, the directions).
// - Hessian: the rows G_j = a_j r_j are stored once; Q = coef r + ga W G
//   (n x d) is built with one (rows, column) strip per thread; then each
//   thread owns a few of the d (d + 1) / 2 symmetric entries and sums
//   r_j[i] Q_j[k] over the data. No reduction, no read-modify-write.
// - Cholesky: thread i keeps row i of the factor in registers (loops
//   unrolled to MAX_D, every index a constant), right-looking, the column
//   of each step broadcast by shuffles; the forward solve broadcasts one
//   finished component per step, the backward one reads L' from a copy in
//   shared memory. Which solve is taken (ridge, Gershgorin shift, scaled
//   gradient) is uniform across the group.
// - Backtracking: the 18 candidates x n data rows are dealt to the threads
//   in tiles of 2 points x 2 rows, for k(x_c, X_j) and then for W k; thread
//   c sums candidate c's mu and variance in data order. The winner is the
//   largest value strictly above the current one, the lowest candidate
//   index on a tie: what the sequential strict `>` loop selects.
// - Best start: each group keeps its best (value, start, x) in start order;
//   after a barrier the lane's first group picks the largest value, lowest
//   start on a tie.
// Shared memory per group (words, dp = d | 1): 5 cap rows + 2 cap x max(dp,
// 18) (G and Q; reused for the candidates' k and W k columns) + 2 d dp (A
// and its factor) + 18 dp (candidates) + 7 dp (vectors) + dp + 2 (result):
// at the bench shape 1,492 words, so a block of one lane x 10 groups (320
// threads) takes 63,320 B with the lane's 3,640 B. It is held to 64
// registers (__launch_bounds__), so three such blocks, 30 warps, are
// resident per SM. One layout serves every shape: groups of 8 or 16 threads
// (several starts a warp at d <= 8) were slower than a warp at every shape
// that runs them, and a second layout for d <= 8 (the candidates' sums in
// registers) gained 1.1-1.5x on synthetic ladder lanes only (PERF.md).
//
// The double kernel (designed for the BO loops' float64 shapes). The float
// kernel's layout left the myopic loop's one lane on one SM of 132 (one
// block of 3 warps, 22 starts each in series: 34 ms), and at the
// non-myopic shape one 9-warp block per SM (128 registers).
// - A grid over (lane block, start block): when the lanes fill fewer
//   blocks than the card has SMs, a lane's starts spread over blocks, as
//   many as make one block per SM (each of the myopic loop's 66 starts a
//   block of one warp); each block stages its lane. Each block writes its
//   best start per lane to `part`; best_start_kernel then picks, per
//   lane, the largest value, the lowest start on a tie, over the blocks in
//   start order. The wrapper counts the two kernels as one launch.
// - Li is staged as its packed lower triangle (row j at j (j + 1) / 2):
//   half the square's words (44 KB at capacity 105).
// - A warp per (lane, start), as in the float kernel (groups of 16
//   threads, two starts a warp, measured slower at the non-myopic shape:
//   shared memory, not threads, caps the starts an SM holds).
// - Registers: 56 where d <= 8 (__maxnreg__), so that the non-myopic
//   shape's blocks of one lane x 9 warps sit four to an SM (36 warps;
//   shared memory allows four): 8.3 ms against 9.9-10.3 at 64 registers
//   (27 warps) and 16.1 at 128 (9 warps), spills and all. 128 where d <=
//   16: there shared memory holds the blocks to one or two per SM.
// - The candidates: thread t owns a pair of points (t mod 9) and a third of
//   the data rows, computes their k(x_c, X_j) and then (Li k_c)_j for its
//   row pairs, and keeps mu and |Li k_c|^2 as partial sums in registers,
//   added over the three row groups in a fixed order: no (cap, 18) column
//   of Li k. The candidates' k columns take the words of the passes'
//   vectors, G and P, dead by then: per group cap x max(5 + 2 dp, 18) + 2 d
//   dp + 26 dp + 2 words, 705 at the non-myopic shape against the float
//   layout's 1,211.
// - A fixed point ends a start: an iteration is a function of its point
//   alone, so once it returns the point unchanged every later one does
//   too, and the start stops with the result all `iterations` would give
//   (10.0-10.2 of 12 iterations run at the BO loops' shapes).
// - The Cholesky factorization unrolls to D = 8 where d <= 8 (half the
//   registers of row t's copy), inlined once for both shifts; the kernels
//   newton_li_kernel_d8 and _d16 differ in D and registers only. The
//   profile's constants are computed once per lane (li_psi: the same
//   values) and the triangular loops unrolled: 1.06-1.15x at the BO
//   loops' shapes against the same code without them.
// rollout_bo_tpu_torch/ops/newton_lanes.py::_block_shape computes every
// kernel's layout and must match `GroupScratch`, `LiScratch` and the
// kernels' carve-up below.
//
// d and the capacity are runtime values (d <= MAX_D); kind, rule and the
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

// A launch on the caller's stream (the tests' CPU emulation defines its own)
#ifndef LANES_LAUNCH
#define LANES_LAUNCH(kernel, blocks, threads, smem, stream) \
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>
#endif

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
  __device__ __forceinline__ T* bv() const { return base + 2 * cap; }
  __device__ __forceinline__ T* wv() const { return base + 3 * cap; }  // K^{-1} k
  __device__ __forceinline__ T* ia() const { return base + 4 * cap; }  // a, or iso at rho = 0
  __device__ __forceinline__ T* Gm() const { return base + 5 * cap; }  // (cap, dp) a_j r_j
  __device__ __forceinline__ T* Q() const { return Gm() + cap * dp; }  // (cap, dp)
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
    for (int l = 0; l < n; ++l) {
      const T kal = ka[l * kNc], kbl = kb[l * kNc], Wal = Wa[l], Wbl = Wb[l];
      waa += Wal * kal;
      wab += Wbl * kal;
      wba += Wal * kbl;
      wbb += Wbl * kbl;
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
      quad += kj * wc[j * kNc + c];  // k^T W k
    }
    const T var = jmax(L.k0 - quad, L.sfloor * L.sfloor);
    take(c, finite_or_neg_inf(rule_value(L.rule, mu, m_sqrt(var), L.th, L.fm, L.stol)));
  }
}

// Solve (A + tau I) p = g by Cholesky, thread i on row i; g_t and p_t are
// thread t's components. False (on every thread) when the matrix is not
// positive definite or p is no ascent direction. Row t of the factor lives
// in registers (a[], every index a constant after unrolling to D >= d).
// Right-looking: step j broadcasts column j by shuffles, four at a time
// with no branch between them so that they pipeline, and each thread
// updates its own row; the subtractions reach each entry in the order of
// the left-looking loop. Rows at and beyond d hold exact zeros. The forward
// solve broadcasts one finished component per step; the backward solve
// reads L' from the copy in shared memory (Lc, written once).
// (The float kernel calls it out of line, chol_solve below; the double
// kernel inlines it once.)
template <int D, typename T>
__device__ __forceinline__ bool chol_solve_inline(const T* A, T tau, T g_t, int d, int dp,
                                                  T* Lc, int t, unsigned m, T& p_t) {
  static_assert(D <= kG, "thread i of the group holds row i");
  const bool row = t < d;
  T a[D];
#pragma unroll
  for (int k = 0; k < D; ++k)
    a[k] = (row && k <= t) ? A[t * dp + k] + (k == t ? tau : T(0)) : T(0);
  T inv_t = T(1);
#pragma unroll
  for (int j = 0; j < D; ++j) {
    if (j < d) {
      const T sj = __shfl_sync(m, a[j], j, kG);
      const T inv = m_rsqrt(sj);
      const T l = (row && t > j) ? a[j] * inv : (t == j ? sj * inv : T(0));  // L[t][j]
      if (t == j) inv_t = inv;
      a[j] = l;
#pragma unroll
      for (int k0 = 0; k0 < D; k0 += 4) {
        if (k0 + 3 > j && k0 < d) {
#pragma unroll
          for (int k = (k0 > j + 1 ? k0 : j + 1); k < k0 + 4; ++k)
            a[k] -= l * __shfl_sync(m, l, k, kG);  // L[t][j] L[k][j]; used where k <= t
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < D; ++k)
    if (row && k <= t) Lc[t * dp + k] = a[k];
  __syncwarp(m);
  T acc = row ? g_t : T(0);
  T z_t = T(0);
#pragma unroll
  for (int k = 0; k < D; ++k) {
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
template <typename T>
__device__ __noinline__ bool chol_solve(const T* A, T tau, T g_t, int d, int dp, T* Lc, int t,
                                   unsigned m, T& p_t) {
  return chol_solve_inline<MAX_D>(A, tau, g_t, d, dp, Lc, t, m, p_t);
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
    S.av()[j] = a;
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
  __syncwarp(m);
  PHASE_MARK(1);  // the Q strips
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
    for (int j = 0; j < n; ++j) h += (xi - L.X[j * dp + i]) * S.Q()[j * dp + k];
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

// The float kernel. Block b runs lane block b / start_blocks over the starts
// of start block b % start_blocks (contiguous ranges of ceil(S /
// start_blocks)); a group of kG threads per (lane, start), each group
// looping over starts ws, ws + groups_per_lane, ... of the block's range.
// With one start block the block's best start per lane goes to xout / vout;
// with several, to part (lane, start block): value, start (-1 if none), x,
// and best_start_kernel picks over the blocks. A start stops at a fixed point:
// an iteration is a function of x alone, so once it returns x unchanged
// every later one does too, and the result is the one all `iterations`
// would give. `runs` (may be null) takes the iterations each (lane, start)
// ran, for the measurements' work count. Held to 64 registers
// (__launch_bounds__ with 2 blocks of kMaxThreads), so that three 320-thread
// blocks (30 warps) are resident at the bench shape: measured faster than 80,
// 96 or 128 registers with fewer warps, spills and all.
template <bool kStageM>
__global__ void __launch_bounds__(kMaxThreads, 2)
    newton_lanes_kernel(const float* __restrict__ X, const float* __restrict__ M,
                        const float* __restrict__ c, const long long* __restrict__ n_lane,
                        const float* __restrict__ fmini, const float* __restrict__ theta0,
                        const float* __restrict__ params, const float* __restrict__ lbs,
                        const float* __restrict__ ubs, const float* __restrict__ xstarts,
                        float* __restrict__ xout, float* __restrict__ vout,
                        float* __restrict__ part, int* __restrict__ runs, int num_lanes,
                        int cap, int d, int S, int iterations, int kind, int rule,
                        int lanes_per_block, int groups_per_lane, int start_blocks,
                        float stol, float sfloor, float ridge, float f_tol, float x_tol) {
  using T = float;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nth = blockDim.x;
  const int tid = threadIdx.x;
  const int dp = d | 1;
  const int mst = kStageM ? (cap | 1) : cap;
  const int lblock = blockIdx.x / start_blocks, sb = blockIdx.x - lblock * start_blocks;
  const int chunk = (S + start_blocks - 1) / start_blocks;
  const int s_lo = sb * chunk, s_hi = min(S, s_lo + chunk);
  const int lane0 = lblock * lanes_per_block;
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
    for (int i = tid; i < here * cap * cap; i += nth) {
      const int r = i / cap;
      sM[r * mst + (i - r * cap)] = M[(size_t)lane0 * cap * cap + i];
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
    for (int s = s_lo + ws; s < s_hi; s += groups_per_lane) {
      T x_t = comp ? clip(xstarts[s * d + t], lb_t, ub_t) : T(0);
      if (comp) Sg.xs()[t] = x_t;
      __syncwarp(m);
      int it = 0;
      while (it < iterations) {
        T xn_t, a0, vbest;
        group_iteration(L, Sg, t, m, x_t, scale, ridge, xn_t, a0, vbest);
        ++it;
        bool freeze = __all_sync(m, xn_t == x_t);  // a fixed point
        if (loose) {
          // IPNewton-style loose acceptance (reference rbf_optim.jl:26-30);
          // a frozen start keeps its point, so it may stop iterating
          const T improvement = jmax(vbest - a0, T(0));
          const T dx2 = group_sum(m, (xn_t - x_t) * (xn_t - x_t));
          freeze = freeze || improvement <= f_tol * (m_abs(a0) + f_tol) || m_sqrt(dx2) <= x_tol;
        }
        x_t = xn_t;
        if (comp) Sg.xs()[t] = x_t;
        __syncwarp(m);
        if (freeze) break;
      }
      if (runs != nullptr && t == 0) runs[(size_t)lane * S + s] = it;
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

  // the block's best start per lane: the largest value, the lowest start on
  // a tie (what a strict > in start order selects); every start -inf gives
  // x = 0
  if (active && ws == 0 && comp) {
    T best = neg_inf<T>();
    int arg = -1, arg_s = 0;
    const size_t at = Sg.res() - Sg.base;
    for (int j = 0; j < groups_per_lane; ++j) {
      const T* res = sgroups + (size_t)(g + j) * group_words + at;
      const T v = res[0];
      const int s = static_cast<int>(res[1]);
      if (s >= 0 && (v > best || (v == best && s < arg_s))) {
        best = v;
        arg = j;
        arg_s = s;
      }
    }
    const T* res = sgroups + (size_t)(g + (arg < 0 ? 0 : arg)) * group_words + at;
    if (start_blocks == 1) {
      xout[(size_t)lane * d + t] = arg < 0 ? T(0) : res[2 + t];
      if (t == 0) vout[lane] = best;
    } else {
      T* out = part + ((size_t)lane * start_blocks + sb) * (d + 2);
      out[2 + t] = arg < 0 ? T(0) : res[2 + t];
      if (t == 0) {
        out[0] = best;
        out[1] = arg < 0 ? T(-1) : T(arg_s);
      }
    }
  }
}

// The best start per lane over its start blocks: the largest value, the
// lowest start on a tie (the blocks hold increasing ranges of starts, so a
// strict > in block order keeps the first); every start -inf gives x = 0.
template <typename T>
__global__ void best_start_kernel(const T* __restrict__ part, T* __restrict__ xout,
                                  T* __restrict__ vout, int num_lanes, int start_blocks, int d) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= num_lanes) return;
  const T* p = part + (size_t)lane * start_blocks * (d + 2);
  T best = neg_inf<T>();
  int arg = -1;
  for (int b = 0; b < start_blocks; ++b) {
    const T v = p[b * (d + 2)];
    if (p[b * (d + 2) + 1] >= T(0) && v > best) {
      best = v;
      arg = b;
    }
  }
  for (int k = 0; k < d; ++k) xout[(size_t)lane * d + k] = arg < 0 ? T(0) : p[arg * (d + 2) + 2 + k];
  vout[lane] = best;
}

constexpr int kReduceThreads = 128;

int launch_f32(const void* X, const void* M, const void* c, const void* n, const void* fmini,
               const void* theta0, const void* params, const void* lbs, const void* ubs,
               const void* xstarts, void* xout, void* vout, void* part, void* runs,
               int num_lanes, int cap, int d, int S, int iterations, int kind, int rule,
               int lanes_per_block, int groups_per_lane, int start_blocks, int stage_m,
               double stol, double sfloor, double ridge, double f_tol, double x_tol, int smem,
               void* stream) {
  if (d < 1 || d > MAX_D || S < 1 || lanes_per_block < 1 || groups_per_lane < 1 ||
      start_blocks < 1 || start_blocks > S || (start_blocks > 1 && part == nullptr) ||
      lanes_per_block * groups_per_lane * kG > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  const auto kernel = stage_m ? newton_lanes_kernel<true> : newton_lanes_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (num_lanes + lanes_per_block - 1) / lanes_per_block * start_blocks;
  const int threads = lanes_per_block * groups_per_lane * kG;
  LANES_LAUNCH(kernel, blocks, threads, smem, stream)(
      static_cast<const float*>(X), static_cast<const float*>(M),
      static_cast<const float*>(c), static_cast<const long long*>(n),
      static_cast<const float*>(fmini), static_cast<const float*>(theta0),
      static_cast<const float*>(params), static_cast<const float*>(lbs),
      static_cast<const float*>(ubs), static_cast<const float*>(xstarts),
      static_cast<float*>(xout), static_cast<float*>(vout), static_cast<float*>(part),
      static_cast<int*>(runs), num_lanes, cap, d, S, iterations, kind, rule, lanes_per_block,
      groups_per_lane, start_blocks, float(stol), float(sfloor), float(ridge), float(f_tol),
      float(x_tol));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || start_blocks == 1) return (int)e;
  const auto reduce = best_start_kernel<float>;
  LANES_LAUNCH(reduce, (num_lanes + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0,
               stream)(static_cast<const float*>(part), static_cast<float*>(xout),
                       static_cast<float*>(vout), num_lanes, start_blocks, d);
  return (int)cudaGetLastError();
}

// ============================================================================
// The float64 kernel: the Li form, a grid over (lane block, start block)
// ============================================================================

constexpr int kLiMaxThreads = 512;  // per block; the wrapper sizes blocks within it
// Registers per thread, by the factorization's unroll D:
// - D = 8 (d <= 8): 56, so that an SM holds four 288-thread blocks (36
//   warps) at the non-myopic shape, where shared memory allows four as
//   well; measured faster than 48, 64 or 128, spills and all
//   (scripts/ab_newton_lanes_cuda.py --variants builds the others with
//   -DNEWTON_LI_MAXNREG8=n);
// - D = 16: 128, since shared memory holds the d = 16 shapes' blocks to
//   one or two per SM and 56 registers spill the unrolled rows.
#ifndef NEWTON_LI_MAXNREG8
#define NEWTON_LI_MAXNREG8 56
#endif

// One lane: X (cap, dp), c and the box in shared memory; Li's lower
// triangle packed by rows in shared memory (kStage: row j at j (j + 1) / 2)
// or read in place from device memory (row j at j cap). No word above the
// diagonal is read.
template <bool kStage> struct LiLane {
  const double* X;
  const double* M;
  const double* c;
  const double* lb;
  const double* ub;
  int n, d, dp, cap, kind, rule;
  double ell, period, k0, fm, th, stol, sfloor;
  double pc, pc1;  // profile_psi's constants (li_psi)
  __device__ __forceinline__ const double* row(int j) const {
    return kStage ? M + j * (j + 1) / 2 : M + (size_t)j * cap;
  }
};

// profile_psi with the lane's constants computed once (the same expressions,
// so the same values): pc = sqrt(5) / ell, sqrt(3) / ell, 1 / ell, 2 ell^2
// or pi / period by kind; pc1 = 2 / ell^2 (periodic)
template <bool kStage> __device__ __forceinline__ void li_psi_constants(LiLane<kStage>& L) {
  const double ell = L.ell;
  L.pc1 = 2.0 / (ell * ell);
  if (L.kind == PERIODIC) {
    L.pc = kPi / L.period;
  } else if (L.kind == MATERN52) {
    L.pc = m_sqrt(5.0) / ell;
  } else if (L.kind == MATERN32) {
    L.pc = m_sqrt(3.0) / ell;
  } else if (L.kind == MATERN12) {
    L.pc = 1.0 / ell;
  } else {
    L.pc = 2.0 * (ell * ell);
  }
}
template <bool kStage>
__device__ __forceinline__ double li_psi(const LiLane<kStage>& L, double rho, double sq) {
  if (L.kind == PERIODIC) {
    const double su = m_sin(L.pc * rho);
    return m_exp(-L.pc1 * su * su);
  } else if (L.kind == MATERN52) {
    const double s = L.pc * rho;
    return (1.0 + s * (1.0 + s / 3.0)) * m_exp(-s);
  } else if (L.kind == MATERN32) {
    const double s = L.pc * rho;
    return (1.0 + s) * m_exp(-s);
  } else if (L.kind == MATERN12) {
    return m_exp(-L.pc * rho);
  }
  return m_exp(-sq / L.pc);
}

// Offsets into one group's shared memory, in doubles; the Python
// _block_shape counts the same words. The first region holds the passes'
// vectors, G and P until the Hessian's entries are summed, then the
// candidates' k(x_c, X).
struct LiScratch {
  double* base;
  int cap, d, dp;
  __device__ __forceinline__ double* kx() const { return base; }  // k(x, X)
  __device__ __forceinline__ double* vv() const { return base + cap; }  // Li k
  __device__ __forceinline__ double* bv() const { return base + 2 * cap; }
  __device__ __forceinline__ double* wv() const { return base + 3 * cap; }  // Li^T Li k
  __device__ __forceinline__ double* ia() const { return base + 4 * cap; }  // a, or iso at 0
  __device__ __forceinline__ double* Gm() const { return base + 5 * cap; }  // (cap, dp) G, C
  __device__ __forceinline__ double* P() const { return Gm() + cap * dp; }  // (cap, dp) Li G
  __device__ __forceinline__ double* kxc() const { return base; }  // (cap, kCand)
  __device__ static int region(int cap, int dp) {
    return cap * (5 + 2 * dp > kCand ? 5 + 2 * dp : kCand);
  }
  __device__ __forceinline__ double* A() const { return base + region(cap, dp); }  // (d, dp)
  __device__ __forceinline__ double* Lc() const { return A() + d * dp; }  // its factor
  __device__ __forceinline__ double* cand() const { return Lc() + d * dp; }  // (kCand, dp)
  __device__ __forceinline__ double* vec(int i) const { return cand() + (kCand + i) * dp; }
  __device__ __forceinline__ double* xs() const { return vec(0); }  // current point
  __device__ __forceinline__ double* gm() const { return vec(1); }  // grad mu
  __device__ __forceinline__ double* gs() const { return vec(2); }  // grad sigma
  __device__ __forceinline__ double* fr() const { return vec(3); }  // free mask
  __device__ __forceinline__ double* gf() const { return vec(4); }  // free gradient
  __device__ __forceinline__ double* pv() const { return vec(5); }  // Newton direction
  __device__ __forceinline__ double* gv() const { return vec(6); }  // gradient step
  __device__ __forceinline__ double* res() const { return vec(7); }  // (dp + 2) group's best
  __device__ static int words(int cap, int d, int dp) {
    return region(cap, dp) + 2 * d * dp + (kCand + 7) * dp + dp + 2;
  }
};

// A thread's best point: the largest value, the lowest point on a tie
struct LiBest {
  double v;
  int c;
};

// The rule's value at kNc points x_c (rows of xc at stride dp), by the
// group's warp, with partial sums in registers in place of a (cap, kNc)
// column of Li k. Thread t < kCp R owns the point pair cp = t % kCp (points
// 2 cp and 2 cp + 1) and the row group rg = t / kCp of R. It writes k(x_c,
// X_j) for its points and rows j = rg, rg + R, ... to kxc, summing mu; after
// a barrier, (Li k_c)_j over l <= j for its row pairs (2 jp, 2 jp + 1), jp =
// rg, rg + R, ...: four independent chains, each word of Li and of k loaded
// once for two products, their squares summed. The R partial sums of a pair
// are added in rg order (for one point, kCp = 1, by the butterfly). Thread
// cp < kCp returns the larger value of its points (the first on a tie, -inf
// for a non-finite one) and its index; the other threads (-inf, kNc).
template <int kNc, bool kStage>
__device__ __forceinline__ LiBest li_candidates(const LiLane<kStage>& L, double* kxc,
                                                const double* xc, int t, unsigned m) {
  constexpr int kCp = (kNc + 1) / 2;  // point pairs
  static_assert(kCp <= kG, "a thread per point pair");
  constexpr int R = kG / kCp;         // row groups
  const int d = L.d, n = L.n, dp = L.dp;
  const int cp = t % kCp, rg = t / kCp;
  const bool own = rg < R;
  const int c0 = 2 * cp, c1 = min(c0 + 1, kNc - 1);
  double mua = 0.0, mub = 0.0, qa = 0.0, qb = 0.0;
  if (own) {
    const double* xa = xc + c0 * dp;
    const double* xb = xc + c1 * dp;
    for (int j = rg; j < n; j += R) {
      const double* Xj = L.X + j * dp;
      double sa = 0.0, sb = 0.0;
      for (int k = 0; k < d; ++k) {
        const double ra = xa[k] - Xj[k], rb = xb[k] - Xj[k];
        sa += ra * ra;
        sb += rb * rb;
      }
      const double ka = li_psi(L, m_sqrt(jmax(sa, 0.0)), sa);
      const double kb = li_psi(L, m_sqrt(jmax(sb, 0.0)), sb);
      kxc[j * kNc + c0] = ka;
      kxc[j * kNc + c1] = kb;
      mua += ka * L.c[j];
      mub += kb * L.c[j];
    }
  }
  __syncwarp(m);
  if (own) {
    const double* ka = kxc + c0;
    const double* kb = kxc + c1;
    for (int j0 = 2 * rg; j0 < n; j0 += 2 * R) {
      const double* Wa = L.row(j0);
      double waa = 0.0, wab = 0.0, wba = 0.0, wbb = 0.0;  // w<point><row>
      if (j0 + 1 < n) {
        const double* Wb = L.row(j0 + 1);
#pragma unroll 2
        for (int l = 0; l <= j0; ++l) {
          const double kal = ka[l * kNc], kbl = kb[l * kNc], Wal = Wa[l], Wbl = Wb[l];
          waa += Wal * kal;
          wab += Wbl * kal;
          wba += Wal * kbl;
          wbb += Wbl * kbl;
        }
        const double Wbb = Wb[j0 + 1];  // row j0 + 1's diagonal term
        wab += Wbb * ka[(j0 + 1) * kNc];
        wbb += Wbb * kb[(j0 + 1) * kNc];
      } else {
#pragma unroll 2
        for (int l = 0; l <= j0; ++l) {
          const double Wal = Wa[l];
          waa += Wal * ka[l * kNc];
          wba += Wal * kb[l * kNc];
        }
      }
      qa += waa * waa + wab * wab;
      qb += wba * wba + wbb * wbb;
    }
  }
  if constexpr (kCp == 1) {
    mua = group_sum(m, mua);
    qa = group_sum(m, qa);
    mub = mua;
    qb = qa;
  } else {
    const double mua0 = mua, mub0 = mub, qa0 = qa, qb0 = qb;
#pragma unroll
    for (int r = 1; r < R; ++r) {
      const int src = (t + r * kCp) & (kG - 1);
      mua += __shfl_sync(m, mua0, src, kG);
      mub += __shfl_sync(m, mub0, src, kG);
      qa += __shfl_sync(m, qa0, src, kG);
      qb += __shfl_sync(m, qb0, src, kG);
    }
  }
  LiBest best{neg_inf<double>(), kNc};
  if (t < kCp) {
    const double floor2 = L.sfloor * L.sfloor;
    const double va = finite_or_neg_inf(
        rule_value(L.rule, mua, m_sqrt(jmax(L.k0 - qa, floor2)), L.th, L.fm, L.stol));
    if (va > best.v) best = LiBest{va, c0};
    if (c1 != c0) {
      const double vb = finite_or_neg_inf(
          rule_value(L.rule, mub, m_sqrt(jmax(L.k0 - qb, floor2)), L.th, L.fm, L.stol));
      if (vb > best.v) best = LiBest{vb, c1};
    }
  }
  return best;
}

// One projected-Newton iteration of the group's start, as group_iteration
// above but in the Li form (D >= d unrolls the factorization). Results as
// there.
template <int D, bool kStage>
__device__ void li_iteration(const LiLane<kStage>& L, const LiScratch& S, int t, unsigned m,
                             double x_t, double scale, double ridge, double& xn_t, double& a0,
                             double& vbest) {
  const int d = L.d, dp = L.dp, n = L.n;
  const bool comp = t < d;
  const double* xs = S.xs();

  PHASE_START();
  // pass 1: k(x, X), b, iso, G_j = a_j r_j; mu; iso . c
  double mu = 0.0, iso_c = 0.0;
  for (int j = t; j < n; j += kG) {
    const double* Xj = L.X + j * dp;
    double sq = 0.0;
    for (int k = 0; k < d; ++k) {
      const double r = xs[k] - Xj[k];
      sq += r * r;
    }
    const double rho = m_sqrt(jmax(sq, 0.0));
    double psi, a, b, iso;
    profile_terms(L.kind, rho, sq, L.ell, L.period, psi, a, b, iso);
    const double ia = rho > kEps ? a : iso;
    S.kx()[j] = psi;
    S.bv()[j] = b;
    S.ia()[j] = ia;
    const double cj = L.c[j];
    mu += psi * cj;
    iso_c += cj * ia;
    double* Gj = S.Gm() + j * dp;
    for (int k = 0; k < d; ++k) Gj[k] = a * (xs[k] - Xj[k]);
  }
  mu = group_sum(m, mu);
  iso_c = group_sum(m, iso_c);
  __syncwarp(m);
  // pass 2: v = Li k by rows (l <= j), the variance k0 - |v|^2; then
  // w = Li^T v by columns, thread t on column l0 + t of each G-wide slice
  // over the rows j >= l (neighbouring words of one row); iso . w
  double quad = 0.0, iso_w = 0.0;
  for (int j = t; j < n; j += kG) {
    const double* Lj = L.row(j);
    double vj = 0.0;
#pragma unroll 4
    for (int l = 0; l <= j; ++l) vj += Lj[l] * S.kx()[l];
    S.vv()[j] = vj;
    quad += vj * vj;
  }
  quad = group_sum(m, quad);
  __syncwarp(m);
  for (int l0 = 0; l0 < n; l0 += kG) {
    const int l = l0 + t;
    double wl = 0.0;
    for (int j = l0; j < n; ++j)
      if (j >= l) wl += L.row(j)[l] * S.vv()[j];
    if (l < n) {
      S.wv()[l] = wl;
      iso_w += wl * S.ia()[l];
    }
  }
  iso_w = group_sum(m, iso_w);
  const double var = jmax(L.k0 - quad, L.sfloor * L.sfloor);
  const double sigma = m_sqrt(var);
  const double ssafe = jmax(sigma, L.sfloor);
  __syncwarp(m);
  // pass 3: grad mu and grad sigma, component t
  double gm_t = 0.0, gs_t = 0.0;
  if (comp) {
    for (int j = 0; j < n; ++j) {
      const double gjt = S.Gm()[j * dp + t];
      gm_t += L.c[j] * gjt;
      gs_t += S.wv()[j] * gjt;
    }
    gs_t = -gs_t / ssafe;
  }

  a0 = rule_value(L.rule, mu, sigma, L.th, L.fm, L.stol);
  double pr[5];
  rule_partials(L.rule, mu, sigma, L.th, L.fm, L.stol, pr);
  const double gmu = pr[0], gsig = pr[1], gmumu = pr[2], gsigsig = pr[3], gmusig = pr[4];
  const double hs = gsig / ssafe;  // gsig * hess_sigma = hs * (ssafe * hess_sigma)

  // gradient and the active set at the box faces, component t
  const double btol = 1e-9 * scale;
  double fr_t = 0.0, gf_t = 0.0;
  if (comp) {
    const double g_t = gmu * gm_t + gsig * gs_t;
    const bool lo = (x_t <= L.lb[t] + btol) && (g_t < 0.0);
    const bool hi = (x_t >= L.ub[t] - btol) && (g_t > 0.0);
    fr_t = (lo || hi) ? 0.0 : 1.0;
    gf_t = g_t * fr_t;
    S.gm()[t] = gm_t;
    S.gs()[t] = gs_t;
    S.fr()[t] = fr_t;
    S.gf()[t] = gf_t;
  }

  PHASE_MARK(0);  // the three passes, the rule, the active set
  // H as in group_iteration; G' K^{-1} G = P' P with P = Li G, and the sums
  // over the data are sum_j r_j C_j' - hs P_j P_j', C_j = (gmu c_j - hs w_j)
  // b_j r_j. P by strips (rows tj, tj + jstep, ...; column tk), one per thread
  const int jstep = kG / d;
  const int tj = t / d, tk = t - tj * d;
  if (tj < jstep) {
    const double* Gk = S.Gm() + tk;
    int j = tj;
    for (; j + jstep < n; j += 2 * jstep) {  // two rows at a time
      const double* La = L.row(j);
      const double* Lb = L.row(j + jstep);
      double ua = 0.0, ub = 0.0;
      int l = 0;
#pragma unroll 4
      for (; l <= j; ++l) {
        const double gl = Gk[l * dp];
        ua += La[l] * gl;
        ub += Lb[l] * gl;
      }
      for (; l <= j + jstep; ++l) ub += Lb[l] * Gk[l * dp];
      S.P()[j * dp + tk] = ua;
      S.P()[(j + jstep) * dp + tk] = ub;
    }
    if (j < n) {
      const double* La = L.row(j);
      double ua = 0.0;
      for (int l = 0; l <= j; ++l) ua += La[l] * Gk[l * dp];
      S.P()[j * dp + tk] = ua;
    }
  }
  __syncwarp(m);
  // G is spent: its rows take C_j, one entry per thread in turn
  for (int e = t; e < n * d; e += kG) {
    const int j = e / d, k = e - j * d;
    const double bj = S.bv()[j];
    const double coef = gmu * L.c[j] * bj - hs * S.wv()[j] * bj;
    S.Gm()[j * dp + k] = coef * (xs[k] - L.X[j * dp + k]);
  }
  __syncwarp(m);
  PHASE_MARK(1);  // P = Li G and the rows C_j
  // symmetric entries (i >= k) of H, a few per thread; A = -Hf on the free
  // set, the identity on the active one
  const int npairs = d * (d + 1) / 2;
  for (int e = t; e < npairs; e += kG) {
    int i = static_cast<int>((sqrtf(8.0f * e + 1.0f) - 1.0f) * 0.5f);
    while (i * (i + 1) / 2 > e) --i;
    while ((i + 1) * (i + 2) / 2 <= e) ++i;
    const int k = e - i * (i + 1) / 2;
    const double gmi = S.gm()[i], gmk = S.gm()[k], gsi = S.gs()[i], gsk = S.gs()[k];
    double h = gmumu * gmi * gmk + gsigsig * gsi * gsk + gmusig * (gmi * gsk + gsi * gmk) -
               hs * gsi * gsk;
    if (i == k) h += gmu * iso_c - hs * iso_w;
    const double xi = xs[i];
    double hc = 0.0, hp = 0.0;
    for (int j = 0; j < n; ++j) {
      hc += (xi - L.X[j * dp + i]) * S.Gm()[j * dp + k];
      hp += S.P()[j * dp + i] * S.P()[j * dp + k];
    }
    h += hc - hs * hp;
    const double fi = S.fr()[i], fk = S.fr()[k];
    const double aik = -(h * fi * fk - (i == k ? 1.0 - fi : 0.0));
    S.A()[i * dp + k] = aik;
    S.A()[k * dp + i] = aik;
  }
  __syncwarp(m);

  PHASE_MARK(2);  // the entries of H
  // Gershgorin-damped Newton direction
  double adiag = neg_inf<double>(), off = neg_inf<double>();
  if (comp) {
    const double* Ai = S.A() + t * dp;
    const double aii = Ai[t];
    double rowsum = 0.0;
    for (int k = 0; k < d; ++k) rowsum += m_abs(Ai[k]);
    adiag = m_abs(aii);
    off = rowsum - m_abs(aii) - aii;
  }
  const double s_scale = jmax(group_max(m, adiag), ridge);
  const double tau_g = jmax(group_max(m, off), 0.0) + ridge + 1e-6 * s_scale;
  double p_t;
  bool solved = false;  // the ridge first, the Gershgorin shift where it fails
  for (int k = 0; k < 2 && !solved; ++k)
    solved = chol_solve_inline<D>(S.A(), k == 0 ? ridge : tau_g, gf_t, d, dp, S.Lc(), t, m,
                                     p_t);
  if (!solved) p_t = gf_t / s_scale;
  PHASE_MARK(3);  // Gershgorin and the Cholesky solves
  p_t *= fr_t;
  const bool finite = __all_sync(m, m_finite(p_t));
  const double pg = group_sum(m, p_t * gf_t);
  const double gnorm2 = group_sum(m, gf_t * gf_t);
  const bool bad = !finite || pg <= 0.0;
  const double gden = jmax(m_sqrt(gnorm2), 1e-12);
  const double gstep_t = gf_t / gden * (0.1 * scale);
  if (bad) p_t = gstep_t;
  const double pn2 = group_sum(m, p_t * p_t);
  const double shrink = jmin(1.0, scale / jmax(m_sqrt(pn2), 1e-30));
  p_t *= shrink;
  if (comp) {
    S.pv()[t] = p_t;
    S.gv()[t] = gstep_t;
  }
  __syncwarp(m);

  PHASE_MARK(4);  // the directions
  // backtracking over both directions: direction 0 (Newton) steps 1, 1/2,
  // ... then direction 1 (gradient); strictly better than a0 only, the
  // lowest candidate on a tie
  a0 = finite_or_neg_inf(a0);
  for (int c = t; c < kCand; c += kG) {
    const int dir = c / kBacktrack, step = c - dir * kBacktrack;
    const double* dv = dir == 0 ? S.pv() : S.gv();
    const double tt = 1.0 / double(1 << step);
    double* xc = S.cand() + c * dp;
    for (int k = 0; k < d; ++k) xc[k] = clip(xs[k] + tt * dv[k], L.lb[k], L.ub[k]);
  }
  __syncwarp(m);
  const LiBest own = li_candidates<kCand>(L, S.kxc(), S.cand(), t, m);
  PHASE_MARK(5);  // the candidates' values
  const double vmax = group_max(m, own.v);  // no NaN left: a plain maximum
  const int win = group_min(m, own.v == vmax ? own.c : kCand);
  __syncwarp(m);
  if (vmax > a0 && win < kCand) {
    vbest = vmax;
    xn_t = comp ? S.cand()[win * dp + t] : 0.0;
  } else {
    vbest = a0;
    xn_t = x_t;
  }
  PHASE_MARK(6);  // the winner
}

// Block b runs lane block b / start_blocks over the starts of start block
// b % start_blocks (contiguous ranges of ceil(S / start_blocks)); a group of
// kG threads (a warp) per (lane, start), each group looping over starts ws,
// ws + groups_per_lane, ... of the block's range. The block's best start per lane
// goes to part (lane, start block): value, start (-1 if none), x. A start
// stops at a fixed point: an iteration is a function of x alone, so once it
// returns x unchanged every later one does too, and the result is the one
// all `iterations` would give. `runs` (may be null) takes the iterations
// each (lane, start) ran, for the measurements' work count.
#define LI_PARAMS                                                                        \
  const double *__restrict__ X, const double *__restrict__ Li,                           \
      const double *__restrict__ c, const long long *__restrict__ n_lane,                \
      const double *__restrict__ fmini, const double *__restrict__ theta0,               \
      const double *__restrict__ params, const double *__restrict__ lbs,                 \
      const double *__restrict__ ubs, const double *__restrict__ xstarts,                \
      double *__restrict__ part, int *__restrict__ runs, int num_lanes, int cap, int d,  \
      int S, int iterations, int kind, int rule, int lanes_per_block, int groups_per_lane, \
      int start_blocks, double stol, double sfloor, double ridge, double f_tol, double x_tol
#define LI_ARGS                                                                          \
  X, Li, c, n_lane, fmini, theta0, params, lbs, ubs, xstarts, part, runs, num_lanes, cap, d, \
      S, iterations, kind, rule, lanes_per_block, groups_per_lane, start_blocks, stol,     \
      sfloor, ridge, f_tol, x_tol
template <int D, bool kStage>
__device__ __forceinline__ void li_solve(LI_PARAMS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nth = blockDim.x;
  const int tid = threadIdx.x;
  const int dp = d | 1;
  const int tri = cap * (cap + 1) / 2;
  const int lblock = blockIdx.x / start_blocks, sb = blockIdx.x - lblock * start_blocks;
  const int chunk = (S + start_blocks - 1) / start_blocks;
  const int s_lo = sb * chunk, s_hi = min(S, s_lo + chunk);
  const int lane0 = lblock * lanes_per_block;
  const int here = min(lanes_per_block, num_lanes - lane0);

  // block: X (lanes, cap, dp), Li packed (lanes, tri) when staged, c (lanes,
  // cap), the box (2, dp); then one LiScratch per group
  double* sX = reinterpret_cast<double*>(smem_raw);
  double* sM = sX + lanes_per_block * cap * dp;
  double* sc = sM + (kStage ? lanes_per_block * tri : 0);
  double* sbox = sc + lanes_per_block * cap;
  double* sgroups = sbox + 2 * dp;
  const int group_words = LiScratch::words(cap, d, dp);

  for (int i = tid; i < here * cap * d; i += nth) {
    const int r = i / d;
    sX[r * dp + (i - r * d)] = X[(size_t)lane0 * cap * d + i];
  }
  if (kStage) {  // Li's lower triangle, packed: nothing reads above it
    for (int i = tid; i < here * cap * cap; i += nth) {
      const int r = i / cap, col = i - r * cap;
      const int ll = r / cap, j = r - ll * cap;
      if (col <= j) sM[ll * tri + j * (j + 1) / 2 + col] = Li[(size_t)lane0 * cap * cap + i];
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
  LiScratch Sg;
  Sg.base = sgroups + (size_t)g * group_words;
  Sg.cap = cap;
  Sg.d = d;
  Sg.dp = dp;
  const bool comp = t < d;

  if (active) {
    LiLane<kStage> L;
    L.X = sX + ll * cap * dp;
    L.M = kStage ? sM + ll * tri : Li + (size_t)lane * cap * cap;
    L.c = sc + ll * cap;
    L.lb = sbox;
    L.ub = sbox + dp;
    const long long nl = n_lane[lane];
    L.n = nl < 0 ? 0 : (nl > cap ? cap : static_cast<int>(nl));
    L.d = d;
    L.dp = dp;
    L.cap = cap;
    L.kind = kind;
    L.rule = rule;
    L.ell = params[0];
    L.period = params[1];
    double a_, b_, iso_;
    profile_terms(kind, 0.0, 0.0, L.ell, L.period, L.k0, a_, b_, iso_);
    li_psi_constants(L);
    L.fm = fmini[lane];
    L.th = theta0[lane];
    L.stol = stol;
    L.sfloor = sfloor;

    const double lb_t = comp ? L.lb[t] : 0.0, ub_t = comp ? L.ub[t] : 0.0;
    const double scale = group_max(m, comp ? ub_t - lb_t : neg_inf<double>());
    const bool loose = f_tol > 0.0 || x_tol > 0.0;
    // the group's best start so far, in start order (strict >: first wins)
    double best_v = neg_inf<double>(), best_x = 0.0;
    int best_s = -1;
    for (int s = s_lo + ws; s < s_hi; s += groups_per_lane) {
      double x_t = comp ? clip(xstarts[s * d + t], lb_t, ub_t) : 0.0;
      if (comp) Sg.xs()[t] = x_t;
      __syncwarp(m);
      int it = 0;
      while (it < iterations) {
        double xn_t, a0, vbest;
        li_iteration<D>(L, Sg, t, m, x_t, scale, ridge, xn_t, a0, vbest);
        ++it;
        bool freeze = __all_sync(m, xn_t == x_t);  // a fixed point
        if (loose) {
          // IPNewton-style loose acceptance (reference rbf_optim.jl:26-30);
          // a frozen start keeps its point, so it may stop iterating
          const double improvement = jmax(vbest - a0, 0.0);
          const double dx2 = group_sum(m, (xn_t - x_t) * (xn_t - x_t));
          freeze = freeze || improvement <= f_tol * (m_abs(a0) + f_tol) || m_sqrt(dx2) <= x_tol;
        }
        x_t = xn_t;
        if (comp) Sg.xs()[t] = x_t;
        __syncwarp(m);
        if (freeze) break;
      }
      if (runs != nullptr && t == 0) runs[(size_t)lane * S + s] = it;
      const double v = __shfl_sync(m, li_candidates<1>(L, Sg.kxc(), Sg.xs(), t, m).v, 0, kG);
      if (v > best_v) {
        best_v = v;
        best_x = x_t;
        best_s = s;
      }
    }
    double* res = Sg.res();
    if (t == 0) {
      res[0] = best_v;
      res[1] = double(best_s);
    }
    if (comp) res[2 + t] = best_x;
  }
  __syncthreads();

  // the block's best start per lane: the largest value, the lowest start on
  // a tie (what a strict > in start order selects)
  if (active && ws == 0 && comp) {
    double best = neg_inf<double>();
    int arg = -1, arg_s = 0;
    const size_t at = Sg.res() - Sg.base;
    for (int j = 0; j < groups_per_lane; ++j) {
      const double* res = sgroups + (size_t)(g + j) * group_words + at;
      const double v = res[0];
      const int s = static_cast<int>(res[1]);
      if (s >= 0 && (v > best || (v == best && s < arg_s))) {
        best = v;
        arg = j;
        arg_s = s;
      }
    }
    const double* res = sgroups + (size_t)(g + (arg < 0 ? 0 : arg)) * group_words + at;
    double* out = part + ((size_t)lane * start_blocks + sb) * (d + 2);
    out[2 + t] = arg < 0 ? 0.0 : res[2 + t];
    if (t == 0) {
      out[0] = best;
      out[1] = arg < 0 ? -1.0 : double(arg_s);
    }
  }
}

// The kernels, by the factorization's unroll (and so by their registers)
template <bool kStage>
__global__ void __maxnreg__(NEWTON_LI_MAXNREG8) newton_li_kernel_d8(LI_PARAMS) {
  li_solve<8, kStage>(LI_ARGS);
}
template <bool kStage>
__global__ void __launch_bounds__(kLiMaxThreads, 1) newton_li_kernel_d16(LI_PARAMS) {
  li_solve<16, kStage>(LI_ARGS);
}

using LiKernel = decltype(&newton_li_kernel_d8<true>);

// The kernel for this d: the factorization unrolled to 8 where d allows it
// and Li is staged (Li in device memory goes with the largest capacities).
LiKernel li_kernel_for(int d, int stage_m) {
  if (!stage_m) return newton_li_kernel_d16<false>;
  return d > 8 ? newton_li_kernel_d16<true> : newton_li_kernel_d8<true>;
}

int launch_li(const void* X, const void* Li, const void* c, const void* n,
              const void* fmini, const void* theta0, const void* params, const void* lbs,
              const void* ubs, const void* xstarts, void* xout, void* vout, void* part,
              void* runs, int num_lanes, int cap, int d, int S, int iterations, int kind, int rule,
              int lanes_per_block, int groups_per_lane, int start_blocks,
              int stage_m, double stol, double sfloor, double ridge, double f_tol,
              double x_tol, int smem, void* stream) {
  if (d < 1 || d > MAX_D || S < 1 || lanes_per_block < 1 || groups_per_lane < 1 ||
      start_blocks < 1 || start_blocks > S ||
      lanes_per_block * groups_per_lane * kG > kLiMaxThreads)
    return (int)cudaErrorInvalidValue;
  const LiKernel kernel = li_kernel_for(d, stage_m);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (num_lanes + lanes_per_block - 1) / lanes_per_block * start_blocks;
  const int threads = lanes_per_block * groups_per_lane * kG;
  LANES_LAUNCH(kernel, blocks, threads, smem, stream)(
      static_cast<const double*>(X), static_cast<const double*>(Li),
      static_cast<const double*>(c), static_cast<const long long*>(n),
      static_cast<const double*>(fmini), static_cast<const double*>(theta0),
      static_cast<const double*>(params), static_cast<const double*>(lbs),
      static_cast<const double*>(ubs), static_cast<const double*>(xstarts),
      static_cast<double*>(part), static_cast<int*>(runs), num_lanes, cap, d, S, iterations,
      kind, rule,
      lanes_per_block, groups_per_lane, start_blocks, stol, sfloor, ridge, f_tol, x_tol);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const auto reduce = best_start_kernel<double>;
  LANES_LAUNCH(reduce, (num_lanes + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0,
               stream)(static_cast<const double*>(part), static_cast<double*>(xout),
                       static_cast<double*>(vout), num_lanes, start_blocks, d);
  return (int)cudaGetLastError();
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

// blocks of `threads` threads and `smem` dynamic bytes that one SM holds, for
// the kernel that a launch of this itemsize, d and staging runs
extern "C" int newton_lanes_blocks_per_sm(int itemsize, int d, int stage_m, int threads,
                                          int smem) {
  int blocks = 0;
  cudaError_t e;
  if (itemsize == 4) {
    auto k = stage_m ? newton_lanes_kernel<true> : newton_lanes_kernel<false>;
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, threads, smem);
  } else {
    const LiKernel k = li_kernel_for(d, stage_m);
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, threads, smem);
  }
  return e == cudaSuccess ? blocks : -(int)e;
}

// The entry points: one signature for both. `part` (lanes, start blocks, d +
// 2) holds each block's best start where there are several start blocks (a
// float launch of one start block may pass null); `runs` (lanes, S) int32,
// may be null.
extern "C" int newton_lanes_f32(const void* X, const void* W, const void* c, const void* n,
                                const void* fmini, const void* theta0, const void* params,
                                const void* lbs, const void* ubs, const void* xstarts,
                                void* xout, void* vout, void* part, void* runs, int num_lanes,
                                int cap, int d, int S, int iterations, int kind, int rule,
                                int lanes_per_block, int groups_per_lane, int start_blocks,
                                int stage_m, double stol, double sfloor, double ridge,
                                double f_tol, double x_tol, int smem, void* stream) {
  return launch_f32(X, W, c, n, fmini, theta0, params, lbs, ubs, xstarts, xout, vout, part,
                    runs, num_lanes, cap, d, S, iterations, kind, rule, lanes_per_block,
                    groups_per_lane, start_blocks, stage_m, stol, sfloor, ridge, f_tol, x_tol,
                    smem, stream);
}

extern "C" int newton_lanes_f64(const void* X, const void* Li, const void* c, const void* n,
                                const void* fmini, const void* theta0, const void* params,
                                const void* lbs, const void* ubs, const void* xstarts,
                                void* xout, void* vout, void* part, void* runs, int num_lanes,
                                int cap, int d, int S, int iterations, int kind, int rule,
                                int lanes_per_block, int groups_per_lane, int start_blocks,
                                int stage_m, double stol, double sfloor, double ridge,
                                double f_tol, double x_tol, int smem, void* stream) {
  return launch_li(X, Li, c, n, fmini, theta0, params, lbs, ubs, xstarts, xout, vout, part,
                   runs, num_lanes, cap, d, S, iterations, kind, rule, lanes_per_block,
                   groups_per_lane, start_blocks, stage_m, stol, sfloor, ridge, f_tol, x_tol,
                   smem, stream);
}
