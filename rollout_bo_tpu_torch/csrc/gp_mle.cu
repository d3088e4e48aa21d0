// Box-constrained MLE of one GP's kernel hyperparameters per block: every
// projected-Adam step of `optimize_hypers` in one launch.
//
// Replaces no TPU kernel. The JAX package runs this MLE as XLA ops
// (rollout_bo_tpu/models/surrogate.py::optimize_hypers, `jax.grad` through
// the JAX Cholesky); the port first ran it as PyTorch ops with autograd
// through a masked `cholesky_ex` over the whole capacity: per Adam step a
// factorization, a triangular inverse against the identity and the
// backward pass, some 30 small cuBLAS / cuSOLVER launches, ~535 us a step
// at every n (PERF.md). This kernel runs the same iteration with the
// closed-form gradient of the log marginal likelihood (reference
// radial_basis_surrogates.jl:778-799):
//
//   d log p / d log theta_k = sum_{i > j} (alpha_i alpha_j - Kinv_ij) dK_ij,
//
// with alpha = K^{-1} y and dK = d K / d log theta_k in closed form per
// kind (zero on the diagonal: psi(0) = 1 for every kind), over the active
// n x n block only (the identity padding adds 0 to both terms). A step at
// which a pivot of K(theta) is <= 0 or not finite has gradient 0, and a
// non-finite component is zeroed: the NaN contract of the autograd loop.
// Adam (0.9, 0.999, 1e-8), its bias corrections, the step of `lr` and the
// clamp to [log lb, log ub] are that loop's, in the same order.
//
// What bounds it on an H100: neither operations nor bytes. A step at n 105
// is ~n^3 = 1.2 MFLOP (the factorization and the inverse's row operations
// 2n^3/3, K^{-1}'s lower triangle n^3/3): 60 steps are 2.1 us of the card's
// 33.5 TFLOP/s of float64, over ~6 KB of X and y. What the time is made of
// is the chain of dependent steps: 60 Adam steps, each a factorization
// whose n columns follow one another, inside one block.
//
// Design:
// - One block per GP (the grid runs over leading lane axes); the whole Adam
//   loop runs inside the block, with no host synchronization and no launch
//   per step. n is read on the device, so one captured graph serves every
//   n; every loop runs over the active n x n block.
// - X, y and the pairwise distances (packed lower triangle) are staged once,
//   and Adam's bias corrections and the log bounds computed once. Each step
//   builds K's lower triangle in one n x n square S (row-major, an odd row
//   stride so that a warp's strided column reads hit distinct banks) and
//   zeroes its upper triangle.
// - Factorization and inverse in one right-looking elimination: column j's
//   row operations on [K | I] update the trailing lower triangle (the
//   unscaled factor, A_rc -= A_cj A_rj / p_j) and, stored transposed in S's
//   upper triangle, the unit-lower inverse M = L_unit^{-1} (M_cr -= A_cj
//   M_jr / p_j). A warp takes rows, its lanes columns. Two columns go per
//   block barrier, with the arithmetic of one after the other: each thread
//   forms the second column after the first's update where it reads it, so
//   an entry is read and written once per pair. A column is latency: the
//   barrier, the pivot's reciprocal, the rows of the busiest warp.
//   Li = L^{-1} = diag(1/sqrt(p)) M (a scaling pass), alpha = Li^T (Li y)
//   by two warp-per-row products, and K^{-1}'s lower triangle as the Gram
//   of Li's columns (warp per row, lanes over columns, four chains of sums
//   each), reduced in registers straight into the gradient.
// - Where S, the distances and X do not fit in the 227 KB a block can use
//   (capacity above 135 in float64, 193 in float32, at d 6), the same code
//   keeps them in a device scratch buffer that the wrapper allocates (L2
//   holds it); the small vectors stay in shared memory. The choice follows
//   the shape alone (ops/gp_mle.py::_layout).
// - Sums run in a fixed order (butterflies, then the warps in order): no
//   atomics, so a graph replay equals an eager launch bit for bit.
// - The block size is a launch parameter (a multiple of 32): the card runs
//   1024 threads, the host emulation (tests/test_torch_mle_emulation.py) a
//   few. Tried on the card and dropped (PERF.md, section 6): the elimination
//   with the square in registers (a tile per thread) issued ~6 guard
//   instructions per multiply-add and ran no faster at n 105, slower below.

#include <cuda_runtime.h>
#include <math.h>

#ifndef GP_MLE_LAUNCH
#define GP_MLE_LAUNCH(kernel, blocks, threads, smem, stream) \
  kernel<<<(blocks), (threads), (smem), static_cast<cudaStream_t>(stream)>>>
#endif

namespace {

constexpr int kMaxThreads = 1024;
// kernel kinds: the order of ops/gp_mle.py::KINDS
constexpr int kMatern52 = 0, kMatern32 = 1, kMatern12 = 2, kSqExp = 3, kPeriodic = 4;

// psi(r) of the kind at hyperparameters th, the expressions of
// ops/kernels.py::_profile; with GRAD also d psi / d log th_k into dl
// (ops/kernels.py::profile_dlog_theta)
template <typename T, bool GRAD>
__device__ __forceinline__ T profile(int kind, T r, const T* th, T* dl) {
  const T ell = th[0];
  if (kind == kMatern52) {
    const T c = T(2.23606797749978969640) / ell;
    const T s = c * r;
    const T e = exp(-s);
    if constexpr (GRAD) dl[0] = (s * s / T(3)) * (T(1) + s) * e;
    return (T(1) + s * (T(1) + s / T(3))) * e;
  } else if (kind == kMatern32) {
    const T c = T(1.73205080756887729353) / ell;
    const T s = c * r;
    const T e = exp(-s);
    if constexpr (GRAD) dl[0] = s * s * e;
    return (T(1) + s) * e;
  } else if (kind == kMatern12) {
    const T s = r / ell;
    const T e = exp(-s);
    if constexpr (GRAD) dl[0] = s * e;
    return e;
  } else if (kind == kSqExp) {
    const T l2 = ell * ell;
    const T psi = exp(-(r * r) / (T(2) * l2));
    if constexpr (GRAD) dl[0] = (r * r / l2) * psi;
    return psi;
  } else {
    const T c1 = T(2) / (ell * ell);
    const T w = T(3.14159265358979323846) / th[1];
    const T u = w * r;
    const T sn = sin(u);
    const T psi = exp(-c1 * (sn * sn));
    if constexpr (GRAD) {
      dl[0] = T(2) * c1 * (sn * sn) * psi;
      dl[1] = c1 * u * sin(T(2) * u) * psi;
    }
    return psi;
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ T clamp_to(T x, T lo, T hi) {
  x = x < lo ? lo : x;   // torch.clamp: NaN stays NaN
  return hi < x ? hi : x;
}


// STAGED: every matrix in shared memory (the compiler then addresses it as
// such); else S, the distances and X in this GP's part of `scratch`.
template <typename T, bool STAGED>
__global__ void __launch_bounds__(kMaxThreads)
gp_mle_kernel(const T* __restrict__ Xg, const T* __restrict__ yg,
              const long long* __restrict__ ng, const T* __restrict__ noise,
              const T* __restrict__ theta0, const T* __restrict__ lbg,
              const T* __restrict__ ubg, T* __restrict__ theta_out, T* __restrict__ scratch,
              int cap, int d, int kind, int iterations, T lr) {
  const int P = kind == kPeriodic ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int gp = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, W = blockDim.x >> 5;
  const int ld = cap | 1;
  // S (cap x ld), the distances (packed lower triangle) and X
  const size_t big = (size_t)cap * ld + (size_t)cap * (cap - 1) / 2 + (size_t)cap * d;
  T* S = STAGED ? sm : scratch + (size_t)gp * big;
  T* D = S + (size_t)cap * ld;
  T* Xs = D + (size_t)cap * (cap - 1) / 2;
  T* y = STAGED ? sm + big : sm;
  T* z = y + cap;         // Li y
  T* al = z + cap;        // alpha = K^{-1} y
  T* col1 = al + cap;     // the second column of a pair, after the first
  T* rs = col1 + cap;     // 1 / sqrt(pivot): Li's diagonal
  T* red = rs + cap;      // W x 2: each warp's part of the gradient
  T* th = red + 2 * W;    // theta = exp(lt) of the current step
  T* lt = th + 2;         // log theta, Adam's moments, log of the bounds
  T* mo = lt + 2;
  T* ve = mo + 2;
  T* llb = ve + 2;
  T* lub = llb + 2;
  T* bc = lub + 2;        // 2 x iterations: Adam's bias corrections

  const long long nl = ng[gp];
  const int n = nl < 0 ? 0 : (nl > cap ? cap : (int)nl);
  const T nz = noise[0];
  for (int e = tid; e < n * d; e += blockDim.x) Xs[e] = Xg[(size_t)gp * cap * d + e];
  for (int i = tid; i < n; i += blockDim.x) y[i] = yg[(size_t)gp * cap + i];
  for (int t = tid; t < iterations; t += blockDim.x) {
    bc[t] = T(1.0 - pow(0.9, (double)(t + 1)));
    bc[iterations + t] = T(1.0 - pow(0.999, (double)(t + 1)));
  }
  if (tid < P) {
    llb[tid] = log(lbg[tid]);
    lub[tid] = log(ubg[tid]);
    lt[tid] = clamp_to(log(theta0[(size_t)gp * P + tid]), llb[tid], lub[tid]);
    mo[tid] = T(0);
    ve[tid] = T(0);
    th[tid] = exp(lt[tid]);
  }
  __syncthreads();
  for (int i = warp; i < n; i += W)
    for (int j = lane; j < i; j += 32) {
      T sq = T(0);
      for (int k = 0; k < d; ++k) {
        const T t = Xs[i * d + k] - Xs[j * d + k];
        sq += t * t;
      }
      D[(size_t)i * (i - 1) / 2 + j] = sqrt(sq);
    }
  __syncthreads();

  for (int it = 0; it < iterations; ++it) {
    const T tk[2] = {th[0], th[1]};
    // K's lower triangle (psi(0) + noise on the diagonal), zeros above it
    for (int i = warp; i < n; i += W) {
      T* row = S + (size_t)i * ld;
      const T* drow = D + (size_t)i * (i - 1) / 2;
#pragma unroll 2
      for (int j = lane; j < n; j += 32) {
        T v = T(0);
        if (j < i) v = profile<T, false>(kind, drow[j], tk, nullptr);
        else if (j == i) v = T(1) + nz;
        row[j] = v;
      }
    }
    __syncthreads();
    // the elimination: column j updates the columns c > j, the factor's
    // rows r >= c and the inverse's rows r <= j (S(r, c) = M_cr above the
    // diagonal): S(r, c) -= (S(c, j) / p_j) u_r, u_r = S(r, j) (1 at r = j).
    // Columns j and j1 = j + 1 go together, in the order of one column after
    // the other: every thread forms column j1 after column j's update where
    // it needs it, and column j1's values go back to S at the next pair
    // (through col1), when no thread reads their old values any more.
    bool pd = true;
    int prev = -1;   // the column whose values wait in col1
    for (int j = 0; j < n; j += 2) {
      const T p = S[(size_t)j * (ld + 1)];
      if (!(p > T(0)) || !isfinite(p)) {   // the same p in every thread
        pd = false;
        break;
      }
      const T rp = T(1) / p;
      const int j1 = j + 1;
      if (j1 == n) break;   // the last column updates nothing
      const T sj1 = S[(size_t)j1 * ld + j];
      const T a1 = sj1 * rp;
      const T p1 = S[(size_t)j1 * (ld + 1)] - a1 * sj1;
      if (!(p1 > T(0)) || !isfinite(p1)) {
        pd = false;
        break;
      }
      const T rp1 = T(1) / p1;
      for (int r = warp; r < n; r += W) {
        T* row = S + (size_t)r * ld;
        const T uj = r == j ? T(1) : row[j];
        const T s1 = row[j1] - a1 * uj;    // S(r, j1) after column j (p1 at r = j1)
        const T uj1 = r == j1 ? T(1) : s1;
        if (lane == 0) {
          if (prev >= 0) row[prev] = col1[r];
          col1[r] = s1;
        }
        const int cend = r <= j1 ? n : r + 1;
        for (int c = j1 + 1 + lane; c < cend; c += 32) {
          const T* col = S + (size_t)c * ld;
          const T scj = col[j];
          const T vj = scj * rp;
          const T vj1 = (col[j1] - a1 * scj) * rp1;
          T v = row[c];
          if (r != j1) v = v - vj * uj;
          row[c] = v - vj1 * uj1;
        }
      }
      prev = j1;
      __syncthreads();
    }
    if (pd && prev >= 0) {
      for (int r = tid; r < n; r += blockDim.x) S[(size_t)r * ld + prev] = col1[r];
      __syncthreads();
    }
    if (pd) {
      // Li = diag(rs) M: above the diagonal S(r, c) = Li_cr
      for (int m = tid; m < n; m += blockDim.x) rs[m] = T(1) / sqrt(S[(size_t)m * (ld + 1)]);
      __syncthreads();
      for (int r = warp; r < n; r += W) {
        T* row = S + (size_t)r * ld;
        for (int c = r + 1 + lane; c < n; c += 32) row[c] *= rs[c];
      }
      __syncthreads();
    }
    T acc[2] = {T(0), T(0)};
    if (pd) {
      // z = Li y: z_m = rs_m y_m + sum_{k < m} Li_mk y_k
      for (int m = warp; m < n; m += W) {
        T part = T(0);
        for (int k = lane; k < m; k += 32) part += S[(size_t)k * ld + m] * y[k];
        part = warp_sum(part);
        if (lane == 0) z[m] = rs[m] * y[m] + part;
      }
      __syncthreads();
      // alpha = Li^T z: alpha_i = rs_i z_i + sum_{m > i} Li_mi z_m
      for (int i = warp; i < n; i += W) {
        const T* row = S + (size_t)i * ld;
        T part = T(0);
        for (int m = i + 1 + lane; m < n; m += 32) part += row[m] * z[m];
        part = warp_sum(part);
        if (lane == 0) al[i] = rs[i] * z[i] + part;
      }
      __syncthreads();
      // Kinv_ij = sum_{m >= i} Li_mi Li_mj (i > j), in four chains, straight
      // into the sum
      for (int i = warp; i < n; i += W) {
        const T* rowi = S + (size_t)i * ld;
        const T* drow = D + (size_t)i * (i - 1) / 2;
        for (int j = lane; j < i; j += 32) {
          const T* rowj = S + (size_t)j * ld;
          T k0 = rs[i] * rowj[i], k1 = T(0), k2 = T(0), k3 = T(0);
          int m = i + 1;
          for (; m + 3 < n; m += 4) {
            k0 += rowi[m] * rowj[m];
            k1 += rowi[m + 1] * rowj[m + 1];
            k2 += rowi[m + 2] * rowj[m + 2];
            k3 += rowi[m + 3] * rowj[m + 3];
          }
          for (; m < n; ++m) k0 += rowi[m] * rowj[m];
          const T w = al[i] * al[j] - ((k0 + k1) + (k2 + k3));
          T dl[2];
          profile<T, true>(kind, drow[j], tk, dl);
          acc[0] += w * dl[0];
          if (P == 2) acc[1] += w * dl[1];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const T v = warp_sum(acc[k]);
      if (lane == 0) red[warp * 2 + k] = v;
    }
    __syncthreads();
    if (tid < P) {
      const int k = tid;
      T G = T(0);
      for (int w = 0; w < W; ++w) G += red[w * 2 + k];
      T g = pd ? -G : T(0);            // d(-log p) / d log theta_k
      if (!isfinite(g)) g = T(0);
      mo[k] = T(0.9) * mo[k] + T(1.0 - 0.9) * g;
      ve[k] = T(0.999) * ve[k] + T(1.0 - 0.999) * g * g;
      const T mhat = mo[k] / bc[it];
      const T vhat = ve[k] / bc[iterations + it];
      lt[k] = clamp_to(lt[k] - lr * mhat / (sqrt(vhat) + T(1e-8)), llb[k], lub[k]);
      th[k] = exp(lt[k]);
    }
    __syncthreads();
  }
  if (tid < P) theta_out[(size_t)gp * P + tid] = th[tid];
}

template <typename T, bool STAGED>
int launch_layout(const void* X, const void* y, const void* n, const void* noise,
                  const void* theta0, const void* lb, const void* ub, void* theta_out,
                  void* scratch, int num_gps, int cap, int d, int kind, int iterations,
                  double lr, int threads, int smem, void* stream) {
  const auto kernel = gp_mle_kernel<T, STAGED>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  GP_MLE_LAUNCH(kernel, num_gps, threads, smem, stream)(
      static_cast<const T*>(X), static_cast<const T*>(y), static_cast<const long long*>(n),
      static_cast<const T*>(noise), static_cast<const T*>(theta0), static_cast<const T*>(lb),
      static_cast<const T*>(ub), static_cast<T*>(theta_out), static_cast<T*>(scratch), cap, d,
      kind, iterations, static_cast<T>(lr));
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* X, const void* y, const void* n, const void* noise, const void* theta0,
           const void* lb, const void* ub, void* theta_out, void* scratch, int num_gps,
           int cap, int d, int kind, int iterations, double lr, int staged, int threads,
           int smem, void* stream) {
  if (num_gps < 1 || cap < 1 || d < 1 || iterations < 0 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || smem < 0 || (!staged && !scratch) ||
      kind < kMatern52 || kind > kPeriodic)
    return (int)cudaErrorInvalidValue;
  return (staged ? launch_layout<T, true> : launch_layout<T, false>)(
      X, y, n, noise, theta0, lb, ub, theta_out, scratch, num_gps, cap, d, kind, iterations, lr,
      threads, smem, stream);
}

}  // namespace


// The entry points, one per dtype. X (num_gps, cap, d), y (num_gps, cap), n
// (num_gps,) int64, noise (1), theta0 (num_gps, P), lb and ub (P) the
// hyperparameters' box, theta_out (num_gps, P); P = 2 for the periodic kind,
// else 1. `staged` 1: every matrix in `smem` bytes of shared memory; 0: S,
// the distances and X in `scratch` (num_gps x (cap * (cap | 1) + cap * (cap
// - 1) / 2 + cap * d) elements).
extern "C" int gp_mle_f64(const void* X, const void* y, const void* n, const void* noise,
                          const void* theta0, const void* lb, const void* ub, void* theta_out,
                          void* scratch, int num_gps, int cap, int d, int kind, int iterations,
                          double lr, int staged, int threads, int smem, void* stream) {
  return launch<double>(X, y, n, noise, theta0, lb, ub, theta_out, scratch, num_gps, cap, d,
                        kind, iterations, lr, staged, threads, smem, stream);
}

extern "C" int gp_mle_f32(const void* X, const void* y, const void* n, const void* noise,
                          const void* theta0, const void* lb, const void* ub, void* theta_out,
                          void* scratch, int num_gps, int cap, int d, int kind, int iterations,
                          double lr, int staged, int threads, int smem, void* stream) {
  return launch<float>(X, y, n, noise, theta0, lb, ub, theta_out, scratch, num_gps, cap, d,
                       kind, iterations, lr, staged, threads, smem, stream);
}
