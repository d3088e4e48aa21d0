// Host emulation of the few CUDA features that the sources in
// rollout_bo_tpu_torch/csrc/ use (newton_lanes.cu, gp_mle.cu), so that g++
// can build a kernel and a CPU test can hold its control flow, indexing and
// reductions against the plain PyTorch version
// (tests/test_torch_kernel_emulation.py, tests/test_torch_mle_emulation.py).
// One OS thread per CUDA thread; blocks run one after another; __syncthreads,
// __syncwarp and the *_sync intrinsics are barriers over the threads of the
// block, or of the mask (a full warp, either half of it or one of its
// quarters: a group of 32, 16 or 8 threads). Kernels launch through the
// sources' LANES_LAUNCH and GP_MLE_LAUNCH. Shared memory is a heap block of
// exactly the launch's dynamic bytes, filled with 0xff (NaN patterns), so
// that an address sanitizer sees an overrun and a read of a word nobody
// wrote shows in the result. It says nothing about speed, bank
// conflicts or what nvcc accepts.
#pragma once
#include <barrier>
#include <cfloat>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __constant__ static const
#define __launch_bounds__(...)
#define __maxnreg__(...)
#define __noinline__
#define __align__(x)

struct EmuIdx { int x; };
static thread_local EmuIdx threadIdx, blockIdx, blockDim;
static unsigned char* emu_smem = nullptr;

typedef int cudaError_t;
typedef void* cudaStream_t;
static const int cudaSuccess = 0, cudaErrorInvalidValue = 1;
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F> int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int cudaGetLastError() { return 0; }
inline float normcdff(float x) { return 0.5f * erfcf(-x * 0.70710678118654752440f); }
inline double normcdf(double x) { return 0.5 * erfc(-x * 0.70710678118654752440); }
using std::min;

struct EmuWarp {
  unsigned long long slot[32];
  std::unique_ptr<std::barrier<>> bars[7];  // full, low half, high half, the quarters
  std::barrier<>& bar(unsigned m) {
    int i = m == 0xffffffffu ? 0 : (m == 0x0000ffffu ? 1 : (m == 0xffff0000u ? 2 : -1));
    for (int q = 0; q < 4; ++q)
      if (m == 0xffu << (8 * q)) i = 3 + q;
    if (i < 0 || !bars[i]) { fprintf(stderr, "emu: bad mask %08x\n", m); abort(); }
    return *bars[i];
  }
};
static std::vector<EmuWarp>* emu_warps = nullptr;
static std::barrier<>* emu_block_bar = nullptr;

inline void __syncthreads() { emu_block_bar->arrive_and_wait(); }
inline EmuWarp& emu_warp() { return (*emu_warps)[threadIdx.x >> 5]; }
inline void __syncwarp(unsigned m = 0xffffffffu) { emu_warp().bar(m).arrive_and_wait(); }

template <class T> T emu_exchange(unsigned m, T v, int src_lane) {
  EmuWarp& w = emu_warp();
  const int lane = threadIdx.x & 31;
  if (!((m >> lane) & 1u)) { fprintf(stderr, "emu: lane %d not in mask %08x\n", lane, m); abort(); }
  if (!((m >> src_lane) & 1u)) { fprintf(stderr, "emu: source %d not in mask %08x\n", src_lane, m); abort(); }
  w.slot[lane] = 0;
  memcpy(&w.slot[lane], &v, sizeof(T));
  w.bar(m).arrive_and_wait();
  T r;
  memcpy(&r, &w.slot[src_lane], sizeof(T));
  w.bar(m).arrive_and_wait();
  return r;
}
template <class T> T __shfl_sync(unsigned m, T v, int src, int width = 32) {
  const int lane = threadIdx.x & 31;
  return emu_exchange(m, v, (lane & ~(width - 1)) + (src & (width - 1)));
}
template <class T> T __shfl_xor_sync(unsigned m, T v, int o, int width = 32) {
  const int lane = threadIdx.x & 31;
  if (o >= width) { fprintf(stderr, "emu: xor offset\n"); abort(); }
  return emu_exchange(m, v, lane ^ o);
}
inline unsigned __ballot_sync(unsigned m, bool pred) {
  EmuWarp& w = emu_warp();
  const int lane = threadIdx.x & 31;
  w.slot[lane] = pred ? 1 : 0;
  w.bar(m).arrive_and_wait();
  unsigned bits = 0;
  for (int i = 0; i < 32; ++i)
    if (((m >> i) & 1u) && w.slot[i] != 0) bits |= 1u << i;
  w.bar(m).arrive_and_wait();
  return bits;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline bool __any_sync(unsigned m, bool pred) { return __ballot_sync(m, pred) != 0u; }
inline bool __all_sync(unsigned m, bool pred) {
  EmuWarp& w = emu_warp();
  const int lane = threadIdx.x & 31;
  w.slot[lane] = pred ? 1 : 0;
  w.bar(m).arrive_and_wait();
  bool all = true;
  for (int i = 0; i < 32; ++i)
    if ((m >> i) & 1u) all = all && w.slot[i] != 0;
  w.bar(m).arrive_and_wait();
  return all;
}

template <class K, class... Args>
void emu_run(K kernel, int blocks, int threads, int smem, Args... args) {
  for (int b = 0; b < blocks; ++b) {
    // exactly smem bytes on the heap, so that a sanitizer sees an overrun
    std::unique_ptr<unsigned char[]> mem(new unsigned char[smem]);
    memset(mem.get(), 0xff, smem);  // NaN patterns: unwritten reads show
    emu_smem = mem.get();
    const int nwarps = (threads + 31) / 32;
    std::vector<EmuWarp> warps(nwarps);
    for (int w = 0; w < nwarps; ++w) {
      const int in_warp = std::min(32, threads - 32 * w);
      if (in_warp == 32) warps[w].bars[0] = std::make_unique<std::barrier<>>(32);
      warps[w].bars[1] = std::make_unique<std::barrier<>>(16);
      if (in_warp == 32) warps[w].bars[2] = std::make_unique<std::barrier<>>(16);
      for (int q = 0; q < 4; ++q)
        if (in_warp >= 8 * (q + 1)) warps[w].bars[3 + q] = std::make_unique<std::barrier<>>(8);
    }
    std::barrier<> block_bar(threads);
    emu_warps = &warps;
    emu_block_bar = &block_bar;
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([=]() {
        threadIdx.x = t;
        blockIdx.x = b;
        blockDim.x = threads;
        kernel(args...);
      });
    for (auto& th : pool) th.join();
  }
}
template <class K> auto emu_launch(K kernel, int blocks, int threads, int smem) {
  return [=](auto... args) { emu_run(kernel, blocks, threads, smem, args...); };
}
#define LANES_LAUNCH(kernel, blocks, threads, smem, stream) \
  emu_launch(kernel, blocks, threads, smem)
#define GP_MLE_LAUNCH(kernel, blocks, threads, smem, stream) \
  emu_launch(kernel, blocks, threads, smem)
template <class F> int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* b, F, int, int) { *b = 0; return 0; }
inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
