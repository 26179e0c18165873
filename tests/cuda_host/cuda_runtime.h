// A host stand-in for the parts of the CUDA runtime that
// kubernetes_tpu_torch/csrc/taint_ports.cu and csrc/preempt_whatif.cu use,
// so that their kernels can be compiled with a C++20 host compiler and run
// on the CPU (tests/test_torch_taint_ports_host.py,
// tests/test_torch_preempt_host.py). Each CUDA thread of a block is
// one std::thread, __syncthreads is a std::barrier over them (and
// __syncwarp one over each 32 of them), and the
// blocks of a grid run one after another over one shared-memory buffer.
// It checks the kernel's logic (compaction, merging, double buffering,
// the store paths), not its speed. The launch `k<<<grid, block, bytes,
// stream>>>(args)` is rewritten to `host_launch(grid, block, bytes, k,
// args)` before compiling.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

using std::isfinite;
using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
#define __shared__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct int4 { int x, y, z, w; };
struct uint4 { unsigned x, y, z, w; };
struct uint2 { unsigned x, y; };
struct alignas(8) int2 { int x, y; };
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
inline int2 make_int2(int a, int b) { return {a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline void __stcs(uint4* p, uint4 v) { *p = v; }
inline void __stcs(int4* p, int4 v) { *p = v; }
inline int atomicOr(int* p, int v) {
  return std::atomic_ref<int>(*p).fetch_or(v);
}
inline int atomicAnd(int* p, int v) {
  return std::atomic_ref<int>(*p).fetch_and(v);
}

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* host_block_barrier;
inline thread_local std::barrier<>* host_warp_barrier;
inline void __syncthreads() { host_block_barrier->arrive_and_wait(); }
// a barrier over the calling thread's warp (32 consecutive threads)
inline void __syncwarp(unsigned = 0xffffffffu) {
  host_warp_barrier->arrive_and_wait();
}
namespace {
// the block's dynamic shared memory (an `extern __shared__` array in the
// kernel's own anonymous namespace names this one)
alignas(16) unsigned char smem[232448];
}  // namespace

typedef void* cudaStream_t;
enum cudaError_t {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline int host_shared_opt_in = 0;
// a card of one SM that holds one block, so that every block walks all
// the pod chunks of its node tile
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int bytes) {
  host_shared_opt_in = bytes;
  return cudaSuccess;
}
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 1;
  return cudaSuccess;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int,
                                                          size_t) {
  *n = 1;
  return cudaSuccess;
}
inline cudaError_t host_last_error = cudaSuccess;
inline cudaError_t cudaGetLastError() {
  const cudaError_t e = host_last_error;
  host_last_error = cudaSuccess;
  return e;
}
inline const char* cudaGetErrorString(cudaError_t) { return "host launch"; }

template <class K, class... A>
void host_launch(dim3 grid, dim3 block, size_t bytes, cudaStream_t, K kernel,
                 A... args) {
  // a block above 48 KB must have opted in, as on the card
  if (bytes > sizeof(smem) ||
      (bytes > 48 * 1024 && (long)bytes > host_shared_opt_in)) {
    host_last_error = cudaErrorInvalidValue;
    return;
  }
  gridDim = grid;
  blockDim = block;
  const unsigned nt = block.x * block.y;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::memset(smem, 0xAB, sizeof(smem));  // no state between blocks
      std::barrier<> bar(nt);
      host_block_barrier = &bar;
      std::vector<std::unique_ptr<std::barrier<>>> warps;
      for (unsigned w = 0; w * 32 < nt; ++w)
        warps.push_back(std::make_unique<std::barrier<>>(
            std::min<unsigned>(32, nt - w * 32)));
      std::vector<std::thread> threads;
      for (unsigned ty = 0; ty < block.y; ++ty)
        for (unsigned tx = 0; tx < block.x; ++tx)
          threads.emplace_back([=, &warps] {
            threadIdx = dim3(tx, ty);
            blockIdx = dim3(bx, by);
            host_warp_barrier = warps[(ty * block.x + tx) / 32].get();
            kernel(args...);
          });
      for (auto& t : threads) t.join();
    }
}

// IEEE single-precision arithmetic rounded to nearest, one operation at a
// time (the card's __fadd_rn / __fsub_rn / __fmul_rn); the host compile
// turns FMA contraction off (-ffp-contract=off)
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline int __float_as_int(float f) {
  int i;
  std::memcpy(&i, &f, sizeof i);
  return i;
}
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, sizeof f);
  return f;
}
