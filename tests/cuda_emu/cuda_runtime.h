// An emulation of the parts of the CUDA runtime that the f32 kernels of
// mxnet_tpu_torch/csrc use, for compiling them with a host C++ compiler
// in the CPU tests (tests/test_torch_cuda_emu.py): one std::thread per
// CUDA thread, the blocks of a grid one after another, a std::barrier
// per block for __syncthreads, shared memory as a global array.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <thread>
#include <vector>

using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(x) alignas(x)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
extern thread_local dim3 threadIdx;
extern dim3 blockIdx;
extern std::barrier<>* emu_barrier;
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }

struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline float2 make_float2(float a, float b) { return {a, b}; }

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8
};
// what a block may use on an H100: 227 KB
constexpr size_t kEmuSharedBytes = 232448;
extern int emu_error;
template <class F>
int cudaFuncSetAttribute(F, int, int bytes) {
  return bytes > (int)kEmuSharedBytes ? cudaErrorInvalidValue : cudaSuccess;
}
inline int cudaGetLastError() {
  const int e = emu_error;
  emu_error = 0;
  return e;
}
inline int cudaSetDevice(int) { return cudaSuccess; }
inline const char* cudaGetErrorString(int) { return "emulated launch error"; }

// kernel<<<grid, threads, smem, stream>>>(args...) becomes
// emu_launch(kernel, grid, threads, smem, stream, args...)
template <class K, class... A>
void emu_launch(K kernel, dim3 grid, int threads, size_t smem, void*,
                A... args) {
  if (smem > kEmuSharedBytes || threads > 1024) {
    emu_error = cudaErrorInvalidConfiguration;
    return;
  }
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      blockIdx = dim3(bx, by);
      std::barrier<> bar(threads);
      emu_barrier = &bar;
      std::vector<std::thread> ts;
      for (int t = 0; t < threads; ++t)
        ts.emplace_back([=]() {
          threadIdx = dim3(t);
          kernel(args...);
        });
      for (auto& t : ts) t.join();
    }
}
