// An emulation of the parts of the CUDA runtime that the kernels of
// mxnet_tpu_torch/csrc run under it use, for compiling them with a host
// C++ compiler in the CPU tests (tests/test_torch_cuda_emu*.py): the f32
// attention kernels, the NMS kernel and the image augment kernel.  One
// fiber (a ucontext with its own stack, all on the calling OS thread) per
// CUDA thread, the blocks of
// a grid one after another, a barrier per block for __syncthreads and one
// per warp for __syncwarp and the shuffles (each lane writes its value to
// a slot of the block, the warp meets, each lane reads its source lane's
// slot, the warp meets again), shared memory as a global array.  A fiber
// runs until it arrives at a barrier; the scheduler then runs the fibers
// free to go in an order it shuffles at each pass (a fixed seed, so a run
// repeats), so threads run ahead of one another as far as the barriers
// let them, in changing orders: a missing barrier shows as a read of data
// not yet written, or already overwritten.  A barrier that some threads never
// reach (a hang on the card) aborts the process with a message.
#pragma once
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <deque>
#include <functional>
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
// the running fiber's thread index, set by the scheduler at each switch
extern dim3 threadIdx;
extern dim3 blockIdx;
extern dim3 gridDim;

// A barrier of `expected` fibers: each arriving fiber gives the OS
// thread back to the scheduler (emu_state.cpp), the last after opening
// the next generation; the scheduler resumes a fiber only once the
// generation it arrived in has passed.
struct EmuBarrier {
  int expected, arrived = 0;
  unsigned gen = 0;
  explicit EmuBarrier(int n) : expected(n) {}
  void arrive_and_wait();
};
void emu_wait(EmuBarrier* b, unsigned gen);
inline void EmuBarrier::arrive_and_wait() {
  const unsigned g = gen;
  if (++arrived == expected) {
    arrived = 0;
    ++gen;
  }
  emu_wait(this, g);
}
extern EmuBarrier* emu_barrier;
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }

// the warps' barriers and the shuffles' slots of the running block
extern std::deque<EmuBarrier>* emu_warp_barriers;
extern uint64_t emu_shfl_slots[1024];
inline void __syncwarp(unsigned = 0xffffffffu) {
  (*emu_warp_barriers)[threadIdx.x / 32].arrive_and_wait();
}
template <class T>
T emu_shfl_from(T v, int src_lane) {
  static_assert(sizeof(T) <= sizeof(uint64_t), "one slot a lane");
  const unsigned w = threadIdx.x / 32;
  std::memcpy(&emu_shfl_slots[threadIdx.x], &v, sizeof(T));
  __syncwarp();
  T r;
  std::memcpy(&r, &emu_shfl_slots[w * 32 + (src_lane & 31)], sizeof(T));
  __syncwarp();
  return r;
}
template <class T>
T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  return emu_shfl_from(v, (int)(threadIdx.x & 31) ^ lane_mask);
}
template <class T>
T __shfl_sync(unsigned, T v, int src_lane) {
  return emu_shfl_from(v, src_lane);
}
template <class T>
T __shfl_up_sync(unsigned, T v, unsigned delta) {
  const int lane = (int)(threadIdx.x & 31);  // lanes below delta keep v
  return emu_shfl_from(v, lane >= (int)delta ? lane - (int)delta : lane);
}
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  unsigned m = v;
  for (int off = 1; off < 32; off <<= 1)
    m = std::max(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}
inline unsigned __reduce_add_sync(unsigned, unsigned v) {
  unsigned s = v;
  for (int off = 1; off < 32; off <<= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}
// the lanes of a warp are fibers of one OS thread: an atomic is a plain
// read-modify-write between two switches
inline unsigned atomicOr(unsigned* p, unsigned v) {
  const unsigned old = *p;
  *p = old | v;
  return old;
}
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
// IEEE single precision, round to nearest, never contracted: the host's
// float arithmetic (x86-64 SSE, -ffp-contract=off)
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
// round toward zero: the sum in double, then toward zero to float; exact
// wherever the double sum is (operands within 29 binary orders of each
// other, as in the kernels' uses)
inline float __fadd_rz(float a, float b) {
  const double d = (double)a + (double)b;
  float r = (float)d;
  if (std::fabs((double)r) > std::fabs(d)) r = std::nextafter(r, 0.0f);
  return r;
}
// a load through the read-only cache: a plain load here
template <class T>
inline T __ldg(const T* p) {
  return *p;
}

struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
struct uint4 { unsigned x, y, z, w; };
struct uint2 { unsigned x, y; };
struct int4 { int x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline float2 make_float2(float a, float b) { return {a, b}; }
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaDevAttrMultiProcessorCount = 16
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
inline int cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
// the SMs a kernel sees; the tests set it to steer a choice that follows
// the card's size
extern "C" int emu_sm_count;
inline int cudaDeviceGetAttribute(int* v, int, int) {
  *v = emu_sm_count;
  return cudaSuccess;
}
inline const char* cudaGetErrorString(int) { return "emulated launch error"; }

// runs `threads` fibers of emu_body to their end (emu_state.cpp)
extern std::function<void()>* emu_body;
void emu_run_block(int threads);

// kernel<<<grid, threads, smem, stream>>>(args...) becomes
// emu_launch(kernel, grid, threads, smem, stream, args...)
template <class K, class... A>
void emu_launch(K kernel, dim3 grid, int threads, size_t smem, void*,
                A... args) {
  if (smem > kEmuSharedBytes || threads > 1024) {
    emu_error = cudaErrorInvalidConfiguration;
    return;
  }
  std::function<void()> body = [=]() { kernel(args...); };
  emu_body = &body;
  gridDim = grid;
  for (unsigned bz = 0; bz < grid.z; ++bz)
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      blockIdx = dim3(bx, by, bz);
      EmuBarrier bar(threads);
      emu_barrier = &bar;
      std::deque<EmuBarrier> warps;
      for (int w = 0; w < threads; w += 32)
        warps.emplace_back(std::min(32, threads - w));
      emu_warp_barriers = &warps;
      emu_run_block(threads);
    }
  emu_body = nullptr;
}
