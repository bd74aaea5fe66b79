// The emulation's mma_tiles.cuh.  cp.async copies: with emu_defer 0 each
// lands when it starts; with emu_defer 1 it is held in its thread's
// commit group and lands only at the cp.async.wait that must cover it, so
// a read that comes before its wait sees stale data.  The tensor-core
// helpers of the bf16 kernels abort: those kernels only compile here.
#pragma once
#include <cstdlib>
#include <cstring>
#include <deque>
#include <stdint.h>
#include <vector>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

extern "C" int emu_defer;

namespace mma {

using bf16 = __nv_bfloat16;

template <int D>
constexpr int row_stride() {
  return D + 8;
}

struct Copy {
  void* dst;
  const void* src;
  int bytes, size;
};
// each CUDA thread's open group and committed groups (by threadIdx.x)
extern std::vector<Copy> open_groups[1024];
extern std::deque<std::vector<Copy>> groups_of[1024];

inline void land(const Copy& c) {
  memset(c.dst, 0, c.size);
  if (c.bytes) memcpy(c.dst, c.src, c.bytes);
}
inline void start_copy(const Copy& c) {
  if (emu_defer)
    open_groups[threadIdx.x].push_back(c);
  else
    land(c);
}
inline void cp_async16(void* dst, const void* src, int src_bytes) {
  start_copy({dst, src, src_bytes, 16});
}
inline void cp_async4(void* dst, const void* src, bool ok) {
  start_copy({dst, src, ok ? 4 : 0, 4});
}
inline void cp_async_commit() {
  groups_of[threadIdx.x].push_back(open_groups[threadIdx.x]);
  open_groups[threadIdx.x].clear();
}
template <int N>
inline void cp_async_wait() {
  auto& groups = groups_of[threadIdx.x];
  while ((int)groups.size() > N) {
    for (const Copy& c : groups.front()) land(c);
    groups.pop_front();
  }
}

template <int D, int ROWS, int NT>
inline void load_rows(bf16*, const bf16*, int, int) { abort(); }
template <int LD>
inline void load_a(uint32_t (&)[4], const bf16*, int, int, int) { abort(); }
template <int LD>
inline void load_b_nk(uint32_t (&)[4], const bf16*, int, int, int) {
  abort();
}
template <int LD>
inline void load_b_kn(uint32_t (&)[4], const bf16*, int, int, int) {
  abort();
}
inline void mma_bf16(float (&)[4], const uint32_t (&)[4], uint32_t,
                     uint32_t) {
  abort();
}
inline void pack_a(uint32_t (&)[4], const float (&)[4], const float (&)[4]) {
  abort();
}
inline void store_bf16x2(bf16*, float, float) { abort(); }
inline float quad_max(float) { abort(); }
inline float quad_sum(float) { abort(); }

}  // namespace mma
