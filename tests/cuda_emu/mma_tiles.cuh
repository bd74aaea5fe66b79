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
extern thread_local std::vector<Copy> open_group;
extern thread_local std::deque<std::vector<Copy>> groups;

inline void land(const Copy& c) {
  memset(c.dst, 0, c.size);
  if (c.bytes) memcpy(c.dst, c.src, c.bytes);
}
inline void start_copy(const Copy& c) {
  if (emu_defer)
    open_group.push_back(c);
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
  groups.push_back(open_group);
  open_group.clear();
}
template <int N>
inline void cp_async_wait() {
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

}  // namespace mma
