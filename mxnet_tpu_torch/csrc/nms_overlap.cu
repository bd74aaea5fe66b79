// The suppression matrix of greedy non-maximum suppression, for a batch
// of boxes already sorted by score:
//
//   S[n, j, i] = 1  when j < i, j < ks, valid[n, j], the classes of j and i
//                   agree (when classes are given) and overlap(j, i) > thresh
//
// for j < ks and i < ke (the row stride of boxes, valid and classes is K).
// It is what mxnet_tpu_torch/ops/detection.py suppress_matrix computes with
// PyTorch's elementwise ops (its plain version); nms_keep then iterates the
// greedy recursion over the pairs S holds.  The JAX package computes the
// same decisions inside a lax.fori_loop (mxnet_tpu/ops/detection.py:258,
// contrib_ops.py:206), outside any Pallas kernel.
//
// Two overlap rules, each the plain version's order of operations:
//   rule 0 (MultiBoxDetection, multibox_detection.cc CalculateOverlap):
//     corners with no +1, 0 where the union is not positive;
//   rule 1 (Proposal, proposal.cc NonMaximumSuppression): pixel boxes,
//     +1 in width and height.
// Every operation rounds as PyTorch's CUDA elementwise kernels round in the
// boxes' type: float32 in IEEE single precision with no contraction into
// fused multiply-adds (the __f*_rn intrinsics), bfloat16 computed in float32
// and rounded to bfloat16 after each operation.  So the kernel's matrix
// equals the plain version's bit for bit.
//
// Design. The matrix is 263 MB at the detect path's shape (4 images x 8108
// boxes, one byte a pair), so writing it is the bound (0.079 ms at 3.35 TB/s on
// an H100 SXM), and most pairs (92% of the detect path's, with 20 classes) fail
// the order, validity or class test before any IoU. So a thread owns 16
// consecutive i's of a row (one 16-byte store: the output's rows are padded to
// a stride `ld` that is a multiple of 16) and a block of 128 threads owns 2048
// i's for 16 rows j. The block stages its i's boxes (f32 boxes as float4s, bf16
// ones as their own 8 bytes, which halves the block's shared memory and so lets
// more blocks share an SM) and their areas in shared memory once, loaded by
// neighbouring threads, each box put where the thread that owns it reads it
// without bank conflicts; the thread keeps its 16 classes in registers; all of
// it serves the 16 rows. The block's rows (box, area, class, validity) are
// staged in shared memory once too. For each row the thread forms the mask of
// its i's that pass the order, range and class tests (the class test before any
// IoU). Where the warp's 512 i's hold 128 candidates or more, each lane
// computes all 16 of its IoUs without branches; else the warp lists its
// candidates in shared memory and takes them 32 at a time, each result or-ed
// into its owner's mask, so no lane waits on the lane with the most candidates.
// Rows of an invalid box, and i's at or below the row, are stored as zeros
// without any IoU; a block whose i's all lie at or below its first row stores
// zeros and stages nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

template <typename T>
struct Round;

template <>
struct Round<float> {
  static __device__ __forceinline__ float r(float x) { return x; }
  static __device__ __forceinline__ float load(const float* p) { return *p; }
};

template <>
struct Round<__nv_bfloat16> {
  static __device__ __forceinline__ float r(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};

template <typename T>
struct Ops {
  static __device__ __forceinline__ float sub(float a, float b) {
    return Round<T>::r(__fsub_rn(a, b));
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return Round<T>::r(__fadd_rn(a, b));
  }
  static __device__ __forceinline__ float mul(float a, float b) {
    return Round<T>::r(__fmul_rn(a, b));
  }
  static __device__ __forceinline__ float div(float a, float b) {
    return Round<T>::r(__fdiv_rn(a, b));
  }
};

// A box's area, each rule's order of operations (detection.py iou_matrix:
// (x1 - x0) * (y1 - y0); pixel_iou: (x1 - x0 + 1) * (y1 - y0 + 1)).
template <typename T, int RULE>
__device__ __forceinline__ float area(float4 b) {
  using O = Ops<T>;
  if (RULE == 0) return O::mul(O::sub(b.z, b.x), O::sub(b.w, b.y));
  return O::mul(O::add(O::sub(b.z, b.x), 1.f), O::add(O::sub(b.w, b.y), 1.f));
}

// The test round(inter / uni) > thresh, in the boxes' rounding (f32, or
// bf16 after f32), made without the division where that is exact: for
// uni > 0 and a positive threshold, the quotients that round above it
// are those above a boundary between two neighbouring floats, so the test
// is inter > hi * uni, or inter >= lo * uni where a tie rounds up
// (`incl`), in double, where the products of these 24- and 25-bit values
// are exact.  f32: hi = lo = the midpoint of thresh and the next float,
// a tie rounding up when thresh's last bit is odd.  bf16 (the f32
// quotient rounded again): the f32 quotients that round above a bf16
// thresh are those above m, the midpoint of thresh and the next bf16
// value, and m itself when thresh's last bf16 bit is odd; hi and lo are
// the midpoints around m.  The IEEE division costs about a third of the
// kernel's time at the detect shape (it is a subroutine, with its own
// branch); where the bounds do not hold (`exact` 0) it is taken.
struct Above {
  float thresh;
  double lo, hi;
  int incl, exact;
};

template <typename T>
__device__ __forceinline__ bool quotient_above(float inter, float uni,
                                               const Above& th) {
  if (th.exact && uni > 0.f) {
    const double x = inter, u = uni;
    return x > th.hi * u || (th.incl && x >= th.lo * u);
  }
  return Ops<T>::div(inter, uni) > th.thresh;
}

// overlap(a, b) > thresh with the areas given (they are the same values
// whether computed here or once a box)
template <typename T, int RULE>
__device__ __forceinline__ bool overlap_above(float4 a, float area_a,
                                              float4 b, float area_b,
                                              const Above& th) {
  using O = Ops<T>;
  if (RULE == 0) {  // detection.py iou_matrix
    const float iw =
        fmaxf(0.f, O::sub(fminf(a.z, b.z), fmaxf(a.x, b.x)));
    const float ih =
        fmaxf(0.f, O::sub(fminf(a.w, b.w), fmaxf(a.y, b.y)));
    const float inter = O::mul(iw, ih);
    const float uni = O::sub(O::add(area_a, area_b), inter);
    return uni > 0.f ? quotient_above<T>(inter, uni, th) : 0.f > th.thresh;
  }
  // detection.py pixel_iou
  const float inter =
      O::mul(fmaxf(O::add(O::sub(fminf(a.z, b.z), fmaxf(a.x, b.x)), 1.f),
                   0.f),
             fmaxf(O::add(O::sub(fminf(a.w, b.w), fmaxf(a.y, b.y)), 1.f),
                   0.f));
  return quotient_above<T>(inter, O::sub(O::add(area_a, area_b), inter), th);
}

// The bounds of quotient_above for thresh and the boxes' dtype (0 f32,
// 1 bf16), computed on the host from thresh's bits.
Above above_of(float thresh, int dtype) {
  Above th{thresh, 0.0, 0.0, 0, 0};
  uint32_t u;
  memcpy(&u, &thresh, 4);
  // positive and finite, its neighbours too; in bf16 a bf16 value
  if (!(thresh > 0.f) || u >= 0x7f000000u || (dtype == 1 && (u & 0xFFFFu)))
    return th;
  auto value = [](uint32_t bits) {
    float x;
    memcpy(&x, &bits, 4);
    return (double)x;
  };
  if (dtype == 0) {
    th.lo = th.hi = (value(u) + value(u + 1)) / 2;
    th.incl = u & 1u;
  } else {
    const uint32_t m = u + 0x8000u;  // thresh's midpoint to the next bf16
    th.lo = (value(m - 1) + value(m)) / 2;
    th.hi = (value(m) + value(m + 1)) / 2;
    th.incl = (u >> 16) & 1u;
  }
  th.exact = 1;
  return th;
}

constexpr int NT = 128;        // threads a block
constexpr int PER = 16;        // i's a thread: one 16-byte store
constexpr int IR = NT * PER;   // i's a block
constexpr int ROWS = 16;       // rows j a block
constexpr int SLOT = NT + 1;   // row stride of the staged boxes, in boxes
// candidates of a warp in a row from which each lane computes all 16
// IoUs of its i's; below it the warp shares its candidates out
constexpr int DENSE = 128;

// a box as staged in shared memory: f32 boxes as a float4, bf16 boxes as
// their own 8 bytes, widened to f32 when read (exact)
template <typename T>
struct Staged {
  using type = float4;
  static __device__ __forceinline__ float4 load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ float4 get(float4 s) { return s; }
  static __device__ __forceinline__ float4 zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
};

template <>
struct Staged<__nv_bfloat16> {
  using type = uint2;
  static __device__ __forceinline__ uint2 load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint2*>(p);
  }
  static __device__ __forceinline__ float4 get(uint2 s) {
    return make_float4(__uint_as_float(s.x << 16),
                       __uint_as_float(s.x & 0xFFFF0000u),
                       __uint_as_float(s.y << 16),
                       __uint_as_float(s.y & 0xFFFF0000u));
  }
  static __device__ __forceinline__ uint2 zero() { return make_uint2(0, 0); }
};

template <typename T>
__device__ __forceinline__ float4 load_box(const T* p) {
  return make_float4(Round<T>::load(p), Round<T>::load(p + 1),
                     Round<T>::load(p + 2), Round<T>::load(p + 3));
}

template <>
__device__ __forceinline__ float4 load_box(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Bits 0-3 of x as the low bits of the 4 bytes of a word: x * 0x204081
// is x + (x << 7) + (x << 14) + (x << 21), four copies that do not
// overlap, and bit b of the copy shifted by 7 b lands on bit 8 b.
__device__ __forceinline__ unsigned nibble_bytes(unsigned x) {
  return ((x & 0xFu) * 0x00204081u) & 0x01010101u;
}

// The 16 bytes of a 16-bit mask: byte e is bit e.
__device__ __forceinline__ uint4 mask_bytes(unsigned m) {
  return make_uint4(nibble_bytes(m), nibble_bytes(m >> 4),
                    nibble_bytes(m >> 8), nibble_bytes(m >> 12));
}

template <typename T, int RULE>
__global__ void __launch_bounds__(NT)
nms_suppress_kernel(const T* __restrict__ boxes,
                    const uint8_t* __restrict__ valid,
                    const float* __restrict__ classes,
                    uint8_t* __restrict__ S, int K, int ks, int ke, int ld,
                    Above thresh) {
  // thread t's box e at slot e * SLOT + t: a quarter-warp reading one e
  // reads 8 neighbouring float4s, and the staging's writes (below) fall
  // on distinct banks a quarter-warp too
  using St = Staged<T>;
  __shared__ typename St::type sbox[PER * SLOT];
  __shared__ float sarea[PER * SLOT];
  // the block's rows: box, area, class; valid or not
  __shared__ float4 rbox[ROWS];
  __shared__ float rarea[ROWS], rcls[ROWS];
  __shared__ int rvalid[ROWS];
  // a warp's candidates of one row (owner lane * PER + e), and the IoU
  // tests' results, a 16-bit mask a thread
  __shared__ unsigned short wlist[NT / 32][DENSE];
  __shared__ unsigned whit[NT];
  const int n = blockIdx.z;
  const int ib = blockIdx.x * IR;
  const int j0 = blockIdx.y * ROWS;
  const int j1 = min(j0 + ROWS, ks);
  const int t = threadIdx.x;
  const int lane = t % 32, warp0 = t - lane;
  unsigned short* list = wlist[t / 32];
  const int i0 = ib + t * PER;
  const size_t row = (size_t)n * K;
  uint8_t* out = S + (size_t)n * ks * ld + i0;
  const bool owns = i0 < ld;  // this thread's 16 bytes lie in the row
  const int nin = max(0, min(PER, ke - i0));  // its i's below ke

  if (min(ib + IR, ke) - 1 <= j0) {  // every i <= every j: all zeros
    if (owns)
      for (int j = j0; j < j1; ++j)
        *reinterpret_cast<uint4*>(out + (size_t)j * ld) =
            make_uint4(0, 0, 0, 0);
    return;
  }

  if (t < j1 - j0) {
    const int j = j0 + t;
    rvalid[t] = valid[row + j];
    if (rvalid[t]) {
      rbox[t] = load_box<T>(boxes + (row + j) * 4);
      rarea[t] = area<T, RULE>(rbox[t]);
      rcls[t] = classes != nullptr ? classes[row + j] : 0.f;
    }
  }
  // the block's i's below ke, loaded by neighbouring threads (coalesced),
  // each box with its area put in its owner's slot
#pragma unroll 4
  for (int x = t; x < IR; x += NT) {
    const int i = ib + x;
    const bool ok = i < ke;
    const typename St::type b =
        ok ? St::load(boxes + (row + i) * 4) : St::zero();
    const int slot = (x % PER) * SLOT + x / PER;
    sbox[slot] = b;
    sarea[slot] = area<T, RULE>(St::get(b));
  }
  // the classes of this thread's i's
  const unsigned in_range = (1u << nin) - 1u;
  float ci[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e)
    ci[e] = e < nin && classes != nullptr ? classes[row + i0 + e] : 0.f;
  __syncthreads();


  for (int j = j0; j < j1; ++j) {
    const int r = j - j0;
    unsigned m = 0;
    const int lo = j + 1 - i0;  // the first e with i > j
    if (lo < nin && rvalid[r]) {
      m = lo <= 0 ? in_range : in_range & (0xFFFFu << lo);
      if (classes != nullptr) {
        const float cj = rcls[r];
        unsigned same = 0;
#pragma unroll
        for (int e = 0; e < PER; ++e) same |= (ci[e] == cj ? 1u : 0u) << e;
        m &= same;
      }
    }
    // the IoU of the candidates: where the warp has many, each lane all
    // 16 of its own without branches (independent, so they overlap);
    // else the warp lists its candidates and takes them 32 at a time, so
    // that a lane with many waits for no other
    const int c = __popc(m);
    const int total = (int)__reduce_add_sync(0xffffffffu, (unsigned)c);
    unsigned hit = 0;
    if (total >= DENSE) {
      const float4 a = rbox[r];
      const float aa = rarea[r];
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const bool over =
            overlap_above<T, RULE>(a, aa, St::get(sbox[e * SLOT + t]),
                                   sarea[e * SLOT + t], thresh);
        hit |= (over ? 1u : 0u) << e;
      }
      hit &= m;
    } else if (total > 0) {
      int at = c;  // the lanes' candidates before this one's, inclusive
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int below = __shfl_up_sync(0xffffffffu, at, o);
        if (lane >= o) at += below;
      }
      at -= c;
      for (unsigned left = m; left; left &= left - 1)
        list[at++] = (unsigned short)(lane * PER + __ffs(left) - 1);
      whit[t] = 0;
      __syncwarp();
      const float4 a = rbox[r];
      const float aa = rarea[r];
      for (int x = lane; x < total; x += 32) {
        const int code = list[x];
        const int owner = warp0 + code / PER, e = code % PER;
        if (overlap_above<T, RULE>(a, aa, St::get(sbox[e * SLOT + owner]),
                                   sarea[e * SLOT + owner], thresh))
          atomicOr(&whit[owner], 1u << e);
      }
      // every lane's tests and reads of the list are done before any
      // lane lists the next row's or clears its mask
      __syncwarp();
      hit = whit[t];
    }
    if (owns) *reinterpret_cast<uint4*>(out + (size_t)j * ld) = mask_bytes(hit);
  }
}

template <typename T>
cudaError_t launch(const void* boxes, const void* valid, const void* classes,
                   void* S, int N, int K, int ks, int ke, int ld, int rule,
                   Above thresh, cudaStream_t stream) {
  dim3 grid((ld + IR - 1) / IR, (ks + ROWS - 1) / ROWS, N);
  const T* b = static_cast<const T*>(boxes);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  const float* c = static_cast<const float*>(classes);
  uint8_t* s = static_cast<uint8_t*>(S);
  if (rule == 0)
    nms_suppress_kernel<T, 0><<<grid, NT, 0, stream>>>(b, v, c, s, K, ks, ke,
                                                       ld, thresh);
  else
    nms_suppress_kernel<T, 1><<<grid, NT, 0, stream>>>(b, v, c, s, K, ks, ke,
                                                       ld, thresh);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// boxes (N, K, 4) of dtype (0 = float32, 1 = bfloat16; a box is read in one
// load, so float32 boxes are 16-byte aligned and bfloat16 ones 8), valid (N,
// K) bytes, classes (N, K) float32 or null, S (N, ks, ld) bytes, 16-byte
// aligned, of which columns [0, ke) are the matrix (ld a multiple of 16, at
// least ke; the columns past ke are written as zeros); rule 0 = corners, 1 =
// pixel boxes. Returns the cudaError_t of the launch.
int mxtt_nms_suppress(const void* boxes, const void* valid,
                      const void* classes, void* S, int N, int K, int ks,
                      int ke, int ld, int dtype, int rule, float thresh,
                      int device, void* stream) {
  if (N == 0 || ks == 0 || ke == 0) return 0;
  if (ks > ke || ke > K || ld < ke || ld % 16 || N > 65535 ||
      (ks + ROWS - 1) / ROWS > 65535 ||
      (rule != 0 && rule != 1) || (uintptr_t)S % 16 ||
      (uintptr_t)boxes % (dtype == 0 ? 16 : 8))
    return (int)cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float>(boxes, valid, classes, S, N, K, ks, ke, ld,
                              rule, above_of(thresh, 0), st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(boxes, valid, classes, S, N, K, ks, ke,
                                      ld, rule, above_of(thresh, 1), st);
  return (int)cudaErrorInvalidValue;
}

const char* mxtt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
