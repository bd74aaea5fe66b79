// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces mxnet_tpu/ops/attention.py::_flash_fwd.kernel (:73), the Pallas
// TPU kernel (launched there with the logsumexp output at :131 and without
// it at :147).  It
// computes the same function, not the same blocks:
//
//   s = q . k^T * scale             (scale defaults to 1/sqrt(D) in Python)
//   masked where k_pos >= Sk, and under causal where k_pos > q_pos
//   (top-left alignment, also for Sq != Sk), to the FINITE -1e30
//   online softmax over KV tiles with f32 (m, l, acc)
//   out = acc / max(l, 1e-30);  lse = m + log(max(l, 1e-30))  (optional)
//
// Layout: q (B, H, Sq, D), k/v (B, Hk, Sk, D), o like q, lse (B, H, Sq) f32,
// all contiguous.  GQA: query head h reads KV head h / (H / Hk), so KV is
// never repeated.  Ragged Sq/Sk are masked in the kernel; nothing is
// padded in memory.
//
// Two designs, chosen by dtype in launch_d (never as a fallback):
//
// * bf16 -> flash_fwd_mma_kernel, on the tensor cores (FlashAttention-2's
//   forward).  One block of 4 warps (128 threads) per (b*H + h, 64-row q
//   tile); each warp owns 16 query rows.  Under causal the heaviest q tiles
//   (the last ones) get the lowest block indices, so the ragged tail of
//   the grid is the cheap tiles.  Shared memory holds bf16 only, rows
//   padded to D + 8 values so that ldmatrix is free of bank conflicts: the
//   Q tile, staged once, and K and V tiles of 64 rows in a two-stage
//   cp.async ring (tile j + 1 is in flight while tile j is computed; rows
//   past Sk are zero-filled by the copy).  That is 9 + 36 = 45 KB at
//   D=64, 85 KB at D=128.  S = Q.K^T runs as mma.sync m16n8k16 (bf16 in,
//   f32 accumulators; Q's fragments are loaded once by ldmatrix and kept
//   in registers, K's by ldmatrix); the online softmax stays in registers
//   in the accumulator layout (each thread 2 rows, row max and sum over
//   the 4 lanes of a quad), in base 2 (scores times scale * log2 e);
//   only the diagonal and the ragged last tile mask per element.  P is
//   rounded to bf16 straight from the accumulators into the A fragments
//   of O += P.V (V's fragments by ldmatrix.trans); O stays f32 in
//   registers until the epilogue divides by l and stores bf16.
// * float32 -> flash_fwd_kernel, on the f32 CUDA cores in full f32 (no
//   TF32, no mma: on the tensor cores f32 would mean TF32, about three
//   decimal digits, and the f32 path is what holds the card to the CPU
//   in chip_smoke.py).  A block of 4 warps takes a q tile of 64 rows, each
//   warp 16 of them; K and V tiles of 64 rows go through a two-stage ring
//   of 16-byte cp.async copies (the next tile's copy overlaps this tile's
//   work; one barrier a tile), in f32 rows strided D + 4 floats.  Lane (a,
//   c) = (lane / 8, lane % 8) computes S = Q.K^T for rows a + 4 i (i < 4)
//   of its warp and keys c + 8 j (j < 8), a 4x8 patch from float4 reads
//   along D; the online softmax runs in base 2 (exp2f, scale * log2 e
//   folded in), the row max reduced by shuffles over the 8 lanes of a row
//   and the row sum kept per lane until the end; P goes through the
//   warp's own shared tile (only __syncwarp), and O += P.V adds 4 rows x
//   D / 8 columns a lane from float4 reads, over the keys the warp's rows
//   can see.  Only tiles that meet the diagonal or run past Sk mask per
//   element; the heaviest causal q tiles start first.  When the grid of
//   64-row tiles would leave SMs without a block (ViT-S/16's fp32
//   predict, B 2, H 6, S 196: 48 blocks), the block takes 16 q rows
//   instead and its four warps split the keys of every tile, 16 each, in
//   4x2 patches of S, each with a softmax state of its own; the four
//   states are merged through shared memory at the end (156 blocks, and a
//   quarter of the work a warp).  Shared memory: Q, 2 stages of K and V,
//   4 P tiles: 104 KB at D=64 (two blocks an SM), 187 KB at D=128.

// What bounds it.  At the main shape (B=8, H=12, S=1024, D=64, causal,
// bf16) the causal products are 12.9 GFLOP and q/k/v/o 50 MB: 13 us of
// bf16 tensor-core work at 989 TFLOP/s against 15 us of HBM traffic at
// 3.35 TB/s, so bytes bound it at 0.015 ms.  On an NVIDIA H100 80GB
// HBM3 at 700.00 W the CUDA-core design took 0.58 ms there and the
// tensor-core design takes 0.093 ms, 6x the bound and 1.9x SDPA's
// forward (PERF.md §6).  In f32 the same products bound it at 0.19 ms
// (67 TFLOP/s); next comes shared memory, which delivers 128 bytes a
// clock an SM to the threads however a read broadcasts: a TM x TN patch
// reads 4 (TM + TN) / (TM TN) bytes an FMA, 1.5 for 4x8 in both passes
// (the first design's 4x4 patches of scalar reads took 2.0, and 0.61 ms).
// In one run on that card this design took 0.3839 ms there and SDPA's
// forward 0.5020 (PERF.md §6, the row "final").

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ---- float32: CUDA cores ----

constexpr int WQ = 16;       // query rows a warp owns
constexpr int BK = 64;       // key rows a tile
constexpr int PS = BK + 8;   // row stride of a warp's P tile
constexpr int MAX_DEVICES = 32;

// Row stride, in floats, of an f32 Q, K or V tile: D + 4 keeps every row
// on 16 bytes (cp.async, float4 reads) and puts row r + 1 four banks after
// row r, so 8 consecutive rows read as float4 at one column cover all 32
// banks.
template <int D>
__host__ __device__ constexpr int f32_ld() {
  return D + 4;
}

// Shared memory, in floats, of the f32 kernel: Q (64 rows, or 16 when
// the warps split the keys), two stages of K and V, and one P tile a warp.
template <int D, bool SPLIT>
__host__ __device__ constexpr int fwd_f32_floats() {
  return WQ * (SPLIT ? 1 : 4) * f32_ld<D>() + 4 * BK * f32_ld<D>() +
         4 * WQ * PS;
}

__device__ __forceinline__ void ld4(float (&v)[4], const float* p) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}

// Stage rows [r0, r0 + ROWS) of a contiguous (rows, D) f32 matrix into a
// ROWS x f32_ld<D>() tile with 16-byte cp.async, NT threads sharing the
// work; rows at or past `rows` are zero-filled by the copy itself.  A
// thread copies one 16-byte column of every NT / (D / 4)-th row, so its
// copies differ only by constant offsets from one shared and one global
// address (offsets per copy computed once would be hoisted out of the
// tile loop and held in registers: 64 of them at NT = 32).
template <int D, int ROWS, int NT>
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ src,
                                           int r0, int rows) {
  constexpr int CPR = D / 4;     // 16-byte chunks per row
  constexpr int STEP = NT / CPR;  // rows between a thread's copies
  static_assert(NT % CPR == 0 && ROWS % STEP == 0, "chunks split evenly");
  const int r = r0 + threadIdx.x / CPR, c = threadIdx.x % CPR * 4;
  float* d = dst + (threadIdx.x / CPR) * f32_ld<D>() + c;
  const float* g = src + (int64_t)r * D + c;
  // (up to 64 copies a thread at one warp a block: unrolled in eights,
  // or their addresses and predicates crowd the registers)
#pragma unroll 8
  for (int j = 0; j < ROWS / STEP; ++j) {
    const bool ok = r + j * STEP < rows;
    mma::cp_async16(d + j * STEP * f32_ld<D>(), ok ? g + j * STEP * D : src,
                    ok ? 16 : 0);
  }
}

// The max and the sum over the 8 lanes that share a row (lane & ~7).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// K1 in float32: one block of 4 warps per (b*H + h, q tile).  Without
// SPLIT the tile is 64 rows and warp w owns rows 16 w .. 16 w + 15 over
// all keys; with SPLIT it is 16 rows that all four warps share, warp w
// taking keys 16 w .. 16 w + 15 of every 64-key tile with a softmax state
// of its own, and the four states are merged at the end.  Lane (a, c) =
// (lane / 8, lane % 8) holds rows a + 4 i (i < 4) of its warp's rows, of
// S at key columns c + 8 j of its warp's keys (j < 8, or 2 with SPLIT)
// and of O at d columns 32 m + 4 c + n (m < D / 32, n < 4).
template <int D, bool SPLIT>
__global__ void __launch_bounds__(128, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int H, int Hk, int Sq, int Sk,
                 int causal, float scale) {
  constexpr int NT = 128, LD = f32_ld<D>(), NC = D / 32;
  constexpr int BQ = SPLIT ? WQ : 4 * WQ;  // q rows a block
  constexpr int KW = SPLIT ? BK / 4 : BK;  // keys of a tile a warp takes
  constexpr int JN = KW / 8;               // S columns a lane
  extern __shared__ __align__(16) float smem_f32[];
  float* sQ = smem_f32;             // BQ x LD
  float* sK = sQ + BQ * LD;         // 2 stages of BK x LD
  float* sV = sK + 2 * BK * LD;     // 2 stages of BK x LD
  const int w = threadIdx.x >> 5;
  float* sP = sV + 2 * BK * LD + w * WQ * PS;  // this warp's P, WQ x PS

  const int nq = (Sq + BQ - 1) / BQ;
  const int q0 = (causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y) * BQ;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = b * Hk + h / (H / Hk);
  const float* kp = k + (int64_t)kvh * Sk * D;
  const float* vp = v + (int64_t)kvh * Sk * D;
  const int lane = threadIdx.x & 31;
  const int wr = SPLIT ? 0 : w * WQ;   // the warp's first row in the tile
  const int qw = q0 + wr;              // and its query position
  const int kw = SPLIT ? w * KW : 0;   // the warp's first key in a tile
  const int a = lane >> 3, c = lane & 7;

  const int nk = (Sk + BK - 1) / BK;
  const int hi = causal ? min(nk, (q0 + BQ + BK - 1) / BK) : nk;

  stage_rows<D, BQ, NT>(sQ, q + (int64_t)bh * Sq * D, q0, Sq);
  if (hi > 0) {
    stage_rows<D, BK, NT>(sK, kp, 0, Sk);
    stage_rows<D, BK, NT>(sV, vp, 0, Sk);
  }
  mma::cp_async_commit();

  // rows wr + a + 4 i: running max (base 2), this lane's part of the
  // running sum, output
  float m[4], l[4], acc[4][NC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int mm = 0; mm < NC; ++mm)
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[i][mm][n] = 0.f;
  }
  const float sl2 = scale * LOG2E;

  for (int kb = 0; kb < hi; ++kb) {
    const int k0 = kb * BK + kw;  // this warp's first key of the tile
    const float* cK = sK + (kb & 1) * BK * LD + kw * LD;
    const float* cV = sV + (kb & 1) * BK * LD + kw * LD;
    mma::cp_async_wait<0>();
    __syncthreads();  // tile kb is in; every warp is done with tile kb - 1
    if (kb + 1 < hi) {  // the next tile's copy overlaps this tile's work
      stage_rows<D, BK, NT>(sK + ((kb + 1) & 1) * BK * LD, kp,
                            (kb + 1) * BK, Sk);
      stage_rows<D, BK, NT>(sV + ((kb + 1) & 1) * BK * LD, vp,
                            (kb + 1) * BK, Sk);
      mma::cp_async_commit();
    }
    // the warp's keys that its rows see: none past Sk, and under causal
    // none past the warp's last row
    int kend = min(KW, Sk - k0);
    if (causal) kend = min(kend, qw + WQ - k0);
    if (kend <= 0) continue;  // warp-uniform

    // S = Q.K^T: 4 q rows x JN keys a lane, 4 + JN float4 reads per
    // 16 JN FMAs
    float s[4][JN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float qv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ld4(qv[i], sQ + (wr + a + 4 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        float kv[4];
        ld4(kv, cK + (c + 8 * j) * LD + d);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[i][j] = fmaf(qv[i][e], kv[e], s[i][j]);
      }
    }

    // online softmax in base 2; the mask only where the warp's rows meet
    // the diagonal or its keys run past Sk; P to the warp's own tile
    const bool edge = kend < KW || (causal && k0 + KW - 1 > qw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x[JN], mx = m[i];
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        x[j] = s[i][j] * sl2;
        if (edge) {
          const int kc = k0 + c + 8 * j, qr = qw + a + 4 * i;
          if (kc >= Sk || (causal && kc > qr)) x[j] = NEG;
        }
        mx = fmaxf(mx, x[j]);
      }
      mx = row_max(mx);
      const float alpha = exp2f(m[i] - mx);
      m[i] = mx;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        // exp2f(NEG - mx) is 0 unless no key of the row has been seen yet
        // (mx is NEG); what such a row adds, the next real key's alpha of
        // 0, or the merge's weight of 0, takes away
        const float p = exp2f(x[j] - mx);
        sP[(a + 4 * i) * PS + c + 8 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int mm = 0; mm < NC; ++mm)
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[i][mm][n] *= alpha;
    }
    __syncwarp();  // the warp's P is in

    // O += P.V over the keys the warp sees (P is 0 past them, and V's rows
    // past Sk are zero-filled): 4 P and 4 NC V float4 reads per 64 NC FMAs
    const int kend4 = (kend + 3) & ~3;
#pragma unroll 2
    for (int kk = 0; kk < kend4; kk += 4) {
      float pv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ld4(pv[i], sP + (a + 4 * i) * PS + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int mm = 0; mm < NC; ++mm) {
          float vv[4];
          ld4(vv, cV + (kk + e) * LD + mm * 32 + c * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int n = 0; n < 4; ++n)
              acc[i][mm][n] = fmaf(pv[i][e], vv[n], acc[i][mm][n]);
        }
    }
    // the next write of P comes after the next __syncthreads
  }
  mma::cp_async_wait<0>();

  if (!SPLIT) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float den = fmaxf(row_sum(l[i]), 1e-30f);
      const int qr = qw + a + 4 * i;
      if (qr >= Sq) continue;
      float* orow = o + ((int64_t)bh * Sq + qr) * D;
#pragma unroll
      for (int mm = 0; mm < NC; ++mm)
        *reinterpret_cast<float4*>(orow + mm * 32 + c * 4) =
            make_float4(acc[i][mm][0] / den, acc[i][mm][1] / den,
                        acc[i][mm][2] / den, acc[i][mm][3] / den);
      if (lse != nullptr && c == 0)
        lse[(int64_t)bh * Sq + qr] = m[i] * LN2 + logf(den);
    }
    return;
  }

  // SPLIT: the four warps' states of each row, merged through the K and V
  // stages (no copy is in flight: the last tile committed none)
  __syncthreads();
  float* cm = sK;             // 4 x WQ maxima
  float* cl = cm + 4 * WQ;    // 4 x WQ sums
  float* ca = sV;             // 4 x WQ x D outputs
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = a + 4 * i;
    const float lt = row_sum(l[i]);
    if (c == 0) cm[w * WQ + r] = m[i], cl[w * WQ + r] = lt;
#pragma unroll
    for (int mm = 0; mm < NC; ++mm)
      *reinterpret_cast<float4*>(ca + (w * WQ + r) * D + mm * 32 + c * 4) =
          make_float4(acc[i][mm][0], acc[i][mm][1], acc[i][mm][2],
                      acc[i][mm][3]);
  }
  __syncthreads();
  // thread t: row t / 8 and rows + 16 ..., 4-column chunks t % 8 + 8 n
  for (int x = threadIdx.x; x < WQ * D / 4; x += NT) {
    const int r = x / (D / 4), d = x % (D / 4) * 4;
    const int qr = q0 + r;
    if (qr >= Sq) continue;
    float mx = NEG;
#pragma unroll
    for (int u = 0; u < 4; ++u) mx = fmaxf(mx, cm[u * WQ + r]);
    float den = 0.f, o4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float f = exp2f(cm[u * WQ + r] - mx);
      den += cl[u * WQ + r] * f;
      float a4[4];
      ld4(a4, ca + (u * WQ + r) * D + d);
#pragma unroll
      for (int n = 0; n < 4; ++n) o4[n] += a4[n] * f;
    }
    den = fmaxf(den, 1e-30f);
    *reinterpret_cast<float4*>(o + ((int64_t)bh * Sq + qr) * D + d) =
        make_float4(o4[0] / den, o4[1] / den, o4[2] / den, o4[3] / den);
    if (lse != nullptr && d == 0)
      lse[(int64_t)bh * Sq + qr] = mx * LN2 + logf(den);
  }
}

// Whether the f32 kernel's warps split the keys (16-row q tiles): when the
// grid of 64-row tiles leaves SMs of the device without a block.
bool f32_split(int BH, int Sq, int device) {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return (int64_t)BH * ((Sq + 4 * WQ - 1) / (4 * WQ)) < (int64_t)sms;
}

template <int D, bool SPLIT>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int H, int Hk, int Sq, int Sk, int causal,
               float scale, int device, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * fwd_f32_floats<D, SPLIT>();
  // above 48 KB only once allowed, once a device and instance
  static unsigned allowed = 0;
  if (smem > 48 * 1024 && !(allowed >> device & 1u)) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D, SPLIT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed |= 1u << device;
  }
  constexpr int BQ = SPLIT ? WQ : 4 * WQ;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_fwd_kernel<D, SPLIT><<<grid, 128, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o,
      (float*)lse, H, Hk, Sq, Sk, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int H, int Hk, int Sq, int Sk, int causal, float scale,
           int device, cudaStream_t stream) {
  if (f32_split(B * H, Sq, device))
    return launch_f32<D, true>(q, k, v, o, lse, B, H, Hk, Sq, Sk, causal,
                               scale, device, stream);
  return launch_f32<D, false>(q, k, v, o, lse, B, H, Hk, Sq, Sk, causal,
                              scale, device, stream);
}

// ---- bf16: tensor cores ----

using mma::bf16;

constexpr int MQ = 64;   // query rows per block: 4 warps of 16
constexpr int MK = 64;   // key rows per tile
constexpr int MT = 128;  // threads per block

template <int D>
__global__ void __launch_bounds__(MT)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int H, int Hk, int Sq, int Sk,
                     int causal, float scale) {
  constexpr int LD = mma::row_stride<D>();
  constexpr int KS = D / 16;  // k-steps of S = Q.K^T
  constexpr int NS = MK / 8;  // n-blocks of S
  constexpr int NO = D / 8;   // n-blocks of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // MQ x LD
  bf16* sK = sQ + MQ * LD;                       // 2 stages of MK x LD
  bf16* sV = sK + 2 * MK * LD;                   // 2 stages of MK x LD

  const int nq = (Sq + MQ - 1) / MQ;
  const int q0 = (causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y) * MQ;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = b * Hk + h / (H / Hk);
  const bf16* kp = k + (int64_t)kvh * Sk * D;
  const bf16* vp = v + (int64_t)kvh * Sk * D;

  const int lane = threadIdx.x & 31;
  const int wr = (threadIdx.x >> 5) * 16;  // the warp's first row
  const int g = lane >> 2, t = lane & 3;

  const int nk = (Sk + MK - 1) / MK;
  const int hi = causal ? min(nk, (q0 + MQ + MK - 1) / MK) : nk;

  mma::load_rows<D, MQ, MT>(sQ, q + (int64_t)bh * Sq * D, q0, Sq);
  mma::cp_async_commit();
  if (hi > 0) {
    mma::load_rows<D, MK, MT>(sK, kp, 0, Sk);
    mma::load_rows<D, MK, MT>(sV, vp, 0, Sk);
  }
  mma::cp_async_commit();

  // rows g and g + 8 of the warp: running max (base 2), sum, output
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  uint32_t qf[KS][4];
  const float sl2 = scale * LOG2E;

  for (int kb = 0; kb < hi; ++kb) {
    const int k0 = kb * MK;
    const bf16* cK = sK + (kb & 1) * MK * LD;
    const bf16* cV = sV + (kb & 1) * MK * LD;
    if (kb + 1 < hi) {  // the next tile's copy overlaps this tile's work
      mma::load_rows<D, MK, MT>(sK + ((kb + 1) & 1) * MK * LD, kp, k0 + MK,
                                Sk);
      mma::load_rows<D, MK, MT>(sV + ((kb + 1) & 1) * MK * LD, vp, k0 + MK,
                                Sk);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    if (kb == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        mma::load_a<LD>(qf[kk], sQ, wr, kk * 16, lane);
    }

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kf[4];
        mma::load_b_nk<LD>(kf, cK, np * 16, kk * 16, lane);
        mma::mma_bf16(s[2 * np], qf[kk], kf[0], kf[1]);
        mma::mma_bf16(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }

    // scale into base 2, mask (only where this warp's rows meet the
    // diagonal or the tile runs past Sk), running max
    const bool edge = k0 + MK > Sk || (causal && k0 + MK - 1 > q0 + wr);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sl2;
        if (edge) {
          const int kc = k0 + j * 8 + 2 * t + (e & 1);
          const int qr = q0 + wr + g + (e >> 1) * 8;
          if (kc >= Sk || (causal && kc > qr)) x = NEG;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = mma::quad_max(mx[i]);
      alpha[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + mma::quad_sum(rs[i]);
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];

    // O += P.V, P rounded to bf16 in registers
#pragma unroll
    for (int kk = 0; kk < MK / 16; ++kk) {
      uint32_t pa[4];
      mma::pack_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        mma::load_b_kn<LD>(vf, cV, kk * 16, dp * 16, lane);
        mma::mma_bf16(acc[2 * dp], pa, vf[0], vf[1]);
        mma::mma_bf16(acc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this stage's readers are done before its refill
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qr = q0 + wr + g + i * 8;
    if (qr >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    bf16* orow = o + ((int64_t)bh * Sq + qr) * D;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      mma::store_bf16x2(orow + j * 8 + 2 * t, acc[j][2 * i] / den,
                        acc[j][2 * i + 1] / den);
    if (lse != nullptr && t == 0)
      lse[(int64_t)bh * Sq + qr] = m[i] * LN2 + logf(den);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int H, int Hk, int Sq, int Sk, int causal,
               float scale, int device, cudaStream_t stream) {
  const size_t smem =
      sizeof(bf16) * (size_t)(MQ + 4 * MK) * mma::row_stride<D>();
  static unsigned allowed = 0;  // the attribute, once a device
  if (!(allowed >> device & 1u)) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed |= 1u << device;
  }
  const dim3 grid(B * H, (Sq + MQ - 1) / MQ);
  flash_fwd_mma_kernel<D><<<grid, MT, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
      H, Hk, Sq, Sk, causal, scale);
  return (int)cudaGetLastError();
}

// The design follows the dtype: bf16 (1) on the tensor cores, float32 (0)
// on the CUDA cores.
template <int D>
int launch_dtype(int dtype, const void* q, const void* k, const void* v,
                 void* o, void* lse, int B, int H, int Hk, int Sq, int Sk,
                 int causal, float scale, int device, cudaStream_t stream) {
  if (dtype == 1)
    return launch_mma<D>(q, k, v, o, lse, B, H, Hk, Sq, Sk, causal, scale,
                         device, stream);
  if (dtype == 0)
    return launch<D>(q, k, v, o, lse, B, H, Hk, Sq, Sk, causal, scale,
                     device, stream);
  return (int)cudaErrorInvalidValue;
}

int launch_d(int D, int dtype, const void* q, const void* k, const void* v,
             void* o, void* lse, int B, int H, int Hk, int Sq, int Sk,
             int causal, float scale, int device, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_dtype<32>(dtype, q, k, v, o, lse, B, H, Hk, Sq, Sk,
                              causal, scale, device, stream);
    case 64:
      return launch_dtype<64>(dtype, q, k, v, o, lse, B, H, Hk, Sq, Sk,
                              causal, scale, device, stream);
    case 128:
      return launch_dtype<128>(dtype, q, k, v, o, lse, B, H, Hk, Sq, Sk,
                               causal, scale, device, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  lse may be null.  Returns the
// cudaError_t of the launch (0 = success).
int mxtt_flash_fwd(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int H, int Hk, int Sq, int Sk, int D,
                   int dtype, int causal, float scale, int device,
                   void* stream) {
  if (B * H == 0 || Sq == 0) return 0;
  if (Hk <= 0 || H % Hk != 0 || device < 0 || device >= MAX_DEVICES)
    return (int)cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return launch_d(D, dtype, q, k, v, o, lse, B, H, Hk, Sq, Sk, causal, scale,
                  device, (cudaStream_t)stream);
}

// q rows a block of the float32 kernel for these shapes on that device:
// 64, or 16 when its warps split the keys; 0 on a bad device.
int mxtt_flash_fwd_f32_tile(int B, int H, int Sq, int device) {
  if (device < 0 || device >= MAX_DEVICES) return 0;
  return f32_split(B * H, Sq, device) ? WQ : 4 * WQ;
}

const char* mxtt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
