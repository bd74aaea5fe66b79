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
// * float32 -> flash_fwd_kernel, the first design, on the f32 CUDA cores:
//   one block of 256 threads per (b*H + h, 64-row q tile), Q staged once
//   and K/V tiles walked through shared memory in f32; each thread owns a
//   4x4 patch of the score tile and the same 4 rows of the output, row
//   max and sum reduce over a half-warp; row strides of D+1 and 65 floats
//   keep the column reads free of bank conflicts.  Q, K, V and P tiles
//   take 115 KB at D=128.  It stays: on the tensor cores f32 would mean
//   TF32, about three decimal digits, and the f32 path is what holds the
//   card to the CPU at 1e-3 in chip_smoke.py.
//
// What bounds it.  At the main shape (B=8, H=12, S=1024, D=64, causal,
// bf16) the causal products are 12.9 GFLOP and q/k/v/o 50 MB: 13 us of
// bf16 tensor-core work at 989 TFLOP/s against 15 us of HBM traffic at
// 3.35 TB/s, so bytes bound it at 0.015 ms.  On an NVIDIA H100 80GB
// HBM3 at 700.00 W the CUDA-core design took 0.58 ms there and the
// tensor-core design takes 0.093 ms, 6x the bound and 1.9x SDPA's
// forward (PERF.md §6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // key rows per tile
constexpr int NT = 256;   // threads per block: 16 (tx) x 16 (ty)
constexpr int PS = BK + 1;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// Copy rows [r0, r0 + 64) of a (rows, D) matrix into a 64 x stride f32
// tile, zero-filling rows past `rows`.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const T* __restrict__ src,
                                          int r0, int rows) {
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, c = i % D;
    dst[r * stride + c] =
        (r0 + r < rows) ? to_f32(src[(int64_t)(r0 + r) * D + c]) : 0.f;
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Hk, int Sq, int Sk,
                 int causal, float scale) {
  constexpr int DS = D + 1;
  constexpr int DJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;            // BQ x DS
  float* sK = sQ + BQ * DS;    // BK x DS
  float* sV = sK + BK * DS;    // BK x D
  float* sP = sV + BK * D;     // BQ x PS

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int b = bh / H, h = bh % H;
  const int kvh = b * Hk + h / (H / Hk);
  const T* qp = q + (int64_t)bh * Sq * D;
  const T* kp = k + (int64_t)kvh * Sk * D;
  const T* vp = v + (int64_t)kvh * Sk * D;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<T, D>(sQ, DS, qp, q0, Sq);

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int nk = (Sk + BK - 1) / BK;
  const int hi = causal ? min(nk, (q0 + BQ + BK - 1) / BK) : nk;
  for (int kb = 0; kb < hi; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // previous tile's readers are done
    load_tile<T, D>(sK, DS, kp, k0, Sk);
    load_tile<T, D>(sV, D, vp, k0, Sk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * DS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * DS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + ty * 4 + i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = k0 + tx + 16 * j;
        const bool ok = kc < Sk && (!causal || kc <= qr);
        s[i][j] = ok ? s[i][j] * scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(ty * 4 + i) * PS + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * PS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = sV[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty * 4 + i;
    if (qr >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + ((int64_t)bh * Sq + qr) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) store(orow + tx + 16 * j, acc[i][j] / den);
    if (lse != nullptr && tx == 0)
      lse[(int64_t)bh * Sq + qr] = m[i] + logf(den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int H, int Hk, int Sq, int Sk, int causal, float scale,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * PS);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, H, Hk, Sq,
      Sk, causal, scale);
  return (int)cudaGetLastError();
}

// ---- bf16: tensor cores ----

using mma::bf16;

constexpr int MQ = 64;   // query rows per block: 4 warps of 16
constexpr int MK = 64;   // key rows per tile
constexpr int MT = 128;  // threads per block
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

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
               float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(bf16) * (size_t)(MQ + 4 * MK) * mma::row_stride<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
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
                 int causal, float scale, cudaStream_t stream) {
  if (dtype == 1)
    return launch_mma<D>(q, k, v, o, lse, B, H, Hk, Sq, Sk, causal, scale,
                         stream);
  if (dtype == 0)
    return launch<float, D>(q, k, v, o, lse, B, H, Hk, Sq, Sk, causal,
                            scale, stream);
  return (int)cudaErrorInvalidValue;
}

int launch_d(int D, int dtype, const void* q, const void* k, const void* v,
             void* o, void* lse, int B, int H, int Hk, int Sq, int Sk,
             int causal, float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_dtype<32>(dtype, q, k, v, o, lse, B, H, Hk, Sq, Sk,
                              causal, scale, stream);
    case 64:
      return launch_dtype<64>(dtype, q, k, v, o, lse, B, H, Hk, Sq, Sk,
                              causal, scale, stream);
    case 128:
      return launch_dtype<128>(dtype, q, k, v, o, lse, B, H, Hk, Sq, Sk,
                               causal, scale, stream);
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
  if (Hk <= 0 || H % Hk != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return launch_d(D, dtype, q, k, v, o, lse, B, H, Hk, Sq, Sk, causal, scale,
                  (cudaStream_t)stream);
}

const char* mxtt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
