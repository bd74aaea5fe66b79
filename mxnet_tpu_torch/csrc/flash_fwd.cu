// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces mxnet_tpu/ops/attention.py::_flash_fwd.kernel, the Pallas TPU
// kernel (launched there with and without the logsumexp output).  It
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
// Design.  One block of 256 threads per (b*H + h, 64-row q tile).  The
// block stages its Q tile once and walks 64-row K/V tiles through shared
// memory, converted to f32; under causal the walk stops after the
// diagonal tile.  Each thread owns a 4x4 patch of the 64x64 score tile
// (rows ty*4..ty*4+3, columns tx + 16*j) and the same 4 rows of the output
// accumulator (columns tx + 16*j, j < D/16), so the row statistics it
// needs for the rescale stay in its registers; row max and sum reduce
// over the 16 lanes of a half-warp with shuffles.  Row strides of D+1 and
// 65 floats keep the column reads free of bank conflicts.
//
// What bounds it.  At the serving shape (B=8, H=12, S=1024, D=64, causal,
// bf16) the causal products are about 12.9 GFLOP and q/k/v/o about 50 MB:
// on an H100 SXM that is about 13 us of bf16 tensor-core work against
// about 15 us of HBM traffic, so the two floors are close.  This design
// does the products on the f32 CUDA cores from shared memory instead of
// wgmma/TMA, and so sits far above both (0.58 ms measured on an H100 SXM
// at 700 W, see PERF.md): it is the simple, correct first version; the
// tensor-core version is later work.
//
// Shared memory: Q and K tiles 64 x (D+1), V tile 64 x D, P tile 64 x 65,
// all f32: 115 KB at D=128, above the 48 KB static limit, hence the
// cudaFuncAttributeMaxDynamicSharedMemorySize call before each launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // key rows per tile
constexpr int NT = 256;   // threads per block: 16 (tx) x 16 (ty)
constexpr int PS = BK + 1;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* o,
             void* lse, int B, int H, int Hk, int Sq, int Sk, int causal,
             float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, H, Hk, Sq, Sk, causal, scale,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, H, Hk, Sq, Sk, causal, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, H, Hk, Sq, Sk, causal, scale,
                            stream);
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
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, o, lse, B, H, Hk, Sq, Sk, causal,
                           scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, o, lse, B, H, Hk, Sq, Sk,
                                   causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* mxtt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
