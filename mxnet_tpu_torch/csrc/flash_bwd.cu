// Flash-attention backward for Hopper (sm_90a), plain C interface: the dQ
// kernel (K2) and the dK/dV kernel (K3).
//
// Replaces the two Pallas TPU kernels of mxnet_tpu/ops/attention.py::
// _flash_bwd: dq_kernel (:222, launched :257) and dkv_kernel (:273,
// launched :317).  They compute the same function (FlashAttention-2's
// backward), not the same blocks:
//
//   s  = q . k^T * scale
//   p  = exp(s - lse)        where k_pos < Sk, q_pos < Sq and, under
//                            causal, k_pos <= q_pos (top-left alignment,
//                            also for Sq != Sk); p = 0 elsewhere, which is
//                            what the TPU kernels get from the finite
//                            -1e30 mask and the +1e30 lse of padded rows
//   dP = dO . v^T;  dS = p * (dP - delta) * scale
//   dQ = dS . k;    dK = dS^T . q;    dV = p^T . dO
//
// delta = rowsum(dO * O) and lse are f32 (B, H, Sq), computed outside
// (delta by the caller in f32, lse by the forward kernel).  Layout: q, dO
// and dQ (B, H, Sq, D); k, v, dK, dV (B, Hk, Sk, D); all contiguous.  GQA:
// query head h reads KV head h / (H / Hk).  Ragged Sq/Sk are masked in the
// kernels; nothing is padded in memory.
//
// Design.  Blocks run in parallel in no order, so nothing is carried
// across them and no atomics are used: both kernels are deterministic.
//
// * K2 (dQ): one block of 256 threads per (b*H + h, 64-row q tile).  It
//   stages its Q and dO tiles once, then walks 64-row K/V tiles (under
//   causal up to the diagonal tile, a bound that depends only on the
//   positions, not on the TPU's 128-row blocks) and keeps the dQ tile in
//   registers.  Each thread owns 4 rows x 4 columns of the 64x64 score
//   tile, computes s and dP for them in one pass over D, writes dS to
//   shared memory, and then adds dS . K into its 4 rows of dQ (columns
//   tx + 16*j).
// * K3 (dK, dV): one block per (b, KV head, 64-row k tile).  It stages
//   its K and V tiles once, then loops over the G = H / Hk query heads of
//   its group and, for each, over the q tiles from the causal start
//   (q tile of k0, since earlier q rows see none of these keys).  The
//   transposed tiles P^T and dS^T go to shared memory, and dV += P^T . dO,
//   dK += dS^T . Q accumulate in registers in f32.  The GQA group sum is
//   thus taken inside the block, in f32, before the one cast to k's dtype
//   (the TPU package writes f32 per query head and sums outside,
//   attention.py:339-343); the outputs are (B, Hk, Sk, D) directly.
//
// What bounds it.  At the training shape (B=8, H=Hk=12, S=1024, D=64,
// causal, bf16) K2 does three products over the causal half, about 19
// GFLOP, against about 64 MB of traffic; K3 does four, about 26 GFLOP,
// against about 76 MB.  On an H100 SXM both floors are near 0.02 ms (bf16
// tensor cores at 989 TFLOP/s, HBM at 3.35 TB/s).  This design does the
// products on the f32 CUDA cores from shared memory, as the forward kernel
// does, and so sits far above both: it is the simple, correct first
// version; mma.sync / wgmma with TMA staging is later work (PERF.md).
//
// Shared memory, f32, rows padded to D+1 and 65 floats so that the column
// reads are free of bank conflicts:
//   K2: Q, dO, K, V tiles 64 x (D+1), dS tile 64 x 65       (149 KB at D=128)
//   K3: K, V, Q, dO tiles 64 x (D+1), P^T and dS^T 64 x 65,
//       lse and delta of the q tile                         (162 KB at D=128)
// Both exceed the 48 KB static limit, hence the
// cudaFuncAttributeMaxDynamicSharedMemorySize call before each launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;    // query rows per tile
constexpr int BK = 64;    // key rows per tile
constexpr int NT = 256;   // threads per block: 16 (tx) x 16 (ty)
constexpr int PS = 65;    // row stride of the 64 x 64 P / dS tiles

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

// K2: dQ for one (b*H + h, 64-row q tile).
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int Hk, int Sq, int Sk, int causal, float scale) {
  constexpr int DS = D + 1;
  constexpr int DJ = D / 16;  // dQ columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;            // BQ x DS
  float* sO = sQ + BQ * DS;    // dO tile, BQ x DS
  float* sK = sO + BQ * DS;    // BK x DS
  float* sV = sK + BK * DS;    // BK x DS
  float* sS = sV + BK * DS;    // dS tile, BQ x PS

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int b = bh / H, h = bh % H;
  const int kvh = b * Hk + h / (H / Hk);
  const T* kp = k + (int64_t)kvh * Sk * D;
  const T* vp = v + (int64_t)kvh * Sk * D;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<T, D>(sQ, DS, q + (int64_t)bh * Sq * D, q0, Sq);
  load_tile<T, D>(sO, DS, dout + (int64_t)bh * Sq * D, q0, Sq);

  float lr[4], dr[4];
  bool rok[4];
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty * 4 + i;
    rok[i] = qr < Sq;
    lr[i] = rok[i] ? lse[(int64_t)bh * Sq + qr] : 0.f;
    dr[i] = rok[i] ? delta[(int64_t)bh * Sq + qr] : 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int nk = (Sk + BK - 1) / BK;
  const int hi = causal ? min(nk, (q0 + BQ + BK - 1) / BK) : nk;
  for (int kb = 0; kb < hi; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(sK, DS, kp, k0, Sk);
    load_tile<T, D>(sV, DS, vp, k0, Sk);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(ty * 4 + i) * DS + d];
        ov[i] = sO[(ty * 4 + i) * DS + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = sK[(tx + 16 * j) * DS + d];
        vv[j] = sV[(tx + 16 * j) * DS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = k0 + tx + 16 * j;
        const bool ok = rok[i] && kc < Sk && (!causal || kc <= qr);
        const float p = ok ? expf(s[i][j] * scale - lr[i]) : 0.f;
        sS[(ty * 4 + i) * PS + tx + 16 * j] = p * (dp[i][j] - dr[i]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sS[(ty * 4 + i) * PS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kk = sK[c * DS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dsv[i], kk, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!rok[i]) continue;
    T* row = dq + ((int64_t)bh * Sq + q0 + ty * 4 + i) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) store(row + tx + 16 * j, acc[i][j]);
  }
}

// K3: dK and dV for one (b*Hk + kv head, 64-row k tile), summed over the
// G query heads of the group.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Hk, int Sq, int Sk,
                     int causal, float scale) {
  constexpr int DS = D + 1;
  constexpr int DJ = D / 16;  // dK / dV columns per thread
  extern __shared__ float smem[];
  float* sK = smem;            // BK x DS
  float* sV = sK + BK * DS;    // BK x DS
  float* sQ = sV + BK * DS;    // BQ x DS
  float* sO = sQ + BQ * DS;    // dO tile, BQ x DS
  float* sP = sO + BQ * DS;    // P^T tile, BK x PS
  float* sS = sP + BK * PS;    // dS^T tile, BK x PS
  float* sL = sS + BK * PS;    // lse of the q tile, BQ
  float* sD = sL + BQ;         // delta of the q tile, BQ

  const int bkh = blockIdx.x;  // b * Hk + kv head
  const int k0 = blockIdx.y * BK;
  const int b = bkh / Hk, kh = bkh % Hk;
  const int G = H / Hk;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<T, D>(sK, DS, k + (int64_t)bkh * Sk * D, k0, Sk);
  load_tile<T, D>(sV, DS, v + (int64_t)bkh * Sk * D, k0, Sk);

  bool kok[4];
  float gk[4][DJ], gv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    kok[i] = k0 + ty * 4 + i < Sk;
#pragma unroll
    for (int j = 0; j < DJ; ++j) gk[i][j] = gv[i][j] = 0.f;
  }

  const int nq = (Sq + BQ - 1) / BQ;
  const int lo = causal ? k0 / BQ : 0;
  for (int g = 0; g < G; ++g) {
    const int bh = b * H + kh * G + g;
    const T* qp = q + (int64_t)bh * Sq * D;
    const T* op = dout + (int64_t)bh * Sq * D;
    const float* lp = lse + (int64_t)bh * Sq;
    const float* dlp = delta + (int64_t)bh * Sq;
    for (int qb = lo; qb < nq; ++qb) {
      const int q0 = qb * BQ;
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, D>(sQ, DS, qp, q0, Sq);
      load_tile<T, D>(sO, DS, op, q0, Sq);
      if (threadIdx.x < BQ) {
        const int r = q0 + threadIdx.x;
        sL[threadIdx.x] = r < Sq ? lp[r] : 0.f;
        sD[threadIdx.x] = r < Sq ? dlp[r] : 0.f;
      }
      __syncthreads();

      // rows: k rows ty*4 + i; columns: q rows tx + 16*j
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = sK[(ty * 4 + i) * DS + d];
          vv[i] = sV[(ty * 4 + i) * DS + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = sQ[(tx + 16 * j) * DS + d];
          ov[j] = sO[(tx + 16 * j) * DS + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kr = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qc = tx + 16 * j;
          const int qr = q0 + qc;
          const bool ok = kok[i] && qr < Sq && (!causal || kr <= qr);
          const float p = ok ? expf(s[i][j] * scale - sL[qc]) : 0.f;
          sP[(ty * 4 + i) * PS + qc] = p;
          sS[(ty * 4 + i) * PS + qc] = p * (dp[i][j] - sD[qc]) * scale;
        }
      }
      __syncthreads();

#pragma unroll 8
      for (int c = 0; c < BQ; ++c) {
        float pv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = sP[(ty * 4 + i) * PS + c];
          dsv[i] = sS[(ty * 4 + i) * PS + c];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float oo = sO[c * DS + tx + 16 * j];
          const float qq = sQ[c * DS + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            gv[i][j] = fmaf(pv[i], oo, gv[i][j]);
            gk[i][j] = fmaf(dsv[i], qq, gk[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!kok[i]) continue;
    const int64_t off = ((int64_t)bkh * Sk + k0 + ty * 4 + i) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      store(dk + off + tx + 16 * j, gk[i][j]);
      store(dv + off + tx + 16 * j, gv[i][j]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int B, H, Hk, Sq, Sk, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_dq(const Args& a) {
  const size_t smem = sizeof(float) * (size_t)(4 * 64 * (D + 1) + BQ * PS);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.B * a.H, (a.Sq + BQ - 1) / BQ);
  flash_bwd_dq_kernel<T, D><<<grid, NT, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
      (const float*)a.lse, (const float*)a.delta, (T*)a.dq, a.H, a.Hk, a.Sq,
      a.Sk, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const Args& a) {
  const size_t smem = sizeof(float) *
                      (size_t)(4 * 64 * (D + 1) + 2 * BK * PS + 2 * BQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.B * a.Hk, (a.Sk + BK - 1) / BK);
  flash_bwd_dkv_kernel<T, D><<<grid, NT, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
      (const float*)a.lse, (const float*)a.delta, (T*)a.dk, (T*)a.dv, a.H,
      a.Hk, a.Sq, a.Sk, a.causal, a.scale);
  return (int)cudaGetLastError();
}

// which: 0 = dQ (K2), 1 = dK/dV (K3)
template <typename T>
int launch_d(int which, int D, const Args& a) {
  switch (D) {
    case 32:
      return which ? launch_dkv<T, 32>(a) : launch_dq<T, 32>(a);
    case 64:
      return which ? launch_dkv<T, 64>(a) : launch_dq<T, 64>(a);
    case 128:
      return which ? launch_dkv<T, 128>(a) : launch_dq<T, 128>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int launch(int which, const Args& a, int D, int dtype, int device) {
  if (a.Hk <= 0 || a.H % a.Hk != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dtype == 0) return launch_d<float>(which, D, a);
  if (dtype == 1) return launch_d<__nv_bfloat16>(which, D, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K2.  dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout, dq alike); lse
// and delta are float32.  Returns the cudaError_t of the launch.
int mxtt_flash_bwd_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int H, int Hk, int Sq, int Sk, int D,
                      int dtype, int causal, float scale, int device,
                      void* stream) {
  if (B * H == 0 || Sq == 0) return 0;
  Args a{q,  k, v, dout, lse, delta, dq, nullptr, nullptr, B,
         H,  Hk, Sq, Sk, causal, scale, (cudaStream_t)stream};
  return launch(0, a, D, dtype, device);
}

// K3.  Same conventions; dk and dv are (B, Hk, Sk, D) in k's dtype.
int mxtt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int H, int Hk, int Sq,
                       int Sk, int D, int dtype, int causal, float scale,
                       int device, void* stream) {
  if (B * Hk == 0 || Sk == 0) return 0;
  Args a{q,  k, v, dout, lse, delta, nullptr, dk, dv, B,
         H,  Hk, Sq, Sk, causal, scale, (cudaStream_t)stream};
  return launch(1, a, D, dtype, device);
}

const char* mxtt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
