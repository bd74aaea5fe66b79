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
// * K2 (dQ): one block per (b*H + h, 64-row q tile).  It stages its Q
//   and dO tiles once, then walks 64-row K/V tiles (under causal up to
//   the diagonal tile, a bound that depends only on the positions, not
//   on the TPU's 128-row blocks) and keeps the dQ tile in registers in
//   f32.  Two designs on that frame, chosen by dtype in launch_dtype
//   (never as a fallback):
//   - bf16 -> flash_bwd_dq_mma_kernel, on the tensor cores: 4 warps (128
//     threads), each owning 16 of the 64 q rows; under causal the
//     heaviest q tiles (the last ones) get the lowest block indices, as
//     in the forward.  Q and dO are staged once in bf16 with the
//     warp's lse and delta rows in registers; their A fragments are
//     read by ldmatrix at each use, not kept in registers: at D=64
//     keeping them took 199 registers a thread (2 blocks per SM) and
//     0.123 ms at the training shape, reading them 168 (3 blocks per
//     SM) and 0.093 ms (PERF.md §6).  K and V tiles go through a
//     two-stage cp.async ring, so the next tile's copy overlaps this
//     one's work; rows past Sq or Sk are zero-filled by the copy.
//     S = Q.K^T and dP = dO.V^T run as mma.sync m16n8k16 (bf16 in, f32
//     accumulators; K and V fragments by ldmatrix); P = exp(S scale -
//     lse) and dS = P (dP - delta) scale are formed in the accumulator
//     registers (masked to 0 only in tiles that meet the diagonal or a
//     ragged edge, decided per warp) and dS is rounded to bf16 straight
//     into the A fragments of dQ += dS.K (K fragments by
//     ldmatrix.trans): dS never goes to shared memory.  Shared memory,
//     bf16 rows padded to D + 8 values (ldmatrix without bank
//     conflicts): Q, dO 64 rows each, K, V 2 stages each: 54 KB at
//     D=64, 102 KB at D=128.
//   - float32 -> flash_bwd_dq_kernel, on the f32 CUDA cores in full f32
//     (no TF32, no mma): 128 threads (4 warps), the heaviest causal q
//     tiles first as above.  Q and dO are staged once; K goes through a
//     two-stage cp.async ring of 16-byte copies, V's next tile is copied
//     as soon as this tile's S and dP are done (rows past Sq or Sk
//     zero-filled by the copy).  Each thread computes S = Q.K^T and dP =
//     dO.V^T for the same 4 x 8 patch (q rows r + 16 i, k columns c + 8
//     j) from float4 reads along D, and dS = P (dP - delta) scale in
//     registers (P masked only in tiles that meet the diagonal or a
//     ragged edge); dS goes to shared memory, and after one barrier every
//     thread adds dQ += dS.K for 8 q rows x D / 16 d columns, from float4
//     reads of dS along k and of K along d.
// * K3 (dK, dV): one block per (b, KV head, 64-row k tile).  It stages
//   its K and V tiles once, then loops over the G = H / Hk query heads of
//   its group and, for each, over the q tiles from the causal start
//   (q tile of k0, since earlier q rows see none of these keys).  dV +=
//   P^T . dO and dK += dS^T . Q accumulate in registers in f32, so the
//   GQA group sum is taken inside the block, in f32, before the one cast
//   to k's dtype (the TPU package writes f32 per query head and sums
//   outside, attention.py:339-343); the outputs are (B, Hk, Sk, D)
//   directly.  Two designs on that frame, chosen by dtype in
//   launch_dtype (never as a fallback):
//   - bf16 -> flash_bwd_dkv_mma_kernel, on the tensor cores: 4 warps (128
//     threads), each owning 16 of the 64 k rows.  K and V are staged once
//     in bf16 (at D <= 64 their A fragments are then kept in registers;
//     at D=128 they are read by ldmatrix at each use, for registers).  Q
//     and dO tiles go through a two-stage cp.async ring with the q tile's
//     lse and delta beside them, so the next tile's copy overlaps this
//     one's work; rows past Sq are zero-filled by the copy.  S^T = K.Q^T
//     and dP^T = V.dO^T run as mma.sync m16n8k16 (bf16 in, f32
//     accumulators; Q and dO fragments by ldmatrix); P^T = exp(S^T scale
//     - lse) and dS^T = P^T (dP^T - delta) scale are formed in the
//     accumulator registers (masked to 0 only in tiles that meet the
//     diagonal or a ragged edge) and rounded to bf16 straight into the A
//     fragments of dV += P^T.dO and dK += dS^T.Q (dO and Q fragments by
//     ldmatrix.trans): nothing goes back through shared memory.  q tiles
//     are 64 rows at D = 32 and 64, 32 at D = 128, where the two 16 x 128
//     f32 accumulators per warp already take 128 registers a thread.
//     Shared memory, bf16 rows padded to D + 8 values (ldmatrix without
//     bank conflicts): K, V 64 rows each, Q, dO 2 stages each, lse and
//     delta 2 stages: 55 KB at D=64, 69 KB at D=128.
//   - float32 -> flash_bwd_dkv_kernel, on the f32 CUDA cores in full
//     f32: 128 threads.  K and V are staged once; Q, dO, lse and delta of
//     each 64-row q tile are copied with 16-byte cp.async once the last
//     tile is read (two stages would take 142 KB of shared memory at
//     D=64, one block an SM; with one stage two blocks share an SM and
//     each covers the other's copy).  Each thread computes S^T = K.Q^T
//     and dP^T = V.dO^T for the same 4 x 8 patch (k rows r + 16 i, q
//     columns c + 8 j) and P^T and dS^T from them; both go to shared
//     memory, and after one barrier warps 0-1 add dV += P^T.dO and warps
//     2-3 dK += dS^T.Q, each thread 8 k rows x D / 8 d columns, summed
//     over the GQA group in registers.  f32 stays off the tensor cores:
//     there it would mean TF32, about three decimal digits, and the f32
//     path is what holds the card to the CPU at 1e-3 in chip_smoke.py.
//
// What bounds it.  At the training shape (B=8, H=Hk=12, S=1024, D=64,
// causal, bf16) K2 does three products over the causal half, 19.4 GFLOP,
// against 64 MB of traffic; K3 does four, 25.8 GFLOP, against 76 MB.  On
// an H100 SXM (bf16 tensor cores at 989 TFLOP/s, HBM at 3.35 TB/s) the
// operations bound both: 0.020 ms for K2, 0.026 ms for K3.  So both run
// their products on the tensor cores in bf16, keep P and dS in
// registers between the products, and overlap the next tile's copy with
// this tile's products; what is left above the bound (the mma.sync issue
// rate, the per-tile __syncthreads, 2-3 blocks per SM) is for wgmma and
// TMA.  On an NVIDIA H100 80GB HBM3 at 700.00 W the CUDA-core designs
// took 0.83 ms (K2) and 0.97 ms (K3) there in bf16, and the tensor-core
// designs take 0.093 ms (K2) and 0.13 ms (K3), about 5x their bounds
// (PERF.md §6).
//
// What bounds the float32 designs.  The same work in f32 is bound by the
// CUDA cores' FMAs: 0.289 ms for K2 and 0.385 ms for K3 at the training
// shape on an H100 SXM (67 TFLOP/s, 128 FMAs a clock an SM).  Next comes
// shared memory, which delivers 128 bytes a clock an SM to the threads:
// a warp's LDS.128 takes four clocks, broadcast or not, so a TM x TN
// patch of an outer product, TM + TN floats read for TM TN FMAs, costs
// 4 (TM + TN) / (TM TN) bytes an FMA, and above 1 the FMAs wait: 4x4
// patches, even read as float4, need 2 bytes an FMA.  Here K2 reads 1.5
// bytes an FMA in both passes,
// K3 1.5 for S^T and dP^T and 1.0 for dV and dK, every read a float4 of
// rows strided D + 4 floats (row r + 1 four banks after row r), free of
// bank conflicts.  8x8 patches of one product a thread (1.0 byte an FMA)
// were tried and were slower: P had to be handed from one group of warps
// to the other, one barrier more a tile and one group idle while the
// other took the exponentials.  The f32 kernels compute exp(x) as
// exp2f(x log2 e), one MUFU.EX2, as the bf16 kernels do (2% faster than
// the accurate expf in K2; the kernels still agree with the plain
// version within 1e-5 where 1e-3 is asked).  At most 255 registers a
// thread at 128 threads, 105.5 KB (K2) or 107 KB (K3) of shared memory at
// D=64, so two blocks (8 warps) share an SM:
//   K2: Q, dO, 2 stages of K, V, the dS tile           (187 KB at D=128)
//   K3: K, V, Q, dO, P^T, dS^T, lse and delta          (172 KB at D=128)
// Both exceed the 48 KB static limit, hence the
// cudaFuncAttributeMaxDynamicSharedMemorySize call before each launch.
// On an NVIDIA H100 80GB HBM3 at 700.00 W at the training shape in f32,
// K2 takes 0.536 ms and K3 0.769 ms, against SDPA's whole f32 backward
// at 1.24-1.26 ms in the same runs (PERF.md section 6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

constexpr int BQ = 64;  // query rows per tile (K2 in both dtypes, K3 in bf16)
constexpr int BK = 64;  // key rows per tile
// exp(x) is computed as exp2f(x log2 e), one MUFU.EX2 (about 2 ulp)
constexpr float LOG2E = 1.4426950408889634f;

// ---- float32: CUDA cores ----

constexpr int NT = 128;     // threads of the f32 kernels: 4 warps
constexpr int SS = BK + 8;  // row stride of the dS, P^T and dS^T tiles
static_assert(BQ == BK, "the f32 kernels' tiles are square");

// Row stride, in floats, of an f32 Q, K, V or dO tile: D + 4 keeps every
// row on 16 bytes (cp.async, float4 reads) and puts row r + 1 four banks
// after row r, so 8 consecutive rows read as float4 at one column cover
// all 32 banks.
template <int D>
__host__ __device__ constexpr int f32_ld() {
  return D + 4;
}

// This thread's group (0: warps 0-1, 1: warps 2-3) and its (r, c) in the
// 8 x 8 layout of the group's 64 threads; a warp covers 4 r x 8 c, so the
// 8 lanes of a quarter-warp share r and read 8 consecutive c.
__device__ __forceinline__ void f32_group(int& grp, int& r, int& c) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  grp = w >> 1;
  r = (w & 1) * 4 + (lane >> 3);
  c = lane & 7;
}

template <int N>
__device__ __forceinline__ void ld_vec(float (&v)[N], const float* p) {
  static_assert(N == 2 || N == 4, "float2 or float4");
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x, v[1] = x.y;
  }
}

template <int N>
__device__ __forceinline__ void st_vec(float* p, const float (&v)[N]) {
  if constexpr (N == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

// Stage rows [r0, r0 + ROWS) of a contiguous (rows, D) f32 matrix into a
// ROWS x f32_ld<D>() tile with 16-byte cp.async; rows at or past `rows`
// are zero-filled by the copy itself.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows_f32(float* dst,
                                              const float* __restrict__ src,
                                              int r0, int rows) {
  constexpr int CPR = D / 4;  // 16-byte chunks per row
  static_assert(ROWS * CPR % NT == 0, "chunks must split evenly");
#pragma unroll
  for (int j = 0; j < ROWS * CPR / NT; ++j) {
    const int i = j * NT + threadIdx.x;
    const int r = i / CPR, c = i % CPR;
    const bool ok = r0 + r < rows;
    const float* g = ok ? src + (int64_t)(r0 + r) * D + c * 4 : src;
    mma::cp_async16(dst + r * f32_ld<D>() + c * 4, g, ok ? 16 : 0);
  }
}

// x[i][j] += A[r + 16 i] . B[c + 8 j] over D, both tiles row-major with
// row stride LD: a 4 x 8 patch of a product whose reduction runs along
// the rows, 12 float4 reads for every 128 FMAs.
template <int D>
__device__ __forceinline__ void patch_rows(float (&x)[4][8], const float* a,
                                           const float* b, int r, int c) {
  constexpr int LD = f32_ld<D>();
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float av[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) ld_vec(av[i], a + (r + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float bv[4];
      ld_vec(bv, b + (c + 8 * j) * LD + d);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i][j] = fmaf(av[i][e], bv[e], x[i][j]);
    }
  }
}

// g[i][m][n] += sum over k < K of P[r + 8 i][k] * B[k][col(m, n)] with
// col(m, n) = m * C * CW + c * CW + n: the product of a tile P (rows of
// stride PS, read as float4 along k) and a row-major tile B (stride LD,
// read as CW-wide vectors along its columns), C column groups.
template <int K, int PS, int LD, int C, int NC, int CW>
__device__ __forceinline__ void patch_cols(float (&g)[8][NC][CW],
                                           const float* p, const float* b,
                                           int r, int c) {
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float av[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) ld_vec(av[i], p + (r + 8 * i) * PS + k);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        float bv[CW];
        ld_vec(bv, b + (k + e) * LD + m * C * CW + c * CW);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int n = 0; n < CW; ++n)
            g[i][m][n] = fmaf(av[i][e], bv[n], g[i][m][n]);
      }
  }
}

// Shared memory, in floats, of the f32 dQ kernel: Q, dO, two stages of K,
// V, and the P / dS tile.
template <int D>
__host__ __device__ constexpr int dq_f32_floats() {
  return 2 * BQ * f32_ld<D>() + 3 * BK * f32_ld<D>() + BQ * SS;
}

// K2 in float32: dQ for one (b*H + h, 64-row q tile).
template <int D>
__global__ void __launch_bounds__(NT, 2)
flash_bwd_dq_kernel(const float* __restrict__ q,
                    const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int H, int Hk, int Sq, int Sk, int causal, float scale) {
  constexpr int LD = f32_ld<D>();
  // dQ += dS.K: 8 q rows x D / 16 d columns a thread, in NC vectors of CW
  constexpr int CW = D >= 64 ? 4 : 2, NC = D / (16 * CW);
  extern __shared__ __align__(16) float smem_f32[];
  float* sQ = smem_f32;          // BQ x LD
  float* sO = sQ + BQ * LD;      // dO, BQ x LD
  float* sK = sO + BQ * LD;      // 2 stages of BK x LD
  float* sV = sK + 2 * BK * LD;  // BK x LD
  float* sS = sV + BK * LD;      // dS, BQ x SS

  const int nq = (Sq + BQ - 1) / BQ;
  const int q0 = (causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y) * BQ;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = b * Hk + h / (H / Hk);
  const float* kp = k + (int64_t)kvh * Sk * D;
  const float* vp = v + (int64_t)kvh * Sk * D;
  // S and dP: q rows r + 16 i, k columns c + 8 j; a warp 4 r x 8 c
  const int r = (threadIdx.x >> 5) * 4 + ((threadIdx.x & 31) >> 3);
  const int c = threadIdx.x & 7;
  // dQ: q rows r3 + 8 i, column group c3 of 16
  const int r3 = (threadIdx.x >> 4), c3 = threadIdx.x & 15;

  const int nk = (Sk + BK - 1) / BK;
  const int hi = causal ? min(nk, (q0 + BQ + BK - 1) / BK) : nk;

  load_rows_f32<D, BQ>(sQ, q + (int64_t)bh * Sq * D, q0, Sq);
  load_rows_f32<D, BQ>(sO, dout + (int64_t)bh * Sq * D, q0, Sq);
  if (hi > 0) {
    load_rows_f32<D, BK>(sK, kp, 0, Sk);
    load_rows_f32<D, BK>(sV, vp, 0, Sk);
  }
  mma::cp_async_commit();

  float lr[4], dr[4];  // rows r + 16 i (0 past Sq)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + r + 16 * i;
    lr[i] = qr < Sq ? lse[(int64_t)bh * Sq + qr] : 0.f;
    dr[i] = qr < Sq ? delta[(int64_t)bh * Sq + qr] : 0.f;
  }
  float acc[8][NC][CW];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int m = 0; m < NC; ++m)
#pragma unroll
      for (int n = 0; n < CW; ++n) acc[i][m][n] = 0.f;

  for (int kb = 0; kb < hi; ++kb) {
    const int k0 = kb * BK;
    const float* cK = sK + (kb & 1) * BK * LD;
    mma::cp_async_wait<0>();
    __syncthreads();  // K and V of this tile are in; the last tile is done
    if (kb + 1 < hi) {  // K's next tile lands during this tile's work
      load_rows_f32<D, BK>(sK + ((kb + 1) & 1) * BK * LD, kp, k0 + BK, Sk);
      mma::cp_async_commit();
    }

    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
    patch_rows<D>(s, sQ, cK, r, c);
    patch_rows<D>(dp, sO, sV, r, c);

    // dS = P (dP - delta) scale, P masked only in tiles that meet the
    // diagonal or a ragged edge
    const bool edge =
        (causal && k0 + BK - 1 > q0) || k0 + BK > Sk || q0 + BQ > Sq;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float p = exp2f(fmaf(s[i][j], scale, -lr[i]) * LOG2E);
        if (edge) {
          const int qr = q0 + r + 16 * i, kc = k0 + c + 8 * j;
          if (qr >= Sq || kc >= Sk || (causal && kc > qr)) p = 0.f;
        }
        sS[(r + 16 * i) * SS + c + 8 * j] = p * (dp[i][j] - dr[i]) * scale;
      }
    __syncthreads();  // dS is in; V is read
    if (kb + 1 < hi) {  // V's next tile lands during dQ
      load_rows_f32<D, BK>(sV, vp, k0 + BK, Sk);
      mma::cp_async_commit();
    }

    // dQ += dS.K
    patch_cols<BK, SS, LD, 16, NC, CW>(acc, sS, cK, r3, c3);
  }
  mma::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qr = q0 + r3 + 8 * i;
    if (qr >= Sq) continue;
    float* row = dq + ((int64_t)bh * Sq + qr) * D;
#pragma unroll
    for (int m = 0; m < NC; ++m)
      st_vec(row + m * 16 * CW + c3 * CW, acc[i][m]);
  }
}

// Shared memory, in floats, of the f32 dK/dV kernel: K, V, Q and dO,
// P^T and dS^T, the q tile's lse and delta.
template <int D>
__host__ __device__ constexpr int dkv_f32_floats() {
  return 2 * BK * f32_ld<D>() + 2 * BQ * f32_ld<D>() + 2 * BK * SS + 2 * BQ;
}

// K3 in float32: dK and dV for one (b*Hk + kv head, 64-row k tile),
// summed over the G query heads of the group.
template <int D>
__global__ void __launch_bounds__(NT, 2)
flash_bwd_dkv_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int Hk, int Sq, int Sk,
                     int causal, float scale) {
  constexpr int LD = f32_ld<D>();
  // dV or dK: 8 k rows x D / 8 d columns a thread, in D / 32 float4s
  constexpr int NC = D / 32;
  extern __shared__ __align__(16) float smem_f32[];
  float* sK = smem_f32;      // BK x LD
  float* sV = sK + BK * LD;  // BK x LD
  float* sQ = sV + BK * LD;  // BQ x LD
  float* sO = sQ + BQ * LD;  // dO, BQ x LD
  float* sP = sO + BQ * LD;  // P^T, BK x SS
  float* sS = sP + BK * SS;  // dS^T, BK x SS
  float* sL = sS + BK * SS;  // lse of the q tile, BQ
  float* sD = sL + BQ;       // delta of the q tile, BQ

  const int bkh = blockIdx.x;  // b * Hk + kv head
  const int k0 = blockIdx.y * BK;
  const int b = bkh / Hk, kh = bkh % Hk;
  const int G = H / Hk;
  load_rows_f32<D, BK>(sK, k + (int64_t)bkh * Sk * D, k0, Sk);
  load_rows_f32<D, BK>(sV, v + (int64_t)bkh * Sk * D, k0, Sk);

  // iterations walk (query head of the group, q tile from the causal
  // start); `stage` starts the copies of iteration `it`
  const int nq = (Sq + BQ - 1) / BQ;
  const int lo = causal ? min(k0 / BQ, nq) : 0;
  const int nqt = nq - lo;
  const int n_it = G * nqt;
  auto stage = [&](int it) {
    const int bh = b * H + kh * G + it / nqt;
    const int q0 = (lo + it % nqt) * BQ;
    load_rows_f32<D, BQ>(sQ, q + (int64_t)bh * Sq * D, q0, Sq);
    load_rows_f32<D, BQ>(sO, dout + (int64_t)bh * Sq * D, q0, Sq);
    const int i = threadIdx.x % BQ;
    const bool ok = q0 + i < Sq;
    const int64_t off = ok ? (int64_t)bh * Sq + q0 + i : 0;
    if (threadIdx.x < BQ)
      mma::cp_async4(sL + i, lse + off, ok);
    else
      mma::cp_async4(sD + i, delta + off, ok);
  };
  if (n_it > 0) stage(0);
  mma::cp_async_commit();

  // S^T and dP^T: k rows r + 16 i, q columns c + 8 j; a warp 4 r x 8 c
  const int r = (threadIdx.x >> 5) * 4 + ((threadIdx.x & 31) >> 3);
  const int c = threadIdx.x & 7;
  // group 0 adds dV += P^T.dO, group 1 dK += dS^T.Q: k rows rg + 8 i
  int grp, rg, cg;
  f32_group(grp, rg, cg);
  float g[8][NC][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int m = 0; m < NC; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) g[i][m][n] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    mma::cp_async_wait<0>();
    __syncthreads();  // this q tile is in
    const int q0 = (lo + it % nqt) * BQ;

    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
    patch_rows<D>(s, sK, sQ, r, c);
    patch_rows<D>(dp, sV, sO, r, c);

    // P^T and dS^T, masked only in tiles that meet the diagonal or a
    // ragged edge
    const bool edge =
        (causal && k0 + BK - 1 > q0) || q0 + BQ > Sq || k0 + BK > Sk;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qc = c + 8 * j, e = (r + 16 * i) * SS + qc;
        float p = exp2f(fmaf(s[i][j], scale, -sL[qc]) * LOG2E);
        if (edge) {
          const int qr = q0 + qc, kr = k0 + r + 16 * i;
          if (qr >= Sq || kr >= Sk || (causal && kr > qr)) p = 0.f;
        }
        sP[e] = p;
        sS[e] = p * (dp[i][j] - sD[qc]) * scale;
      }
    __syncthreads();  // P^T and dS^T are in

    // dV += P^T.dO (group 0), dK += dS^T.Q (group 1)
    patch_cols<BQ, SS, LD, 8, NC, 4>(g, grp ? sS : sP, grp ? sQ : sO, rg,
                                     cg);
    __syncthreads();  // the q tile is read
    if (it + 1 < n_it) {
      stage(it + 1);
      mma::cp_async_commit();
    }
  }
  mma::cp_async_wait<0>();

  float* out = grp ? dk : dv;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int kr = k0 + rg + 8 * i;
    if (kr >= Sk) continue;
    float* row = out + ((int64_t)bkh * Sk + kr) * D;
#pragma unroll
    for (int m = 0; m < NC; ++m) st_vec(row + m * 32 + cg * 4, g[i][m]);
  }
}

// ---- bf16: tensor cores ----

using mma::bf16;

constexpr int MT = 128;  // threads of the bf16 kernels: 4 warps

// K2 in bf16: dQ for one (b*H + h, 64-row q tile).
template <int D>
__global__ void __launch_bounds__(MT)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dq, int H, int Hk, int Sq, int Sk,
                        int causal, float scale) {
  constexpr int LD = mma::row_stride<D>();
  constexpr int KS = D / 16;  // k-steps of S = Q.K^T
  constexpr int NS = BK / 8;  // n-blocks of S
  constexpr int ND = D / 8;   // n-blocks of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // BQ x LD
  bf16* sO = sQ + BQ * LD;                       // dO, BQ x LD
  bf16* sK = sO + BQ * LD;                       // 2 stages of BK x LD
  bf16* sV = sK + 2 * BK * LD;                   // 2 stages of BK x LD

  const int nq = (Sq + BQ - 1) / BQ;
  const int q0 = (causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y) * BQ;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = b * Hk + h / (H / Hk);
  const bf16* kp = k + (int64_t)kvh * Sk * D;
  const bf16* vp = v + (int64_t)kvh * Sk * D;

  const int lane = threadIdx.x & 31;
  const int wr = (threadIdx.x >> 5) * 16;  // the warp's first q row
  const int g = lane >> 2, t = lane & 3;

  const int nk = (Sk + BK - 1) / BK;
  const int hi = causal ? min(nk, (q0 + BQ + BK - 1) / BK) : nk;

  mma::load_rows<D, BQ, MT>(sQ, q + (int64_t)bh * Sq * D, q0, Sq);
  mma::load_rows<D, BQ, MT>(sO, dout + (int64_t)bh * Sq * D, q0, Sq);
  mma::cp_async_commit();
  if (hi > 0) {
    mma::load_rows<D, BK, MT>(sK, kp, 0, Sk);
    mma::load_rows<D, BK, MT>(sV, vp, 0, Sk);
  }
  mma::cp_async_commit();

  // rows g and g + 8 of the warp: lse, delta (0 past Sq), dQ
  float lr[2], dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qr = q0 + wr + g + i * 8;
    const int64_t off = (int64_t)bh * Sq + qr;
    lr[i] = qr < Sq ? lse[off] : 0.f;
    dr[i] = qr < Sq ? delta[off] : 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kb = 0; kb < hi; ++kb) {
    const int k0 = kb * BK;
    const bf16* cK = sK + (kb & 1) * BK * LD;
    const bf16* cV = sV + (kb & 1) * BK * LD;
    if (kb + 1 < hi) {  // the next tile's copy overlaps this tile's work
      mma::load_rows<D, BK, MT>(sK + ((kb + 1) & 1) * BK * LD, kp, k0 + BK,
                                Sk);
      mma::load_rows<D, BK, MT>(sV + ((kb + 1) & 1) * BK * LD, vp, k0 + BK,
                                Sk);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q.K^T and dP = dO.V^T for the warp's 16 q rows
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4], oa[4];
      mma::load_a<LD>(qa, sQ, wr, kk * 16, lane);
      mma::load_a<LD>(oa, sO, wr, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bf[4];
        mma::load_b_nk<LD>(bf, cK, np * 16, kk * 16, lane);
        mma::mma_bf16(s[2 * np], qa, bf[0], bf[1]);
        mma::mma_bf16(s[2 * np + 1], qa, bf[2], bf[3]);
        mma::load_b_nk<LD>(bf, cV, np * 16, kk * 16, lane);
        mma::mma_bf16(dp[2 * np], oa, bf[0], bf[1]);
        mma::mma_bf16(dp[2 * np + 1], oa, bf[2], bf[3]);
      }
    }

    // dS = P (dP - delta) scale in the accumulators; masked to 0 only
    // where this warp's rows meet the diagonal or a ragged edge
    const bool edge = (causal && k0 + BK - 1 > q0 + wr) || k0 + BK > Sk ||
                      q0 + wr + 16 > Sq;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = exp2f(fmaf(s[j][e], scale, -lr[i]) * LOG2E);
        if (edge) {
          const int kc = k0 + j * 8 + 2 * t + (e & 1);
          const int qr = q0 + wr + g + i * 8;
          if (qr >= Sq || kc >= Sk || (causal && kc > qr)) p = 0.f;
        }
        dp[j][e] = p * (dp[j][e] - dr[i]) * scale;
      }

    // dQ += dS.K, dS rounded to bf16 in registers
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t da[4];
      mma::pack_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t bf[4];
        mma::load_b_kn<LD>(bf, cK, kk * 16, dn * 16, lane);
        mma::mma_bf16(acc[2 * dn], da, bf[0], bf[1]);
        mma::mma_bf16(acc[2 * dn + 1], da, bf[2], bf[3]);
      }
    }
    __syncthreads();  // this stage's readers are done before its refill
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qr = q0 + wr + g + i * 8;
    if (qr >= Sq) continue;
    bf16* row = dq + ((int64_t)bh * Sq + qr) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      mma::store_bf16x2(row + j * 8 + 2 * t, acc[j][2 * i],
                        acc[j][2 * i + 1]);
  }
}

// q rows per tile of the bf16 dK/dV kernel
template <int D>
__host__ __device__ constexpr int mma_bq() {
  return D == 128 ? 32 : 64;
}

// K3 in bf16: dK and dV for one (b*Hk + kv head, 64-row k tile), summed
// over the G query heads of the group.
template <int D>
__global__ void __launch_bounds__(MT)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                         int Hk, int Sq, int Sk, int causal, float scale) {
  constexpr int LD = mma::row_stride<D>();
  constexpr int MQ = mma_bq<D>();
  constexpr int KS = D / 16;  // k-steps of S^T = K.Q^T
  constexpr int NS = MQ / 8;  // n-blocks of S^T
  constexpr int ND = D / 8;   // n-blocks of dK, dV
  constexpr bool HOIST = D <= 64;  // K, V fragments kept in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // BK x LD
  bf16* sV = sK + BK * LD;                       // BK x LD
  bf16* sQ = sV + BK * LD;                       // 2 stages of MQ x LD
  bf16* sO = sQ + 2 * MQ * LD;                   // dO, 2 stages of MQ x LD
  float* sL = reinterpret_cast<float*>(sO + 2 * MQ * LD);  // lse, 2 x MQ
  float* sD = sL + 2 * MQ;                                 // delta, 2 x MQ

  const int bkh = blockIdx.x;  // b * Hk + kv head
  const int k0 = blockIdx.y * BK;
  const int b = bkh / Hk, kh = bkh % Hk;
  const int G = H / Hk;

  const int lane = threadIdx.x & 31;
  const int wr = (threadIdx.x >> 5) * 16;  // the warp's first k row
  const int g = lane >> 2, t = lane & 3;

  mma::load_rows<D, BK, MT>(sK, k + (int64_t)bkh * Sk * D, k0, Sk);
  mma::load_rows<D, BK, MT>(sV, v + (int64_t)bkh * Sk * D, k0, Sk);
  mma::cp_async_commit();

  // iterations walk (query head of the group, q tile from the causal
  // start); `stage` issues the copies of iteration `it` into stage `st`
  const int nq = (Sq + MQ - 1) / MQ;
  const int lo = causal ? min(k0 / MQ, nq) : 0;
  const int nqt = nq - lo;
  const int n_it = G * nqt;
  auto stage = [&](int it, int st) {
    const int bh = b * H + kh * G + it / nqt;
    const int q0 = (lo + it % nqt) * MQ;
    mma::load_rows<D, MQ, MT>(sQ + st * MQ * LD, q + (int64_t)bh * Sq * D,
                              q0, Sq);
    mma::load_rows<D, MQ, MT>(sO + st * MQ * LD,
                              dout + (int64_t)bh * Sq * D, q0, Sq);
    const int i = threadIdx.x % MQ;
    const bool ok = q0 + i < Sq;
    const int64_t off = ok ? (int64_t)bh * Sq + q0 + i : 0;
    if (threadIdx.x < MQ)
      mma::cp_async4(sL + st * MQ + i, lse + off, ok);
    else if (threadIdx.x < 2 * MQ)
      mma::cp_async4(sD + st * MQ + i, delta + off, ok);
  };
  if (n_it > 0) stage(0, 0);
  mma::cp_async_commit();

  float gk[ND][4], gv[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[j][e] = gv[j][e] = 0.f;
  uint32_t kf[HOIST ? KS : 1][4], vf[HOIST ? KS : 1][4];

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) {  // the next tile's copy overlaps this tile's work
      stage(it + 1, st ^ 1);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    if (HOIST && it == 0) {
#pragma unroll
      for (int kk = 0; kk < (HOIST ? KS : 0); ++kk) {
        mma::load_a<LD>(kf[kk], sK, wr, kk * 16, lane);
        mma::load_a<LD>(vf[kk], sV, wr, kk * 16, lane);
      }
    }
    const int q0 = (lo + it % nqt) * MQ;
    const bf16* cQ = sQ + st * MQ * LD;
    const bf16* cO = sO + st * MQ * LD;
    const float* cL = sL + st * MQ;
    const float* cD = sD + st * MQ;

    // S^T = K.Q^T and dP^T = V.dO^T for the warp's 16 k rows
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ka[4], va[4];
      if constexpr (HOIST) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ka[e] = kf[kk][e];
          va[e] = vf[kk][e];
        }
      } else {
        mma::load_a<LD>(ka, sK, wr, kk * 16, lane);
        mma::load_a<LD>(va, sV, wr, kk * 16, lane);
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bf[4];
        mma::load_b_nk<LD>(bf, cQ, np * 16, kk * 16, lane);
        mma::mma_bf16(s[2 * np], ka, bf[0], bf[1]);
        mma::mma_bf16(s[2 * np + 1], ka, bf[2], bf[3]);
        mma::load_b_nk<LD>(bf, cO, np * 16, kk * 16, lane);
        mma::mma_bf16(dp[2 * np], va, bf[0], bf[1]);
        mma::mma_bf16(dp[2 * np + 1], va, bf[2], bf[3]);
      }
    }

    // P^T and dS^T in the accumulators; masked to 0 only where this
    // warp's rows meet the diagonal or the tile meets a ragged edge
    const bool edge = (causal && k0 + wr + 15 > q0) || q0 + MQ > Sq ||
                      k0 + wr + 16 > Sk;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + 2 * t + (e & 1);
        float p = exp2f(fmaf(s[j][e], scale, -cL[qc]) * LOG2E);
        if (edge) {
          const int qr = q0 + qc, kr = k0 + wr + g + (e >> 1) * 8;
          if (qr >= Sq || kr >= Sk || (causal && kr > qr)) p = 0.f;
        }
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - cD[qc]) * scale;
      }

    // dV += P^T.dO and dK += dS^T.Q, P^T and dS^T rounded to bf16 in
    // registers
#pragma unroll
    for (int kk = 0; kk < MQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      mma::pack_a(pa, s[2 * kk], s[2 * kk + 1]);
      mma::pack_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t bf[4];
        mma::load_b_kn<LD>(bf, cO, kk * 16, dn * 16, lane);
        mma::mma_bf16(gv[2 * dn], pa, bf[0], bf[1]);
        mma::mma_bf16(gv[2 * dn + 1], pa, bf[2], bf[3]);
        mma::load_b_kn<LD>(bf, cQ, kk * 16, dn * 16, lane);
        mma::mma_bf16(gk[2 * dn], da, bf[0], bf[1]);
        mma::mma_bf16(gk[2 * dn + 1], da, bf[2], bf[3]);
      }
    }
    __syncthreads();  // this stage's readers are done before its refill
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kr = k0 + wr + g + i * 8;
    if (kr >= Sk) continue;
    const int64_t off = ((int64_t)bkh * Sk + kr) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      mma::store_bf16x2(dk + off + j * 8 + 2 * t, gk[j][2 * i],
                        gk[j][2 * i + 1]);
      mma::store_bf16x2(dv + off + j * 8 + 2 * t, gv[j][2 * i],
                        gv[j][2 * i + 1]);
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

template <int D>
int launch_dq(const Args& a) {
  const size_t smem = sizeof(float) * (size_t)dq_f32_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.B * a.H, (a.Sq + BQ - 1) / BQ);
  flash_bwd_dq_kernel<D><<<grid, NT, smem, a.stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v,
      (const float*)a.dout, (const float*)a.lse, (const float*)a.delta,
      (float*)a.dq, a.H, a.Hk, a.Sq, a.Sk, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_mma(const Args& a) {
  const size_t smem =
      sizeof(bf16) * (size_t)(2 * BQ + 4 * BK) * mma::row_stride<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.B * a.H, (a.Sq + BQ - 1) / BQ);
  flash_bwd_dq_mma_kernel<D><<<grid, MT, smem, a.stream>>>(
      (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
      (const bf16*)a.dout, (const float*)a.lse, (const float*)a.delta,
      (bf16*)a.dq, a.H, a.Hk, a.Sq, a.Sk, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const Args& a) {
  const size_t smem = sizeof(float) * (size_t)dkv_f32_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.B * a.Hk, (a.Sk + BK - 1) / BK);
  flash_bwd_dkv_kernel<D><<<grid, NT, smem, a.stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v,
      (const float*)a.dout, (const float*)a.lse, (const float*)a.delta,
      (float*)a.dk, (float*)a.dv, a.H, a.Hk, a.Sq, a.Sk, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_mma(const Args& a) {
  constexpr int MQ = mma_bq<D>();
  const size_t smem =
      sizeof(bf16) * (size_t)(2 * BK + 4 * MQ) * mma::row_stride<D>() +
      sizeof(float) * 4 * MQ;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_mma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.B * a.Hk, (a.Sk + BK - 1) / BK);
  flash_bwd_dkv_mma_kernel<D><<<grid, MT, smem, a.stream>>>(
      (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
      (const bf16*)a.dout, (const float*)a.lse, (const float*)a.delta,
      (bf16*)a.dk, (bf16*)a.dv, a.H, a.Hk, a.Sq, a.Sk, a.causal, a.scale);
  return (int)cudaGetLastError();
}

// which: 0 = dQ (K2), 1 = dK/dV (K3).  The design follows the dtype,
// for both kernels alike: bf16 (1) runs on the tensor cores, float32 (0)
// on the CUDA cores.
template <int D>
int launch_dtype(int which, int dtype, const Args& a) {
  if (dtype == 0)
    return which ? launch_dkv<D>(a) : launch_dq<D>(a);
  if (dtype == 1)
    return which ? launch_dkv_mma<D>(a) : launch_dq_mma<D>(a);
  return (int)cudaErrorInvalidValue;
}

int launch_d(int which, int D, int dtype, const Args& a) {
  switch (D) {
    case 32:
      return launch_dtype<32>(which, dtype, a);
    case 64:
      return launch_dtype<64>(which, dtype, a);
    case 128:
      return launch_dtype<128>(which, dtype, a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int launch(int which, const Args& a, int D, int dtype, int device) {
  if (a.Hk <= 0 || a.H % a.Hk != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return launch_d(which, D, dtype, a);
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
