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
// One thread an (n, j, i) element, a block a run of 256 i's of one row j
// (box j is read once a block; the boxes of an image stay in cache); one
// byte of output an element, written coalesced.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// detection.py iou_matrix
template <typename T>
__device__ __forceinline__ bool corner_iou_above(const float* a,
                                                 const float* b,
                                                 float thresh) {
  using O = Ops<T>;
  float iw = fmaxf(0.f, O::sub(fminf(a[2], b[2]), fmaxf(a[0], b[0])));
  float ih = fmaxf(0.f, O::sub(fminf(a[3], b[3]), fmaxf(a[1], b[1])));
  float inter = O::mul(iw, ih);
  float area_a = O::mul(O::sub(a[2], a[0]), O::sub(a[3], a[1]));
  float area_b = O::mul(O::sub(b[2], b[0]), O::sub(b[3], b[1]));
  float uni = O::sub(O::add(area_a, area_b), inter);
  float iou = uni > 0.f ? O::div(inter, uni) : 0.f;
  return iou > thresh;
}

// detection.py pixel_iou
template <typename T>
__device__ __forceinline__ bool pixel_iou_above(const float* a,
                                                const float* b,
                                                float thresh) {
  using O = Ops<T>;
  float area_a = O::mul(O::add(O::sub(a[2], a[0]), 1.f),
                        O::add(O::sub(a[3], a[1]), 1.f));
  float area_b = O::mul(O::add(O::sub(b[2], b[0]), 1.f),
                        O::add(O::sub(b[3], b[1]), 1.f));
  float xx1 = fmaxf(a[0], b[0]);
  float yy1 = fmaxf(a[1], b[1]);
  float xx2 = fminf(a[2], b[2]);
  float yy2 = fminf(a[3], b[3]);
  float inter = O::mul(fmaxf(O::add(O::sub(xx2, xx1), 1.f), 0.f),
                       fmaxf(O::add(O::sub(yy2, yy1), 1.f), 0.f));
  float iou = O::div(inter, O::sub(O::add(area_a, area_b), inter));
  return iou > thresh;
}

template <typename T, int RULE>
__global__ void nms_suppress_kernel(const T* __restrict__ boxes,
                                    const uint8_t* __restrict__ valid,
                                    const float* __restrict__ classes,
                                    uint8_t* __restrict__ S, int K, int ks,
                                    int ke, float thresh) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  const int n = blockIdx.z;
  if (i >= ke) return;
  const size_t row = (size_t)n * K;
  bool out = false;
  if (j < i && valid[row + j] &&
      (classes == nullptr || classes[row + j] == classes[row + i])) {
    float a[4], b[4];
    for (int c = 0; c < 4; ++c) {
      a[c] = Round<T>::load(boxes + (row + j) * 4 + c);
      b[c] = Round<T>::load(boxes + (row + i) * 4 + c);
    }
    out = RULE == 0 ? corner_iou_above<T>(a, b, thresh)
                    : pixel_iou_above<T>(a, b, thresh);
  }
  S[((size_t)n * ks + j) * ke + i] = out ? 1 : 0;
}

template <typename T>
cudaError_t launch(const void* boxes, const void* valid, const void* classes,
                   void* S, int N, int K, int ks, int ke, int rule,
                   float thresh, cudaStream_t stream) {
  dim3 grid((ke + 255) / 256, ks, N);
  const T* b = static_cast<const T*>(boxes);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  const float* c = static_cast<const float*>(classes);
  uint8_t* s = static_cast<uint8_t*>(S);
  if (rule == 0)
    nms_suppress_kernel<T, 0><<<grid, 256, 0, stream>>>(b, v, c, s, K, ks,
                                                        ke, thresh);
  else
    nms_suppress_kernel<T, 1><<<grid, 256, 0, stream>>>(b, v, c, s, K, ks,
                                                        ke, thresh);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// boxes (N, K, 4) of dtype (0 = float32, 1 = bfloat16), valid (N, K)
// bytes, classes (N, K) float32 or null, S (N, ks, ke) bytes; rule 0 =
// corners, 1 = pixel boxes.  Returns the cudaError_t of the launch.
int mxtt_nms_suppress(const void* boxes, const void* valid,
                      const void* classes, void* S, int N, int K, int ks,
                      int ke, int dtype, int rule, float thresh, int device,
                      void* stream) {
  if (N == 0 || ks == 0 || ke == 0) return 0;
  if (ks > ke || ke > K || N > 65535 || ks > 65535 || (rule != 0 && rule != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float>(boxes, valid, classes, S, N, K, ks, ke, rule,
                              thresh, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(boxes, valid, classes, S, N, K, ks, ke,
                                      rule, thresh, st);
  return (int)cudaErrorInvalidValue;
}

const char* mxtt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
