// A plain-C shim over the CUDA toolkit's nvJPEG for the record iterators
// and recordio.pack_img / unpack_img on the card (bound with ctypes in
// mxnet_tpu_torch/image/nvjpeg.py, linked with -lnvjpeg).
//
// It replaces no TPU kernel: the JAX package decodes JPEG on the host
// through libjpeg (mxnet_tpu/native/io_native.cc:158 decode_one) or PIL
// and encodes through PIL. An H100 has its own JPEG decode engines
// (NVJPG), which nvJPEG's hardware backend drives; the decoded pixels land
// in card memory, where I1 (csrc/image_augment.cu) resizes, crops,
// mirrors and normalizes them.
//
// Decode. Two nvJPEG handles: the hardware backend
// (NVJPEG_BACKEND_HARDWARE, baseline single-scan JPEG, not 4:1:0 or
// 4:1:1), where the card has the engines and nvJPEG lets it drive them,
// and the GPU-hybrid backend (NVJPEG_BACKEND_GPU_HYBRID: Huffman decode on
// the GPU for a batch of more than 50 baseline interleaved JPEGs, on the
// host below that) for the rest. The caller asks nvJPEG per image whether
// the hardware batch takes it (mxtt_jpeg_info), then hands a batch with
// those flags: the flagged images go through one nvjpegDecodeBatched of
// the hardware handle, the others through one of the GPU-hybrid handle.
// Each image is decoded at its own size into its own buffer of card
// memory, interleaved RGB (or the luma plane for one channel), on the
// caller's stream. A batch call that fails (one bad bitstream fails it)
// leaves its images to nvjpegDecode one by one; an image that no call
// decodes is zero-filled on that stream and counted, as
// io_native.cc:279-282 zero-fills. `used` says per image which path
// decoded it.
//
// Encode. One image a call: interleaved RGB in card memory, baseline
// Huffman JPEG with 4:2:0 chroma at the quality given, through the GPU-hybrid
// handle's GPU encoder; the bitstream is copied to host memory.
#include <cuda_runtime.h>
#include <nvjpeg.h>
#include <stdint.h>
#include <string.h>

#include <vector>

namespace {

// a status of this shim: nvJPEG's own below 1000, CUDA's at 1000 + its code
constexpr int CUDA_BASE = 1000;

struct Ctx {
  int device = 0;
  nvjpegHandle_t sw = nullptr;
  nvjpegJpegState_t sw_state = nullptr;
  nvjpegJpegState_t one_state = nullptr;
  int sw_batch = -1;
  int sw_format = -1;
  nvjpegHandle_t hw = nullptr;
  nvjpegJpegState_t hw_state = nullptr;
  nvjpegJpegStream_t hw_parsed = nullptr;
  int hw_batch = -1;
  int hw_format = -1;
  nvjpegEncoderState_t enc_state = nullptr;
  nvjpegEncoderParams_t enc_params = nullptr;
  int enc_quality = -1;
};

int set_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return err == cudaSuccess ? 0 : CUDA_BASE + (int)err;
}

nvjpegOutputFormat_t format_of(int channels) {
  return channels == 1 ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_RGBI;
}

void destroy(Ctx* c) {
  if (c->enc_params) nvjpegEncoderParamsDestroy(c->enc_params);
  if (c->enc_state) nvjpegEncoderStateDestroy(c->enc_state);
  if (c->hw_parsed) nvjpegJpegStreamDestroy(c->hw_parsed);
  if (c->hw_state) nvjpegJpegStateDestroy(c->hw_state);
  if (c->hw) nvjpegDestroy(c->hw);
  if (c->one_state) nvjpegJpegStateDestroy(c->one_state);
  if (c->sw_state) nvjpegJpegStateDestroy(c->sw_state);
  if (c->sw) nvjpegDestroy(c->sw);
  delete c;
}

// one image through the GPU-hybrid handle's own state; zero-filled on
// failure
int decode_one(Ctx* c, const unsigned char* data, size_t len,
               unsigned char* out, int w, int h, int channels,
               cudaStream_t stream) {
  nvjpegImage_t img;
  memset(&img, 0, sizeof(img));
  img.channel[0] = out;
  img.pitch[0] = (size_t)w * channels;
  nvjpegStatus_t s = nvjpegDecode(c->sw, c->one_state, data, len,
                                  format_of(channels), &img, stream);
  if (s != NVJPEG_STATUS_SUCCESS) {
    cudaMemsetAsync(out, 0, (size_t)w * h * channels, stream);
    return 0;
  }
  return 3;
}

// images `idx` in one nvjpegDecodeBatched of `handle`, its state set up
// again where the batch size or format changed; true when it decoded them
bool decode_batch(nvjpegHandle_t handle, nvjpegJpegState_t state, int* size,
                  int* format, const std::vector<int>& idx,
                  const unsigned char* const* data, const size_t* len,
                  unsigned char* const* out, const int* w, int channels,
                  cudaStream_t stream) {
  if (idx.empty() || handle == nullptr) return false;
  const int nb = (int)idx.size();
  const nvjpegOutputFormat_t fmt = format_of(channels);
  nvjpegStatus_t s = NVJPEG_STATUS_SUCCESS;
  if (nb != *size || (int)fmt != *format) {
    s = nvjpegDecodeBatchedInitialize(handle, state, nb, 1, fmt);
    *size = s == NVJPEG_STATUS_SUCCESS ? nb : -1;
    *format = (int)fmt;
  }
  std::vector<const unsigned char*> d(nb);
  std::vector<size_t> l(nb);
  std::vector<nvjpegImage_t> img(nb);
  for (int j = 0; j < nb; ++j) {
    const int i = idx[j];
    d[j] = data[i];
    l[j] = len[i];
    memset(&img[j], 0, sizeof(nvjpegImage_t));
    img[j].channel[0] = out[i];
    img[j].pitch[0] = (size_t)w[i] * channels;
  }
  if (s == NVJPEG_STATUS_SUCCESS)
    s = nvjpegDecodeBatched(handle, state, d.data(), l.data(), img.data(),
                            stream);
  if (s != NVJPEG_STATUS_SUCCESS) *size = -1;  // set up again next time
  return s == NVJPEG_STATUS_SUCCESS;
}

}  // namespace

extern "C" {

// A decoder on `device`: the GPU-hybrid handle always, the hardware one where
// the card has the engines and nvJPEG drives them. *hw_status is nvJPEG's
// answer to creating the hardware handle (0 when it exists). Returns a
// status.
int mxtt_jpeg_create(int device, void** out, int* hw_status) {
  *out = nullptr;
  *hw_status = -1;
  int err = set_device(device);
  if (err) return err;
  Ctx* c = new Ctx();
  c->device = device;
  nvjpegStatus_t s = nvjpegCreateEx(NVJPEG_BACKEND_GPU_HYBRID, nullptr,
                                    nullptr, 0, &c->sw);
  if (s == NVJPEG_STATUS_SUCCESS)
    s = nvjpegJpegStateCreate(c->sw, &c->sw_state);
  if (s == NVJPEG_STATUS_SUCCESS)
    s = nvjpegJpegStateCreate(c->sw, &c->one_state);
  if (s != NVJPEG_STATUS_SUCCESS) {
    destroy(c);
    return (int)s;
  }
  nvjpegStatus_t hs = nvjpegCreateEx(NVJPEG_BACKEND_HARDWARE, nullptr,
                                     nullptr, 0, &c->hw);
  if (hs == NVJPEG_STATUS_SUCCESS)
    hs = nvjpegJpegStateCreate(c->hw, &c->hw_state);
  if (hs == NVJPEG_STATUS_SUCCESS)
    hs = nvjpegJpegStreamCreate(c->hw, &c->hw_parsed);
  if (hs != NVJPEG_STATUS_SUCCESS) {
    if (c->hw_parsed) nvjpegJpegStreamDestroy(c->hw_parsed);
    if (c->hw_state) nvjpegJpegStateDestroy(c->hw_state);
    if (c->hw) nvjpegDestroy(c->hw);
    c->hw = nullptr;
    c->hw_state = nullptr;
    c->hw_parsed = nullptr;
  }
  *hw_status = (int)hs;
  *out = c;
  return 0;
}

int mxtt_jpeg_destroy(void* ctx) {
  if (ctx) destroy(static_cast<Ctx*>(ctx));
  return 0;
}

// The JPEG's size and component count, and whether the hardware batch
// decodes it (*hw_ok 1). Returns nvJPEG's status (not 0: not a JPEG
// nvJPEG reads).
int mxtt_jpeg_info(void* ctx, const unsigned char* data, size_t len, int* h,
                   int* w, int* components, int* hw_ok) {
  Ctx* c = static_cast<Ctx*>(ctx);
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  nvjpegChromaSubsampling_t css;
  *hw_ok = 0;
  nvjpegStatus_t s = nvjpegGetImageInfo(c->sw, data, len, components, &css,
                                        widths, heights);
  if (s != NVJPEG_STATUS_SUCCESS) return (int)s;
  *w = widths[0];
  *h = heights[0];
  if (c->hw) {
    int unsupported = 1;
    if (nvjpegJpegStreamParseHeader(c->hw, data, len, c->hw_parsed) ==
            NVJPEG_STATUS_SUCCESS &&
        nvjpegDecodeBatchedSupported(c->hw, c->hw_parsed, &unsupported) ==
            NVJPEG_STATUS_SUCCESS)
      *hw_ok = unsupported == 0;
  }
  return 0;
}

// Decode n JPEGs: image i from data[i] (len[i] bytes, host memory) into
// out[i] (card memory, h[i] x w[i] x channels bytes, interleaved; null:
// skipped), through the hardware batch where hw[i] is 1 and the card has
// the engines, the GPU-hybrid batch for the others, and one by one through
// the GPU-hybrid handle where a batch call failed; used[i] says which
// decoded it (1 hardware, 2 GPU-hybrid batch, 3 GPU-hybrid one by one, 0
// none: zero-filled). Returns a status: 0 unless the card itself failed.
int mxtt_jpeg_decode(void* ctx, int n, const unsigned char* const* data,
                     const size_t* len, unsigned char* const* out,
                     const int* h, const int* w, const int* hw, int channels,
                     void* stream, int* used) {
  Ctx* c = static_cast<Ctx*>(ctx);
  cudaStream_t st = (cudaStream_t)stream;
  int err = set_device(c->device);
  if (err) return err;
  std::vector<int> on_hw, on_gpu;
  for (int i = 0; i < n; ++i) {
    used[i] = 0;
    if (out[i] == nullptr) continue;
    (hw[i] && c->hw ? on_hw : on_gpu).push_back(i);
  }
  if (decode_batch(c->hw, c->hw_state, &c->hw_batch, &c->hw_format, on_hw,
                   data, len, out, w, channels, st))
    for (int i : on_hw) used[i] = 1;
  if (decode_batch(c->sw, c->sw_state, &c->sw_batch, &c->sw_format, on_gpu,
                   data, len, out, w, channels, st))
    for (int i : on_gpu) used[i] = 2;
  for (int i = 0; i < n; ++i) {
    if (used[i] || out[i] == nullptr) continue;
    used[i] = decode_one(c, data[i], len[i], out[i], w[i], h[i], channels,
                         st);
  }
  cudaError_t ce = cudaGetLastError();
  return ce == cudaSuccess ? 0 : CUDA_BASE + (int)ce;
}

// Encode one h x w interleaved RGB image in card memory as a baseline JPEG
// with 4:2:0 chroma at `quality`. With dst null, or *len smaller than the
// bitstream, sets *len to the bitstream's length and returns -1; else
// copies it to dst (host memory), sets *len and returns 0; or a status.
int mxtt_jpeg_encode(void* ctx, const unsigned char* rgb, int h, int w,
                     int quality, void* stream, unsigned char* dst,
                     size_t* len) {
  Ctx* c = static_cast<Ctx*>(ctx);
  cudaStream_t st = (cudaStream_t)stream;
  int err = set_device(c->device);
  if (err) return err;
  nvjpegStatus_t s = NVJPEG_STATUS_SUCCESS;
  if (!c->enc_state) {
    s = nvjpegEncoderStateCreate(c->sw, &c->enc_state, st);
    if (s == NVJPEG_STATUS_SUCCESS)
      s = nvjpegEncoderParamsCreate(c->sw, &c->enc_params, st);
    if (s == NVJPEG_STATUS_SUCCESS)
      s = nvjpegEncoderParamsSetSamplingFactors(c->enc_params, NVJPEG_CSS_420,
                                                st);
    if (s == NVJPEG_STATUS_SUCCESS)
      s = nvjpegEncoderParamsSetEncoding(c->enc_params,
                                         NVJPEG_ENCODING_BASELINE_DCT, st);
    if (s == NVJPEG_STATUS_SUCCESS)
      s = nvjpegEncoderParamsSetOptimizedHuffman(c->enc_params, 0, st);
    if (s != NVJPEG_STATUS_SUCCESS) return (int)s;
  }
  if (quality != c->enc_quality) {
    s = nvjpegEncoderParamsSetQuality(c->enc_params, quality, st);
    if (s != NVJPEG_STATUS_SUCCESS) return (int)s;
    c->enc_quality = quality;
  }
  nvjpegImage_t img;
  memset(&img, 0, sizeof(img));
  img.channel[0] = const_cast<unsigned char*>(rgb);
  img.pitch[0] = (size_t)w * 3;
  s = nvjpegEncodeImage(c->sw, c->enc_state, c->enc_params, &img,
                        NVJPEG_INPUT_RGBI, w, h, st);
  if (s != NVJPEG_STATUS_SUCCESS) return (int)s;
  size_t need = 0;
  s = nvjpegEncodeRetrieveBitstream(c->sw, c->enc_state, nullptr, &need, st);
  if (s != NVJPEG_STATUS_SUCCESS) return (int)s;
  if (dst == nullptr || *len < need) {
    *len = need;
    return -1;
  }
  s = nvjpegEncodeRetrieveBitstream(c->sw, c->enc_state, dst, &need, st);
  if (s != NVJPEG_STATUS_SUCCESS) return (int)s;
  cudaError_t ce = cudaStreamSynchronize(st);
  if (ce != cudaSuccess) return CUDA_BASE + (int)ce;
  *len = need;
  return 0;
}

// The hardware decoder's engines and cores an engine (0 without it).
int mxtt_jpeg_hw_info(void* ctx, unsigned* engines, unsigned* cores) {
  Ctx* c = static_cast<Ctx*>(ctx);
  *engines = 0;
  *cores = 0;
  if (!c->hw) return 0;
  return (int)nvjpegGetHardwareDecoderInfo(c->hw, engines, cores);
}

int mxtt_jpeg_version(int* major, int* minor, int* patch) {
  nvjpegGetProperty(MAJOR_VERSION, major);
  nvjpegGetProperty(MINOR_VERSION, minor);
  return (int)nvjpegGetProperty(PATCH_LEVEL, patch);
}

}  // extern "C"
