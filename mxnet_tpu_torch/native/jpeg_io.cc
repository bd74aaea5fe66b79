// JPEG decode, bilinear resize and the fused decode -> crop -> mirror ->
// normalize pass of the port's host data path (device=cpu()): the libjpeg
// part of mxnet_tpu/native/io_native.cc (decode_one with the DCT-domain
// downscale, resize_bilinear, jpeg_decode_resize_batch,
// jpeg_decode_augment_batch, jpeg_probe), kept as a copy with the same
// arithmetic, so that the port's CPU batches equal the JAX package's bit
// for bit.  Built at first use with the host C++ compiler and libjpeg
// (mxnet_tpu_torch/native/__init__.py) and bound with ctypes.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <vector>

#include <jpeglib.h>
#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// JPEG decode + resize (libjpeg + bilinear), OMP-parallel over the batch
// ---------------------------------------------------------------------------

struct JerrMgr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

static void jerr_exit(j_common_ptr cinfo) {
  JerrMgr* m = (JerrMgr*)cinfo->err;
  longjmp(m->jb, 1);
}

// Bilinear resize HWC uint8 -> (oh, ow).
static void resize_bilinear(const uint8_t* src, int h, int w, int c,
                            uint8_t* dst, int oh, int ow) {
  const float sy = (float)h / oh, sx = (float)w / ow;
  for (int y = 0; y < oh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = (int)fy; if (y0 < 0) y0 = 0;
    int y1 = y0 + 1 < h ? y0 + 1 : h - 1;
    float wy = fy - y0; if (wy < 0) wy = 0;
    for (int x = 0; x < ow; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = (int)fx; if (x0 < 0) x0 = 0;
      int x1 = x0 + 1 < w ? x0 + 1 : w - 1;
      float wx = fx - x0; if (wx < 0) wx = 0;
      for (int k = 0; k < c; ++k) {
        float v00 = src[(y0 * w + x0) * c + k];
        float v01 = src[(y0 * w + x1) * c + k];
        float v10 = src[(y1 * w + x0) * c + k];
        float v11 = src[(y1 * w + x1) * c + k];
        float v0 = v00 + (v01 - v00) * wx;
        float v1 = v10 + (v11 - v10) * wx;
        dst[(y * ow + x) * c + k] = (uint8_t)(v0 + (v1 - v0) * wy + 0.5f);
      }
    }
  }
}

// Decode one JPEG into HWC uint8, optional center-resize to (oh, ow).
// Returns 0 ok, nonzero on decode error.
static int decode_one(const uint8_t* buf, int64_t len, uint8_t* out,
                      int oh, int ow, int channels,
                      std::vector<uint8_t>* scratch) {
  jpeg_decompress_struct cinfo;
  JerrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jerr_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, (unsigned long)len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = channels == 1 ? JCS_GRAYSCALE : JCS_RGB;
  // DCT-domain downscale (libjpeg scale 1/d): decode at the smallest
  // 1/{1,2,4,8} that still covers the target, then bilinear to exact —
  // the same cost trick as the reference's TurboJPEG path
  if (oh > 0 && ow > 0) {
    unsigned d = 1;
    while (d < 8 && cinfo.image_height / (d * 2) >= (unsigned)oh &&
           cinfo.image_width / (d * 2) >= (unsigned)ow) {
      d *= 2;
    }
    cinfo.scale_num = 1;
    cinfo.scale_denom = d;
  }
  jpeg_start_decompress(&cinfo);
  int h = cinfo.output_height, w = cinfo.output_width,
      c = cinfo.output_components;
  scratch->resize((size_t)h * w * c);
  uint8_t* rows = scratch->data();
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* rp = rows + (size_t)cinfo.output_scanline * w * c;
    jpeg_read_scanlines(&cinfo, &rp, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  if (oh > 0 && ow > 0 && (h != oh || w != ow)) {
    resize_bilinear(rows, h, w, c, out, oh, ow);
  } else {
    memcpy(out, rows, (size_t)h * w * c);
  }
  return 0;
}

// Decode a batch of JPEGs into a preallocated NHWC uint8 tensor
// out[n, oh, ow, channels], resizing each image.  Returns the number of
// failed decodes (their slots are zeroed).
int jpeg_decode_resize_batch(const uint8_t** bufs, const int64_t* lens,
                             long n, uint8_t* out, int oh, int ow,
                             int channels, int nthreads) {
  int failures = 0;
  size_t img_size = (size_t)oh * ow * channels;
#ifdef _OPENMP
  if (nthreads > 0) omp_set_num_threads(nthreads);
#pragma omp parallel reduction(+ : failures)
  {
    std::vector<uint8_t> scratch;
#pragma omp for schedule(dynamic)
    for (long i = 0; i < n; ++i) {
      if (decode_one(bufs[i], lens[i], out + i * img_size, oh, ow,
                     channels, &scratch)) {
        memset(out + i * img_size, 0, img_size);
        failures += 1;
      }
    }
  }
#else
  std::vector<uint8_t> scratch;
  for (long i = 0; i < n; ++i) {
    if (decode_one(bufs[i], lens[i], out + i * img_size, oh, ow, channels,
                   &scratch)) {
      memset(out + i * img_size, 0, img_size);
      failures += 1;
    }
  }
#endif
  return failures;
}

// Fused decode -> crop -> mirror -> normalize -> NCHW float32.
//
// The Python side draws the stochastic augmenter parameters (crop offsets
// y0/x0 per image, mirror flags) so RNG semantics stay with the iterator;
// this kernel does all the byte work in one OMP pass per image: JPEG
// decode at (dh, dw), crop (oh, ow) at the given offset, optional
// horizontal mirror, subtract per-channel mean / divide per-channel std,
// and write channel-first float32 — replacing a per-image Python crop
// loop plus three full-batch numpy passes (transpose, mirror, normalize).
//
// out: float32[n, channels, oh, ow]; y0/x0/flip: per-image arrays;
// mean/std: per-channel (std entries must be nonzero).
// Returns the number of failed decodes (slots zero-filled pre-normalize,
// i.e. they hold (0-mean)/std like the reference's zeroed corrupt slots).
int jpeg_decode_augment_batch(const uint8_t** bufs, const int64_t* lens,
                              long n, float* out, int dh, int dw, int oh,
                              int ow, int channels, const int* y0s,
                              const int* x0s, const uint8_t* flips,
                              const float* mean, const float* stdv,
                              int nthreads) {
  if (channels < 1 || channels > 8) return -1;
  if (oh > dh || ow > dw || oh < 1 || ow < 1) return -2;
  int failures = 0;
  size_t dec_size = (size_t)dh * dw * channels;
  size_t out_size = (size_t)oh * ow * channels;
  float inv_std[8];
  float mean_c[8];
  for (int k = 0; k < channels; ++k) {
    inv_std[k] = 1.0f / stdv[k];
    mean_c[k] = mean[k];
  }
#ifdef _OPENMP
  if (nthreads > 0) omp_set_num_threads(nthreads);
#pragma omp parallel reduction(+ : failures)
#endif
  {
    std::vector<uint8_t> scratch;
    std::vector<uint8_t> dec(dec_size);
#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
    for (long i = 0; i < n; ++i) {
      uint8_t* img = dec.data();
      if (decode_one(bufs[i], lens[i], img, dh, dw, channels, &scratch)) {
        memset(img, 0, dec_size);
        failures += 1;
      }
      // clamp high first, then low: with oh <= dh (checked above) the
      // result is always a valid in-bounds corner
      int y0 = y0s[i], x0 = x0s[i];
      if (y0 > dh - oh) y0 = dh - oh;
      if (x0 > dw - ow) x0 = dw - ow;
      if (y0 < 0) y0 = 0;
      if (x0 < 0) x0 = 0;
      const bool flip = flips[i] != 0;
      float* dst = out + i * out_size;
      for (int k = 0; k < channels; ++k) {
        const float m = mean_c[k];
        const float is = inv_std[k];
        float* plane = dst + (size_t)k * oh * ow;
        for (int y = 0; y < oh; ++y) {
          const uint8_t* src_row =
              img + ((size_t)(y0 + y) * dw + x0) * channels + k;
          float* out_row = plane + (size_t)y * ow;
          if (flip) {
            const uint8_t* s = src_row + (size_t)(ow - 1) * channels;
            for (int x = 0; x < ow; ++x, s -= channels)
              out_row[x] = ((float)*s - m) * is;
          } else {
            const uint8_t* s = src_row;
            for (int x = 0; x < ow; ++x, s += channels)
              out_row[x] = ((float)*s - m) * is;
          }
        }
      }
    }
  }
  return failures;
}

// Probe a JPEG's dimensions without a full decode.
int jpeg_probe(const uint8_t* buf, int64_t len, int* h, int* w, int* c) {
  jpeg_decompress_struct cinfo;
  JerrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jerr_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, (unsigned long)len);
  jpeg_read_header(&cinfo, TRUE);
  *h = cinfo.image_height;
  *w = cinfo.image_width;
  *c = cinfo.num_components;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // extern "C"
