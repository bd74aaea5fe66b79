// Record reading and the raw-record crop passes of the port's host data
// path: the part of mxnet_tpu/native/io_native.cc that needs no JPEG
// library (rec_index_file, rec_read_batch, crop_flip_u8_batch,
// crop_flip_u8_nhwc_batch), kept as a copy so that the port imports
// nothing of the JAX package.  Built at first use with the host C++
// compiler (mxnet_tpu_torch/native/__init__.py) and bound with ctypes.
// On the card the record iterators need only this library: their JPEG
// decode runs on the card (csrc/nvjpeg_decode.cu) and their crop in
// csrc/image_augment.cu.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

static const uint32_t kMagic = 0xced7230a;

// ---------------------------------------------------------------------------
// RecordIO (dmlc-core framing: [magic][cflag:3|len:29][data][pad4])
// ---------------------------------------------------------------------------

// Scan a .rec file, returning byte offsets of each *logical* record start.
// Returns the number of records (<= cap written to out_offsets), or -1 on
// IO error.
long rec_index_file(const char* path, int64_t* out_offsets, long cap) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  long n = 0;
  int64_t pos = 0;
  uint32_t head[2];
  bool in_cont = false;
  while (fread(head, sizeof(uint32_t), 2, f) == 2) {
    if (head[0] != kMagic) { fclose(f); return -1; }
    uint32_t cflag = head[1] >> 29;
    uint32_t len = head[1] & ((1u << 29) - 1);
    uint32_t padded = (len + 3u) & ~3u;
    if (cflag == 0 || cflag == 1) {
      if (n < cap && !in_cont) out_offsets[n] = pos;
      if (cflag == 0) { n++; } else { in_cont = true; }
    } else if (cflag == 3) {
      n++;
      in_cont = false;
    }
    if (fseek(f, padded, SEEK_CUR) != 0) break;
    pos = ftell(f);
  }
  fclose(f);
  return n;
}

// Read `n` logical records at the given offsets.  For each record i the
// caller provides bufs[i] with capacity lens[i]; on return lens[i] is the
// actual payload size (continuations rejoined, magic re-inserted).
// A record larger than its buffer sets lens[i] to the required size
// negated; caller re-allocates and retries.  Returns 0 on success.
int rec_read_batch(const char* path, const int64_t* offsets, long n,
                   uint8_t** bufs, int64_t* lens) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  for (long i = 0; i < n; ++i) {
    if (fseek(f, (long)offsets[i], SEEK_SET) != 0) { fclose(f); return -2; }
    int64_t cap = lens[i];
    int64_t size = 0;
    bool done = false;
    bool overflow = false;
    while (!done) {
      uint32_t head[2];
      if (fread(head, sizeof(uint32_t), 2, f) != 2) { fclose(f); return -3; }
      if (head[0] != kMagic) { fclose(f); return -4; }
      uint32_t cflag = head[1] >> 29;
      uint32_t len = head[1] & ((1u << 29) - 1);
      uint32_t pad = ((len + 3u) & ~3u) - len;
      if (cflag == 2 || cflag == 3) {
        // rejoin: the splitter removed an embedded magic
        if (size + 4 <= cap) memcpy(bufs[i] + size, &kMagic, 4);
        else overflow = true;
        size += 4;
      }
      if (size + (int64_t)len <= cap) {
        if (fread(bufs[i] + size, 1, len, f) != len) { fclose(f); return -3; }
      } else {
        overflow = true;
        if (fseek(f, len, SEEK_CUR) != 0) { fclose(f); return -3; }
      }
      size += len;
      if (pad) fseek(f, pad, SEEK_CUR);
      done = (cflag == 0 || cflag == 3);
    }
    lens[i] = overflow ? -size : size;
  }
  fclose(f);
  return 0;
}

// Crop -> mirror -> NCHW on PRE-DECODED uint8 records (the raw-payload
// fast path, reference: ImageRecordUInt8Iter src/io/io.cc:337-758 — decode
// cost paid ONCE at dataset-pack time).  bufs[i] points at an HWC uint8
// image of shape (dh, dw, channels); output is uint8[n, channels, oh, ow].
// Pure byte movement: one pass, no float math — normalization happens on
// the device where it fuses into the training step.
int crop_flip_u8_batch(const uint8_t** bufs, long n, uint8_t* out, int dh,
                       int dw, int oh, int ow, int channels,
                       const int* y0s, const int* x0s,
                       const uint8_t* flips, int nthreads) {
  if (channels < 1 || channels > 8) return -1;
  if (oh > dh || ow > dw || oh < 1 || ow < 1) return -2;
  size_t out_size = (size_t)oh * ow * channels;
#ifdef _OPENMP
  if (nthreads > 0) omp_set_num_threads(nthreads);
#pragma omp parallel for schedule(dynamic)
#endif
  for (long i = 0; i < n; ++i) {
    const uint8_t* img = bufs[i];
    int y0 = y0s[i], x0 = x0s[i];
    if (y0 > dh - oh) y0 = dh - oh;
    if (x0 > dw - ow) x0 = dw - ow;
    if (y0 < 0) y0 = 0;
    if (x0 < 0) x0 = 0;
    const bool flip = flips[i] != 0;
    uint8_t* dst = out + i * out_size;
    for (int k = 0; k < channels; ++k) {
      uint8_t* plane = dst + (size_t)k * oh * ow;
      for (int y = 0; y < oh; ++y) {
        const uint8_t* src_row =
            img + ((size_t)(y0 + y) * dw + x0) * channels + k;
        uint8_t* out_row = plane + (size_t)y * ow;
        if (flip) {
          const uint8_t* s = src_row + (size_t)(ow - 1) * channels;
          for (int x = 0; x < ow; ++x, s -= channels) out_row[x] = *s;
        } else {
          const uint8_t* s = src_row;
          for (int x = 0; x < ow; ++x, s += channels) out_row[x] = *s;
        }
      }
    }
  }
  return 0;
}

// NHWC variant: output is uint8[n, oh, ow, channels].  An unflipped row
// is ONE contiguous memcpy, so the host cost approaches raw memory
// bandwidth — the HWC->CHW transpose belongs on the DEVICE, where it
// fuses into the uint8->bf16 cast for free (the reference pays the
// same transpose inside its GPU copy kernel).
int crop_flip_u8_nhwc_batch(const uint8_t** bufs, long n, uint8_t* out,
                            int dh, int dw, int oh, int ow, int channels,
                            const int* y0s, const int* x0s,
                            const uint8_t* flips, int nthreads) {
  if (channels < 1 || channels > 8) return -1;
  if (oh > dh || ow > dw || oh < 1 || ow < 1) return -2;
  size_t row_bytes = (size_t)ow * channels;
  size_t out_size = (size_t)oh * row_bytes;
#ifdef _OPENMP
  if (nthreads > 0) omp_set_num_threads(nthreads);
#pragma omp parallel for schedule(dynamic)
#endif
  for (long i = 0; i < n; ++i) {
    const uint8_t* img = bufs[i];
    int y0 = y0s[i], x0 = x0s[i];
    if (y0 > dh - oh) y0 = dh - oh;
    if (x0 > dw - ow) x0 = dw - ow;
    if (y0 < 0) y0 = 0;
    if (x0 < 0) x0 = 0;
    const bool flip = flips[i] != 0;
    uint8_t* dst = out + i * out_size;
    for (int y = 0; y < oh; ++y) {
      const uint8_t* src_row =
          img + ((size_t)(y0 + y) * dw + x0) * channels;
      uint8_t* out_row = dst + (size_t)y * row_bytes;
      // always memcpy forward (sequential source read); a mirrored row
      // is then reversed IN PLACE in the output, which is already L1-hot
      memcpy(out_row, src_row, row_bytes);
      if (flip) {
        uint8_t* a = out_row;
        uint8_t* b = out_row + (size_t)(ow - 1) * channels;
        for (; a < b; a += channels, b -= channels) {
          for (int k = 0; k < channels; ++k) {
            uint8_t t = a[k];
            a[k] = b[k];
            b[k] = t;
          }
        }
      }
    }
  }
  return 0;
}

}  // extern "C"
