// JPEG codec core of the port's image I/O: a copy of the JAX package's
// native data-loader core (animatablegaussians_tpu/native/dataloader.cpp)
// with a JPEG encoder added, driven from Python via ctypes
// (animatablegaussians_torch/data/image_io.py, which builds it with
// g++ -O3 -shared -fPIC ... -ljpeg into build/ at first use):
//
//   * agt_jpeg_info / agt_decode_jpeg: libjpeg scanline decode into a
//     caller-provided buffer (BGR channel order to match the cv2 convention
//     the whole pipeline uses).
//   * agt_decode_jpeg_batch: a std::thread pool decoding N files in
//     parallel -- no GIL, no worker processes
//     (animatablegaussians_torch/data/native_io.py).
//   * agt_encode_jpeg: libjpeg scanline encode of a BGR or grayscale
//     buffer, for the synthetic capture and the mini-test snapshots.
//
// The JAX core's boundary mask is not copied: the port computes it with
// torch (image_io.boundary_mask).

// jpeglib.h needs size_t and FILE declared first
#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

bool read_header(const char* path, FILE** fp_out, jpeg_decompress_struct* cinfo,
                 ErrorMgr* jerr) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  cinfo->err = jpeg_std_error(&jerr->pub);
  jerr->pub.error_exit = error_exit;
  if (setjmp(jerr->setjmp_buffer)) {
    jpeg_destroy_decompress(cinfo);
    fclose(fp);
    return false;
  }
  jpeg_create_decompress(cinfo);
  jpeg_stdio_src(cinfo, fp);
  jpeg_read_header(cinfo, TRUE);
  *fp_out = fp;
  return true;
}

}  // namespace

extern "C" {

// Returns 0 on success; fills w/h/channels.
int agt_jpeg_info(const char* path, int* w, int* h, int* c) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  FILE* fp = nullptr;
  if (!read_header(path, &fp, &cinfo, &jerr)) return 1;
  *w = static_cast<int>(cinfo.image_width);
  *h = static_cast<int>(cinfo.image_height);
  *c = cinfo.num_components;
  jpeg_destroy_decompress(&cinfo);
  fclose(fp);
  return 0;
}

// Decode into out (h*w*out_channels uint8). out_channels: 1 (gray) or
// 3 (BGR). Returns 0 on success.
int agt_decode_jpeg(const char* path, uint8_t* out, int out_channels) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  FILE* fp = nullptr;
  if (!read_header(path, &fp, &cinfo, &jerr)) return 1;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(fp);
    return 2;
  }
  cinfo.out_color_space = out_channels == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width;
  const int row_ch = cinfo.output_components;
  std::vector<uint8_t> row(static_cast<size_t>(w) * row_ch);
  JSAMPROW rowptr = row.data();
  int y = 0;
  while (cinfo.output_scanline < cinfo.output_height) {
    jpeg_read_scanlines(&cinfo, &rowptr, 1);
    uint8_t* dst = out + static_cast<size_t>(y) * w * out_channels;
    if (out_channels == 1) {
      memcpy(dst, row.data(), w);
    } else {
      // RGB -> BGR (cv2 convention used across the pipeline)
      for (int x = 0; x < w; ++x) {
        dst[3 * x + 0] = row[3 * x + 2];
        dst[3 * x + 1] = row[3 * x + 1];
        dst[3 * x + 2] = row[3 * x + 0];
      }
    }
    ++y;
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(fp);
  return 0;
}

// Parallel batch decode: paths[n], each into outs + i * stride_bytes, on
// n_threads threads (8 when n_threads <= 0, never more than n). The caller
// checks that every file has the buffer's size. Returns the number of
// failures.
int agt_decode_jpeg_batch(const char** paths, int n, uint8_t* outs,
                          int64_t stride_bytes, int out_channels,
                          int n_threads) {
  std::atomic<int> next(0), failures(0);
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      if (agt_decode_jpeg(paths[i], outs + static_cast<int64_t>(i) *
                          stride_bytes, out_channels) != 0) {
        failures.fetch_add(1);
      }
    }
  };
  int nt = n_threads > 0 ? n_threads : 8;
  if (nt > n) nt = n;
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}

// Encode h x w x channels (1: gray, 3: BGR) uint8 rows to a baseline JPEG
// at `quality`. Returns 0 on success.
int agt_encode_jpeg(const char* path, const uint8_t* img, int h, int w,
                    int channels, int quality) {
  FILE* fp = fopen(path, "wb");
  if (!fp) return 1;
  jpeg_compress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_compress(&cinfo);
    fclose(fp);
    return 2;
  }
  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, fp);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = channels;
  cinfo.in_color_space = channels == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  std::vector<uint8_t> row(static_cast<size_t>(w) * channels);
  JSAMPROW rowptr = row.data();
  while (cinfo.next_scanline < cinfo.image_height) {
    const uint8_t* src =
        img + static_cast<size_t>(cinfo.next_scanline) * w * channels;
    if (channels == 1) {
      memcpy(row.data(), src, w);
    } else {
      // BGR -> RGB (cv2 convention used across the pipeline)
      for (int x = 0; x < w; ++x) {
        row[3 * x + 0] = src[3 * x + 2];
        row[3 * x + 1] = src[3 * x + 1];
        row[3 * x + 2] = src[3 * x + 0];
      }
    }
    jpeg_write_scanlines(&cinfo, &rowptr, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  fclose(fp);
  return 0;
}

}  // extern "C"
