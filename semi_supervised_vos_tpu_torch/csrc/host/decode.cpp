// Threaded JPEG decode for the data loader (plain C ABI, loaded with ctypes
// by data/native_decode.py).
//
// The datasets preload encoded bytes in RAM (data/davis.py) and decode on
// demand; this library decodes a batch with a std::thread pool directly
// through libjpeg, and a row band of one image (the training crop) without
// the IDCT of the rows above it. Linked against Pillow's bundled
// libjpeg-turbo when there is one, so the bytes equal PIL's.
//
// Build (done at first use by data/native_decode.py, into build/host/):
//   g++ -O2 -shared -fPIC -o libsvosdecode.so decode.cpp -ljpeg -lpthread

#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Decode one baseline/progressive JPEG into out (h*w*3, RGB, row-major).
// Returns 0 on success, nonzero on failure or dimension mismatch.
int decode_one(const uint8_t* buf, size_t len, uint8_t* out, int h, int w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_height) != h ||
      static_cast<int>(cinfo.output_width) != w ||
      cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 3;
  }
  const size_t stride = static_cast<size_t>(w) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode only rows [y0, y0 + nrows) of a JPEG into out (nrows*w*3).
// libjpeg-turbo's jpeg_skip_scanlines elides the IDCT + colour conversion
// for the skipped leading rows, and jpeg_abort_decompress drops the tail —
// for a 256-row training crop of a 480-row frame this removes ~half the
// decode work. Output bytes are identical to the same rows of a full
// decode (turbo decodes partial iMCU rows internally; enforced by the
// Python self-check).
int decode_rows(const uint8_t* buf, size_t len, uint8_t* out, int h, int w,
                int y0, int nrows) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_height) != h ||
      static_cast<int>(cinfo.output_width) != w ||
      cinfo.output_components != 3 || y0 < 0 || y0 + nrows > h) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 3;
  }
  if (y0 > 0) jpeg_skip_scanlines(&cinfo, static_cast<JDIMENSION>(y0));
  const size_t stride = static_cast<size_t>(w) * 3;
  int written = 0;
  while (written < nrows && cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + static_cast<size_t>(written) * stride;
    written += static_cast<int>(jpeg_read_scanlines(&cinfo, &row, 1));
  }
  jpeg_abort_decompress(&cinfo);  // never decode the tail rows
  jpeg_destroy_decompress(&cinfo);
  return written == nrows ? 0 : 4;
}

}  // namespace

extern "C" {

// Row-band decode: rows [y0, y0+nrows) only. Returns 0 on success.
int svos_jpeg_decode_rows(const uint8_t* buf, size_t len, uint8_t* out,
                          int h, int w, int y0, int nrows) {
  return decode_rows(buf, len, out, h, w, y0, nrows);
}

// Probe one image's dimensions. Returns 0 and fills (h, w) on success.
int svos_jpeg_shape(const uint8_t* buf, size_t len, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  jpeg_calc_output_dimensions(&cinfo);
  *h = static_cast<int>(cinfo.output_height);
  *w = static_cast<int>(cinfo.output_width);
  jpeg_abort_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode n same-sized JPEGs into out (n, h, w, 3) with `threads` workers.
// Returns the number of failed decodes (0 = all good).
int svos_jpeg_decode_batch(const uint8_t** bufs, const size_t* lens, int n,
                           uint8_t* out, int h, int w, int threads) {
  if (threads < 1) threads = 1;
  if (threads > n) threads = n;
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  const size_t frame = static_cast<size_t>(h) * w * 3;

  auto worker = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      if (decode_one(bufs[i], lens[i], out + frame * i, h, w) != 0) {
        failures.fetch_add(1);
      }
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failures.load();
}

}  // extern "C"
