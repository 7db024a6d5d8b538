// Native image-decode core for the data loader (host code; a copy of the
// JAX package's csrc/image_core.cpp, which the port does not import).
//
// JPEG (libjpeg) and PNG (libpng) decoding to RGB8, callable via ctypes
// (rscotr_tpu_torch/data/native_image.py) from the TaskDataLoader's worker
// threads. ctypes drops the GIL for the call, so decode parallelism is real
// on multi-core hosts. Built at first use by rscotr_tpu_torch/ops/host_lib.py
// and linked with -ljpeg -lpng.
//
// Two-call protocol (stateless, thread-safe):
//   imdecode_dims(buf, len, &w, &h)      -> 0 ok (fills dims), <0 error
//   imdecode_rgb(buf, len, out, cap)     -> 0 ok (out: h*w*3 RGB8)
// Format is sniffed from magic bytes (JPEG FFD8, PNG 8950).

#include <csetjmp>
#include <cstdint>
#include <cstdio>  // jpeglib.h needs FILE declared
#include <cstring>

#include <jpeglib.h>
#include <png.h>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  std::jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  std::longjmp(e->jb, 1);
}

bool is_jpeg(const uint8_t* buf, int64_t len) {
  return len >= 2 && buf[0] == 0xFF && buf[1] == 0xD8;
}

bool is_png(const uint8_t* buf, int64_t len) {
  return len >= 8 && png_sig_cmp(buf, 0, 8) == 0;
}

int jpeg_dims(const uint8_t* buf, int64_t len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  *w = static_cast<int>(cinfo.image_width);
  *h = static_cast<int>(cinfo.image_height);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int jpeg_decode(const uint8_t* buf, int64_t len, uint8_t* out,
                int64_t cap) {
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;  // grayscale/YCbCr/CMYK -> RGB
  jpeg_start_decompress(&cinfo);
  const int64_t w = cinfo.output_width, h = cinfo.output_height;
  if (cinfo.output_components != 3 || cap < w * h * 3) {
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + int64_t(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int png_dims(const uint8_t* buf, int64_t len, int* w, int* h) {
  png_image img;
  std::memset(&img, 0, sizeof(img));
  img.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&img, buf,
                                        static_cast<size_t>(len)))
    return -2;
  *w = static_cast<int>(img.width);
  *h = static_cast<int>(img.height);
  png_image_free(&img);
  return 0;
}

int png_decode(const uint8_t* buf, int64_t len, uint8_t* out,
               int64_t cap) {
  png_image img;
  std::memset(&img, 0, sizeof(img));
  img.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&img, buf,
                                        static_cast<size_t>(len)))
    return -2;
  img.format = PNG_FORMAT_RGB;  // palette/gray/alpha -> RGB
  const int64_t need = PNG_IMAGE_SIZE(img);
  if (cap < need) {
    png_image_free(&img);
    return -3;
  }
  if (!png_image_finish_read(&img, nullptr, out, 0, nullptr)) {
    png_image_free(&img);
    return -2;
  }
  return 0;
}

}  // namespace

extern "C" {

// 0 ok; -1 unknown format; -2 decode error.
int imdecode_dims(const uint8_t* buf, int64_t len, int* w, int* h) {
  if (is_jpeg(buf, len)) return jpeg_dims(buf, len, w, h);
  if (is_png(buf, len)) return png_dims(buf, len, w, h);
  return -1;
}

// out must hold h*w*3 bytes (from imdecode_dims). 0 ok; -1 unknown
// format; -2 decode error; -3 buffer too small / odd channel count.
int imdecode_rgb(const uint8_t* buf, int64_t len, uint8_t* out,
                 int64_t cap) {
  if (is_jpeg(buf, len)) return jpeg_decode(buf, len, out, cap);
  if (is_png(buf, len)) return png_decode(buf, len, out, cap);
  return -1;
}

}  // extern "C"
