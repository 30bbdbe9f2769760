// decode.cpp — threaded JPEG decode + PIL-exact resize, the PIL-exact
// resize alone, and a JPEG encoder, for dfu_multimodal_tpu_torch.
//
// The port's own copy of dfu_multimodal_tpu/native/decode.cpp.  One
// source, built by g++ (native/__init__.py) in one of three ways, chosen
// at build time from what the host has:
//
//   -DDFU_JPEG_LIBJPEG  libjpeg(-turbo): islow IDCT and fancy upsampling,
//                       as PIL decodes, so the result is bit-equal to PIL;
//   -DDFU_JPEG_NVJPEG   nvJPEG on the GPU (the CUDA toolkit's library):
//                       its IDCT and chroma upsampling are its own, so the
//                       result is near PIL's, not equal;
//   neither             resize_rgb only (the PNG path needs no JPEG
//                       library).
//
// The resize reproduces PIL's BILINEAR resample exactly (torchvision's
// Resize((S, S)) on a PIL image, and PIL's resize((W, H)) for the
// standardizer's aspect-kept targets): a separable two-pass triangle filter
// whose support widens with the downscale factor (and stays 1 on an
// upscale), coefficients quantized to 22-bit fixed point, each pass
// rounding to uint8.
//
// C ABI for ctypes:
//   decode_jpegs_resized(paths, n, out_h, out_w, out, status, threads)
//   resize_rgb(src, h, w, dst, out_h, out_w)
//   encode_jpeg(rgb, h, w, quality, path) -> 0 on success

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#if defined(DFU_JPEG_LIBJPEG)
#include <csetjmp>
#include <jpeglib.h>
#elif defined(DFU_JPEG_NVJPEG)
#include <cuda_runtime.h>
#include <nvjpeg.h>
#endif

namespace {

// ---------------------------------------------------------------- resize

constexpr int kPrecisionBits = 32 - 8 - 2;

inline uint8_t clip8(int64_t v) {
  if (v >= (int64_t(255) << kPrecisionBits)) return 255;
  if (v <= 0) return 0;
  return uint8_t(v >> kPrecisionBits);
}

inline double triangle(double x) {
  if (x < 0) x = -x;
  return x < 1.0 ? 1.0 - x : 0.0;
}

// Integer coefficient windows for one resampled axis.
struct AxisCoeffs {
  int ksize = 0;
  std::vector<int> bounds;   // per out pixel: xmin, xmax (window length)
  std::vector<int32_t> kk;   // per out pixel: ksize quantized weights
};

AxisCoeffs precompute(int in_size, int out_size) {
  AxisCoeffs c;
  double scale = double(in_size) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 1.0 * filterscale;        // bilinear support = 1
  c.ksize = int(std::ceil(support)) * 2 + 1;
  c.bounds.resize(size_t(out_size) * 2);
  c.kk.resize(size_t(out_size) * c.ksize);
  std::vector<double> w(c.ksize);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    double ss = 1.0 / filterscale;
    int xmin = int(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = int(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double ww = 0.0;
    for (int x = 0; x < xmax; ++x) {
      w[x] = triangle((x + xmin - center + 0.5) * ss);
      ww += w[x];
    }
    int32_t* k = &c.kk[size_t(xx) * c.ksize];
    for (int x = 0; x < xmax; ++x) {
      double v = ww != 0.0 ? w[x] / ww : w[x];
      k[x] = int32_t(v < 0 ? v * (1 << kPrecisionBits) - 0.5
                           : v * (1 << kPrecisionBits) + 0.5);
    }
    for (int x = xmax; x < c.ksize; ++x) k[x] = 0;
    c.bounds[size_t(xx) * 2] = xmin;
    c.bounds[size_t(xx) * 2 + 1] = xmax;
  }
  return c;
}

// src: (in_h, in_w, 3) → dst: (in_h, out_w, 3)
void resample_horizontal(const uint8_t* src, int in_h, int in_w,
                         uint8_t* dst, int out_w, const AxisCoeffs& c) {
  for (int yy = 0; yy < in_h; ++yy) {
    const uint8_t* row = src + size_t(yy) * in_w * 3;
    uint8_t* orow = dst + size_t(yy) * out_w * 3;
    for (int xx = 0; xx < out_w; ++xx) {
      int xmin = c.bounds[size_t(xx) * 2];
      int xmax = c.bounds[size_t(xx) * 2 + 1];
      const int32_t* k = &c.kk[size_t(xx) * c.ksize];
      int64_t s0 = int64_t(1) << (kPrecisionBits - 1);
      int64_t s1 = s0, s2 = s0;
      for (int x = 0; x < xmax; ++x) {
        const uint8_t* p = row + size_t(xmin + x) * 3;
        s0 += int64_t(p[0]) * k[x];
        s1 += int64_t(p[1]) * k[x];
        s2 += int64_t(p[2]) * k[x];
      }
      orow[size_t(xx) * 3] = clip8(s0);
      orow[size_t(xx) * 3 + 1] = clip8(s1);
      orow[size_t(xx) * 3 + 2] = clip8(s2);
    }
  }
}

// src: (in_h, w, 3) → dst: (out_h, w, 3)
void resample_vertical(const uint8_t* src, int in_h, int w,
                       uint8_t* dst, int out_h, const AxisCoeffs& c) {
  for (int yy = 0; yy < out_h; ++yy) {
    int ymin = c.bounds[size_t(yy) * 2];
    int ymax = c.bounds[size_t(yy) * 2 + 1];
    const int32_t* k = &c.kk[size_t(yy) * c.ksize];
    uint8_t* orow = dst + size_t(yy) * w * 3;
    for (int xx = 0; xx < w * 3; ++xx) {
      int64_t s = int64_t(1) << (kPrecisionBits - 1);
      for (int y = 0; y < ymax; ++y)
        s += int64_t(src[size_t(ymin + y) * w * 3 + xx]) * k[y];
      orow[xx] = clip8(s);
    }
  }
}

// (h, w, 3) → (out_h, out_w, 3).  An axis whose size does not change
// goes through the pass as well: at scale 1 its window is the pixel
// itself with weight 1, so the pass copies it, as PIL's skipped pass.
void resize(const uint8_t* rgb, int h, int w, uint8_t* out, int out_h,
            int out_w) {
  if (w == out_w && h == out_h) {
    memcpy(out, rgb, size_t(h) * w * 3);
    return;
  }
  AxisCoeffs ch = precompute(w, out_w);
  AxisCoeffs cv = precompute(h, out_h);
  std::vector<uint8_t> tmp(size_t(h) * out_w * 3);
  resample_horizontal(rgb, h, w, tmp.data(), out_w, ch);
  resample_vertical(tmp.data(), h, out_w, out, out_h, cv);
}

// ---------------------------------------------------------------- decode
// status: 0 ok; 1 open fail; 2 decode error (not a JPEG / corrupt);
// 3 unsupported colorspace (CMYK / YCCK); 4 the GPU decoder failed.

#if defined(DFU_JPEG_LIBJPEG)

// libjpeg's default error handler exit()s the process; route fatal
// errors through longjmp instead and stay silent on warnings.
struct JmpErrorMgr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void on_fatal(j_common_ptr cinfo) {
  JmpErrorMgr* err = reinterpret_cast<JmpErrorMgr*>(cinfo->err);
  longjmp(err->jb, 1);
}

void on_message(j_common_ptr, int) {}

struct Decoder {
  int decode(const char* path, int out_h, int out_w, uint8_t* out) {
    FILE* f = fopen(path, "rb");
    if (!f) return 1;
    int rc = decode_from(f, nullptr, 0, out_h, out_w, out);
    fclose(f);
    return rc;
  }

  int decode_mem(const uint8_t* data, size_t n, int out_h, int out_w,
                 uint8_t* out) {
    if (n == 0) return 2;
    return decode_from(nullptr, data, n, out_h, out_w, out);
  }

  // From an open file, or from `data` (n bytes) when f is null.
  int decode_from(FILE* f, const uint8_t* data, size_t n, int out_h,
                  int out_w, uint8_t* out) {
    jpeg_decompress_struct cinfo;
    JmpErrorMgr err;
    cinfo.err = jpeg_std_error(&err.mgr);
    err.mgr.error_exit = on_fatal;
    err.mgr.emit_message = on_message;
    std::vector<uint8_t> rgb;
    if (setjmp(err.jb)) {
      jpeg_destroy_decompress(&cinfo);
      return 2;
    }
    jpeg_create_decompress(&cinfo);
    if (f)
      jpeg_stdio_src(&cinfo, f);
    else
      jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(n));
    jpeg_read_header(&cinfo, TRUE);
    if (cinfo.jpeg_color_space == JCS_CMYK ||
        cinfo.jpeg_color_space == JCS_YCCK) {
      jpeg_destroy_decompress(&cinfo);
      return 3;
    }
    cinfo.out_color_space = JCS_RGB;  // grayscale/YCbCr → RGB, like PIL
    jpeg_start_decompress(&cinfo);
    int w = int(cinfo.output_width), h = int(cinfo.output_height);
    if (w <= 0 || h <= 0 || cinfo.output_components != 3) {
      jpeg_destroy_decompress(&cinfo);
      return 2;
    }
    rgb.resize(size_t(w) * h * 3);
    while (cinfo.output_scanline < cinfo.output_height) {
      uint8_t* rowp = rgb.data() + size_t(cinfo.output_scanline) * w * 3;
      jpeg_read_scanlines(&cinfo, &rowp, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    resize(rgb.data(), h, w, out, out_h, out_w);
    return 0;
  }
};

// Pillow's save(quality=q) with its defaults: jpeg_set_defaults, then
// jpeg_set_quality(q, force_baseline=TRUE); 4:2:0 chroma (libjpeg's
// default sampling), baseline, Huffman tables not optimised, islow DCT.
int encode(const uint8_t* rgb, int h, int w, int quality, const char* path) {
  FILE* f = fopen(path, "wb");
  if (!f) return 1;
  jpeg_compress_struct cinfo;
  JmpErrorMgr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = on_fatal;
  err.mgr.emit_message = on_message;
  if (setjmp(err.jb)) {
    jpeg_destroy_compress(&cinfo);
    fclose(f);
    return 2;
  }
  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, f);
  cinfo.image_width = JDIMENSION(w);
  cinfo.image_height = JDIMENSION(h);
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(rgb) +
                   size_t(cinfo.next_scanline) * w * 3;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  return fclose(f) == 0 ? 0 : 1;
}

#elif defined(DFU_JPEG_NVJPEG)

// One nvJPEG handle for the process; each worker thread has its own
// decode state, stream and device buffer (nvjpegDecode is thread-safe
// across states).
nvjpegHandle_t g_handle = nullptr;
std::once_flag g_once;
bool g_ok = false;

bool handle() {
  std::call_once(g_once, [] {
    g_ok = nvjpegCreateSimple(&g_handle) == NVJPEG_STATUS_SUCCESS;
  });
  return g_ok;
}

bool read_file(const char* path, std::vector<uint8_t>* data) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  data->resize(n > 0 ? size_t(n) : 0);
  bool ok = n > 0 && fread(data->data(), 1, size_t(n), f) == size_t(n);
  fclose(f);
  return ok;
}

struct Decoder {
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  uint8_t* dbuf = nullptr;
  size_t cap = 0;

  ~Decoder() {
    if (dbuf) cudaFree(dbuf);
    if (state) nvjpegJpegStateDestroy(state);
    if (stream) cudaStreamDestroy(stream);
  }

  int decode(const char* path, int out_h, int out_w, uint8_t* out) {
    std::vector<uint8_t> data;
    if (!read_file(path, &data)) return 1;
    return decode_mem(data.data(), data.size(), out_h, out_w, out);
  }

  int decode_mem(const uint8_t* data, size_t n, int out_h, int out_w,
                 uint8_t* out) {
    if (n == 0) return 2;
    if (!handle()) return 4;
    if (!state) {
      if (nvjpegJpegStateCreate(g_handle, &state) != NVJPEG_STATUS_SUCCESS ||
          cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking) !=
              cudaSuccess)
        return 4;
    }
    int ncomp = 0;
    nvjpegChromaSubsampling_t css;
    int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
    if (nvjpegGetImageInfo(g_handle, data, n, &ncomp, &css, widths,
                           heights) != NVJPEG_STATUS_SUCCESS)
      return 2;
    if (ncomp == 4) return 3;
    if (ncomp != 1 && ncomp != 3) return 2;
    int w = widths[0], h = heights[0];
    if (w <= 0 || h <= 0) return 2;
    // grayscale decodes to Y and is replicated on the host, as PIL's
    // convert("RGB") replicates L
    int ch = ncomp == 1 ? 1 : 3;
    size_t bytes = size_t(w) * h * ch;
    if (bytes > cap) {
      if (dbuf) cudaFree(dbuf);
      dbuf = nullptr;
      cap = 0;
      if (cudaMalloc(&dbuf, bytes) != cudaSuccess) return 4;
      cap = bytes;
    }
    nvjpegImage_t img;
    memset(&img, 0, sizeof(img));
    img.channel[0] = dbuf;
    img.pitch[0] = size_t(w) * ch;
    nvjpegOutputFormat_t fmt = ch == 1 ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_RGBI;
    if (nvjpegDecode(g_handle, state, data, n, fmt, &img, stream) !=
        NVJPEG_STATUS_SUCCESS)
      return 2;
    std::vector<uint8_t> host(bytes);
    if (cudaMemcpyAsync(host.data(), dbuf, bytes, cudaMemcpyDeviceToHost,
                        stream) != cudaSuccess ||
        cudaStreamSynchronize(stream) != cudaSuccess)
      return 4;
    if (ch == 1) {
      std::vector<uint8_t> rgb(size_t(w) * h * 3);
      for (size_t i = 0; i < size_t(w) * h; ++i)
        rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = host[i];
      host.swap(rgb);
    }
    resize(host.data(), h, w, out, out_h, out_w);
    return 0;
  }
};

// nvJPEG's encoder at quality q, 4:2:0 chroma, baseline, Huffman tables
// not optimised.
int encode(const uint8_t* rgb, int h, int w, int quality, const char* path) {
  if (!handle()) return 4;
  cudaStream_t stream = nullptr;
  nvjpegEncoderState_t est = nullptr;
  nvjpegEncoderParams_t params = nullptr;
  uint8_t* d = nullptr;
  size_t bytes = size_t(w) * h * 3;
  std::vector<uint8_t> bits;
  int rc = 4;
  do {
    if (cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking) !=
            cudaSuccess ||
        nvjpegEncoderStateCreate(g_handle, &est, stream) !=
            NVJPEG_STATUS_SUCCESS ||
        nvjpegEncoderParamsCreate(g_handle, &params, stream) !=
            NVJPEG_STATUS_SUCCESS ||
        nvjpegEncoderParamsSetQuality(params, quality, stream) !=
            NVJPEG_STATUS_SUCCESS ||
        nvjpegEncoderParamsSetSamplingFactors(params, NVJPEG_CSS_420,
                                              stream) !=
            NVJPEG_STATUS_SUCCESS ||
        nvjpegEncoderParamsSetOptimizedHuffman(params, 0, stream) !=
            NVJPEG_STATUS_SUCCESS ||
        cudaMalloc(&d, bytes) != cudaSuccess ||
        cudaMemcpyAsync(d, rgb, bytes, cudaMemcpyHostToDevice, stream) !=
            cudaSuccess)
      break;
    nvjpegImage_t img;
    memset(&img, 0, sizeof(img));
    img.channel[0] = d;
    img.pitch[0] = size_t(w) * 3;
    size_t len = 0;
    if (nvjpegEncodeImage(g_handle, est, params, &img, NVJPEG_INPUT_RGBI, w,
                          h, stream) != NVJPEG_STATUS_SUCCESS ||
        nvjpegEncodeRetrieveBitstream(g_handle, est, nullptr, &len,
                                      stream) != NVJPEG_STATUS_SUCCESS)
      break;
    bits.resize(len);
    if (nvjpegEncodeRetrieveBitstream(g_handle, est, bits.data(), &len,
                                      stream) != NVJPEG_STATUS_SUCCESS ||
        cudaStreamSynchronize(stream) != cudaSuccess)
      break;
    bits.resize(len);
    FILE* f = fopen(path, "wb");
    if (!f) {
      rc = 1;
      break;
    }
    bool ok = fwrite(bits.data(), 1, len, f) == len;
    rc = (fclose(f) == 0 && ok) ? 0 : 1;
  } while (false);
  if (d) cudaFree(d);
  if (params) nvjpegEncoderParamsDestroy(params);
  if (est) nvjpegEncoderStateDestroy(est);
  if (stream) cudaStreamDestroy(stream);
  return rc;
}

#endif

}  // namespace

extern "C" {

// The PIL-exact BILINEAR resize of one (h, w, 3) uint8 image into
// dst (out_h, out_w, 3).
void resize_rgb(const uint8_t* src, int h, int w, uint8_t* dst, int out_h,
                int out_w) {
  resize(src, h, w, dst, out_h, out_w);
}

#if defined(DFU_JPEG_LIBJPEG) || defined(DFU_JPEG_NVJPEG)

// Decode n JPEGs, resize each to (out_h, out_w, 3) RGB uint8 into
// out[i * out_h*out_w*3]; status[i] as above.  `threads` <= 0 uses the
// route's default: every hardware thread for libjpeg, one for nvJPEG.
void decode_jpegs_resized(const char** paths, int n, int out_h, int out_w,
                          uint8_t* out, int* status, int threads) {
  if (threads <= 0) {
#if defined(DFU_JPEG_NVJPEG)
    // one GPU decoder: a thread's own state, stream and buffer cost more
    // than they save at dataset scale (eight threads were slower than
    // one on 80 files at 224² on an H100 host)
    threads = 1;
#else
    threads = int(std::thread::hardware_concurrency());
    if (threads <= 0) threads = 1;
#endif
  }
  if (threads > n) threads = n > 0 ? n : 1;
  size_t stride = size_t(out_h) * out_w * 3;
  std::atomic<int> next{0};
  auto worker = [&]() {
    Decoder dec;
    int i;
    while ((i = next.fetch_add(1)) < n)
      status[i] = dec.decode(paths[i], out_h, out_w,
                             out + size_t(i) * stride);
  };
  if (threads == 1) {
    worker();
    return;
  }
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

// Decoders kept for the in-memory entry: a daemon's request threads live
// one request each, so a decoder per call (or per thread) would create
// and free the GPU route's stream, state and buffer on every upload, and
// cudaFree synchronises the device under the serving batcher's kernels.
// A call takes an idle decoder or makes one; the pool grows to the most
// uploads decoded at once and is never freed (process exit may come after
// the CUDA context is gone).
static std::mutex g_pool_mu;
static std::vector<Decoder*> g_pool;

// Decode one JPEG held in memory (n bytes) and resize it to (out_h,
// out_w, 3) RGB uint8 into out; returns the status above.
int decode_jpeg_bytes_resized(const uint8_t* data, long n, int out_h,
                              int out_w, uint8_t* out) {
  Decoder* dec = nullptr;
  {
    std::lock_guard<std::mutex> lock(g_pool_mu);
    if (!g_pool.empty()) {
      dec = g_pool.back();
      g_pool.pop_back();
    }
  }
  if (!dec) dec = new Decoder();
  int rc = dec->decode_mem(data, n > 0 ? size_t(n) : 0, out_h, out_w, out);
  std::lock_guard<std::mutex> lock(g_pool_mu);
  g_pool.push_back(dec);
  return rc;
}

// Write one (h, w, 3) RGB uint8 image as a JPEG at `quality`.  Returns 0
// on success, 1 on a file error, 2 on an encoder error, 4 when the GPU
// encoder failed.
int encode_jpeg(const uint8_t* rgb, int h, int w, int quality,
                const char* path) {
  return encode(rgb, h, w, quality, path);
}

#endif

}  // extern "C"
