// Native data loader: threaded image decode + CIR preprocess.
//
// A copy of spn4cir_tpu/native/loader.cpp with the same C API, built by
// spn4cir_tpu_torch/native/__init__.py with g++ into build/native/. The
// reference feeds its GPUs through torchvision/PIL in DataLoader worker
// processes; this loader implements the full preprocess pipeline natively:
//   decode (libjpeg / libpng) -> optional square/target pad -> bicubic
//   shortest-side resize -> center crop -> normalize -> float32 HWC
// with a persistent worker pool parallelizing over batch items.
//
// Geometry parity targets (same math as spn4cir_tpu_torch/data/transforms.py,
// which mirrors clip4cir/data_utils.py:20-98):
//   - TargetPad: pad iff max/min aspect >= ratio, to max_wh/ratio (int floor)
//   - SquarePad: pad to max(w, h), centered with int floor offsets
//   - Resize: shortest side -> dim, long side int() truncation, PIL-style
//     bicubic (a = -0.5, support scaled by the downscale factor)
//   - CenterCrop: torchvision rounding, zero-pad when smaller than crop
//
// C API (ctypes-consumed by spn4cir_tpu_torch/native/__init__.py):
//   void* loader_create(int num_threads);
//   void  loader_destroy(void*);
//   int   loader_decode_batch(void*, const char** paths, int n,
//                             int kind, int dim, float target_ratio,
//                             const float* mean, const float* std,
//                             float* out /* n*dim*dim*3 */,
//                             int8_t* status /* n, nullable */);
//   int   loader_stage_raw_batch(void*, const char** paths, int n,
//                                int kind, int canvas, float target_ratio,
//                                uint8_t* out /* n*canvas*canvas*3 */,
//                                int32_t* extents /* n*2 (H, W) */,
//                                int8_t* status /* n, nullable */);
//   (decode-only staging for the on-device fused preprocess)
//   both return the count of not-OK items; per-image status: 0 ok, 1 decode
//   failed, 2 needs the Python/PIL path (palette-mode PNG: Pillow resizes
//   mode-P images with NEAREST and pads with palette[0], which this decoder
//   does not replicate — the caller falls back per image). Failed/fallback
//   slots are zeroed; the batch never crashes.

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

#include <csetjmp>
#include <jpeglib.h>
#include <png.h>

namespace {

struct ImageU8 {
  int w = 0, h = 0;
  std::vector<uint8_t> rgb;  // h*w*3
};

// ---------------------------------------------------------------------------
// Decoders
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

bool decode_jpeg(FILE* fp, ImageU8* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->rgb.resize(size_t(out->w) * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->rgb.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool decode_png(FILE* fp, ImageU8* out, bool* needs_fallback) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_init_io(png, fp);
  png_read_info(png, info);

  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type, nullptr, nullptr,
               nullptr);
  if (color_type == PNG_COLOR_TYPE_PALETTE) {
    // Pillow keeps mode-P through resize (forcing NEAREST) and pads with
    // palette index 0; converting to RGB here would silently change the
    // pixels vs the PIL/reference path — let Python handle these images
    if (needs_fallback) *needs_fallback = true;
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  // normalize everything to 8-bit RGB
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);

  out->w = int(w);
  out->h = int(h);
  out->rgb.resize(size_t(w) * h * 3);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y)
    rows[y] = out->rgb.data() + size_t(y) * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

bool decode_file(const char* path, ImageU8* out, bool* needs_fallback) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  uint8_t magic[8] = {0};
  size_t got = fread(magic, 1, 8, fp);
  rewind(fp);
  bool ok = false;
  if (got >= 3 && magic[0] == 0xFF && magic[1] == 0xD8 && magic[2] == 0xFF) {
    ok = decode_jpeg(fp, out);
  } else if (got >= 8 && png_sig_cmp(magic, 0, 8) == 0) {
    ok = decode_png(fp, out, needs_fallback);
  }
  fclose(fp);
  return ok && out->w > 0 && out->h > 0;
}

// ---------------------------------------------------------------------------
// Geometry (parity with spn4cir_tpu_torch/data/transforms.py)
// ---------------------------------------------------------------------------

void pad_image(const ImageU8& in, int hp, int vp, ImageU8* out) {
  out->w = in.w + 2 * hp;
  out->h = in.h + 2 * vp;
  out->rgb.resize(size_t(out->w) * out->h * 3);
  uint8_t* dst = out->rgb.data();
  size_t row = size_t(out->w) * 3;
  // zero only the border strips; interior rows are fully overwritten
  std::memset(dst, 0, row * vp);
  std::memset(dst + row * (vp + in.h), 0, row * vp);
  for (int y = 0; y < in.h; ++y) {
    uint8_t* d = dst + row * (y + vp);
    std::memset(d, 0, size_t(hp) * 3);
    std::memcpy(d + size_t(hp) * 3, in.rgb.data() + size_t(y) * in.w * 3,
                size_t(in.w) * 3);
    std::memset(d + size_t(hp + in.w) * 3, 0,
                (row - size_t(hp + in.w) * 3));
  }
}

// PIL-style bicubic kernel, a = -0.5
inline double cubic(double x) {
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct ResampleCoeffs {
  int ksize;                 // taps per output pixel
  std::vector<int> bounds;   // 2 * out_size: (start, count)
  std::vector<float> kk;     // out_size * ksize weights
};

// PIL ImagingResampleHorizontal coefficient precomputation (math in double,
// stored as float: both passes quantize to 8 bits, so float32 weights keep
// every accumulated value well within the rounding tolerance)
ResampleCoeffs precompute(int in_size, int out_size) {
  ResampleCoeffs rc;
  double scale = double(in_size) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 2.0 * filterscale;
  rc.ksize = int(std::ceil(support)) * 2 + 1;
  rc.bounds.resize(size_t(out_size) * 2);
  rc.kk.resize(size_t(out_size) * rc.ksize, 0.0f);
  std::vector<double> kd(rc.ksize);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    int xmin = int(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = int(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    float* k = &rc.kk[size_t(xx) * rc.ksize];
    double ww = 0.0;
    for (int x = 0; x < xmax; ++x) {
      kd[x] = cubic((x + xmin - center + 0.5) / filterscale);
      ww += kd[x];
    }
    for (int x = 0; x < xmax; ++x)
      k[x] = float(ww != 0.0 ? kd[x] / ww : kd[x]);
    rc.bounds[size_t(xx) * 2] = xmin;
    rc.bounds[size_t(xx) * 2 + 1] = xmax;
  }
  return rc;
}

// 4-lane float vector (SSE on x86, NEON on arm): the horizontal tap loop
// multiply-accumulates one RGB pixel (+ one spill lane) per instruction.
typedef float v4sf __attribute__((vector_size(16)));

// Separable bicubic resize restricted to the [x0, x0+cw) x [y0, y0+ch)
// window of the full out_w x out_h result (each output pixel of a separable
// filter is independent, so the restriction is exact — the center crop
// after a shortest-side resize discards the long-side margins, so the crop
// caller never pays for them). Float accumulation, clamped to [0, 255]; the
// horizontal taps use 4-wide vector MACs over the interleaved RGB row and
// both PIL-parity quantization passes run as flat vectorizable sweeps —
// together ~2x the scalar-double full-frame version this replaced (resize
// was the whole pipeline's dominant cost).
void resize_bicubic_window(const ImageU8& in, int out_w, int out_h,
                           int x0, int y0, int cw, int ch,
                           std::vector<float>* out /* ch*cw*3 */) {
  ResampleCoeffs hc = precompute(in.w, out_w);
  ResampleCoeffs vc = precompute(in.h, out_h);
  // input rows referenced by the window's vertical taps (tap windows are
  // monotone in yy, so first row's start / last row's end bound them all)
  int rlo = vc.bounds[size_t(y0) * 2];
  int rhi = vc.bounds[size_t(y0 + ch - 1) * 2] +
            vc.bounds[size_t(y0 + ch - 1) * 2 + 1];
  // horizontal pass: (rhi-rlo) x cw x 3 floats
  std::vector<float> tmp(size_t(rhi - rlo) * cw * 3);
  // +4 zero floats: the v4 load at the row's last pixel reads one lane past
  std::vector<float> rowf(size_t(in.w) * 3 + 4, 0.f);
  for (int y = rlo; y < rhi; ++y) {
    const uint8_t* row = in.rgb.data() + size_t(y) * in.w * 3;
    // one u8->f32 conversion per row (vectorizes); taps then read floats
    for (int i = 0; i < in.w * 3; ++i) rowf[i] = float(row[i]);
    float* trow = tmp.data() + size_t(y - rlo) * cw * 3;
    for (int xi = 0; xi < cw; ++xi) {
      size_t xx = size_t(x0) + xi;
      int xmin = hc.bounds[xx * 2];
      int xmax = hc.bounds[xx * 2 + 1];
      const float* k = &hc.kk[xx * hc.ksize];
      const float* px = rowf.data() + size_t(xmin) * 3;
      v4sf acc = {0.f, 0.f, 0.f, 0.f};
      for (int x = 0; x < xmax; ++x) {
        v4sf p;
        std::memcpy(&p, px, sizeof(p));  // RGB + next pixel's R (discarded)
        float w = k[x];
        v4sf wv = {w, w, w, w};
        acc += p * wv;
        px += 3;
      }
      float a[4];
      std::memcpy(a, &acc, sizeof(a));
      trow[xi * 3 + 0] = a[0];
      trow[xi * 3 + 1] = a[1];
      trow[xi * 3 + 2] = a[2];
    }
    // PIL quantizes the horizontal pass to uint8 before the vertical pass;
    // done as a flat row sweep so it vectorizes (roundps + min/max)
    for (int i = 0; i < cw * 3; ++i) {
      float r = std::nearbyintf(trow[i]);
      trow[i] = r < 0.f ? 0.f : (r > 255.f ? 255.f : r);
    }
  }
  out->assign(size_t(ch) * cw * 3, 0.0f);
  for (int yi = 0; yi < ch; ++yi) {
    size_t yy = size_t(y0) + yi;
    int ymin = vc.bounds[yy * 2];
    int ymax = vc.bounds[yy * 2 + 1];
    const float* k = &vc.kk[yy * vc.ksize];
    float* orow = out->data() + size_t(yi) * cw * 3;
    for (int y = 0; y < ymax; ++y) {
      const float* trow = tmp.data() + size_t(ymin + y - rlo) * cw * 3;
      float w = k[y];
      for (int x = 0; x < cw * 3; ++x) orow[x] += trow[x] * w;
    }
  }
  // PIL stores the intermediate as uint8 (clip + round); replicate for parity
  for (auto& v : *out) {
    float r = std::nearbyint(v);
    v = r < 0.f ? 0.f : (r > 255.f ? 255.f : r);
  }
}

enum PadKind { KIND_CLIP = 0, KIND_SQUAREPAD = 1, KIND_TARGETPAD = 2 };

bool preprocess_one(const char* path, int kind, int dim, float target_ratio,
                    const float* mean, const float* stdv, float* out,
                    bool* needs_fallback) {
  ImageU8 img;
  if (!decode_file(path, &img, needs_fallback)) return false;

  ImageU8 padded;
  const ImageU8* cur = &img;
  if (kind == KIND_SQUAREPAD) {
    int side = img.w > img.h ? img.w : img.h;
    pad_image(img, (side - img.w) / 2, (side - img.h) / 2, &padded);
    cur = &padded;
  } else if (kind == KIND_TARGETPAD) {
    double mx = std::max(img.w, img.h), mn = std::min(img.w, img.h);
    if (mx / mn >= target_ratio) {
      double scaled = mx / target_ratio;
      int hp = std::max(int((scaled - img.w) / 2), 0);
      int vp = std::max(int((scaled - img.h) / 2), 0);
      pad_image(img, hp, vp, &padded);
      cur = &padded;
    }
  }

  // shortest-side resize with int() long-side truncation
  int rw, rh;
  if (cur->w <= cur->h) {
    rw = dim;
    rh = std::max(1, int(double(dim) * cur->h / cur->w));
  } else {
    rh = dim;
    rw = std::max(1, int(double(dim) * cur->w / cur->h));
  }
  // center crop (torchvision uses Python round() = half-to-even; nearbyint
  // under the default FE_TONEAREST mode matches); pad with zeros when smaller
  int left = int(std::nearbyint((rw - dim) / 2.0));
  int top = int(std::nearbyint((rh - dim) / 2.0));

  // resize only the crop window: a separable filter's output pixels are
  // independent, so restricting to the kept [wx0, wx0+ww) x [wy0, wy0+wh)
  // region is exact and skips the long-side margins the crop discards
  int wx0 = std::max(left, 0), wy0 = std::max(top, 0);
  int ww = std::max(std::min(left + dim, rw) - wx0, 1);
  int wh = std::max(std::min(top + dim, rh) - wy0, 1);
  std::vector<float> resized;
  resize_bicubic_window(*cur, rw, rh, wx0, wy0, ww, wh, &resized);

  for (int y = 0; y < dim; ++y) {
    for (int x = 0; x < dim; ++x) {
      int sy = y + top, sx = x + left;
      float* o = out + (size_t(y) * dim + x) * 3;
      if (sy < 0 || sy >= rh || sx < 0 || sx >= rw) {
        for (int c = 0; c < 3; ++c) o[c] = (0.f - mean[c]) / stdv[c];
      } else {
        const float* s =
            resized.data() + (size_t(sy - wy0) * ww + (sx - wx0)) * 3;
        for (int c = 0; c < 3; ++c)
          o[c] = (s[c] / 255.0f - mean[c]) / stdv[c];
      }
    }
  }
  return true;
}

// Pad offsets for pasting a (w, h) image into the device-preprocess canvas
// (same int-floor math as the pad branches of preprocess_one / the Python
// transforms.pad_geometry).
void pad_offsets(int w, int h, int kind, float target_ratio, int* hp,
                 int* vp) {
  *hp = 0;
  *vp = 0;
  if (kind == KIND_SQUAREPAD) {
    int side = std::max(w, h);
    *hp = (side - w) / 2;
    *vp = (side - h) / 2;
  } else if (kind == KIND_TARGETPAD) {
    double mx = std::max(w, h), mn = std::min(w, h);
    if (mx / mn >= target_ratio) {
      double scaled = mx / target_ratio;
      *hp = std::max(int((scaled - w) / 2), 0);
      *vp = std::max(int((scaled - h) / 2), 0);
    }
  }
}

// Raw staging for the on-device fused preprocess (`--device_preprocess`,
// ops/preprocess.py:preprocess_batch_dynamic): decode only, paste the image
// into a zeroed uint8 canvas at its pad offsets, report the padded extent.
// No resize on the host — except the pre-downscale when the padded extent
// exceeds the canvas, mirroring transforms.stage_raw_image exactly.
bool stage_raw_one(const char* path, int kind, int canvas, float target_ratio,
                   uint8_t* out /* canvas*canvas*3 */, int32_t* extent,
                   bool* needs_fallback) {
  ImageU8 img;
  if (!decode_file(path, &img, needs_fallback)) return false;
  int hp, vp;
  pad_offsets(img.w, img.h, kind, target_ratio, &hp, &vp);
  int pw = img.w + 2 * hp, ph = img.h + 2 * vp;
  if (std::max(pw, ph) > canvas) {
    double scale = double(canvas) / std::max(pw, ph);
    int nh = std::max(1, int(img.h * scale));
    int nw = std::max(1, int(img.w * scale));
    std::vector<float> rf;  // already PIL-quantized (clip+round) floats
    resize_bicubic_window(img, nw, nh, 0, 0, nw, nh, &rf);
    ImageU8 small;
    small.w = nw;
    small.h = nh;
    small.rgb.resize(rf.size());
    for (size_t i = 0; i < rf.size(); ++i) small.rgb[i] = uint8_t(rf[i]);
    img = std::move(small);
    pad_offsets(img.w, img.h, kind, target_ratio, &hp, &vp);
    hp = std::min(hp, (canvas - img.w) / 2);
    vp = std::min(vp, (canvas - img.h) / 2);
    pw = img.w + 2 * hp;
    ph = img.h + 2 * vp;
  }
  std::memset(out, 0, size_t(canvas) * canvas * 3);
  for (int y = 0; y < img.h; ++y)
    std::memcpy(out + (size_t(y + vp) * canvas + hp) * 3,
                img.rgb.data() + size_t(y) * img.w * 3, size_t(img.w) * 3);
  extent[0] = ph;
  extent[1] = pw;
  return true;
}

// ---------------------------------------------------------------------------
// Thread pool
// ---------------------------------------------------------------------------

class Pool {
 public:
  explicit Pool(int n) {
    for (int i = 0; i < n; ++i)
      workers_.emplace_back([this] { this->run(); });
  }
  ~Pool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }
  void submit(std::function<void()> fn) {
    {
      std::unique_lock<std::mutex> lk(mu_);
      q_.push(std::move(fn));
    }
    cv_.notify_one();
  }

 private:
  void run() {
    for (;;) {
      std::function<void()> fn;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !q_.empty(); });
        if (stop_ && q_.empty()) return;
        fn = std::move(q_.front());
        q_.pop();
      }
      fn();
    }
  }
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> q_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_ = false;
};

struct Latch {
  std::mutex mu;
  std::condition_variable cv;
  int remaining;
  explicit Latch(int n) : remaining(n) {}
  void done() {
    std::unique_lock<std::mutex> lk(mu);
    if (--remaining == 0) cv.notify_all();
  }
  void wait() {
    std::unique_lock<std::mutex> lk(mu);
    cv.wait(lk, [this] { return remaining == 0; });
  }
};

}  // namespace

extern "C" {

void* loader_create(int num_threads) {
  if (num_threads < 1) num_threads = 1;
  return new Pool(num_threads);
}

void loader_destroy(void* pool) { delete static_cast<Pool*>(pool); }

int loader_decode_batch(void* pool_ptr, const char** paths, int n, int kind,
                        int dim, float target_ratio, const float* mean,
                        const float* stdv, float* out, int8_t* status) {
  Pool* pool = static_cast<Pool*>(pool_ptr);
  std::atomic<int> failures{0};
  Latch latch(n);
  size_t stride = size_t(dim) * dim * 3;
  for (int i = 0; i < n; ++i) {
    const char* path = paths[i];
    float* slot = out + stride * i;
    int8_t* st = status ? status + i : nullptr;
    pool->submit([&, path, slot, st] {
      bool fb = false;
      if (!preprocess_one(path, kind, dim, target_ratio, mean, stdv, slot,
                          &fb)) {
        std::memset(slot, 0, stride * sizeof(float));
        failures.fetch_add(1);
        if (st) *st = fb ? 2 : 1;
      } else if (st) {
        *st = 0;
      }
      latch.done();
    });
  }
  latch.wait();
  return failures.load();
}

int loader_stage_raw_batch(void* pool_ptr, const char** paths, int n,
                           int kind, int canvas, float target_ratio,
                           uint8_t* out /* n*canvas*canvas*3 */,
                           int32_t* extents /* n*2 */, int8_t* status) {
  Pool* pool = static_cast<Pool*>(pool_ptr);
  std::atomic<int> failures{0};
  Latch latch(n);
  size_t stride = size_t(canvas) * canvas * 3;
  for (int i = 0; i < n; ++i) {
    const char* path = paths[i];
    uint8_t* slot = out + stride * i;
    int32_t* ext = extents + size_t(i) * 2;
    int8_t* st = status ? status + i : nullptr;
    pool->submit([&, path, slot, ext, st] {
      bool fb = false;
      if (!stage_raw_one(path, kind, canvas, target_ratio, slot, ext, &fb)) {
        std::memset(slot, 0, stride);
        ext[0] = ext[1] = canvas;  // harmless extent for the zeroed slot
        failures.fetch_add(1);
        if (st) *st = fb ? 2 : 1;
      } else if (st) {
        *st = 0;
      }
      latch.done();
    });
  }
  latch.wait();
  return failures.load();
}

}  // extern "C"
