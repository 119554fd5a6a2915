// Native dataset ingest runtime: threaded PNG decode + undistortion remap
// + ordered bounded queue.
//
// Parity target: the reference's ROS 2 ingestion node (SURVEY L9,
// ros2_ws/src/mono-inertial/include/image_grabber.hpp:96-110 — GPU
// remap-undistort -> resize -> grayscale pipeline feeding the tracker
// through queues).  Here the same role is played by a C++ thread pool that
// decodes PNG frames and applies the (precomputed) bilinear remap off the
// Python GIL, handing ready frames to the host loop in order.
//
// Two ways to feed the pool:
//   - built with INGEST_WITH_LIBPNG (needs png.h, links -lpng -lz), the
//     workers decode the files themselves with libpng (ingest_create,
//     ingest_create2);
//   - in every build, the caller decodes (PIL) and hands each frame in its
//     raw PNG pixel layout (ingest_create_pushed + ingest_push); the
//     workers convert it to 8-bit gray exactly as decode_png_gray has
//     libpng do it (raw_to_gray), then run the same stages.
//
// Exposed C ABI (used from Python via ctypes — no pybind11 in this image):
//   ingest_create(paths, n, remap, h, w, sw, sh, threads, queue_cap)
//   ingest_create2(... + resize output dims + CLAHE clip/grid) — the full
//     grabber pipeline: decode -> remap -> resize (INTER_LINEAR) -> CLAHE,
//     matching image_grabber.hpp:103-108 (remap there is INTER_CUBIC; we
//     use bilinear — sub-0.5-graylevel difference on smooth images).
//   ingest_create_pushed(n, remap, ... as ingest_create2 without paths)
//   ingest_push(handle, index, pixels, h, w, channels, bit_depth, gamma)
//   ingest_has_libpng()                        -> 1 libpng build, 0 not
//   ingest_next(handle, out_frame, out_index)  -> 1 ok, 0 end
//   ingest_destroy(handle)
//
// Build: io/native_ingest.py (g++ -O3 -march=native -shared).

#ifdef INGEST_WITH_LIBPNG
#include <png.h>
#endif

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cmath>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Frame {
  std::vector<float> data;
  int index = -1;
};

// A frame the caller decoded, in its PNG pixel layout: `channels` samples
// of `depth` bits per pixel (gray, gray+alpha, RGB, RGBA; a palette
// expanded to RGB), and the file's gamma in libpng's fixed point (0: no
// gAMA / sRGB chunk).  ok == false: the caller could not decode the file.
struct RawFrame {
  std::vector<uint8_t> data;
  int h = 0, w = 0, channels = 0, depth = 0, gamma = 0;
  bool ok = false;
};

struct Ingest {
  int n = 0;                        // frames in the stream
  std::vector<std::string> paths;   // libpng: one per frame; pushed: empty
  std::map<int, RawFrame> pushed;   // pushed frames not yet taken
  std::vector<char> was_pushed;     // pushed: one flag per index
  std::condition_variable cv_input;
  std::vector<float> remap;  // (rh*rw*2) source coords (x, y); empty = none
  int remap_h = 0, remap_w = 0;  // undistorted (pre-resize) size
  int out_h = 0, out_w = 0;      // final output size (post-resize)
  int src_h = 0, src_w = 0;      // source image size
  float clahe_clip = 0.0f;       // <= 0: CLAHE off
  int clahe_grid = 8;
  int queue_cap = 8;

  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::map<int, Frame> ready;   // decoded frames by index
  std::atomic<int> next_to_fetch{0};
  int next_to_emit = 0;
  std::atomic<bool> stop{false};
  std::atomic<int> n_failed{0};
};

#ifdef INGEST_WITH_LIBPNG
bool decode_png_gray(const char* path, std::vector<float>* out, int* w,
                     int* h) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    std::fclose(fp);
    return false;
  }
  png_infop info = png_create_info_struct(png);
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  *w = png_get_image_width(png, info);
  *h = png_get_image_height(png, info);
  png_byte color = png_get_color_type(png, info);
  png_byte depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
      color == PNG_COLOR_TYPE_PALETTE)
    png_set_rgb_to_gray(png, 1, -1.0, -1.0);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  png_read_update_info(png, info);

  std::vector<png_byte> row((*w));
  out->resize(static_cast<size_t>(*w) * (*h));
  for (int y = 0; y < *h; ++y) {
    png_read_row(png, row.data(), nullptr);
    float* dst = out->data() + static_cast<size_t>(y) * (*w);
    for (int x = 0; x < *w; ++x) dst[x] = static_cast<float>(row[x]);
  }
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return true;
}
#endif  // INGEST_WITH_LIBPNG

// ---- decode_png_gray's conversion to 8-bit gray, without libpng --------
// libpng 1.6 (pngrtran.c, png.c) with decode_png_gray's transforms:
// png_set_strip_16 keeps a 16-bit sample's high byte; png_set_strip_alpha
// drops alpha before any other step; png_set_rgb_to_gray(png, 1, -1, -1)
// takes the default coefficients 6968 / 23434 / 2366 (of 32768).  With no
// significant file gamma it truncates (rc*r + gc*g + bc*b) >> 15.  With one
// (gAMA, or sRGB's 45455; no png_set_gamma, so the screen gamma is the
// file's reciprocal) it builds 8-bit tables and maps the sum, rounded,
// through them; a pixel with r == g == b passes through gamma_table.
constexpr int kFp1 = 100000;        // PNG_FP_1
constexpr int kGammaThreshold = 5000;  // PNG_GAMMA_THRESHOLD_FIXED
constexpr uint32_t kRedCoeff = 6968, kGreenCoeff = 23434;

bool gamma_significant(int g) {  // png_gamma_significant
  return g < kFp1 - kGammaThreshold || g > kFp1 + kGammaThreshold;
}

int reciprocal(int a) {  // png_reciprocal
  const double r = std::floor(1E10 / a + .5);
  return (r <= 2147483647. && r >= -2147483648.) ? static_cast<int>(r) : 0;
}

int reciprocal2(int a, int b) {  // png_reciprocal2
  if (a == 0 || b == 0) return 0;
  double r = 1E15 / a;
  r /= b;
  r = std::floor(r + .5);
  return (r <= 2147483647. && r >= -2147483648.) ? static_cast<int>(r) : 0;
}

// png_build_8bit_table through png_gamma_8bit_correct (floating point)
void build_8bit_table(int gamma, uint8_t* table) {
  for (int i = 0; i < 256; ++i) {
    if (gamma_significant(gamma) && i > 0 && i < 255) {
      const double r =
          std::floor(255 * std::pow(i / 255., gamma * .00001) + .5);
      table[i] = static_cast<uint8_t>(r);
    } else {
      table[i] = static_cast<uint8_t>(i);
    }
  }
}

bool raw_to_gray(const RawFrame& raw, std::vector<float>* out) {
  const int c = raw.channels;
  const bool wide = raw.depth == 16;
  // 16-bit color is not taken: PIL hands it to the caller as 8 bits
  if (raw.h < 1 || raw.w < 1 || c < 1 || c > 4 || (raw.depth != 8 && !wide) ||
      (wide && c > 2) ||
      raw.data.size() !=
          static_cast<size_t>(raw.h) * raw.w * c * (wide ? 2 : 1))
    return false;
  const size_t n = static_cast<size_t>(raw.h) * raw.w;
  out->resize(n);
  if (c <= 2) {  // gray (+ alpha): the sample, or a 16-bit one's high byte
    if (wide) {
      uint16_t v;
      for (size_t i = 0; i < n; ++i) {
        std::memcpy(&v, raw.data.data() + i * c * 2, 2);
        (*out)[i] = static_cast<float>(v >> 8);
      }
    } else {
      for (size_t i = 0; i < n; ++i) (*out)[i] = raw.data[i * c];
    }
    return true;
  }
  const uint32_t rc = kRedCoeff, gc = kGreenCoeff, bc = 32768 - rc - gc;
  // the file's gamma (0 = none, libpng's default PNG_FP_1)
  const int file_gamma = raw.gamma > 0 ? raw.gamma : kFp1;
  const int screen_gamma = reciprocal(file_gamma);
  const bool tables =
      gamma_significant(file_gamma) || gamma_significant(screen_gamma);
  uint8_t gamma_table[256], to_1[256], from_1[256];
  if (tables) {
    build_8bit_table(
        screen_gamma > 0 ? reciprocal2(file_gamma, screen_gamma) : kFp1,
        gamma_table);
    build_8bit_table(reciprocal(file_gamma), to_1);
    build_8bit_table(screen_gamma > 0 ? reciprocal(screen_gamma) : file_gamma,
                     from_1);
  }
  for (size_t i = 0; i < n; ++i) {
    const uint8_t* p = raw.data.data() + i * c;
    uint32_t r = p[0], g = p[1], b = p[2];
    if (r == g && r == b) {
      (*out)[i] = tables ? gamma_table[r] : r;
    } else if (tables) {
      r = to_1[r];
      g = to_1[g];
      b = to_1[b];
      (*out)[i] = from_1[(rc * r + gc * g + bc * b + 16384) >> 15];
    } else {
      (*out)[i] = static_cast<float>((rc * r + gc * g + bc * b) >> 15);
    }
  }
  return true;
}

void apply_remap(const std::vector<float>& src, int sh, int sw,
                 const std::vector<float>& remap, int oh, int ow,
                 std::vector<float>* dst) {
  dst->resize(static_cast<size_t>(oh) * ow);
  for (int y = 0; y < oh; ++y) {
    for (int x = 0; x < ow; ++x) {
      const size_t i = static_cast<size_t>(y) * ow + x;
      float mx = remap[i * 2];
      float my = remap[i * 2 + 1];
      if (mx < 0) mx = 0;
      if (my < 0) my = 0;
      if (mx > sw - 1.001f) mx = sw - 1.001f;
      if (my > sh - 1.001f) my = sh - 1.001f;
      const int x0 = static_cast<int>(mx);
      const int y0 = static_cast<int>(my);
      const float fx = mx - x0;
      const float fy = my - y0;
      const float* r0 = src.data() + static_cast<size_t>(y0) * sw;
      const float* r1 = r0 + sw;
      (*dst)[i] = (r0[x0] * (1 - fx) + r0[x0 + 1] * fx) * (1 - fy) +
                  (r1[x0] * (1 - fx) + r1[x0 + 1] * fx) * fy;
    }
  }
}

// cv::resize INTER_LINEAR semantics: src = (dst + 0.5) * scale - 0.5.
void resize_bilinear(const std::vector<float>& src, int sh, int sw,
                     int oh, int ow, std::vector<float>* dst) {
  dst->resize(static_cast<size_t>(oh) * ow);
  const float sy = static_cast<float>(sh) / oh;
  const float sx = static_cast<float>(sw) / ow;
  for (int y = 0; y < oh; ++y) {
    float my = (y + 0.5f) * sy - 0.5f;
    if (my < 0) my = 0;
    if (my > sh - 1.001f) my = sh - 1.001f;
    const int y0 = static_cast<int>(my);
    const float fy = my - y0;
    const float* r0 = src.data() + static_cast<size_t>(y0) * sw;
    const float* r1 = r0 + sw;
    for (int x = 0; x < ow; ++x) {
      float mx = (x + 0.5f) * sx - 0.5f;
      if (mx < 0) mx = 0;
      if (mx > sw - 1.001f) mx = sw - 1.001f;
      const int x0 = static_cast<int>(mx);
      const float fx = mx - x0;
      (*dst)[static_cast<size_t>(y) * ow + x] =
          (r0[x0] * (1 - fx) + r0[x0 + 1] * fx) * (1 - fy) +
          (r1[x0] * (1 - fx) + r1[x0 + 1] * fx) * fy;
    }
  }
}

// CLAHE (contrast-limited adaptive histogram equalization), the
// cv::createCLAHE(clip, grid) algorithm the reference grabber constructs
// (image_grabber.hpp:47): per-tile clipped 256-bin histogram -> CDF LUT,
// bilinear interpolation between the 4 surrounding tile LUTs.  Input is
// grayscale float 0..255 (quantized to bins by rounding); clipped excess
// is redistributed evenly across bins.
void apply_clahe(const std::vector<float>& src, int h, int w, float clip,
                 int grid, std::vector<float>* dst) {
  const int gh = grid, gw = grid;
  const int th = (h + gh - 1) / gh, tw = (w + gw - 1) / gw;
  const int tile_area = th * tw;
  std::vector<float> lut(static_cast<size_t>(gh) * gw * 256);
  std::vector<int> hist(256);
  for (int ty = 0; ty < gh; ++ty) {
    for (int tx = 0; tx < gw; ++tx) {
      std::fill(hist.begin(), hist.end(), 0);
      // histogram over the tile, reading reflected samples where the
      // padded tile extends past the image (cv pads to a tile multiple
      // with BORDER_REFLECT_101)
      for (int y = ty * th; y < (ty + 1) * th; ++y) {
        int yy = y < h ? y : 2 * (h - 1) - y;
        const float* row = src.data() + static_cast<size_t>(yy) * w;
        for (int x = tx * tw; x < (tx + 1) * tw; ++x) {
          int xx = x < w ? x : 2 * (w - 1) - x;
          int b = static_cast<int>(row[xx] + 0.5f);
          hist[b < 0 ? 0 : (b > 255 ? 255 : b)]++;
        }
      }
      const int climit =
          std::max(1, static_cast<int>(clip * tile_area / 256.0f));
      int excess = 0;
      for (int b = 0; b < 256; ++b)
        if (hist[b] > climit) {
          excess += hist[b] - climit;
          hist[b] = climit;
        }
      const int bonus = excess / 256, resid = excess % 256;
      for (int b = 0; b < 256; ++b) hist[b] += bonus + (b < resid ? 1 : 0);
      const float scale = 255.0f / tile_area;
      int cdf = 0;
      float* tl = lut.data() + (static_cast<size_t>(ty) * gw + tx) * 256;
      for (int b = 0; b < 256; ++b) {
        cdf += hist[b];
        tl[b] = scale * cdf;
      }
    }
  }
  dst->resize(static_cast<size_t>(h) * w);
  for (int y = 0; y < h; ++y) {
    const float gy = (y + 0.5f) / th - 0.5f;
    int ty0 = static_cast<int>(gy < 0 ? 0 : gy);
    if (ty0 > gh - 2) ty0 = gh - 2;
    float fy = gy - ty0;
    fy = fy < 0 ? 0 : (fy > 1 ? 1 : fy);
    const float* row = src.data() + static_cast<size_t>(y) * w;
    float* out = dst->data() + static_cast<size_t>(y) * w;
    for (int x = 0; x < w; ++x) {
      const float gx = (x + 0.5f) / tw - 0.5f;
      int tx0 = static_cast<int>(gx < 0 ? 0 : gx);
      if (tx0 > gw - 2) tx0 = gw - 2;
      float fx = gx - tx0;
      fx = fx < 0 ? 0 : (fx > 1 ? 1 : fx);
      int b = static_cast<int>(row[x] + 0.5f);
      b = b < 0 ? 0 : (b > 255 ? 255 : b);
      const float* l00 = lut.data() + (static_cast<size_t>(ty0) * gw + tx0) * 256;
      const float* l01 = l00 + 256;
      const float* l10 = l00 + static_cast<size_t>(gw) * 256;
      const float* l11 = l10 + 256;
      out[x] = (l00[b] * (1 - fx) + l01[b] * fx) * (1 - fy) +
               (l10[b] * (1 - fx) + l11[b] * fx) * fy;
    }
  }
}

// Stages 1-3 on a decoded gray frame of h x w; the frame emitted for
// `idx` (zeros, counted as failed, where the decode failed or the frame's
// size does not fit), then its slot in the ordered queue.  Returns false
// when the pool is stopping.
bool finish_frame(Ingest* ing, int idx, bool decoded, std::vector<float> img,
                  int h, int w) {
  Frame f;
  f.index = idx;
  if (decoded) {
    // stage 1: undistort/rectify remap (to remap_h x remap_w)
    std::vector<float> cur;
    int ch = h, cw = w;
    bool ok = true;
    if (!ing->remap.empty()) {
      apply_remap(img, h, w, ing->remap, ing->remap_h, ing->remap_w, &cur);
      ch = ing->remap_h;
      cw = ing->remap_w;
    } else {
      cur = std::move(img);
    }
    // stage 2: resize to the final output size
    if (ok && (ch != ing->out_h || cw != ing->out_w)) {
      if (ing->remap.empty() && (ch < 2 || cw < 2)) {
        ok = false;  // degenerate source
      } else if (ing->remap.empty() &&
                 (ch != ing->src_h || cw != ing->src_w) && ing->src_h > 0) {
        // decoded size != declared source size with no remap: reject
        // rather than silently rescaling a corrupt frame
        ok = false;
      } else {
        std::vector<float> rs;
        resize_bilinear(cur, ch, cw, ing->out_h, ing->out_w, &rs);
        cur = std::move(rs);
        ch = ing->out_h;
        cw = ing->out_w;
      }
    }
    // stage 3: CLAHE
    if (ok && ing->clahe_clip > 0.0f) {
      std::vector<float> eq;
      apply_clahe(cur, ch, cw, ing->clahe_clip, ing->clahe_grid, &eq);
      cur = std::move(eq);
    }
    if (ok && ch == ing->out_h && cw == ing->out_w) {
      f.data = std::move(cur);
    } else {
      // decoded size != declared output size: treat as a failed frame
      // (a larger image would otherwise overflow the caller's buffer)
      ing->n_failed.fetch_add(1);
      f.data.assign(static_cast<size_t>(ing->out_h) * ing->out_w, 0.0f);
    }
  } else {
    ing->n_failed.fetch_add(1);
    f.data.assign(static_cast<size_t>(ing->out_h) * ing->out_w, 0.0f);
  }
  std::unique_lock<std::mutex> lk(ing->mu);
  ing->cv_space.wait(lk, [&] {
    return ing->stop.load() ||
           static_cast<int>(ing->ready.size()) < ing->queue_cap ||
           idx < ing->next_to_emit + ing->queue_cap;
  });
  if (ing->stop.load()) return false;
  ing->ready.emplace(idx, std::move(f));
  ing->cv_ready.notify_all();
  return true;
}

#ifdef INGEST_WITH_LIBPNG
void worker(Ingest* ing) {
  while (!ing->stop.load()) {
    const int idx = ing->next_to_fetch.fetch_add(1);
    if (idx >= ing->n) return;
    std::vector<float> img;
    int w = 0, h = 0;
    const bool decoded = decode_png_gray(ing->paths[idx].c_str(), &img, &w, &h);
    if (!finish_frame(ing, idx, decoded, std::move(img), h, w)) return;
  }
}
#endif

// The pushed pool's worker: takes the lowest pushed index, converts it to
// gray and finishes it; returns once every frame was taken.
void push_worker(Ingest* ing) {
  for (;;) {
    RawFrame raw;
    int idx;
    {
      std::unique_lock<std::mutex> lk(ing->mu);
      ing->cv_input.wait(lk, [&] {
        return ing->stop.load() || !ing->pushed.empty() ||
               ing->next_to_fetch.load() >= ing->n;
      });
      if (ing->stop.load() || ing->pushed.empty()) return;
      auto it = ing->pushed.begin();
      idx = it->first;
      raw = std::move(it->second);
      ing->pushed.erase(it);
      if (ing->next_to_fetch.fetch_add(1) + 1 >= ing->n)
        ing->cv_input.notify_all();  // the others may return
    }
    std::vector<float> img;
    const bool decoded = raw.ok && raw_to_gray(raw, &img);
    if (!finish_frame(ing, idx, decoded, std::move(img), raw.h, raw.w)) return;
  }
}

Ingest* new_ingest(int n, const float* remap, int remap_h, int remap_w,
                   int out_h, int out_w, int src_h, int src_w,
                   float clahe_clip, int clahe_grid, int queue_cap) {
  auto* ing = new Ingest();
  ing->n = n > 0 ? n : 0;
  if (remap != nullptr) {
    ing->remap.assign(remap,
                      remap + static_cast<size_t>(remap_h) * remap_w * 2);
  }
  ing->remap_h = remap_h;
  ing->remap_w = remap_w;
  ing->out_h = out_h;
  ing->out_w = out_w;
  ing->src_h = src_h;
  ing->src_w = src_w;
  ing->clahe_clip = clahe_clip;
  ing->clahe_grid = clahe_grid > 1 ? clahe_grid : 8;
  ing->queue_cap = queue_cap > 1 ? queue_cap : 2;
  return ing;
}

void start(Ingest* ing, void (*fn)(Ingest*), int n_threads) {
  const int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; ++i) ing->workers.emplace_back(fn, ing);
}

}  // namespace

extern "C" {

#ifdef INGEST_WITH_LIBPNG
// Full grabber pipeline: decode -> remap (remap_h x remap_w) -> resize
// (out_h x out_w) -> CLAHE (clahe_clip <= 0 disables).
void* ingest_create2(const char** paths, int n_paths, const float* remap,
                     int remap_h, int remap_w, int out_h, int out_w,
                     int src_h, int src_w, float clahe_clip, int clahe_grid,
                     int n_threads, int queue_cap) {
  Ingest* ing = new_ingest(n_paths, remap, remap_h, remap_w, out_h, out_w,
                           src_h, src_w, clahe_clip, clahe_grid, queue_cap);
  ing->paths.reserve(n_paths);
  for (int i = 0; i < n_paths; ++i) ing->paths.emplace_back(paths[i]);
  start(ing, worker, n_threads);
  return ing;
}

void* ingest_create(const char** paths, int n_paths, const float* remap,
                    int out_h, int out_w, int src_h, int src_w,
                    int n_threads, int queue_cap) {
  return ingest_create2(paths, n_paths, remap, out_h, out_w, out_h, out_w,
                        src_h, src_w, 0.0f, 8, n_threads, queue_cap);
}
#endif

// The same pipeline for `n_frames` frames that the caller decodes and
// hands in with ingest_push, in any order.
void* ingest_create_pushed(int n_frames, const float* remap, int remap_h,
                           int remap_w, int out_h, int out_w, int src_h,
                           int src_w, float clahe_clip, int clahe_grid,
                           int n_threads, int queue_cap) {
  Ingest* ing = new_ingest(n_frames, remap, remap_h, remap_w, out_h, out_w,
                           src_h, src_w, clahe_clip, clahe_grid, queue_cap);
  ing->was_pushed.assign(ing->n, 0);
  start(ing, push_worker, n_threads);
  return ing;
}

// Hands frame `index` to a pushed pool: h x w pixels of `channels` samples
// of `bit_depth` (8 or 16, native byte order) bits, copied here; `gamma`
// is the file's gamma in libpng's fixed point (0: none).  pixels == NULL:
// the caller could not decode the file (a failed frame).  Returns 0, and
// takes nothing, for an index out of range or pushed before.
int ingest_push(void* handle, int index, const void* pixels, int h, int w,
                int channels, int bit_depth, int gamma) {
  auto* ing = static_cast<Ingest*>(handle);
  if (index < 0 || index >= static_cast<int>(ing->was_pushed.size())) return 0;
  RawFrame raw;
  if (pixels != nullptr && h > 0 && w > 0 && channels > 0 && bit_depth > 0) {
    const size_t bytes =
        static_cast<size_t>(h) * w * channels * ((bit_depth + 7) / 8);
    raw.data.assign(static_cast<const uint8_t*>(pixels),
                    static_cast<const uint8_t*>(pixels) + bytes);
    raw.h = h;
    raw.w = w;
    raw.channels = channels;
    raw.depth = bit_depth;
    raw.gamma = gamma;
    raw.ok = true;
  }
  std::lock_guard<std::mutex> lk(ing->mu);
  if (ing->stop.load() || ing->was_pushed[index]) return 0;
  ing->was_pushed[index] = 1;
  ing->pushed.emplace(index, std::move(raw));
  ing->cv_input.notify_one();
  return 1;
}

int ingest_has_libpng() {
#ifdef INGEST_WITH_LIBPNG
  return 1;
#else
  return 0;
#endif
}

int ingest_next(void* handle, float* out, int* out_index) {
  auto* ing = static_cast<Ingest*>(handle);
  std::unique_lock<std::mutex> lk(ing->mu);
  const int want = ing->next_to_emit;
  if (want >= ing->n) return 0;
  ing->cv_ready.wait(lk, [&] { return ing->ready.count(want) > 0; });
  Frame f = std::move(ing->ready[want]);
  ing->ready.erase(want);
  ing->next_to_emit++;
  ing->cv_space.notify_all();
  lk.unlock();
  // belt-and-braces: never copy more than the caller's declared buffer
  const size_t cap = static_cast<size_t>(ing->out_h) * ing->out_w;
  const size_t n = f.data.size() < cap ? f.data.size() : cap;
  std::memcpy(out, f.data.data(), n * sizeof(float));
  if (n < cap) std::memset(out + n, 0, (cap - n) * sizeof(float));
  *out_index = f.index;
  return 1;
}

int ingest_failed_count(void* handle) {
  return static_cast<Ingest*>(handle)->n_failed.load();
}

void ingest_destroy(void* handle) {
  auto* ing = static_cast<Ingest*>(handle);
  ing->stop.store(true);
  ing->cv_space.notify_all();
  ing->cv_ready.notify_all();
  ing->cv_input.notify_all();
  for (auto& t : ing->workers) t.join();
  delete ing;
}

}  // extern "C"
