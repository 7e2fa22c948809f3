// mmrp_io: native data-loading runtime of mmrp_tpu_torch (host C++, no CUDA).
//
// A copy of native/mmrp_io.cpp, the JAX package's decoder, so that the port
// carries its own source: the decode -> window -> resize -> normalize hot
// path of a DICOM file, with a persistent worker pool for batches, exposed
// through a C ABI consumed via ctypes (mmrp_tpu_torch/data/native.py, which
// also builds it with g++ into mmrp_tpu_torch/build/).
//
// Scope: DICOM Part-10, implicit/explicit VR little endian, uncompressed
// 8/16-bit MONOCHROME1/2 pixel data — the same subset as the Python
// decoder (mmrp_tpu_torch/data/dicom.py), bit-for-bit compatible windowing math.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

struct DicomInfo {
  int rows = 0, cols = 0;
  int bits = 16;
  bool is_signed = false;
  bool mono1 = false;
  double slope = 1.0, intercept = 0.0;
  double wc = NAN, ww = NAN;
  const uint8_t* pixels = nullptr;
  size_t pixel_len = 0;
};

inline uint16_t rd16(const uint8_t* p) { return (uint16_t)(p[0] | (p[1] << 8)); }
inline uint32_t rd32(const uint8_t* p) {
  return (uint32_t)(p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24));
}

bool is_long_vr(const uint8_t* vr) {
  static const char* L[] = {"OB", "OW", "OF", "OD", "OL", "SQ", "UT", "UN", "UC", "UR"};
  for (auto s : L)
    if (vr[0] == s[0] && vr[1] == s[1]) return true;
  return false;
}

double parse_ds_first(const uint8_t* v, size_t n) {
  // decimal string, possibly multi-valued "40\\400" -> first value
  char buf[64];
  size_t m = 0;
  for (size_t i = 0; i < n && m < 63; ++i) {
    if (v[i] == '\\') break;
    buf[m++] = (char)v[i];
  }
  buf[m] = 0;
  return strtod(buf, nullptr);
}

int parse_int_value(const uint8_t* v, size_t n) {
  if (n == 2) return rd16(v);
  if (n == 4) return (int)rd32(v);
  char buf[32];
  size_t m = std::min(n, (size_t)31);
  memcpy(buf, v, m);
  buf[m] = 0;
  return atoi(buf);
}

// Parse the element stream; returns false on structural failure.
bool parse_elements(const uint8_t* p, size_t n, bool explicit_vr, DicomInfo* info) {
  size_t pos = 0;
  while (pos + 8 <= n) {
    uint16_t group = rd16(p + pos), elem = rd16(p + pos + 2);
    pos += 4;
    uint32_t length;
    if (explicit_vr) {
      const uint8_t* vr = p + pos;
      if (is_long_vr(vr)) {
        if (pos + 8 > n) return false;
        length = rd32(p + pos + 4);
        pos += 8;
      } else {
        if (pos + 4 > n) return false;
        length = rd16(p + pos + 2);
        pos += 4;
      }
    } else {
      if (pos + 4 > n) return false;
      length = rd32(p + pos);
      pos += 4;
    }
    if (length == 0xFFFFFFFFu) {
      // undefined length: scan for SequenceDelimitationItem (FFFE,E0DD)
      const uint8_t delim[8] = {0xFE, 0xFF, 0xDD, 0xE0, 0, 0, 0, 0};
      const uint8_t* found = nullptr;
      for (size_t i = pos; i + 8 <= n; ++i) {
        if (!memcmp(p + i, delim, 8)) { found = p + i; break; }
      }
      if (!found) return false;
      pos = (size_t)(found - p) + 8;
      continue;
    }
    if (pos + length > n) return false;
    const uint8_t* val = p + pos;
    if (group == 0x0028) {
      switch (elem) {
        case 0x0010: info->rows = parse_int_value(val, length); break;
        case 0x0011: info->cols = parse_int_value(val, length); break;
        case 0x0100: info->bits = parse_int_value(val, length); break;
        case 0x0103: info->is_signed = parse_int_value(val, length) == 1; break;
        case 0x0004:
          info->mono1 = length >= 11 && !memcmp(val, "MONOCHROME1", 11);
          break;
        case 0x1050: info->wc = parse_ds_first(val, length); break;
        case 0x1051: info->ww = parse_ds_first(val, length); break;
        case 0x1052: info->intercept = parse_ds_first(val, length); break;
        case 0x1053: info->slope = parse_ds_first(val, length); break;
      }
    } else if (group == 0x7FE0 && elem == 0x0010) {
      info->pixels = val;
      info->pixel_len = length;
    }
    pos += length;
  }
  return true;
}

bool parse_dicom(const uint8_t* buf, size_t n, DicomInfo* info) {
  if (n < 140) return false;
  size_t pos;
  bool explicit_vr = true;
  char ts[64] = {0};
  if (!memcmp(buf + 128, "DICM", 4)) {
    pos = 132;
    // file meta group: always explicit VR LE
    while (pos + 8 <= n) {
      uint16_t group = rd16(buf + pos);
      if (group != 0x0002) break;
      uint16_t elem = rd16(buf + pos + 2);
      const uint8_t* vr = buf + pos + 4;
      uint32_t length;
      size_t vstart;
      if (is_long_vr(vr)) {
        if (pos + 12 > n) return false;
        length = rd32(buf + pos + 8);
        vstart = pos + 12;
      } else {
        length = rd16(buf + pos + 6);
        vstart = pos + 8;
      }
      if (vstart > n || length > n - vstart) return false;
      if (elem == 0x0010 && length < 63) {
        memcpy(ts, buf + vstart, length);
        ts[length] = 0;
        // strip trailing nul/space
        for (int i = (int)length - 1; i >= 0 && (ts[i] == 0 || ts[i] == ' '); --i)
          ts[i] = 0;
      }
      pos = vstart + length;
    }
    if (!strcmp(ts, "1.2.840.10008.1.2"))
      explicit_vr = false;
    else if (ts[0] && strcmp(ts, "1.2.840.10008.1.2.1"))
      return false;  // compressed transfer syntaxes unsupported
  } else {
    pos = 0;
    explicit_vr = false;
  }
  if (pos > n) return false;
  return parse_elements(buf + pos, n - pos, explicit_vr, info) &&
         info->rows > 0 && info->cols > 0 && info->pixels != nullptr &&
         (info->bits == 8 || info->bits == 16) &&
         info->pixel_len >= (size_t)info->rows * info->cols * (info->bits / 8);
}

// window + normalize to [0,1], honoring MONOCHROME1 inversion
void window_to_float(const DicomInfo& info, float wc, float ww, float* out) {
  const int n = info.rows * info.cols;
  const float lower = wc - ww / 2.0f, upper = wc + ww / 2.0f;
  const float inv = 1.0f / std::max(upper - lower, 1e-8f);
  if (info.bits == 16) {
    if (info.is_signed) {
      const int16_t* px = (const int16_t*)info.pixels;
      for (int i = 0; i < n; ++i) {
        float v = std::min(std::max((float)px[i], lower), upper);
        out[i] = (v - lower) * inv;
      }
    } else {
      const uint16_t* px = (const uint16_t*)info.pixels;
      for (int i = 0; i < n; ++i) {
        float v = std::min(std::max((float)px[i], lower), upper);
        out[i] = (v - lower) * inv;
      }
    }
  } else {
    const uint8_t* px = info.pixels;
    for (int i = 0; i < n; ++i) {
      float v = std::min(std::max((float)px[i], lower), upper);
      out[i] = (v - lower) * inv;
    }
  }
  if (info.mono1)
    for (int i = 0; i < n; ++i) out[i] = 1.0f - out[i];
}

// bilinear resize with half-pixel centers (matches cv2/PIL convention and
// the Python fallback in mmrp_tpu/data/dicom.py)
void resize_bilinear(const float* src, int h, int w, float* dst, int oh, int ow) {
  for (int y = 0; y < oh; ++y) {
    float sy = (y + 0.5f) * h / oh - 0.5f;
    int y0 = std::min(std::max((int)floorf(sy), 0), h - 1);
    int y1 = std::min(y0 + 1, h - 1);
    float wy = std::min(std::max(sy - y0, 0.0f), 1.0f);
    for (int x = 0; x < ow; ++x) {
      float sx = (x + 0.5f) * w / ow - 0.5f;
      int x0 = std::min(std::max((int)floorf(sx), 0), w - 1);
      int x1 = std::min(x0 + 1, w - 1);
      float wx = std::min(std::max(sx - x0, 0.0f), 1.0f);
      float a = src[y0 * w + x0], b = src[y0 * w + x1];
      float c = src[y1 * w + x0], d = src[y1 * w + x1];
      dst[y * ow + x] = a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx +
                        c * wy * (1 - wx) + d * wy * wx;
    }
  }
}

// ---------------------------------------------------------------------------
// Worker pool (persistent; sized once)
// ---------------------------------------------------------------------------

class Pool {
 public:
  explicit Pool(int n) : stop_(false) {
    for (int i = 0; i < n; ++i)
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> job;
          {
            std::unique_lock<std::mutex> lk(mu_);
            cv_.wait(lk, [this] { return stop_ || !jobs_.empty(); });
            if (stop_ && jobs_.empty()) return;
            job = std::move(jobs_.front());
            jobs_.pop();
          }
          job();
        }
      });
  }
  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }
  void submit(std::function<void()> f) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      jobs_.push(std::move(f));
    }
    cv_.notify_one();
  }

 private:
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> jobs_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_;
};

Pool* pool() {
  static Pool p(std::max(2u, std::thread::hardware_concurrency()));
  return &p;
}

int preprocess_one(const uint8_t* buf, size_t len, float* out, int oh, int ow,
                   float mean, float std_, float default_wc, float default_ww) {
  DicomInfo info;
  if (!parse_dicom(buf, len, &info)) return -1;
  size_t need = (size_t)info.rows * info.cols * (info.bits / 8);
  if (info.pixel_len < need) return -2;
  float wc = std::isnan(info.wc) ? default_wc : (float)info.wc;
  float ww = std::isnan(info.ww) ? default_ww : (float)info.ww;

  std::vector<float> full((size_t)info.rows * info.cols);
  window_to_float(info, wc, ww, full.data());
  // uint8 quantization round-trip for parity with the PIL path
  // (tensorDICOM.py:149-151, mmrp_tpu/data/dicom.py)
  for (auto& v : full) v = (float)((uint8_t)(v * 255.0f)) / 255.0f;

  std::vector<float> resized((size_t)oh * ow);
  resize_bilinear(full.data(), info.rows, info.cols, resized.data(), oh, ow);
  const float inv_std = 1.0f / std_;
  for (int i = 0; i < oh * ow; ++i) out[i] = (resized[i] - mean) * inv_std;
  return 0;
}

}  // namespace

extern "C" {

// Decode + preprocess one in-memory DICOM -> (oh, ow) float map.
// Returns 0 on success.
int mmrp_preprocess(const uint8_t* buf, long len, float* out, int oh, int ow,
                    float mean, float std_, float default_wc, float default_ww) {
  return preprocess_one(buf, (size_t)len, out, oh, ow, mean, std_, default_wc,
                        default_ww);
}

// Batch variant over the worker pool. bufs/lens: arrays of n pointers/sizes;
// out: (n, oh, ow) contiguous. status: per-item return codes.
void mmrp_preprocess_batch(const uint8_t** bufs, const long* lens, int n,
                           float* out, int oh, int ow, float mean, float std_,
                           float default_wc, float default_ww, int* status) {
  std::atomic<int> remaining(n);
  std::mutex mu;
  std::condition_variable cv;
  for (int i = 0; i < n; ++i) {
    pool()->submit([=, &remaining, &cv, &mu] {
      status[i] = preprocess_one(bufs[i], (size_t)lens[i],
                                 out + (size_t)i * oh * ow, oh, ow, mean, std_,
                                 default_wc, default_ww);
      if (remaining.fetch_sub(1) == 1) {
        std::lock_guard<std::mutex> lk(mu);
        cv.notify_one();
      }
    });
  }
  std::unique_lock<std::mutex> lk(mu);
  cv.wait(lk, [&] { return remaining.load() == 0; });
}

// Raw decode only: rescale slope/intercept applied, no windowing.
// out must hold rows*cols floats (query dims first with mmrp_dicom_dims).
int mmrp_dicom_dims(const uint8_t* buf, long len, int* rows, int* cols) {
  DicomInfo info;
  if (!parse_dicom(buf, (size_t)len, &info)) return -1;
  *rows = info.rows;
  *cols = info.cols;
  return 0;
}

int mmrp_decode_raw(const uint8_t* buf, long len, float* out) {
  DicomInfo info;
  if (!parse_dicom(buf, (size_t)len, &info)) return -1;
  const int n = info.rows * info.cols;
  if (info.bits == 16) {
    if (info.is_signed) {
      const int16_t* px = (const int16_t*)info.pixels;
      for (int i = 0; i < n; ++i)
        out[i] = (float)(px[i] * info.slope + info.intercept);
    } else {
      const uint16_t* px = (const uint16_t*)info.pixels;
      for (int i = 0; i < n; ++i)
        out[i] = (float)(px[i] * info.slope + info.intercept);
    }
  } else {
    for (int i = 0; i < n; ++i)
      out[i] = (float)(info.pixels[i] * info.slope + info.intercept);
  }
  return 0;
}

}  // extern "C"
