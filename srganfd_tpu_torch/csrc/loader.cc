// Native data loader: multi-threaded JPEG/PNG decode + random crop +
// flip/rot90 augmentation producing float32 RGB [0,1] (or raw uint8) batches.
//
// The port's own copy of native/loader.cc, byte for byte the same streams:
// the C API, the per-sample mt19937 seeded by (seed, batch, i), the epoch
// shuffle, crop_augment and the libjpeg/libpng decode are unchanged. A C++
// thread pool with a bounded, batch-id-ordered queue keeps host decode off
// the Python interpreter; Python consumes batches over the ctypes C API
// (srganfd_tpu_torch/data/native_loader.py), which builds this file on first
// use with g++ -O3 -std=c++17 -shared -fPIC ... -ljpeg -lpng -lpthread.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <png.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <queue>
#include <random>
#include <string>
#include <thread>
#include <type_traits>
#include <vector>

namespace {

struct Image {
  int h = 0, w = 0;
  std::vector<uint8_t> rgb;  // h*w*3
};

// ---------------------------------------------------------------- decode

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

bool decode_jpeg(FILE* f, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->rgb.resize(size_t(out->h) * out->w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->rgb.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool decode_png(const char* path, Image* out) {
  png_image image;
  std::memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_file(&image, path)) return false;
  image.format = PNG_FORMAT_RGB;
  out->w = image.width;
  out->h = image.height;
  out->rgb.resize(PNG_IMAGE_SIZE(image));
  if (!png_image_finish_read(&image, nullptr, out->rgb.data(), 0, nullptr)) {
    png_image_free(&image);
    return false;
  }
  return true;
}

bool decode_file(const std::string& path, Image* out) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  uint8_t magic[8] = {0};
  size_t n = std::fread(magic, 1, 8, f);
  bool ok = false;
  if (n >= 3 && magic[0] == 0xFF && magic[1] == 0xD8) {
    std::rewind(f);
    ok = decode_jpeg(f, out);
    std::fclose(f);
  } else {
    std::fclose(f);
    if (n >= 8 && png_sig_cmp(magic, 0, 8) == 0) ok = decode_png(path.c_str(), out);
  }
  return ok && out->h > 0 && out->w > 0;
}

// ------------------------------------------------------------- transform

// Random square crop + optional rot90/flips into (H, W, 3), mirroring
// imgproc random_crop/random_rotate/flips (ESRGAN/imgproc.py:465-575
// semantics). T=float emits [0,1]; T=uint8_t emits raw bytes (the /255
// then happens on-device — 4x less host->device transfer).
template <typename T>
void crop_augment(const Image& img, int crop, bool train, std::mt19937& rng,
                  T* dst) {
  // reflect-extend on the fly if the image is smaller than the crop
  auto reflect = [](int v, int n) {
    if (n == 1) return 0;
    int period = 2 * n - 2;
    v = v % period;
    if (v < 0) v += period;
    return v < n ? v : period - v;
  };
  int max_top = img.h - crop, max_left = img.w - crop;
  int top, left;
  if (train) {
    std::uniform_int_distribution<int> dt(0, max_top > 0 ? max_top : 0);
    std::uniform_int_distribution<int> dl(0, max_left > 0 ? max_left : 0);
    top = dt(rng);
    left = dl(rng);
  } else {
    top = max_top > 0 ? max_top / 2 : 0;
    left = max_left > 0 ? max_left / 2 : 0;
  }
  int k = 0;
  bool hflip = false, vflip = false;
  if (train) {
    std::uniform_int_distribution<int> d4(0, 3);
    std::bernoulli_distribution d2(0.5);
    k = d4(rng);
    hflip = d2(rng);
    vflip = d2(rng);
  }
  const float inv = 1.0f / 255.0f;
  for (int y = 0; y < crop; ++y) {
    for (int x = 0; x < crop; ++x) {
      // inverse-map destination (y, x) through rot90^k + flips
      int sy = y, sx = x;
      if (vflip) sy = crop - 1 - sy;
      if (hflip) sx = crop - 1 - sx;
      for (int r = 0; r < k; ++r) {  // inverse of ccw rot90: rotate cw
        int t = sy;
        sy = sx;
        sx = crop - 1 - t;
      }
      int iy = reflect(top + sy, img.h);
      int ix = reflect(left + sx, img.w);
      const uint8_t* p = img.rgb.data() + (size_t(iy) * img.w + ix) * 3;
      T* d = dst + (size_t(y) * crop + x) * 3;
      if constexpr (std::is_same_v<T, float>) {
        d[0] = p[0] * inv;
        d[1] = p[1] * inv;
        d[2] = p[2] * inv;
      } else {
        d[0] = p[0];
        d[1] = p[1];
        d[2] = p[2];
      }
    }
  }
}

// ----------------------------------------------------------------- loader

struct Loader {
  std::vector<std::string> paths;
  int crop, batch, threads;
  bool train;
  uint64_t seed;

  std::vector<std::thread> workers;
  // Batches are assembled concurrently but EMITTED in batch-id order: a
  // worker parks its finished batch in `ready` keyed by id and next()
  // releases only `next_emit`. This makes the emitted stream a pure
  // function of (seed, start batch) — deterministic across restarts and
  // thread counts, which exact mid-run resume (and the python loader's
  // restart-determinism contract) requires. A plain FIFO queue raced:
  // whichever worker finished first was emitted first.
  std::map<uint64_t, std::vector<uint8_t>> ready;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::atomic<bool> stop{false};
  std::atomic<uint64_t> batch_counter{0};
  uint64_t next_emit = 0;  // guarded by mu
  size_t max_queue = 8;

  // Decoded-image cache (first-fill, no eviction, byte-budgeted via
  // SRGANFD_LOADER_CACHE_MB, default 2048; 0 disables). PNG/JPEG decode
  // dominates batch assembly on few-core hosts (321 of 394 ms/step in
  // the v5e pipeline profile); epochs revisit every image, so caching
  // decoded RGB makes steady-state cost crop+augment only.
  std::vector<std::shared_ptr<const Image>> cache;
  std::mutex cache_mu;
  size_t cache_bytes = 0;
  size_t cache_budget = 0;

  std::shared_ptr<const Image> get_image(size_t idx) {
    if (cache_budget) {
      std::lock_guard<std::mutex> lk(cache_mu);
      if (cache[idx]) return cache[idx];
    }
    auto img = std::make_shared<Image>();
    if (!decode_file(paths[idx], img.get())) return nullptr;
    if (cache_budget) {
      size_t sz = img->rgb.size() + sizeof(Image);
      std::lock_guard<std::mutex> lk(cache_mu);
      if (!cache[idx] && cache_bytes + sz <= cache_budget) {
        cache[idx] = img;
        cache_bytes += sz;
      }
    }
    return img;
  }

  bool u8 = false;  // emit uint8 batches (device-side /255)

  void worker_loop() {
    const size_t batch_elems = size_t(batch) * crop * crop * 3;
    const size_t batch_bytes = batch_elems * (u8 ? 1 : sizeof(float));
    // per-worker cached epoch permutation (rebuilding it per sample would
    // be O(dataset^2) per batch on large datasets)
    uint64_t cached_epoch = ~0ull;
    std::vector<uint32_t> order(paths.size());
    while (!stop.load()) {
      uint64_t b = batch_counter.fetch_add(1);
      std::vector<uint8_t> buf(batch_bytes);
      const size_t sample_elems = size_t(crop) * crop * 3;
      for (int i = 0; i < batch; ++i) {
        std::mt19937 rng(uint32_t(seed ^ (b * 9973 + i) * 2654435761u));
        // epoch-shuffled index stream, seeded like the python loader
        uint64_t epoch = (b * batch + i) / paths.size();
        if (epoch != cached_epoch) {
          for (uint32_t j = 0; j < order.size(); ++j) order[j] = j;
          if (train) {
            std::mt19937 order_rng(uint32_t(seed + epoch));
            std::shuffle(order.begin(), order.end(), order_rng);
          }
          cached_epoch = epoch;
        }
        size_t idx = order[(b * batch + i) % paths.size()];
        std::shared_ptr<const Image> img = get_image(idx);
        if (!img) {
          std::memset(buf.data() + size_t(i) * sample_elems * (u8 ? 1 : 4), 0,
                      sample_elems * (u8 ? 1 : 4));
          continue;
        }
        if (u8) {
          crop_augment<uint8_t>(*img, crop, train, rng,
                                buf.data() + size_t(i) * sample_elems);
        } else {
          crop_augment<float>(
              *img, crop, train, rng,
              reinterpret_cast<float*>(buf.data()) + size_t(i) * sample_elems);
        }
      }
      std::unique_lock<std::mutex> lk(mu);
      // reserve space by batch id: the holder of next_emit can always
      // push (b - next_emit == 0 < max_queue), so ordered emission can't
      // deadlock even when later batches finish first
      cv_space.wait(lk, [&] { return b - next_emit < max_queue || stop.load(); });
      if (stop.load()) return;
      ready.emplace(b, std::move(buf));
      cv_ready.notify_one();
    }
  }

  void start() {
    for (int i = 0; i < threads; ++i)
      workers.emplace_back([this] { worker_loop(); });
  }

  bool next(void* out) {
    std::unique_lock<std::mutex> lk(mu);
    cv_ready.wait(lk, [&] { return ready.count(next_emit) != 0 || stop.load(); });
    auto it = ready.find(next_emit);
    if (it == ready.end()) return false;
    std::vector<uint8_t> buf = std::move(it->second);
    ready.erase(it);
    ++next_emit;
    // all parked producers re-check their b-relative space predicate
    cv_space.notify_all();
    lk.unlock();
    std::memcpy(out, buf.data(), buf.size());
    return true;
  }

  ~Loader() {
    stop.store(true);
    cv_ready.notify_all();
    cv_space.notify_all();
    for (auto& t : workers)
      if (t.joinable()) t.join();
  }
};

}  // namespace

extern "C" {

void* loader_create3(const char** paths, int n_paths, int crop, int batch,
                     uint64_t seed, int n_threads, int train, int out_u8,
                     uint64_t start_batch) {
  auto* l = new Loader();
  l->paths.assign(paths, paths + n_paths);
  l->crop = crop;
  l->batch = batch;
  l->seed = seed;
  l->threads = n_threads > 0 ? n_threads : 4;
  l->train = train != 0;
  l->u8 = out_u8 != 0;
  // O(1) seek: every batch is a pure function of (seed, batch id) — the
  // per-sample RNG and the epoch permutation are both derived from `b`
  // alone — so resuming at batch k just starts the counters there.
  l->batch_counter.store(start_batch);
  l->next_emit = start_batch;
  const char* mb = std::getenv("SRGANFD_LOADER_CACHE_MB");
  size_t budget_mb = mb ? size_t(std::strtoull(mb, nullptr, 10)) : 2048;
  l->cache_budget = budget_mb << 20;
  if (l->cache_budget) l->cache.resize(l->paths.size());
  l->start();
  return l;
}

void* loader_create2(const char** paths, int n_paths, int crop, int batch,
                     uint64_t seed, int n_threads, int train, int out_u8) {
  return loader_create3(paths, n_paths, crop, batch, seed, n_threads, train,
                        out_u8, 0);
}

// Legacy ABI entry (pre-uint8-transport callers): float32 output.
void* loader_create(const char** paths, int n_paths, int crop, int batch,
                    uint64_t seed, int n_threads, int train) {
  return loader_create3(paths, n_paths, crop, batch, seed, n_threads, train, 0,
                        0);
}

int loader_next(void* handle, void* out) {
  if (handle == nullptr) return 0;
  return static_cast<Loader*>(handle)->next(out) ? 1 : 0;
}

void loader_destroy(void* handle) { delete static_cast<Loader*>(handle); }

// single-image decode for inference paths
int decode_image(const char* path, float* out, int max_h, int max_w,
                 int* out_h, int* out_w) {
  Image img;
  if (!decode_file(path, &img)) return 0;
  if (img.h > max_h || img.w > max_w) return -1;
  *out_h = img.h;
  *out_w = img.w;
  const float inv = 1.0f / 255.0f;
  for (size_t i = 0; i < img.rgb.size(); ++i) out[i] = img.rgb[i] * inv;
  return 1;
}
}
