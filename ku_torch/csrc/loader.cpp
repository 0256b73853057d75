// Native host-side input pipeline: threaded image preprocessing + prefetch.
//
// The reference's input pipeline is pure-Python: per-image scipy affine
// resize on the host (reference ku/image_utils/utility.py:29-94) inside
// Keras enqueuer workers (reference ku/backprop/gan.py:339-354). This
// module is the runtime's native equivalent: a C++ thread pool that
// performs bilinear resize + normalization off the GIL, feeding a bounded
// prefetch ring the trainer pops from. Device-side resize stays in
// ku_torch.image_utils (torch); this path covers host-bound decode/resize
// workloads where Python threads would serialize.
//
// C ABI (ctypes-friendly, no pybind11 dependency):
//   ku_loader_create(n_threads, capacity, out_h, out_w, channels) -> handle
//   ku_loader_submit(handle, img_u8, h, w, c)   // enqueue one HWC image
//   ku_loader_get(handle, out_f32)              // blocking pop, SUBMIT order
//   ku_loader_pending(handle)                   // submitted - popped
//   ku_loader_destroy(handle)
//
// Delivery order: get() returns results in the exact order submit() was
// called (jobs carry sequence ids; workers complete out of order but
// results are reordered before delivery), so a consumer pairing popped
// images with per-submit metadata (labels) stays aligned.
//
// Output: float32 in [-1, 1], aspect-preserving letterbox into
// (out_h, out_w), zero padding — matching
// ku_torch.image_utils.resize_image_to_target_symmeric_size semantics.

//
// PNG path (KU_HAS_PNG builds): ku_loader_submit_file(handle, path)
// enqueues a FILE; the worker thread reads + decodes the PNG with libpng
// (simplified png_image API) before resizing — the whole decode→resize→
// normalize chain runs off the GIL. A failed decode produces a zeroed
// output (delivery order must hold) and bumps ku_loader_errors().

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#ifdef KU_HAS_PNG
#include <png.h>
#endif

namespace {

struct Job {
  std::vector<uint8_t> data;
  std::string path;  // non-empty: decode this PNG in the worker
  int h = 0, w = 0, c = 0;
  long seq;
};

#ifdef KU_HAS_PNG
bool decode_png(const char* path, std::vector<uint8_t>& out, int* h, int* w,
                int* c) {
  png_image image;
  std::memset(&image, 0, sizeof image);
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_file(&image, path)) return false;
  image.format = PNG_FORMAT_RGB;
  out.resize(PNG_IMAGE_SIZE(image));
  if (!png_image_finish_read(&image, nullptr, out.data(), 0, nullptr)) {
    png_image_free(&image);
    return false;
  }
  *h = int(image.height);
  *w = int(image.width);
  *c = 3;
  return true;
}
#endif

// Results are returned in SUBMIT order regardless of worker completion
// order: each job carries a sequence id, finished results land in an
// ordered map, and get() blocks until the next-in-order id is ready.
// Workers still run fully concurrently — only delivery is ordered, so
// image/label pairing done by the submitter stays aligned.
struct Loader {
  int out_h, out_w, channels;
  size_t out_size;
  size_t capacity;

  std::deque<Job> in_queue;
  std::map<long, std::vector<float>> out_map;  // seq -> result
  std::mutex mu;
  std::condition_variable cv_in;    // workers wait for jobs
  std::condition_variable cv_out;   // consumers wait for results
  std::condition_variable cv_space; // producers wait for queue space
  std::vector<std::thread> workers;
  bool stop = false;           // guarded by mu
  long next_submit = 0;        // guarded by mu: seq of the next submit
  long next_pop = 0;           // guarded by mu: seq the next get() returns
  long errors = 0;             // guarded by mu: failed decodes (zeroed out)

  void worker_loop() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv_in.wait(lock, [&] { return stop || !in_queue.empty(); });
        if (stop && in_queue.empty()) return;
        job = std::move(in_queue.front());
        in_queue.pop_front();
        cv_space.notify_one();
      }
      bool ok = true;
      if (!job.path.empty()) {
#ifdef KU_HAS_PNG
        ok = decode_png(job.path.c_str(), job.data, &job.h, &job.w, &job.c);
#else
        ok = false;  // submit_file rejects earlier; defensive
#endif
      }
      std::vector<float> out(out_size, 0.0f);
      if (ok) process(job, out.data());
      {
        std::unique_lock<std::mutex> lock(mu);
        if (!ok) ++errors;  // zeroed result keeps delivery order intact
        out_map.emplace(job.seq, std::move(out));
      }
      // Consumers wait for a specific seq; wake them all so the one
      // waiting on job.seq re-checks its predicate.
      cv_out.notify_all();
    }
  }

  // Bilinear resize with aspect-preserving letterbox, normalize to [-1,1].
  void process(const Job& job, float* out) const {
    const int ih = job.h, iw = job.w, ic = job.c;
    // Scale to fit inside (out_h, out_w), preserving aspect.
    const float scale_h = float(out_h) / float(ih);
    const float scale_w = float(out_w) / float(iw);
    const float scale = scale_h < scale_w ? scale_h : scale_w;
    const int rh = int(ih * scale) > out_h ? out_h : int(ih * scale);
    const int rw = int(iw * scale) > out_w ? out_w : int(iw * scale);
    const int pad_t = (out_h - rh) / 2;
    const int pad_l = (out_w - rw) / 2;
    const int cc = ic < channels ? ic : channels;
    const uint8_t* src = job.data.data();

    for (int y = 0; y < rh; ++y) {
      // Align-corners=false bilinear sampling (matches jax.image 'linear').
      float sy = (y + 0.5f) * float(ih) / float(rh) - 0.5f;
      if (sy < 0) sy = 0;
      int y0 = int(sy);
      int y1 = y0 + 1 < ih ? y0 + 1 : ih - 1;
      float fy = sy - y0;
      for (int x = 0; x < rw; ++x) {
        float sx = (x + 0.5f) * float(iw) / float(rw) - 0.5f;
        if (sx < 0) sx = 0;
        int x0 = int(sx);
        int x1 = x0 + 1 < iw ? x0 + 1 : iw - 1;
        float fx = sx - x0;
        float* dst =
            out + size_t((y + pad_t) * out_w + (x + pad_l)) * channels;
        for (int ch = 0; ch < cc; ++ch) {
          const float v00 = src[(size_t(y0) * iw + x0) * ic + ch];
          const float v01 = src[(size_t(y0) * iw + x1) * ic + ch];
          const float v10 = src[(size_t(y1) * iw + x0) * ic + ch];
          const float v11 = src[(size_t(y1) * iw + x1) * ic + ch];
          const float top = v00 + (v01 - v00) * fx;
          const float bot = v10 + (v11 - v10) * fx;
          const float val = top + (bot - top) * fy;
          dst[ch] = val * (2.0f / 255.0f) - 1.0f;
        }
      }
    }
  }
};

}  // namespace

extern "C" {

void* ku_loader_create(int n_threads, int capacity, int out_h, int out_w,
                       int channels) {
  auto* L = new Loader();
  L->out_h = out_h;
  L->out_w = out_w;
  L->channels = channels;
  L->out_size = size_t(out_h) * out_w * channels;
  L->capacity = size_t(capacity) > 0 ? size_t(capacity) : 64;
  for (int i = 0; i < (n_threads > 0 ? n_threads : 4); ++i)
    L->workers.emplace_back([L] { L->worker_loop(); });
  return L;
}

void ku_loader_submit(void* handle, const uint8_t* img, int h, int w, int c) {
  auto* L = static_cast<Loader*>(handle);
  Job job;
  job.h = h;
  job.w = w;
  job.c = c;
  job.data.assign(img, img + size_t(h) * w * c);
  {
    std::unique_lock<std::mutex> lock(L->mu);
    L->cv_space.wait(lock, [L] {
      return L->in_queue.size() + L->out_map.size() < L->capacity;
    });
    // Seq assignment + queue push are one atomic step under mu, so the
    // "will a result for seq s ever arrive" predicate in get() is exact.
    job.seq = L->next_submit++;
    L->in_queue.push_back(std::move(job));
  }
  L->cv_in.notify_one();
}

// Returns 0 on success, 1 if the loader is stopping or nothing was
// submitted for this pop (the consumer must not interpret `out` then).
// Results come back in SUBMIT order; concurrent consumers each claim a
// distinct sequence slot under the mutex.
int ku_loader_get(void* handle, float* out) {
  auto* L = static_cast<Loader*>(handle);
  std::vector<float> result;
  {
    std::unique_lock<std::mutex> lock(L->mu);
    // Over-pop: no job with this seq was ever submitted → no deadlock.
    if (L->next_pop >= L->next_submit) return 1;
    const long want = L->next_pop++;
    L->cv_out.wait(lock, [L, want] {
      return L->stop || L->out_map.count(want) != 0;
    });
    auto it = L->out_map.find(want);
    if (it == L->out_map.end()) return 1;  // stopping
    result = std::move(it->second);
    L->out_map.erase(it);
    L->cv_space.notify_one();
  }
  std::memcpy(out, result.data(), result.size() * sizeof(float));
  return 0;
}

// 1 when this build decodes PNGs in-worker (libpng linked), else 0.
int ku_loader_has_png(void) {
#ifdef KU_HAS_PNG
  return 1;
#else
  return 0;
#endif
}

// Enqueue a PNG file for in-worker decode+resize. Returns 0 on success,
// 1 when this build has no libpng (caller should decode in Python).
int ku_loader_submit_file(void* handle, const char* path) {
#ifndef KU_HAS_PNG
  (void)handle;
  (void)path;
  return 1;
#else
  auto* L = static_cast<Loader*>(handle);
  Job job;
  job.path = path;
  {
    std::unique_lock<std::mutex> lock(L->mu);
    L->cv_space.wait(lock, [L] {
      return L->in_queue.size() + L->out_map.size() < L->capacity;
    });
    job.seq = L->next_submit++;
    L->in_queue.push_back(std::move(job));
  }
  L->cv_in.notify_one();
  return 0;
#endif
}

// Count of failed file decodes so far (each produced a zeroed output).
long ku_loader_errors(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lock(L->mu);
  return L->errors;
}

long ku_loader_pending(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lock(L->mu);
  return L->next_submit - L->next_pop;
}

void ku_loader_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  {
    std::unique_lock<std::mutex> lock(L->mu);
    L->stop = true;
  }
  L->cv_in.notify_all();
  L->cv_out.notify_all();  // wake any consumer blocked in get()
  L->cv_space.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
