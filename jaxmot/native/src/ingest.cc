// Native ingest runtime: MOT det-file parsing, colorspace conversion, and
// a SPSC frame ring buffer for decode->device staging.
//
// Role: the reference's data loading / demo IO is native C++ (SURVEY.md
// section 2 rows "det-file reader" and "video/sequence IO"); these are the
// framework's host-runtime equivalents, exposed over a C ABI for
// ctypes (no pybind11 in this environment).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// MOT det.txt parsing: "frame,id,x,y,w,h,score,..." lines.
// First call with out=nullptr to get the row count, then with a buffer of
// rows*7 doubles (frame, id, x, y, w, h, score). Returns rows, -1 on error.
int64_t jaxmot_parse_mot_csv(const char* path, double* out,
                             int64_t capacity_rows) {
  FILE* f = std::fopen(path, "r");
  if (!f) return -1;
  char line[4096];
  int64_t rows = 0;
  while (std::fgets(line, sizeof(line), f)) {
    double v[7] = {0, 0, 0, 0, 0, 0, 1.0};
    int n = 0;
    char* p = line;
    while (n < 7 && *p) {
      char* end = nullptr;
      const double x = std::strtod(p, &end);
      if (end == p) break;
      v[n++] = x;
      p = end;
      while (*p == ',' || *p == ' ') ++p;
    }
    if (n >= 6) {
      if (out) {
        if (rows >= capacity_rows) break;
        std::memcpy(out + rows * 7, v, sizeof(v));
      }
      ++rows;
    }
  }
  std::fclose(f);
  return rows;
}

// ---------------------------------------------------------------------
// Interleaved BGR (OpenCV default) u8 -> grayscale u8, BT.601.
void jaxmot_bgr_to_gray(const uint8_t* bgr, int64_t n_px, uint8_t* gray) {
  for (int64_t i = 0; i < n_px; ++i) {
    const uint32_t b = bgr[3 * i], g = bgr[3 * i + 1], r = bgr[3 * i + 2];
    // Fixed-point BT.601: (77 R + 150 G + 29 B) >> 8.
    gray[i] = static_cast<uint8_t>((77 * r + 150 * g + 29 * b) >> 8);
  }
}

// ---------------------------------------------------------------------
// Single-producer single-consumer frame ring buffer: the decode thread
// pushes frames, the device-feeding thread pops, no locks on the fast
// path (acquire/release atomics).
struct FrameRing {
  std::vector<uint8_t> storage;
  std::vector<int64_t> sizes;
  int64_t frame_bytes = 0;
  int32_t capacity = 0;
  std::atomic<int64_t> head{0};   // next slot to write
  std::atomic<int64_t> tail{0};   // next slot to read
};

void* jaxmot_ring_create(int32_t capacity, int64_t frame_bytes) {
  auto* r = new FrameRing();
  r->capacity = capacity;
  r->frame_bytes = frame_bytes;
  r->storage.resize(static_cast<int64_t>(capacity) * frame_bytes);
  r->sizes.assign(capacity, 0);
  return r;
}

void jaxmot_ring_destroy(void* ring) {
  delete static_cast<FrameRing*>(ring);
}

// Returns 1 on success, 0 when the ring is full (caller retries/drops).
int32_t jaxmot_ring_push(void* ring, const uint8_t* data, int64_t bytes) {
  auto* r = static_cast<FrameRing*>(ring);
  const int64_t head = r->head.load(std::memory_order_relaxed);
  const int64_t tail = r->tail.load(std::memory_order_acquire);
  if (head - tail >= r->capacity || bytes > r->frame_bytes) return 0;
  const int64_t slot = head % r->capacity;
  std::memcpy(r->storage.data() + slot * r->frame_bytes, data, bytes);
  r->sizes[slot] = bytes;
  r->head.store(head + 1, std::memory_order_release);
  return 1;
}

// Returns bytes popped, 0 when empty.
int64_t jaxmot_ring_pop(void* ring, uint8_t* out, int64_t capacity) {
  auto* r = static_cast<FrameRing*>(ring);
  const int64_t tail = r->tail.load(std::memory_order_relaxed);
  const int64_t head = r->head.load(std::memory_order_acquire);
  if (head == tail) return 0;
  const int64_t slot = tail % r->capacity;
  const int64_t bytes = r->sizes[slot];
  if (bytes > capacity) return -1;
  std::memcpy(out, r->storage.data() + slot * r->frame_bytes, bytes);
  r->tail.store(tail + 1, std::memory_order_release);
  return bytes;
}

int32_t jaxmot_ring_size(void* ring) {
  auto* r = static_cast<FrameRing*>(ring);
  return static_cast<int32_t>(r->head.load(std::memory_order_acquire)
                              - r->tail.load(std::memory_order_acquire));
}

}  // extern "C"
