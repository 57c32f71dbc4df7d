// Multi-stream batch scheduler: assembles the per-step device batch from
// N independent decode threads.
//
// Role: the serving deployment (BASELINE configs[4]) feeds a stream-sharded
// device step with one frame per stream per step.  Decoders run at their
// own (jittery) rates on host threads; this component gives each stream an
// SPSC ring and a single gather call that builds the [n_streams, frame]
// batch with a repeat-last-frame policy for late streams — the host-side
// "executor" between decode and the pjit'd step.  C ABI for ctypes
// (no pybind11 in this environment); a pure-Python fallback lives in
// jaxmot/native/__init__.py.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// From ingest.cc (linked into the same shared object).
void* jaxmot_ring_create(int32_t capacity, int64_t frame_bytes);
void jaxmot_ring_destroy(void* ring);
int32_t jaxmot_ring_push(void* ring, const uint8_t* data, int64_t bytes);
int64_t jaxmot_ring_pop(void* ring, uint8_t* out, int64_t capacity);
int32_t jaxmot_ring_size(void* ring);

struct StreamScheduler {
  int32_t n_streams = 0;
  int64_t frame_bytes = 0;
  std::vector<void*> rings;
  std::vector<uint8_t> last;          // last delivered frame per stream
  std::vector<uint8_t> has_last;      // 0/1 per stream
  std::vector<std::atomic<int64_t>> dropped;   // push-side ring-full drops
  std::vector<int64_t> repeated;      // gather slots filled by repeat
  std::vector<int64_t> fresh_count;   // gather slots filled by a new frame
};

void* jaxmot_sched_create(int32_t n_streams, int32_t ring_capacity,
                          int64_t frame_bytes) {
  auto* s = new StreamScheduler();
  s->n_streams = n_streams;
  s->frame_bytes = frame_bytes;
  s->rings.resize(n_streams);
  for (int32_t i = 0; i < n_streams; ++i)
    s->rings[i] = jaxmot_ring_create(ring_capacity, frame_bytes);
  s->last.resize(static_cast<int64_t>(n_streams) * frame_bytes);
  s->has_last.assign(n_streams, 0);
  s->dropped = std::vector<std::atomic<int64_t>>(n_streams);
  for (auto& d : s->dropped) d.store(0);
  s->repeated.assign(n_streams, 0);
  s->fresh_count.assign(n_streams, 0);
  return s;
}

void jaxmot_sched_destroy(void* sched) {
  auto* s = static_cast<StreamScheduler*>(sched);
  for (void* r : s->rings) jaxmot_ring_destroy(r);
  delete s;
}

// Push one decoded frame for `stream` (callable from that stream's decode
// thread — each ring is SPSC).  Returns 1 on success, 0 when the ring is
// full (the frame is dropped and counted; real-time policy: never block
// the decoder).
int32_t jaxmot_sched_push(void* sched, int32_t stream, const uint8_t* data,
                          int64_t bytes) {
  auto* s = static_cast<StreamScheduler*>(sched);
  if (stream < 0 || stream >= s->n_streams) return 0;
  const int32_t ok = jaxmot_ring_push(s->rings[stream], data, bytes);
  if (!ok) s->dropped[stream].fetch_add(1, std::memory_order_relaxed);
  return ok;
}

// Assemble one batch: out is [n_streams * frame_bytes]; fresh[i] is set to
// 1 when stream i contributed a new frame, 0 when its last frame was
// repeated.  Returns the number of fresh streams, or -1 if some stream has
// never produced a frame yet (batch incomplete — caller retries).
// Single-consumer: call from the device-feeding thread only.
int32_t jaxmot_sched_gather(void* sched, uint8_t* out, uint8_t* fresh) {
  auto* s = static_cast<StreamScheduler*>(sched);
  // Readiness precheck so an incomplete batch consumes nothing (rings only
  // grow from the producer side, so a positive check cannot go stale).
  for (int32_t i = 0; i < s->n_streams; ++i)
    if (!s->has_last[i] && jaxmot_ring_size(s->rings[i]) == 0) return -1;
  int32_t n_fresh = 0;
  for (int32_t i = 0; i < s->n_streams; ++i) {
    uint8_t* slot_out = out + static_cast<int64_t>(i) * s->frame_bytes;
    uint8_t* slot_last = s->last.data()
                         + static_cast<int64_t>(i) * s->frame_bytes;
    const int64_t got = jaxmot_ring_pop(s->rings[i], slot_last,
                                        s->frame_bytes);
    if (got > 0) {
      s->has_last[i] = 1;
      s->fresh_count[i] += 1;
      if (fresh) fresh[i] = 1;
      ++n_fresh;
    } else {
      s->repeated[i] += 1;                // precheck guarantees has_last
      if (fresh) fresh[i] = 0;
    }
    std::memcpy(slot_out, slot_last, s->frame_bytes);
  }
  return n_fresh;
}

// Per-stream counters: dropped (push-side), repeated, fresh (gather-side).
void jaxmot_sched_stats(void* sched, int64_t* dropped, int64_t* repeated,
                        int64_t* fresh) {
  auto* s = static_cast<StreamScheduler*>(sched);
  for (int32_t i = 0; i < s->n_streams; ++i) {
    if (dropped) dropped[i] = s->dropped[i].load(std::memory_order_relaxed);
    if (repeated) repeated[i] = s->repeated[i];
    if (fresh) fresh[i] = s->fresh_count[i];
  }
}

}  // extern "C"
