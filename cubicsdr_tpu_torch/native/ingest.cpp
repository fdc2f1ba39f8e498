// Native ingest runtime: format conversion + bounded sample ring.
//
// The reference's device layer runs a dedicated thread converting CF32
// stream reads into batches pushed through bounded blocking queues
// (ref: src/sdr/SoapySDRThread.cpp:195-433 readStream/readLoop,
// src/util/ThreadBlockingQueue.h). This is its accelerator-host equivalent: tight
// SIMD-friendly conversion loops from wire formats into the PLANAR float32
// layout the device consumes, plus a mutex-guarded ring buffer providing
// the same bounded back-pressure semantics (try_push shedding when full,
// ref: SoapySDRThread.cpp:384-399).
//
// Built as a shared library, bound via ctypes (cubicsdr_tpu_torch/native/
// __init__.py). The port's copy of cubicsdr_tpu/native/ingest.cpp.

#include <algorithm>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <vector>

extern "C" {

// ---- wire-format conversions into planar float32 ----

void cs_deinterleave_cf32(const float* in, int64_t n, float* re, float* im) {
    for (int64_t i = 0; i < n; ++i) {
        re[i] = in[2 * i];
        im[i] = in[2 * i + 1];
    }
}

void cs_convert_cs16(const int16_t* in, int64_t n, float* re, float* im) {
    const float k = 1.0f / 32768.0f;
    for (int64_t i = 0; i < n; ++i) {
        re[i] = in[2 * i] * k;
        im[i] = in[2 * i + 1] * k;
    }
}

void cs_convert_cs8(const int8_t* in, int64_t n, float* re, float* im) {
    const float k = 1.0f / 128.0f;
    for (int64_t i = 0; i < n; ++i) {
        re[i] = in[2 * i] * k;
        im[i] = in[2 * i + 1] * k;
    }
}

void cs_convert_cu8(const uint8_t* in, int64_t n, float* re, float* im) {
    const float k = 1.0f / 127.5f;
    for (int64_t i = 0; i < n; ++i) {
        re[i] = (in[2 * i] - 127.5f) * k;
        im[i] = (in[2 * i + 1] - 127.5f) * k;
    }
}

// Audio float32 [-1,1] -> int16 PCM (WAV writer hot loop,
// ref: src/audio/AudioFileWAV.cpp write path).
void cs_float_to_pcm16(const float* in, int64_t n, int16_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        float v = in[i];
        if (v > 1.0f) v = 1.0f;
        if (v < -1.0f) v = -1.0f;
        out[i] = (int16_t)(v * 32767.0f);
    }
}

// ---- bounded planar sample ring (ThreadBlockingQueue + ReBuffer role) ----
//
// Element-size generic: the ring stores samples in their WIRE format
// (f32, cs16, cs8 planes) so native-format ingest ships fewer bytes to
// the device and converts on the accelerator's vector units instead of
// the host (the reference converts everything to CF32 host-side,
// ref: SoapySDRThread.cpp:253-343 — that spends host-to-device copy
// bandwidth on float32 planes).
//
// Framed layout: the storage holds 2 * cap samples in frames of F
// samples (F divides cap); sample s of plane p lives at element
// ((s / F) * 2 + p) * F + s % F, so a frame-aligned block of F samples is
// one contiguous [2, F] span. F == cap is two whole planes. The storage
// is the ring's own, or the caller's (pinned host memory the device
// copies a block out of in place).
//
// Held spans: cs_ring_acquire hands out the next frame-aligned block
// without copying it and keeps its samples in the fill until
// cs_ring_release frees it, oldest first. A read behind held spans is
// freed with the span after it.
//
// Waits: cs_ring_wait sleeps until n samples are readable; an accepted
// write notifies, and cs_ring_wake releases every waiter early (a reader
// being stopped or retired).

struct Ring {
    std::vector<uint8_t> own;   // the storage, unless the caller's
    uint8_t* buf = nullptr;     // 2 * cap samples, framed
    int64_t cap = 0;            // in samples
    int64_t frame = 0;          // F, samples per frame
    int64_t tail = 0;           // oldest sample not yet freed
    int64_t busy = 0;           // tail to the read position: held or read
    int64_t size = 0;           // tail to the write position (the fill)
    int64_t dropped = 0;
    int32_t elem = 4;           // bytes per sample per plane
    int64_t wakes = 0;          // cs_ring_wake calls
    std::deque<int64_t> held;   // each held span's frame, oldest first
    std::mutex mu;
    std::condition_variable readable;   // a write was accepted, or a wake
};

// A ring over ``storage`` (2 * capacity samples, which the caller keeps
// alive), or over storage of its own where that is null; null if the
// frame does not divide the capacity.
void* cs_ring_create(void* storage, int64_t capacity, int32_t elem_size,
                     int64_t frame) {
    if (capacity <= 0 || elem_size <= 0 || frame <= 0
        || capacity % frame != 0)
        return nullptr;
    Ring* r = new Ring();
    r->cap = capacity;
    r->elem = elem_size;
    r->frame = frame;
    if (storage == nullptr) {
        r->own.resize(2 * capacity * elem_size);
        storage = r->own.data();
    }
    r->buf = (uint8_t*)storage;
    return r;
}

void cs_ring_destroy(void* h) { delete (Ring*)h; }

// Copy n samples between the ring at sample pos and two flat planes, one
// segment per frame (a frame never crosses the wrap).
static void ring_copy(Ring* r, int64_t pos, int64_t n, uint8_t* re,
                      uint8_t* im, bool into_ring) {
    const int64_t e = r->elem, F = r->frame;
    for (int64_t done = 0; done < n;) {
        const int64_t off = pos % F;
        const int64_t seg = std::min(n - done, F - off);
        uint8_t* p0 = r->buf + ((pos / F) * 2 * F + off) * e;
        uint8_t* p1 = p0 + F * e;
        if (into_ring) {
            std::memcpy(p0, re + done * e, seg * e);
            std::memcpy(p1, im + done * e, seg * e);
        } else {
            std::memcpy(re + done * e, p0, seg * e);
            std::memcpy(im + done * e, p1, seg * e);
        }
        done += seg;
        pos = (pos + seg) % r->cap;
    }
}

// try_push semantics: if there is not enough room, the whole batch is
// dropped and counted (back-pressure shedding; the reference drops the
// batch when its queue is full rather than blocking the device thread).
// Held spans take room until they are released. An accepted write wakes
// the waiters once the copy is done and the lock is free.
int32_t cs_ring_write(void* h, const void* re, const void* im,
                      int64_t n) {
    Ring* r = (Ring*)h;
    {
        std::lock_guard<std::mutex> lock(r->mu);
        if (r->size + n > r->cap) {
            r->dropped += n;
            return 0;
        }
        ring_copy(r, (r->tail + r->size) % r->cap, n, (uint8_t*)re,
                  (uint8_t*)im, true);
        r->size += n;
    }
    r->readable.notify_all();
    return 1;
}

// Copies n samples out when that many are readable (else 0), without
// waiting: a reader that wants to sleep until then calls cs_ring_wait.
int32_t cs_ring_read(void* h, void* re, void* im, int64_t n) {
    Ring* r = (Ring*)h;
    std::lock_guard<std::mutex> lock(r->mu);
    if (r->size - r->busy < n) return 0;
    ring_copy(r, (r->tail + r->busy) % r->cap, n, (uint8_t*)re,
              (uint8_t*)im, false);
    if (r->held.empty()) {
        r->tail = (r->tail + n) % r->cap;
        r->size -= n;
    } else {
        r->busy += n;           // freed with the held span before it
    }
    return 1;
}

// Sleep until n samples are readable, timeout_us microseconds pass or
// cs_ring_wake is called; 1 if n samples are readable then, else 0.
int32_t cs_ring_wait(void* h, int64_t n, int64_t timeout_us) {
    Ring* r = (Ring*)h;
    std::unique_lock<std::mutex> lock(r->mu);
    const int64_t wakes = r->wakes;
    r->readable.wait_for(
        lock, std::chrono::microseconds(std::max<int64_t>(timeout_us, 0)),
        [&] { return r->size - r->busy >= n || r->wakes != wakes; });
    return r->size - r->busy >= n;
}

// Release every cs_ring_wait in progress, whatever the ring holds.
void cs_ring_wake(void* h) {
    Ring* r = (Ring*)h;
    {
        std::lock_guard<std::mutex> lock(r->mu);
        ++r->wakes;
    }
    r->readable.notify_all();
}

// The frame holding the next n readable samples, held until released;
// -1 unless n is one frame, the read position starts a frame and n
// samples are readable. Copies nothing.
int64_t cs_ring_acquire(void* h, int64_t n) {
    Ring* r = (Ring*)h;
    std::lock_guard<std::mutex> lock(r->mu);
    const int64_t pos = (r->tail + r->busy) % r->cap;
    if (n != r->frame || pos % r->frame != 0 || r->size - r->busy < n)
        return -1;
    r->held.push_back(pos / r->frame);
    r->busy += n;
    return pos / r->frame;
}

// Free the oldest held span (and reads behind it); 0 if none is held.
int32_t cs_ring_release(void* h) {
    Ring* r = (Ring*)h;
    std::lock_guard<std::mutex> lock(r->mu);
    if (r->held.empty()) return 0;
    r->held.pop_front();
    const int64_t freed = r->held.empty()
        ? r->busy
        : (r->held.front() * r->frame - r->tail + r->cap) % r->cap;
    r->tail = (r->tail + freed) % r->cap;
    r->busy -= freed;
    r->size -= freed;
    return 1;
}

int64_t cs_ring_fill(void* h) {
    Ring* r = (Ring*)h;
    std::lock_guard<std::mutex> lock(r->mu);
    return r->size;
}

int64_t cs_ring_readable(void* h) {
    Ring* r = (Ring*)h;
    std::lock_guard<std::mutex> lock(r->mu);
    return r->size - r->busy;
}

int64_t cs_ring_dropped(void* h) {
    Ring* r = (Ring*)h;
    std::lock_guard<std::mutex> lock(r->mu);
    return r->dropped;
}

}  // extern "C"
