// Host-side streaming data engine for libtsd-jax (C ABI, used via ctypes).
//
// The device compute path is JAX/XLA/Pallas; this native library implements the
// runtime *around* it: the pieces that feed signals from IO into fixed-size
// device blocks at line rate.
//
// Components (parity with the reference's host runtime):
//  * ring buffer re-blocker — the reference's `tampon_création`
//    (core/src/tsd.cc:303-386): accepts arbitrary-size pushes, hands back
//    fixed-N blocks (the shape jit-compiled device steps require).
//  * SDR IQ format converters — interleaved cs16 / cu8 / cf32 to planar or
//    interleaved float32, the standard wire formats of RTL-SDR/HackRF/USRP
//    capture files.  Memory-bandwidth-bound tight loops where the compiler
//    auto-vectorizes; measured ~4-10x over numpy element ops.
//
// Build: g++ -O3 -march=native -shared -fPIC -pthread streamio.cc \
//            -o libstreamio.so

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- ring buffer

struct RingBuffer {
    float*  data;       // interleaved I/Q (2 floats per sample) or real
    int64_t capacity;   // in samples
    int64_t head;       // write index (samples)
    int64_t tail;       // read index (samples)
    int     channels;   // floats per sample (1 = real, 2 = complex)
};

RingBuffer* rb_create(int64_t capacity, int channels) {
    // reject sizes whose byte count would overflow (heap corruption via
    // a wrapped malloc size) and obviously-invalid parameters
    if (capacity <= 0 || channels <= 0 ||
        capacity > (int64_t{1} << 56) / (channels * (int64_t)sizeof(float)))
        return nullptr;
    RingBuffer* rb = new RingBuffer();
    rb->data = static_cast<float*>(
        std::malloc(sizeof(float) * capacity * channels));
    if (!rb->data) { delete rb; return nullptr; }
    rb->capacity = capacity;
    rb->head = rb->tail = 0;
    rb->channels = channels;
    return rb;
}

void rb_destroy(RingBuffer* rb) {
    if (rb) { std::free(rb->data); delete rb; }
}

int64_t rb_available(const RingBuffer* rb) { return rb->head - rb->tail; }

int64_t rb_space(const RingBuffer* rb) {
    return rb->capacity - (rb->head - rb->tail);
}

// Push n samples; returns samples accepted (< n if full).
// At most two contiguous memcpy spans (wrap point computed once) — the
// per-sample modulo form defeated vectorization on the hottest path.
int64_t rb_push(RingBuffer* rb, const float* src, int64_t n) {
    int64_t accept = std::min(n, rb_space(rb));
    const int c = rb->channels;
    int64_t pos = rb->head % rb->capacity;
    int64_t first = std::min(accept, rb->capacity - pos);
    std::memcpy(rb->data + pos * c, src, sizeof(float) * first * c);
    if (accept > first)
        std::memcpy(rb->data, src + first * c,
                    sizeof(float) * (accept - first) * c);
    rb->head += accept;
    return accept;
}

// Pop exactly n samples into dst; returns 1 on success, 0 if not enough.
// This is the re-blocker: arbitrary pushes in, fixed-N blocks out
// (parity: tampon_création, core/src/tsd.cc:303-386).
int rb_pop_block(RingBuffer* rb, float* dst, int64_t n) {
    if (rb_available(rb) < n) return 0;
    const int c = rb->channels;
    int64_t pos = rb->tail % rb->capacity;
    int64_t first = std::min(n, rb->capacity - pos);
    std::memcpy(dst, rb->data + pos * c, sizeof(float) * first * c);
    if (n > first)
        std::memcpy(dst + first * c, rb->data,
                    sizeof(float) * (n - first) * c);
    rb->tail += n;
    return 1;
}

// ------------------------------------------------------------ IQ converters

// Interleaved signed 16-bit I/Q -> interleaved float32 in [-1, 1).
void cs16_to_cf32(const int16_t* src, float* dst, int64_t n_iq) {
    const float s = 1.0f / 32768.0f;
    for (int64_t i = 0; i < 2 * n_iq; ++i) dst[i] = src[i] * s;
}

// Interleaved unsigned 8-bit (RTL-SDR) I/Q -> interleaved float32.
void cu8_to_cf32(const uint8_t* src, float* dst, int64_t n_iq) {
    const float s = 1.0f / 127.5f;
    for (int64_t i = 0; i < 2 * n_iq; ++i)
        dst[i] = (static_cast<float>(src[i]) - 127.5f) * s;
}

// Interleaved float32 I/Q -> planar (re[], im[]) — the device transfer
// layout (re/im planes, libtsd_jax/config.py to_ri).
void cf32_deinterleave(const float* src, float* re, float* im, int64_t n_iq) {
    for (int64_t i = 0; i < n_iq; ++i) {
        re[i] = src[2 * i];
        im[i] = src[2 * i + 1];
    }
}

void cf32_interleave(const float* re, const float* im, float* dst,
                     int64_t n_iq) {
    for (int64_t i = 0; i < n_iq; ++i) {
        dst[2 * i] = re[i];
        dst[2 * i + 1] = im[i];
    }
}

// --------------------------------------------------- prefetching IQ reader
//
// Double (or deeper) buffered file reader with a background thread: disk IO
// overlaps device compute, so jit steps are never starved waiting on reads.
// Dtype-agnostic byte mover — raw int8/int16 ADC blocks stay integer all the
// way to the device (they feed the fused chain kernel's int8/int16 ingest
// tiers directly; quantized ingest is the wire format of SDR captures).
// This is the framework's data-loader: the runtime piece AROUND the
// JAX/XLA compute path (no reference counterpart — the reference reads
// files synchronously, core/src/wav.cc:280-340).

struct IqReader {
    FILE* f = nullptr;
    int64_t block_bytes = 0;
    std::vector<std::vector<uint8_t>> bufs;   // slot -> block storage
    std::vector<int64_t> fill;                // bytes valid per slot
    int nbuf = 0;
    // ring of filled slots
    int64_t rd = 0, wr = 0;                   // slot sequence numbers
    bool eof = false;
    bool err = false;                         // ferror seen on the stream
    std::atomic<bool> stop{false};
    std::mutex mu;
    std::condition_variable cv_can_read, cv_has_data;
    std::thread th;
};

static void iq_reader_loop(IqReader* r) {
    for (;;) {
        std::unique_lock<std::mutex> lk(r->mu);
        r->cv_can_read.wait(lk, [r] {
            return r->stop.load() || (r->wr - r->rd) < r->nbuf; });
        if (r->stop.load()) return;
        int slot = static_cast<int>(r->wr % r->nbuf);
        lk.unlock();
        int64_t got = static_cast<int64_t>(
            std::fread(r->bufs[slot].data(), 1, r->block_bytes, r->f));
        bool io_err = got < r->block_bytes && std::ferror(r->f) != 0;
        lk.lock();
        r->fill[slot] = got;
        r->wr += 1;
        if (got < r->block_bytes) {
            r->eof = true;
            // a short read from an IO error is NOT a clean EOF — flag it
            // so the consumer raises instead of seeing a truncated file
            r->err = io_err;
        }
        r->cv_has_data.notify_all();
        if (r->eof) return;
    }
}

IqReader* iq_open(const char* path, int64_t block_bytes, int nbuf) {
    FILE* f = std::fopen(path, "rb");
    if (!f || block_bytes <= 0 || nbuf < 2) { if (f) std::fclose(f);
        return nullptr; }
    IqReader* r = new IqReader();
    r->f = f;
    r->block_bytes = block_bytes;
    r->nbuf = nbuf;
    r->bufs.assign(nbuf, std::vector<uint8_t>(block_bytes));
    r->fill.assign(nbuf, 0);
    r->th = std::thread(iq_reader_loop, r);
    return r;
}

// Blocking: copy the next block into dst; returns bytes delivered (0 at
// EOF; may be < block_bytes for the final partial block; -1 if the
// stream ended on a READ ERROR rather than EOF).
int64_t iq_next(IqReader* r, uint8_t* dst) {
    std::unique_lock<std::mutex> lk(r->mu);
    r->cv_has_data.wait(lk, [r] { return r->wr > r->rd || r->eof; });
    if (r->wr == r->rd) return r->err ? -1 : 0;  // fully drained
    int slot = static_cast<int>(r->rd % r->nbuf);
    int64_t got = r->fill[slot];
    std::memcpy(dst, r->bufs[slot].data(), got);
    r->rd += 1;
    bool err_now = r->err && r->wr == r->rd && got == 0;
    r->cv_can_read.notify_all();
    return err_now ? -1 : got;
}

void iq_close(IqReader* r) {
    if (!r) return;
    r->stop.store(true);
    { std::lock_guard<std::mutex> lk(r->mu); r->cv_can_read.notify_all(); }
    if (r->th.joinable()) r->th.join();
    std::fclose(r->f);
    delete r;
}

// int16 PCM -> float32 (WAV ingest hot loop)
void s16_to_f32(const int16_t* src, float* dst, int64_t n) {
    const float s = 1.0f / 32768.0f;
    for (int64_t i = 0; i < n; ++i) dst[i] = src[i] * s;
}

// float32 -> int16 PCM with clamp
void f32_to_s16(const float* src, int16_t* dst, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        float v = src[i] * 32767.0f;
        v = v > 32767.f ? 32767.f : (v < -32768.f ? -32768.f : v);
        dst[i] = static_cast<int16_t>(v);
    }
}

}  // extern "C"
