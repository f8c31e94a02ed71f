// vfpio: native .rawv streaming for vfp_tpu_torch (the file half of
// vfp_tpu/native/vfpio.cpp).
//
// Moves frame file I/O off the GIL: a producer thread reads frames from a
// raw frame file into a ring of preallocated buffers while Python and the
// device consume earlier batches.  The writer mirrors it with a consumer
// thread draining a ring into a file.
//
// C ABI (ctypes-friendly):
//   void* vfpio_reader_open_file(const char* path, long frame_bytes, int ring, long skip)
//   long  vfpio_read_batch(void* h, unsigned char* out, long max_frames)
//   void  vfpio_reader_close(void* h)
//   void* vfpio_writer_open_file(const char* path, long frame_bytes, int ring)
//   long  vfpio_write_batch(void* h, const unsigned char* data, long frames)
//   int   vfpio_writer_close(void* h)

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Ring {
    std::vector<std::vector<unsigned char>> slots;
    std::vector<long> fill;  // bytes valid in slot
    size_t head = 0, tail = 0, count = 0;
    std::mutex mu;
    std::condition_variable cv_put, cv_get;
    bool done = false;

    explicit Ring(int n, long cap) : slots(n), fill(n, 0) {
        for (auto& s : slots) s.resize(cap);
    }
};

struct Reader {
    FILE* f = nullptr;
    long frame_bytes = 0;
    long batch_frames = 0;
    Ring* ring = nullptr;
    std::thread th;

    void produce() {
        const long cap = frame_bytes * batch_frames;
        for (;;) {
            std::unique_lock<std::mutex> lk(ring->mu);
            ring->cv_put.wait(lk, [&] { return ring->count < ring->slots.size() || ring->done; });
            if (ring->done) break;
            size_t slot = ring->head;
            lk.unlock();

            long got = (long)fread(ring->slots[slot].data(), 1, cap, f);
            // only whole frames
            got -= got % frame_bytes;

            lk.lock();
            ring->fill[slot] = got;
            ring->head = (ring->head + 1) % ring->slots.size();
            ring->count++;
            bool eof = got < cap;
            if (eof) ring->done = true;
            lk.unlock();
            ring->cv_get.notify_one();
            if (eof) break;
        }
        ring->cv_get.notify_all();
    }
};

struct Writer {
    FILE* f = nullptr;
    long frame_bytes = 0;
    long batch_frames = 0;
    Ring* ring = nullptr;
    std::thread th;
    std::atomic<bool> error{false};

    void consume() {
        for (;;) {
            std::unique_lock<std::mutex> lk(ring->mu);
            ring->cv_get.wait(lk, [&] { return ring->count > 0 || ring->done; });
            if (ring->count == 0 && ring->done) break;
            size_t slot = ring->tail;
            long n = ring->fill[slot];
            lk.unlock();

            if ((long)fwrite(ring->slots[slot].data(), 1, n, f) != n) error = true;

            lk.lock();
            ring->tail = (ring->tail + 1) % ring->slots.size();
            ring->count--;
            lk.unlock();
            ring->cv_put.notify_one();
        }
    }
};

constexpr long kBatchFrames = 16;

}  // namespace

extern "C" {

void* vfpio_reader_open_file(const char* path, long frame_bytes, int ring, long skip) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    if (skip > 0) fseek(f, skip, SEEK_SET);
    auto* r = new Reader();
    r->f = f;
    r->frame_bytes = frame_bytes;
    r->batch_frames = kBatchFrames;
    r->ring = new Ring(ring > 0 ? ring : 4, frame_bytes * kBatchFrames);
    r->th = std::thread([r] { r->produce(); });
    return r;
}

long vfpio_read_batch(void* h, unsigned char* out, long max_frames) {
    auto* r = static_cast<Reader*>(h);
    long want = max_frames * r->frame_bytes;
    long copied = 0;
    while (copied < want) {
        std::unique_lock<std::mutex> lk(r->ring->mu);
        r->ring->cv_get.wait(lk, [&] { return r->ring->count > 0 || r->ring->done; });
        if (r->ring->count == 0) break;  // done and drained
        size_t slot = r->ring->tail;
        long avail = r->ring->fill[slot];
        long take = std::min(avail, want - copied);
        lk.unlock();

        memcpy(out + copied, r->ring->slots[slot].data(), take);
        copied += take;

        lk.lock();
        if (take == avail) {
            r->ring->tail = (r->ring->tail + 1) % r->ring->slots.size();
            r->ring->count--;
            lk.unlock();
            r->ring->cv_put.notify_one();
        } else {
            // partial consume: shift remainder to front
            auto& s = r->ring->slots[slot];
            memmove(s.data(), s.data() + take, avail - take);
            r->ring->fill[slot] = avail - take;
            lk.unlock();
        }
    }
    return copied / r->frame_bytes;
}

void vfpio_reader_close(void* h) {
    auto* r = static_cast<Reader*>(h);
    {
        std::lock_guard<std::mutex> lk(r->ring->mu);
        r->ring->done = true;
    }
    r->ring->cv_put.notify_all();
    r->ring->cv_get.notify_all();
    if (r->th.joinable()) r->th.join();
    fclose(r->f);
    delete r->ring;
    delete r;
}

void* vfpio_writer_open_file(const char* path, long frame_bytes, int ring) {
    FILE* f = fopen(path, "ab");
    if (!f) return nullptr;
    auto* w = new Writer();
    w->f = f;
    w->frame_bytes = frame_bytes;
    w->batch_frames = kBatchFrames;
    w->ring = new Ring(ring > 0 ? ring : 4, frame_bytes * kBatchFrames);
    w->th = std::thread([w] { w->consume(); });
    return w;
}

long vfpio_write_batch(void* h, const unsigned char* data, long frames) {
    auto* w = static_cast<Writer*>(h);
    long total = frames * w->frame_bytes;
    long pushed = 0;
    const long cap = w->frame_bytes * w->batch_frames;
    while (pushed < total) {
        std::unique_lock<std::mutex> lk(w->ring->mu);
        w->ring->cv_put.wait(lk, [&] { return w->ring->count < w->ring->slots.size(); });
        size_t slot = w->ring->head;
        lk.unlock();

        long take = std::min(cap, total - pushed);
        memcpy(w->ring->slots[slot].data(), data + pushed, take);
        pushed += take;

        lk.lock();
        w->ring->fill[slot] = take;
        w->ring->head = (w->ring->head + 1) % w->ring->slots.size();
        w->ring->count++;
        lk.unlock();
        w->ring->cv_get.notify_one();
    }
    return w->error ? -1 : frames;
}

int vfpio_writer_close(void* h) {
    auto* w = static_cast<Writer*>(h);
    {
        std::lock_guard<std::mutex> lk(w->ring->mu);
        w->ring->done = true;
    }
    w->ring->cv_get.notify_all();
    if (w->th.joinable()) w->th.join();
    int rc = w->error ? -1 : 0;
    fclose(w->f);
    delete w->ring;
    delete w;
    return rc;
}

}  // extern "C"
