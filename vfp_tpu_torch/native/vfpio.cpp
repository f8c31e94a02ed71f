// vfpio: native frame streaming for vfp_tpu_torch (the streaming half of
// vfp_tpu/native/vfpio.cpp).
//
// Moves frame I/O off the GIL: a producer thread reads frames from a raw
// frame file, or from the stdout of a command that writes rawvideo, into a
// ring of preallocated buffers while Python and the device consume earlier
// batches.  The writer mirrors it with a consumer thread draining a ring
// into a file or a command's stdin.  A command runs under /bin/sh -c in a
// child of its own, so that close can reap it and report its exit.
//
// C ABI (ctypes-friendly):
//   void* vfpio_reader_open_file(const char* path, long frame_bytes, int ring, long skip)
//   void* vfpio_reader_open_cmd (const char* cmd,  long frame_bytes, int ring)
//   long  vfpio_read_batch(void* h, unsigned char* out, long max_frames)
//   int   vfpio_reader_close(void* h)
//   void* vfpio_writer_open_file(const char* path, long frame_bytes, int ring)
//   void* vfpio_writer_open_cmd (const char* cmd,  long frame_bytes, int ring)
//   long  vfpio_write_batch(void* h, const unsigned char* data, long frames)
//   int   vfpio_writer_close(void* h)
//
// reader_close returns 0 for a file, and for a command its exit code
// (128 + the signal for a child a signal ended) once the stream reached its
// end or the child had exited; a child still running is killed and 0
// returned.  writer_close returns -1 on a write error, else 0 for a file
// and the command's exit code (as above) once it has read its stdin's end.

#include <fcntl.h>
#include <signal.h>
#include <spawn.h>
#include <sys/wait.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

extern char** environ;

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
    pid_t child = 0;  // the command's process, 0 for a file
    bool at_end = false;  // the producer read the stream's end
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
            if (eof) ring->done = at_end = true;
            lk.unlock();
            ring->cv_get.notify_one();
            if (eof) break;
        }
        ring->cv_get.notify_all();
    }
};

struct Writer {
    FILE* f = nullptr;
    pid_t child = 0;  // the command's process, 0 for a file
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

// /bin/sh -c cmd in a new process with its stdout (read) or stdin (write) on
// a pipe; our end of the pipe as a FILE, the child's pid in *pid.
FILE* spawn_pipe(const char* cmd, bool read, pid_t* pid) {
    int fds[2];
    if (pipe(fds) != 0) return nullptr;
    const int ours = read ? fds[0] : fds[1], theirs = read ? fds[1] : fds[0];
    fcntl(ours, F_SETFD, FD_CLOEXEC);  // no later child inherits our end
    posix_spawn_file_actions_t fa;
    posix_spawn_file_actions_init(&fa);
    posix_spawn_file_actions_adddup2(&fa, theirs, read ? STDOUT_FILENO : STDIN_FILENO);
    posix_spawn_file_actions_addclose(&fa, theirs);
    posix_spawn_file_actions_addclose(&fa, ours);
    const char* argv[] = {"sh", "-c", cmd, nullptr};
    const int rc = posix_spawn(pid, "/bin/sh", &fa, nullptr, const_cast<char* const*>(argv),
                               environ);
    posix_spawn_file_actions_destroy(&fa);
    close(theirs);
    FILE* f = rc == 0 ? fdopen(ours, read ? "rb" : "wb") : nullptr;
    if (!f) {
        close(ours);
        if (rc == 0) waitpid(*pid, nullptr, 0);
    }
    return f;
}

// A wait status as an exit code: the child's own, or 128 + the signal.
int exit_code(int status) {
    if (WIFEXITED(status)) return WEXITSTATUS(status);
    if (WIFSIGNALED(status)) return 128 + WTERMSIG(status);
    return -1;
}

Reader* open_reader(FILE* f, pid_t child, long frame_bytes, int ring) {
    if (!f) return nullptr;
    auto* r = new Reader();
    r->f = f;
    r->child = child;
    r->frame_bytes = frame_bytes;
    r->batch_frames = kBatchFrames;
    r->ring = new Ring(ring > 0 ? ring : 4, frame_bytes * kBatchFrames);
    r->th = std::thread([r] { r->produce(); });
    return r;
}

Writer* open_writer(FILE* f, pid_t child, long frame_bytes, int ring) {
    if (!f) return nullptr;
    auto* w = new Writer();
    w->f = f;
    w->child = child;
    w->frame_bytes = frame_bytes;
    w->batch_frames = kBatchFrames;
    w->ring = new Ring(ring > 0 ? ring : 4, frame_bytes * kBatchFrames);
    w->th = std::thread([w] { w->consume(); });
    return w;
}

}  // namespace

extern "C" {

void* vfpio_reader_open_file(const char* path, long frame_bytes, int ring, long skip) {
    FILE* f = fopen(path, "rb");
    if (f && skip > 0) fseek(f, skip, SEEK_SET);
    return open_reader(f, 0, frame_bytes, ring);
}

void* vfpio_reader_open_cmd(const char* cmd, long frame_bytes, int ring) {
    pid_t pid = 0;
    FILE* f = spawn_pipe(cmd, true, &pid);
    return open_reader(f, f ? pid : 0, frame_bytes, ring);
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

int vfpio_reader_close(void* h) {
    auto* r = static_cast<Reader*>(h);
    bool at_end;
    {
        std::lock_guard<std::mutex> lk(r->ring->mu);
        at_end = r->at_end;
        r->ring->done = true;
    }
    int status = 0;
    bool reaped = false, killed = false;
    if (r->child && !at_end) {  // a child still running is stopped, not judged
        reaped = waitpid(r->child, &status, WNOHANG) == r->child;
        if (!reaped) {
            kill(r->child, SIGKILL);
            killed = true;
        }
    }
    r->ring->cv_put.notify_all();
    r->ring->cv_get.notify_all();
    if (r->th.joinable()) r->th.join();  // a killed child's pipe ends the producer's read
    fclose(r->f);
    int rc = 0;
    if (r->child) {
        if (!reaped) waitpid(r->child, &status, 0);
        rc = killed ? 0 : exit_code(status);
    }
    delete r->ring;
    delete r;
    return rc;
}

void* vfpio_writer_open_file(const char* path, long frame_bytes, int ring) {
    return open_writer(fopen(path, "ab"), 0, frame_bytes, ring);
}

void* vfpio_writer_open_cmd(const char* cmd, long frame_bytes, int ring) {
    pid_t pid = 0;
    FILE* f = spawn_pipe(cmd, false, &pid);
    return open_writer(f, f ? pid : 0, frame_bytes, ring);
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
    bool error = w->error;
    if (fclose(w->f) != 0) error = true;  // the last buffered bytes; the child sees the end
    int rc = error ? -1 : 0;
    if (w->child) {
        int status = 0;
        waitpid(w->child, &status, 0);
        if (!error) rc = exit_code(status);
    }
    delete w->ring;
    delete w;
    return rc;
}

}  // extern "C"
