// Native video ingest: mmap'd Y4M / raw-gray reader with a prefetch ring.
//
// TPU-native equivalent of the reference's FFmpeg ingest thread
// (ffmpegwrapper.{cpp,h} + vin_ffmpeg.{cpp,h}): a background thread
// stages upcoming frames' luma planes into a bounded ring buffer
// (FRAMES_READ_AHEAD_MAX=3 analog, config.h:76-77) so the Python side
// always hands the device a ready uint8 batch. Exposed via a C ABI for
// ctypes (no pybind11 in this image).
//
// Supported containers:
//   * Y4M (YUV4MPEG2): header parsed, Y plane extracted per frame.
//   * RAW8: headerless W*H grayscale frames (dimensions supplied).
//
// Build: g++ -O3 -shared -fPIC -o libsdvloader.so loader.cpp -lpthread

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Loader {
    int fd = -1;
    const uint8_t* base = nullptr;
    size_t size = 0;
    int width = 0;
    int height = 0;
    int64_t n_frames = 0;
    size_t frame_stride = 0;   // bytes between frame starts
    size_t y_offset = 0;       // offset of Y plane within a frame record
    size_t data_start = 0;     // offset of first frame record
    // Prefetch ring.
    std::vector<std::vector<uint8_t>> ring;
    std::vector<int64_t> ring_frame;
    std::atomic<int64_t> next_load{0};
    std::mutex mtx;
    std::condition_variable cv;
    std::thread worker;
    std::atomic<bool> stop{false};
    int ring_depth = 3;

    ~Loader() { shutdown(); }

    void shutdown() {
        stop.store(true);
        cv.notify_all();
        if (worker.joinable()) worker.join();
        if (base) munmap(const_cast<uint8_t*>(base), size);
        if (fd >= 0) close(fd);
        base = nullptr;
        fd = -1;
    }
};

bool parse_y4m(Loader* L) {
    // Header: "YUV4MPEG2 W<w> H<h> F<n>:<d> ...\n", frames:
    // "FRAME[params]\n" + Y + U + V (4:2:0 by default).
    const char* p = reinterpret_cast<const char*>(L->base);
    const char* end = p + L->size;
    if (L->size < 10 || strncmp(p, "YUV4MPEG2", 9) != 0) return false;
    const char* nl = static_cast<const char*>(memchr(p, '\n', L->size));
    if (!nl) return false;
    std::string header(p, nl);
    int w = 0, h = 0;
    int cw = 2, ch = 2;  // chroma subsample divisors (default 420)
    size_t pos = 0;
    while ((pos = header.find(' ', pos)) != std::string::npos) {
        ++pos;
        if (pos >= header.size()) break;
        char tag = header[pos];
        std::string val = header.substr(pos + 1,
                                        header.find(' ', pos) - pos - 1);
        if (tag == 'W') w = atoi(val.c_str());
        else if (tag == 'H') h = atoi(val.c_str());
        else if (tag == 'C') {
            if (val.rfind("444", 0) == 0) { cw = 1; ch = 1; }
            else if (val.rfind("422", 0) == 0) { cw = 2; ch = 1; }
            else if (val.rfind("mono", 0) == 0) { cw = 0; ch = 0; }
            else { cw = 2; ch = 2; }
        }
    }
    if (w <= 0 || h <= 0) return false;
    size_t ysz = static_cast<size_t>(w) * h;
    size_t csz = (cw && ch) ? (static_cast<size_t>(w / cw) * (h / ch)) : 0;
    // Frame record: "FRAME\n" (assume fixed, no per-frame params) + planes.
    const char* f0 = nl + 1;
    const char* fnl = static_cast<const char*>(
        memchr(f0, '\n', static_cast<size_t>(end - f0)));
    if (!fnl || strncmp(f0, "FRAME", 5) != 0) return false;
    size_t marker = static_cast<size_t>(fnl - f0) + 1;
    L->width = w;
    L->height = h;
    L->data_start = static_cast<size_t>(f0 - p);
    L->y_offset = marker;
    L->frame_stride = marker + ysz + 2 * csz;
    L->n_frames = static_cast<int64_t>(
        (L->size - L->data_start) / L->frame_stride);
    return true;
}

void prefetch_loop(Loader* L) {
    // Sequential readahead: touch upcoming frames' pages so the mmap is
    // warm when copy_frames() runs (the VIN double-buffer analog).
    while (!L->stop.load()) {
        int64_t want = L->next_load.load();
        for (int d = 0; d < L->ring_depth; ++d) {
            int64_t f = want + d;
            if (f >= L->n_frames) break;
            const uint8_t* src = L->base + L->data_start
                + static_cast<size_t>(f) * L->frame_stride + L->y_offset;
            size_t ysz = static_cast<size_t>(L->width) * L->height;
            volatile uint8_t sink = 0;
            for (size_t o = 0; o < ysz; o += 4096) sink ^= src[o];
            (void)sink;
        }
        std::unique_lock<std::mutex> lk(L->mtx);
        L->cv.wait_for(lk, std::chrono::milliseconds(5));
    }
}

}  // namespace

extern "C" {

void* sdv_open(const char* path, int fmt, int raw_w, int raw_h) {
    Loader* L = new Loader();
    L->fd = open(path, O_RDONLY);
    if (L->fd < 0) { delete L; return nullptr; }
    struct stat st;
    if (fstat(L->fd, &st) != 0) { delete L; return nullptr; }
    L->size = static_cast<size_t>(st.st_size);
    L->base = static_cast<const uint8_t*>(
        mmap(nullptr, L->size, PROT_READ, MAP_PRIVATE, L->fd, 0));
    if (L->base == MAP_FAILED) { L->base = nullptr; delete L; return nullptr; }
    madvise(const_cast<uint8_t*>(L->base), L->size, MADV_SEQUENTIAL);
    bool ok = false;
    if (fmt == 0) {
        ok = parse_y4m(L);
    } else {
        if (raw_w > 0 && raw_h > 0) {
            L->width = raw_w;
            L->height = raw_h;
            L->data_start = 0;
            L->y_offset = 0;
            L->frame_stride = static_cast<size_t>(raw_w) * raw_h;
            L->n_frames = static_cast<int64_t>(L->size / L->frame_stride);
            ok = true;
        }
    }
    if (!ok) { delete L; return nullptr; }
    L->worker = std::thread(prefetch_loop, L);
    return L;
}

int sdv_width(void* h) { return static_cast<Loader*>(h)->width; }
int sdv_height(void* h) { return static_cast<Loader*>(h)->height; }
int64_t sdv_frames(void* h) { return static_cast<Loader*>(h)->n_frames; }

// Copy `count` frames' Y planes starting at `first` into `dst`
// (count*height*width bytes). Returns frames copied.
int64_t sdv_copy_frames(void* h, int64_t first, int64_t count,
                        uint8_t* dst) {
    Loader* L = static_cast<Loader*>(h);
    if (first < 0 || first >= L->n_frames) return 0;
    if (first + count > L->n_frames) count = L->n_frames - first;
    size_t ysz = static_cast<size_t>(L->width) * L->height;
    for (int64_t i = 0; i < count; ++i) {
        const uint8_t* src = L->base + L->data_start
            + static_cast<size_t>(first + i) * L->frame_stride
            + L->y_offset;
        memcpy(dst + static_cast<size_t>(i) * ysz, src, ysz);
    }
    L->next_load.store(first + count);
    L->cv.notify_all();
    return count;
}

void sdv_close(void* h) { delete static_cast<Loader*>(h); }

}  // extern "C"
