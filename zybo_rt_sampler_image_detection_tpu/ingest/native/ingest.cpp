// Native UDP ingest engine for the accelerator host.
//
// Replacement for the reference's fork()'d C receiver child +
// SysV shared-memory ring + semaphores (PC/src/api.c:679-939,
// PC/src/receiver.c): one receive thread parses protocol-v2 datagrams,
// un-serpentines and normalizes into a double-buffered latest-frame slot
// guarded by a seqlock, and keeps packet-counter gap statistics (the
// header counter the reference never used, receiver.h:56).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in the image).
// The hot loop does one recv() + a 256-entry permuted scatter per packet;
// at 190.7 frames/s that is ~48.8k packets/s, far below what a single
// thread sustains here.

#include <arpa/inet.h>
#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <netinet/in.h>
#include <pthread.h>
#include <sched.h>
#include <string>
#include <sys/socket.h>
#include <sys/time.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Engine {
    // config
    int n_mics = 256;       // stream slots per packet
    int n_samples = 256;
    int rows = 8, cols = 8;
    double norm = 16777216.0;
    int protocol_ver = 2;
    int exact_serpentine = 1;

    // runtime
    int sock = -1;
    int n_arrays = 0;
    int ring_cap = 64;              // frames held for batched readers
    std::vector<int> perm;          // logical mic -> stream index
    std::vector<float> ring;        // ring_cap * n_mics * n_samples
    std::vector<double> stamps;     // CLOCK_MONOTONIC publish time per slot
    std::atomic<long long> seq{0};  // completed-frame sequence
    std::mutex mu;
    std::condition_variable cv;
    std::thread thr;
    std::atomic<bool> stop{false};

    // stats
    std::atomic<long long> packets{0}, frames{0}, gaps{0}, bad_proto{0};
    long long last_counter = -1;
};

Engine g;

#pragma pack(push, 1)
struct MsgHeader {
    uint16_t frequency;
    int8_t n_arrays;
    int8_t protocol_ver;
    uint32_t counter;
};
#pragma pack(pop)

std::vector<int> make_perm(int n_arrays, int rows, int cols, int n_mics,
                           int exact);

void build_perm() {
    g.perm = make_perm(g.n_arrays, g.rows, g.cols, g.n_mics,
                       g.exact_serpentine);
}

// Real-time priority for the packet threads: on a busy host the JAX
// runtime's threads can starve them for hundreds of ms, overflowing the
// socket buffer.  SCHED_FIFO (needs root / CAP_SYS_NICE;
// silently skipped otherwise) preempts that work the moment a packet or
// pacing deadline arrives.  Both threads block constantly (recv /
// clock_nanosleep), so they cannot monopolize the core.
void try_set_realtime(int prio) {
    sched_param sp{};
    sp.sched_priority = prio;
    pthread_setschedparam(pthread_self(), SCHED_FIFO, &sp);
}

void recv_loop() {
    try_set_realtime(20);
    const int n_ch = (int)g.perm.size();
    const size_t psize = sizeof(MsgHeader) + 4ull * g.n_mics;
    std::vector<uint8_t> pkt(psize);
    std::vector<float> frame((size_t)g.n_mics * g.n_samples, 0.0f);
    const double inv_norm = 1.0 / g.norm;
    long long asm_base = -1;  // counter base of the frame being assembled
    bool asm_dirty = false;   // buffer holds samples not yet published

    while (!g.stop.load(std::memory_order_relaxed)) {
        ssize_t n = recv(g.sock, pkt.data(), psize, 0);
        if (n < 0) continue;               // timeout (SO_RCVTIMEO) or EINTR
        if ((size_t)n < psize) continue;
        const MsgHeader* h = (const MsgHeader*)pkt.data();
        if (h->protocol_ver != g.protocol_ver) { g.bad_proto++; continue; }
        if (g.last_counter >= 0) {
            long long gap =
                ((long long)h->counter - g.last_counter - 1) & 0xFFFFFFFFll;
            if (gap > 0 && gap < (1 << 16)) g.gaps += gap;
        }
        g.last_counter = h->counter;
        g.packets++;

        // Frame slot from the packet counter (unused by the reference):
        // keeps assembly aligned across startup offsets and packet loss.
        const int step = (int)(h->counter % (uint32_t)g.n_samples);
        const long long base = (long long)h->counter - step;
        if (base != asm_base) {
            // a new frame began without the previous one publishing (its
            // FINAL packet was lost): discard the partial assembly so its
            // samples cannot leak into this frame's lost-packet columns
            // (the documented zeros contract)
            if (asm_dirty)
                std::memset(frame.data(), 0, frame.size() * sizeof(float));
            asm_base = base;
        }
        const int32_t* stream = (const int32_t*)(pkt.data() + sizeof(MsgHeader));
        for (int s = 0; s < n_ch; s++) {
            frame[(size_t)s * g.n_samples + step] =
                (float)((double)stream[g.perm[s]] * inv_norm);
        }
        asm_dirty = true;
        if (step == g.n_samples - 1) {
            {
                // Frame ring slot (seq+1) % cap; write under the mutex so
                // batched readers never observe a torn slot.  256 KB memcpy
                // ~ 20 us, negligible at the 5.24 ms frame period.
                std::lock_guard<std::mutex> lk(g.mu);
                long long sq = g.seq.load(std::memory_order_relaxed);
                std::memcpy(
                    g.ring.data() + (size_t)((sq + 1) % g.ring_cap)
                        * frame.size(),
                    frame.data(), frame.size() * sizeof(float));
                // publish stamp: CLOCK_MONOTONIC == Python's
                // time.perf_counter on Linux, so audio consumers can
                // measure packet->sink latency across the boundary
                timespec ts{};
                clock_gettime(CLOCK_MONOTONIC, &ts);
                g.stamps[(size_t)((sq + 1) % g.ring_cap)] =
                    (double)ts.tv_sec + 1e-9 * (double)ts.tv_nsec;
                g.seq.store(sq + 1, std::memory_order_release);
            }
            g.cv.notify_all();
            g.frames++;
            // Zero the assembly buffer so packets lost in any later frame
            // leave zeros (the documented contract), not stale samples.
            std::memset(frame.data(), 0, frame.size() * sizeof(float));
            asm_dirty = false;
        }
    }
}

std::vector<int> make_perm(int n_arrays, int rows, int cols, int n_mics,
                           int exact) {
    std::vector<int> perm((size_t)n_arrays * rows * cols);
    int s = 0;
    for (int n = 0; n < n_arrays; n++) {
        for (int y = 0; y < rows; y++) {
            int row = n * rows * cols + y * cols;
            for (int x = 0; x < cols; x++) {
                int idx;
                if (y % 2 == 0) idx = row + x;
                else if (exact) idx = row + cols - x;
                else idx = row + cols - 1 - x;
                if (idx > n_mics - 1) idx = n_mics - 1;
                perm[s++] = idx;
            }
        }
    }
    return perm;
}

// ---------------------------------------------------------------------------
// Native packet emulator (udp/streamer.c parity at true line rate).
//
// The Python packet generator costs ~93% of a core at 48,828 pkt/s; this
// thread prebuilds every datagram for one signal cycle (serpentine inverse
// + int32 quantization done once) and the hot loop is sendto + an absolute-
// deadline nanosleep — a few percent of a core.  Counters keep increasing
// across cycles (the header counter is patched in place each cycle).
// ---------------------------------------------------------------------------

struct Emulator {
    int sock = -1;
    sockaddr_in dst{};
    size_t psize = 0;
    int n_steps = 0;                 // packets per cycle
    std::vector<uint8_t> pkts;       // n_steps * psize, counters pre-set
    double interval = 0.0;           // seconds per packet (0 = unpaced)
    std::thread thr;
    std::atomic<bool> stop{false};
    std::atomic<long long> sent{0};
};

Emulator e;

void emulate_loop() {
    try_set_realtime(10);
    timespec next{};
    clock_gettime(CLOCK_MONOTONIC, &next);
    // nanosleep wake latency is ~50 us, far above the 20.5 us per-packet
    // interval at 48,828 pkt/s — pace in chunks of 8 packets (164 us),
    // sending each chunk back-to-back (the real FPGA bursts too; the
    // receiver's socket buffer absorbs far larger bursts than this).
    const int CHUNK = 8;
    const long long step_ns = (long long)(e.interval * 1e9);
    const long long chunk_ns = step_ns * CHUNK;
    while (!e.stop.load(std::memory_order_relaxed)) {
        for (int i = 0; i < e.n_steps; i++) {
            if (e.stop.load(std::memory_order_relaxed)) return;
            sendto(e.sock, e.pkts.data() + (size_t)i * e.psize, e.psize, 0,
                   (sockaddr*)&e.dst, sizeof(e.dst));
            e.sent++;
            if (step_ns > 0 && (i % CHUNK) == CHUNK - 1) {
                next.tv_nsec += chunk_ns;
                while (next.tv_nsec >= 1000000000) {
                    next.tv_nsec -= 1000000000; next.tv_sec += 1;
                }
                // Re-anchor after a long stall (vCPU steal / descheduling)
                // instead of bursting the backlog at wire speed — a real
                // FPGA paused with us would not burst either, and the
                // catch-up flood overflows the receive buffer.
                timespec now{};
                clock_gettime(CLOCK_MONOTONIC, &now);
                long long behind_ns =
                    (now.tv_sec - next.tv_sec) * 1000000000ll +
                    (now.tv_nsec - next.tv_nsec);
                if (behind_ns > 250000000ll) {
                    next = now;
                } else if (behind_ns < 0) {
                    clock_nanosleep(CLOCK_MONOTONIC, TIMER_ABSTIME, &next,
                                    nullptr);
                }
            }
        }
        // next cycle: advance every packet counter by one cycle length
        for (int i = 0; i < e.n_steps; i++) {
            MsgHeader* h = (MsgHeader*)(e.pkts.data() + (size_t)i * e.psize);
            h->counter += (uint32_t)e.n_steps;
        }
    }
}

}  // namespace

extern "C" {

// Returns n_arrays on success; -1 socket error, -2 bind error,
// -3 header timeout, -4 protocol mismatch.
int zrt_ingest_connect(const char* ip, int port, int n_mics, int n_samples,
                       int rows, int cols, double norm, int protocol_ver,
                       int exact_serpentine, double header_timeout_s,
                       int ring_frames) {
    g.n_mics = n_mics; g.n_samples = n_samples; g.rows = rows; g.cols = cols;
    g.norm = norm; g.protocol_ver = protocol_ver;
    g.exact_serpentine = exact_serpentine;
    g.ring_cap = ring_frames > 1 ? ring_frames : 64;
    g.stop.store(false);
    g.packets = 0; g.frames = 0; g.gaps = 0; g.bad_proto = 0;
    g.last_counter = -1; g.seq = 0;

    g.sock = socket(AF_INET, SOCK_DGRAM, IPPROTO_UDP);
    if (g.sock < 0) return -1;
    int rcvbuf = 1 << 25;   // absorb dispatch-length bursts
    // FORCE variant (root) bypasses rmem_max; fall back to the capped one
    if (setsockopt(g.sock, SOL_SOCKET, SO_RCVBUFFORCE, &rcvbuf,
                   sizeof(rcvbuf)) != 0)
        setsockopt(g.sock, SOL_SOCKET, SO_RCVBUF, &rcvbuf, sizeof(rcvbuf));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons((uint16_t)port);
    addr.sin_addr.s_addr = inet_addr(ip);
    if (bind(g.sock, (sockaddr*)&addr, sizeof(addr)) < 0) {
        close(g.sock); g.sock = -1; return -2;
    }

    // Header packet: n_arrays + protocol check (receiver.c:224-239).
    timeval tv{};
    tv.tv_sec = (long)header_timeout_s;
    tv.tv_usec = (long)((header_timeout_s - tv.tv_sec) * 1e6);
    setsockopt(g.sock, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    std::vector<uint8_t> pkt(sizeof(MsgHeader) + 4ull * n_mics);
    ssize_t n = recv(g.sock, pkt.data(), pkt.size(), 0);
    if (n < (ssize_t)sizeof(MsgHeader)) { close(g.sock); g.sock = -1; return -3; }
    const MsgHeader* h = (const MsgHeader*)pkt.data();
    if (h->protocol_ver != protocol_ver) { close(g.sock); g.sock = -1; return -4; }
    g.n_arrays = h->n_arrays;
    // Reject a header whose array count exceeds this config's capacity:
    // recv_loop writes frame rows for n_arrays*rows*cols channels, and a
    // mismatched stream would write past the n_mics-row frame buffer
    // (heap corruption — found via `demo fullrate --preset tiny` with
    // the default 3-array emulator against the 1-array tiny config).
    if (h->n_arrays < 1 ||
        (long long)h->n_arrays * rows * cols > (long long)n_mics) {
        close(g.sock); g.sock = -1; return -5;
    }
    g.last_counter = h->counter;

    build_perm();
    g.ring.assign((size_t)g.ring_cap * n_mics * n_samples, 0.0f);
    g.stamps.assign((size_t)g.ring_cap, 0.0);

    timeval tv2{0, 200000};  // 200 ms poll so stop() is responsive
    setsockopt(g.sock, SOL_SOCKET, SO_RCVTIMEO, &tv2, sizeof(tv2));
    g.thr = std::thread(recv_loop);
    return g.n_arrays;
}

// Copy the newest complete frame into out (n_mics * n_samples floats).
// fresh!=0 waits for a frame with seq > last_seq (timeout_ms).
// Returns the frame sequence, or -1 on timeout.
long long zrt_ingest_read(float* out, int fresh, long long last_seq,
                          int timeout_ms) {
    const size_t fsz = (size_t)g.n_mics * g.n_samples;
    std::unique_lock<std::mutex> lk(g.mu);
    if (fresh) {
        bool ok = g.cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                [&] { return g.seq.load() > last_seq; });
        if (!ok) return -1;
    }
    long long sq = g.seq.load(std::memory_order_acquire);
    std::memcpy(out, g.ring.data() + (size_t)(sq % g.ring_cap) * fsz,
                fsz * sizeof(float));
    return sq;
}

// Copy k counter-contiguous frames starting at max(next_seq, oldest still
// in the ring) into out ((k, out_channels, n_samples) floats, oldest
// first; out_channels <= 0 means all n_mics rows — pass the connected
// channel count n_arrays*rows*cols to skip the always-zero tail rows and
// shrink the host->device transfer).  Blocks until k frames past next_seq
// exist (timeout_ms).  *skipped gets the number of frames the ring
// overwrote before the reader got to them (0 when the reader keeps up).
// Returns the sequence of out[0], or -1 on timeout.  This is the
// full-line-rate path: every frame the receiver writes (receiver.c:94-151
// writes all of them) is delivered exactly once to a batched consumer.
// stamps_out (nullable, k doubles) receives each frame's CLOCK_MONOTONIC
// publish time — the audio-latency contract's packet-side anchor.
long long zrt_ingest_read_batch(float* out, int k, long long next_seq,
                                int timeout_ms, long long* skipped,
                                int out_channels, double* stamps_out) {
    const size_t fsz = (size_t)g.n_mics * g.n_samples;
    const int n_ch = (out_channels > 0 && out_channels <= g.n_mics)
                         ? out_channels : g.n_mics;
    const size_t osz = (size_t)n_ch * g.n_samples;
    if (k < 1 || k > g.ring_cap) return -2;
    if (next_seq < 1) next_seq = 1;
    std::unique_lock<std::mutex> lk(g.mu);
    bool ok = g.cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                            [&] { return g.seq.load() >= next_seq + k - 1 ||
                                         g.stop.load(); });
    if (!ok || g.stop.load()) return -1;
    long long sq = g.seq.load(std::memory_order_acquire);
    long long first = next_seq;
    long long oldest = sq - g.ring_cap + 1;
    if (first < oldest) first = oldest;
    *skipped = first - next_seq;
    for (int i = 0; i < k; i++) {
        long long s = first + i;
        std::memcpy(out + (size_t)i * osz,
                    g.ring.data() + (size_t)(s % g.ring_cap) * fsz,
                    osz * sizeof(float));
        if (stamps_out) stamps_out[i] = g.stamps[(size_t)(s % g.ring_cap)];
    }
    return first;
}

void zrt_ingest_stats(long long* packets, long long* frames, long long* gaps,
                      long long* bad_proto) {
    *packets = g.packets.load(); *frames = g.frames.load();
    *gaps = g.gaps.load(); *bad_proto = g.bad_proto.load();
}

// Start streaming `sig` ((n_ch_logical, n_steps) float32, row-major) as
// protocol-v2 datagrams to ip:port at `rate` packets/s (0 = unpaced),
// preceded by one header packet; cycles forever until zrt_emulate_stop.
// Returns 0 on success, -1 on socket error.
int zrt_emulate_start(const char* ip, int port, int n_mics, int rows,
                      int cols, int n_arrays, int protocol_ver,
                      int exact_serpentine, double rate, const float* sig,
                      long long n_steps, double norm) {
    e.stop.store(true);
    if (e.thr.joinable()) e.thr.join();
    if (e.sock >= 0) { close(e.sock); e.sock = -1; }
    e.stop.store(false);
    e.sent = 0;

    e.sock = socket(AF_INET, SOCK_DGRAM, IPPROTO_UDP);
    if (e.sock < 0) return -1;
    e.dst = sockaddr_in{};
    e.dst.sin_family = AF_INET;
    e.dst.sin_port = htons((uint16_t)port);
    e.dst.sin_addr.s_addr = inet_addr(ip);

    const int n_ch = n_arrays * rows * cols;
    std::vector<int> perm = make_perm(n_arrays, rows, cols, n_mics,
                                      exact_serpentine);
    e.psize = sizeof(MsgHeader) + 4ull * n_mics;
    e.n_steps = (int)n_steps;
    e.pkts.assign((size_t)n_steps * e.psize, 0);
    for (long long i = 0; i < n_steps; i++) {
        uint8_t* p = e.pkts.data() + (size_t)i * e.psize;
        MsgHeader* h = (MsgHeader*)p;
        h->frequency = 0;
        h->n_arrays = (int8_t)n_arrays;
        h->protocol_ver = (int8_t)protocol_ver;
        h->counter = (uint32_t)i;
        int32_t* stream = (int32_t*)(p + sizeof(MsgHeader));
        for (int s = 0; s < n_ch; s++) {
            double v = (double)sig[(size_t)s * n_steps + i] * norm;
            if (v > 2147483647.0) v = 2147483647.0;
            if (v < -2147483648.0) v = -2147483648.0;
            // last-writer-wins on clamped collisions, like the C read
            stream[perm[s]] = (int32_t)llround(v);
        }
    }

    // header packet (counter = -1 so gap accounting stays continuous)
    std::vector<uint8_t> hdr(e.psize, 0);
    MsgHeader* h = (MsgHeader*)hdr.data();
    h->n_arrays = (int8_t)n_arrays;
    h->protocol_ver = (int8_t)protocol_ver;
    h->counter = 0xFFFFFFFFu;
    sendto(e.sock, hdr.data(), e.psize, 0, (sockaddr*)&e.dst, sizeof(e.dst));

    e.interval = rate > 0 ? 1.0 / rate : 0.0;
    e.thr = std::thread(emulate_loop);
    return 0;
}

void zrt_emulate_stop() {
    e.stop.store(true);
    if (e.thr.joinable()) e.thr.join();
    if (e.sock >= 0) { close(e.sock); e.sock = -1; }
}

long long zrt_emulate_sent() { return e.sent.load(); }

void zrt_ingest_disconnect() {
    g.stop.store(true);
    g.cv.notify_all();                  // wake blocked batch readers
    if (g.thr.joinable()) g.thr.join();
    if (g.sock >= 0) { close(g.sock); g.sock = -1; }
}

}  // extern "C"
