// Native runtime core: the hot-path primitives the reference keeps in C
// (reference: parsec/class/{lifo,fifo,dequeue,list}.c lock-free task
// queues; utils/zone_malloc.c segment allocator; profiling.c per-thread
// binary event buffers).  Compiled to a shared library and bound via
// ctypes; queues store opaque 64-bit handles so the Python layer can
// park object identities while the bookkeeping runs without the
// interpreter.
//
// Built at first use by parsec_tpu_torch/native/__init__.py into
// parsec_tpu_torch/_build/libparsec_tpu_torch.so (g++ -O2 -shared -fPIC).

#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// MPMC dequeue of u64 handles (reference: parsec_dequeue_t)
// ---------------------------------------------------------------------------

struct ptq_deq {
    std::mutex m;
    std::deque<uint64_t> q;
};

void* ptq_deq_new() { return new ptq_deq(); }
void ptq_deq_delete(void* h) { delete static_cast<ptq_deq*>(h); }

void ptq_deq_push_back(void* h, uint64_t v) {
    auto* d = static_cast<ptq_deq*>(h);
    std::lock_guard<std::mutex> g(d->m);
    d->q.push_back(v);
}

void ptq_deq_push_front(void* h, uint64_t v) {
    auto* d = static_cast<ptq_deq*>(h);
    std::lock_guard<std::mutex> g(d->m);
    d->q.push_front(v);
}

int ptq_deq_pop_front(void* h, uint64_t* out) {
    auto* d = static_cast<ptq_deq*>(h);
    std::lock_guard<std::mutex> g(d->m);
    if (d->q.empty()) return 0;
    *out = d->q.front();
    d->q.pop_front();
    return 1;
}

int ptq_deq_pop_back(void* h, uint64_t* out) {
    auto* d = static_cast<ptq_deq*>(h);
    std::lock_guard<std::mutex> g(d->m);
    if (d->q.empty()) return 0;
    *out = d->q.back();
    d->q.pop_back();
    return 1;
}

uint64_t ptq_deq_len(void* h) {
    auto* d = static_cast<ptq_deq*>(h);
    std::lock_guard<std::mutex> g(d->m);
    return d->q.size();
}

// ---------------------------------------------------------------------------
// Zone (segment) allocator (reference: utils/zone_malloc.{c,h})
// ---------------------------------------------------------------------------

struct ptq_zone {
    std::mutex m;
    uint64_t unit;
    uint64_t nb_units;
    // start_unit -> (units, free)
    std::map<uint64_t, std::pair<uint64_t, bool>> segs;
};

void* ptq_zone_new(uint64_t total_bytes, uint64_t unit_bytes) {
    if (total_bytes == 0 || unit_bytes == 0 || total_bytes < unit_bytes)
        return nullptr;
    auto* z = new ptq_zone();
    z->unit = unit_bytes;
    z->nb_units = total_bytes / unit_bytes;
    z->segs[0] = {z->nb_units, true};
    return z;
}

void ptq_zone_delete(void* h) { delete static_cast<ptq_zone*>(h); }

int64_t ptq_zone_malloc(void* h, uint64_t nbytes) {
    auto* z = static_cast<ptq_zone*>(h);
    uint64_t units = (nbytes + z->unit - 1) / z->unit;
    if (units == 0) units = 1;
    std::lock_guard<std::mutex> g(z->m);
    for (auto& kv : z->segs) {                  // first fit
        uint64_t start = kv.first;
        auto& seg = kv.second;
        if (!seg.second || seg.first < units) continue;
        if (seg.first > units)
            z->segs[start + units] = {seg.first - units, true};
        seg = {units, false};
        return static_cast<int64_t>(start * z->unit);
    }
    return -1;
}

static void ptq_zone_coalesce(ptq_zone* z) {
    auto it = z->segs.begin();
    while (it != z->segs.end()) {
        auto nxt = std::next(it);
        if (nxt == z->segs.end()) break;
        if (it->second.second && nxt->second.second &&
            it->first + it->second.first == nxt->first) {
            it->second.first += nxt->second.first;
            z->segs.erase(nxt);
        } else {
            it = nxt;
        }
    }
}

int ptq_zone_release(void* h, int64_t offset) {
    auto* z = static_cast<ptq_zone*>(h);
    std::lock_guard<std::mutex> g(z->m);
    auto it = z->segs.find(static_cast<uint64_t>(offset) / z->unit);
    if (it == z->segs.end() || it->second.second) return -1;
    it->second.second = true;
    ptq_zone_coalesce(z);
    return 0;
}

uint64_t ptq_zone_used(void* h) {
    auto* z = static_cast<ptq_zone*>(h);
    std::lock_guard<std::mutex> g(z->m);
    uint64_t used = 0;
    for (auto& kv : z->segs)
        if (!kv.second.second) used += kv.second.first;
    return used * z->unit;
}

uint64_t ptq_zone_free_bytes(void* h) {
    auto* z = static_cast<ptq_zone*>(h);
    std::lock_guard<std::mutex> g(z->m);
    uint64_t freeu = 0;
    for (auto& kv : z->segs)
        if (kv.second.second) freeu += kv.second.first;
    return freeu * z->unit;
}

int ptq_zone_defragmented(void* h) {
    auto* z = static_cast<ptq_zone*>(h);
    std::lock_guard<std::mutex> g(z->m);
    return z->segs.size() == 1 && z->segs.begin()->second.second ? 1 : 0;
}

// ---------------------------------------------------------------------------
// Binary trace buffer (reference: profiling.c per-thread append-only
// buffers of fixed-size events {key, flags, taskpool_id, event_id,
// object_id, timestamp})
// ---------------------------------------------------------------------------

#pragma pack(push, 1)
struct ptq_ev {
    int32_t key;
    int32_t flags;
    uint64_t taskpool_id;
    uint64_t event_id;
    uint64_t object_id;
    double ts;
};
#pragma pack(pop)

struct ptq_trace {
    std::mutex m;
    std::vector<ptq_ev> events;
};

void* ptq_trace_new(uint64_t reserve) {
    auto* t = new ptq_trace();
    t->events.reserve(reserve ? reserve : 1024);
    return t;
}

void ptq_trace_delete(void* h) { delete static_cast<ptq_trace*>(h); }

void ptq_trace_event(void* h, int32_t key, int32_t flags,
                     uint64_t taskpool_id, uint64_t event_id,
                     uint64_t object_id, double ts) {
    auto* t = static_cast<ptq_trace*>(h);
    std::lock_guard<std::mutex> g(t->m);
    t->events.push_back({key, flags, taskpool_id, event_id, object_id, ts});
}

// Bulk ingest of packed events (same layout as ptq_ev): the Python
// tracer batches its hot path into ONE boundary crossing per ~1k
// events instead of a ctypes call per event.
void ptq_trace_events_bulk(void* h, const uint8_t* buf, uint64_t nbytes) {
    auto* t = static_cast<ptq_trace*>(h);
    uint64_t n = nbytes / sizeof(ptq_ev);
    if (!n) return;
    const ptq_ev* evs = reinterpret_cast<const ptq_ev*>(buf);
    std::lock_guard<std::mutex> g(t->m);
    t->events.insert(t->events.end(), evs, evs + n);
}

uint64_t ptq_trace_count(void* h) {
    auto* t = static_cast<ptq_trace*>(h);
    std::lock_guard<std::mutex> g(t->m);
    return t->events.size();
}

uint64_t ptq_trace_event_size() { return sizeof(ptq_ev); }

// Copy out up to maxbytes of packed events starting at event `from`;
// returns bytes written.
uint64_t ptq_trace_read(void* h, uint64_t from, uint8_t* buf,
                        uint64_t maxbytes) {
    auto* t = static_cast<ptq_trace*>(h);
    std::lock_guard<std::mutex> g(t->m);
    if (from >= t->events.size()) return 0;
    uint64_t n = t->events.size() - from;
    uint64_t fit = maxbytes / sizeof(ptq_ev);
    if (n > fit) n = fit;
    std::memcpy(buf, t->events.data() + from, n * sizeof(ptq_ev));
    return n * sizeof(ptq_ev);
}

}  // extern "C"
