// Native transport engine — the C++ hot path for the tpu_std wire.
//
// Analog of the reference's C++ core loops: InputMessenger::OnNewMessages
// (input_messenger.cpp:317-382, read+cut+dispatch) and Socket::StartWrite/
// KeepWrite (socket.cpp:1584-1790).  The reference is C++ end to end; this
// engine restores that property for the framing/IO cycle so the Python
// layer above (services, combos, observability) rides a native data path:
//
//   * server: N worker threads, each owning an epoll set; connections are
//     assigned round-robin at accept.  Frames are cut and, for methods
//     registered as native-echo, answered entirely in C++ (no GIL).  All
//     other frames are handed to a Python dispatch callback (the ctypes
//     layer re-acquires the GIL only for those).
//   * client: a connection pool with blocking call/response round trips;
//     the meta protobuf is packed/parsed here so Python touches only the
//     user payload bytes.  One in-flight RPC per pooled fd — the pooled
//     connection type (channel.h:84-89, GetPooledSocket analog).
//
// Wire format (protocols/tpu_std.py): b"TRPC" u32(meta_size) u32(body_size)
// then RpcMeta pb then body (payload + attachment).  The tiny subset of
// protobuf needed for RpcMeta/Echo is hand-encoded below — schema in
// protos/rpc_meta.proto; field numbers are load-bearing.
//
// Build: g++ -O2 -shared -fPIC -pthread engine.cpp -o _engine.so

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <sys/un.h>
#include <time.h>
#include <unistd.h>

#ifdef __GLIBC__
#include <malloc.h>
#endif

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

// ThreadSanitizer soundness shim (tools/sanitize.sh tsan lane): on
// Linux std::mutex is trivially destructible — ~mutex() never calls
// pthread_mutex_destroy — so TSan keeps per-ADDRESS mutex state alive
// after the object dies.  MuxWaiter lives on the caller's stack and
// MuxClient/MuxConn on the heap; both get reused at identical
// addresses (next call frame / next allocation), and the stale state
// yields bogus "double lock" + data-race reports against the reborn
// mutex.  Destructors below tell TSan the mutex is really gone.  Plain
// builds compile this away entirely.
#if defined(__SANITIZE_THREAD__)
// pthread_mutex_destroy is intercepted by TSan and wipes its per-
// address mutex state — the exact signal ~mutex() omits.  (glibc's
// destroy on an unlocked mutex is an O(1) bookkeeping call.)
#define NS_TSAN_MUTEX_DESTROY(m) pthread_mutex_destroy((m)->native_handle())
#else
#define NS_TSAN_MUTEX_DESTROY(m) ((void)0)
#endif

namespace {

constexpr uint8_t kMagic[4] = {'T', 'R', 'P', 'C'};
constexpr size_t kHeader = 12;
constexpr uint64_t kMaxBody = 2ull << 30;

// Timed condvar wait that stays VISIBLE to ThreadSanitizer.  libstdc++
// lowers condition_variable::wait_for to pthread_cond_clockwait (glibc
// 2.30+), which this toolchain's libtsan does not intercept — the
// wait's internal unlock/relock then never reaches TSan, which keeps
// believing the waiter holds the mutex across the whole wait and
// reports phantom "double lock" + data races against the reactor's
// legitimate acquisitions.  Under TSan we call the intercepted
// pthread_cond_timedwait on the native handles instead; plain builds
// keep the std:: fast path.
template <typename Pred>
bool ns_cv_wait_for_ms(std::condition_variable& cv,
                       std::unique_lock<std::mutex>& lk, int64_t ms,
                       Pred pred) {
#if defined(__SANITIZE_THREAD__)
  timespec abs;
  clock_gettime(CLOCK_REALTIME, &abs);
  abs.tv_sec += ms / 1000;
  abs.tv_nsec += (ms % 1000) * 1000000L;
  if (abs.tv_nsec >= 1000000000L) {
    abs.tv_sec++;
    abs.tv_nsec -= 1000000000L;
  }
  while (!pred()) {
    int rc = pthread_cond_timedwait(cv.native_handle(),
                                    lk.mutex()->native_handle(), &abs);
    if (rc == ETIMEDOUT) return pred();
  }
  return true;
#else
  return cv.wait_for(lk, std::chrono::milliseconds(ms), pred);
#endif
}

#ifdef __GLIBC__
// Per-call response bodies at or above glibc's default mmap threshold
// (128KB) would otherwise cost one mmap+munmap — plus a page fault per
// touched page — per RPC: measured as an 8x qps crater on the
// 128KB-256KB points of the echo size curve (glibc's dynamic threshold
// only self-heals after freeing an mmapped chunk, which is why 256KB+
// partially recovered).  Keep multi-MB call allocations on the
// freelist-managed heap.
struct MallocTuning {
  MallocTuning() {
    mallopt(M_MMAP_THRESHOLD, 16 << 20);
    mallopt(M_TRIM_THRESHOLD, 32 << 20);
  }
} g_malloc_tuning;
#endif

// ---------------------------------------------------------------------------
// deterministic fault injection (chaos/): process-wide per-site knobs
// programmed from Python via ns_set_fault.  The disarmed hot-path cost
// is ONE relaxed atomic load (g_faults_armed).  Armed decisions are a
// pure function of (seed, traversal counter) — murmur3 fmix64 in counter
// mode — so a replayed plan fires on the identical traversal indices.
// ---------------------------------------------------------------------------

enum FaultAction : uint32_t {
  FA_NONE = 0,
  FA_SHORT = 1,   // cap read()/write() size to `arg` bytes (partial IO)
  FA_EAGAIN = 2,  // pretend the fd returned EAGAIN this round
  FA_RESET = 3,   // kill the connection
  FA_DELAY = 4,   // sleep `arg` microseconds
};

// site ids (mirrored by chaos/injector.py _NATIVE_SITE_IDS)
enum FaultSite : int {
  FS_SRV_READ = 0,
  FS_SRV_WRITE = 1,
  FS_COUNT = 2,
};

struct FaultState {
  std::atomic<uint32_t> action{0};
  std::atomic<uint64_t> arg{0};
  std::atomic<uint32_t> prob{0};  // fire when hash_hi32 < prob
  std::atomic<uint64_t> seed{0};
  std::atomic<int64_t> max_hits{-1};  // <0 = unlimited
  std::atomic<uint64_t> evals{0};
  std::atomic<uint64_t> hits{0};
};

FaultState g_faults[FS_COUNT];
std::atomic<uint32_t> g_faults_armed{0};

inline uint64_t fault_mix64(uint64_t x) {
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdull;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ull;
  x ^= x >> 33;
  return x;
}

// Returns the action to apply at `site` this traversal (FA_NONE = no
// fault).  `*arg` receives the action argument.
inline uint32_t fault_check(int site, uint64_t* arg) {
  if (g_faults_armed.load(std::memory_order_relaxed) == 0) return FA_NONE;
  FaultState& f = g_faults[site];
  // acquire pairs with ns_set_fault's release store: arg/prob/seed
  // written before the action publish must be visible once the action
  // is observed (relaxed here could apply a new action with a stale
  // arg/seed on a weakly ordered CPU)
  uint32_t act = f.action.load(std::memory_order_acquire);
  if (act == FA_NONE) return FA_NONE;
  uint64_t n = f.evals.fetch_add(1, std::memory_order_relaxed);
  uint32_t prob = f.prob.load(std::memory_order_relaxed);
  if (prob != 0xFFFFFFFFu) {  // saturated prob = 1.0: ALWAYS fire —
    // the high-32 compare alone would skip ~1-in-4e9 traversals
    uint64_t h = fault_mix64(f.seed.load(std::memory_order_relaxed) +
                             n * 0x9e3779b97f4a7c15ull);
    if (static_cast<uint32_t>(h >> 32) >= prob) return FA_NONE;
  }
  int64_t mh = f.max_hits.load(std::memory_order_relaxed);
  if (mh >= 0) {
    // CAS claim: hits must never transiently exceed the budget — a
    // concurrent ns_fault_hits read during a fetch_add/fetch_sub
    // window would fold a phantom hit into chaos_injected_total
    uint64_t cur = f.hits.load(std::memory_order_relaxed);
    do {
      if (static_cast<int64_t>(cur) >= mh) return FA_NONE;
    } while (!f.hits.compare_exchange_weak(cur, cur + 1,
                                           std::memory_order_relaxed));
  } else {
    f.hits.fetch_add(1, std::memory_order_relaxed);
  }
  *arg = f.arg.load(std::memory_order_relaxed);
  return act;
}

inline void fault_sleep_us(uint64_t us) {
  if (us > 200000) us = 200000;  // bounded: chaos delays, never wedges
  std::this_thread::sleep_for(std::chrono::microseconds(us));
}

// Growable byte buffer WITHOUT zero-fill.  Frames larger than one
// read() chunk are completed by reading straight into the tail;
// std::vector would either memset the tail on resize or force the old
// stage-into-vector path that copied every byte of a large frame twice
// once a connection fell behind a frame boundary (the large-payload
// half of the size-curve crater).
struct ByteBuf {
  uint8_t* p = nullptr;
  size_t len = 0, cap = 0;
  ~ByteBuf() { free(p); }
  ByteBuf() = default;
  ByteBuf(const ByteBuf&) = delete;
  ByteBuf& operator=(const ByteBuf&) = delete;
  bool empty() const { return len == 0; }
  size_t size() const { return len; }
  uint8_t* data() { return p; }
  const uint8_t* data() const { return p; }
  void reserve(size_t n) {
    if (n <= cap) return;
    size_t ncap = cap ? cap * 2 : 4096;
    if (ncap < n) ncap = n;
    p = static_cast<uint8_t*>(realloc(p, ncap));
    cap = ncap;
  }
  // `n` writable bytes past the end; pair with advance() after the read
  uint8_t* tail(size_t n) {
    reserve(len + n);
    return p + len;
  }
  void advance(size_t n) { len += n; }
  void append(const uint8_t* src, size_t n) {
    memcpy(tail(n), src, n);
    len += n;
  }
  void assign(const uint8_t* src, size_t n) {
    len = 0;
    append(src, n);
  }
  void erase_front(size_t n) {
    if (n >= len) {
      len = 0;
      // a burst of large frames can balloon the stash; hand the pages
      // back once it drains
      if (cap > (1u << 20)) {
        free(p);
        p = nullptr;
        cap = 0;
      }
      return;
    }
    memmove(p, p + n, len - n);
    len -= n;
  }
  void clear() { len = 0; }
  void swap_storage(ByteBuf& o) {
    std::swap(p, o.p);
    std::swap(len, o.len);
    std::swap(cap, o.cap);
  }
};

// Stash the uncut remainder of a DIRECT read (one that cut frames
// straight out of the shared read buffer) into the connection's own
// buffer.  When nothing was cut and the remainder is large — the first
// chunk of a frame bigger than one read() — the read buffer is STOLEN
// wholesale (pointer swap) instead of copied: a 1MB+ frame would
// otherwise pay a full extra copy of its first megabyte every request.
constexpr size_t kStealThreshold = 64 * 1024;

void stash_direct_remainder(ByteBuf* in, ByteBuf* rdbuf, size_t off,
                            size_t dlen) {
  size_t rest = dlen - off;
  if (off == 0 && rest >= kStealThreshold) {
    in->swap_storage(*rdbuf);
    in->len = dlen;
    rdbuf->len = 0;
    return;
  }
  in->assign(rdbuf->p + off, rest);
}

// ---------------------------------------------------------------------------
// minimal protobuf
// ---------------------------------------------------------------------------

struct PbWriter {
  std::string own;
  std::string& out;
  PbWriter() : out(own) {}
  // write into an external buffer (skips one copy on hot paths)
  explicit PbWriter(std::string& ext) : out(ext) {}
  void varint(uint64_t v) {
    while (v >= 0x80) {
      out.push_back(static_cast<char>(v | 0x80));
      v >>= 7;
    }
    out.push_back(static_cast<char>(v));
  }
  void tag(uint32_t field, uint32_t wire) { varint((field << 3) | wire); }
  void field_varint(uint32_t f, uint64_t v) {
    if (v) {
      tag(f, 0);
      varint(v);
    }
  }
  void field_bytes(uint32_t f, const char* p, size_t n) {
    tag(f, 2);
    varint(n);
    out.append(p, n);
  }
};

struct PbReader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;
  uint64_t varint() {
    uint64_t v = 0;
    int shift = 0;
    while (p < end) {
      uint8_t b = *p++;
      v |= static_cast<uint64_t>(b & 0x7f) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
      if (shift > 63) break;
    }
    ok = false;
    return 0;
  }
  // returns field number, 0 at end/error; wire type in *wire
  uint32_t next(uint32_t* wire) {
    if (p >= end || !ok) return 0;
    uint64_t key = varint();
    if (!ok) return 0;
    *wire = key & 7;
    return static_cast<uint32_t>(key >> 3);
  }
  bool bytes(const uint8_t** out, size_t* n) {
    uint64_t len = varint();
    if (!ok || len > static_cast<uint64_t>(end - p)) {
      ok = false;
      return false;
    }
    *out = p;
    *n = len;
    p += len;
    return true;
  }
  void skip(uint32_t wire) {
    switch (wire) {
      case 0:
        varint();
        break;
      case 1:
        if (end - p >= 8)
          p += 8;
        else
          ok = false;
        break;
      case 2: {
        const uint8_t* d;
        size_t n;
        bytes(&d, &n);
        break;
      }
      case 5:
        if (end - p >= 4)
          p += 4;
        else
          ok = false;
        break;
      default:
        ok = false;
    }
  }
};

// Parsed RpcMeta subset (protos/rpc_meta.proto)
struct MetaView {
  std::string service, method;   // request.service_name/.method_name
  uint64_t correlation_id = 0;   // field 4
  uint64_t attachment_size = 0;  // field 5
  uint64_t compress_type = 0;    // field 3
  int32_t error_code = 0;        // response.error_code
  std::string error_text;        // response.error_text
  bool has_request = false, has_response = false;
  bool has_stream = false, has_auth = false, has_device_segs = false;
};

bool parse_meta(const uint8_t* data, size_t len, MetaView* m) {
  PbReader r{data, data + len};
  uint32_t wire;
  while (uint32_t f = r.next(&wire)) {
    if (f == 1 && wire == 2) {  // RpcRequestMeta
      const uint8_t* d;
      size_t n;
      if (!r.bytes(&d, &n)) return false;
      m->has_request = true;
      PbReader rr{d, d + n};
      uint32_t w2;
      while (uint32_t f2 = rr.next(&w2)) {
        if (f2 == 1 && w2 == 2) {
          const uint8_t* s;
          size_t sn;
          if (!rr.bytes(&s, &sn)) return false;
          m->service.assign(reinterpret_cast<const char*>(s), sn);
        } else if (f2 == 2 && w2 == 2) {
          const uint8_t* s;
          size_t sn;
          if (!rr.bytes(&s, &sn)) return false;
          m->method.assign(reinterpret_cast<const char*>(s), sn);
        } else {
          rr.skip(w2);
        }
      }
      if (!rr.ok) return false;
    } else if (f == 2 && wire == 2) {  // RpcResponseMeta
      const uint8_t* d;
      size_t n;
      if (!r.bytes(&d, &n)) return false;
      m->has_response = true;
      PbReader rr{d, d + n};
      uint32_t w2;
      while (uint32_t f2 = rr.next(&w2)) {
        if (f2 == 1 && w2 == 0) {
          m->error_code = static_cast<int32_t>(rr.varint());
        } else if (f2 == 2 && w2 == 2) {
          const uint8_t* s;
          size_t sn;
          if (!rr.bytes(&s, &sn)) return false;
          m->error_text.assign(reinterpret_cast<const char*>(s), sn);
        } else {
          rr.skip(w2);
        }
      }
      if (!rr.ok) return false;
    } else if (f == 3 && wire == 0) {
      m->compress_type = r.varint();
    } else if (f == 4 && wire == 0) {
      m->correlation_id = r.varint();
    } else if (f == 5 && wire == 0) {
      m->attachment_size = r.varint();
    } else if (f == 6) {
      m->has_stream = true;
      r.skip(wire);
    } else if (f == 7) {
      m->has_device_segs = true;
      r.skip(wire);
    } else if (f == 8) {
      m->has_auth = true;
      r.skip(wire);
    } else {
      r.skip(wire);
    }
  }
  return r.ok;
}

std::string pack_request_meta(const char* service, size_t service_len,
                              const char* method, size_t method_len,
                              uint64_t cid, uint64_t att_size,
                              uint64_t log_id) {
  PbWriter req;
  req.field_bytes(1, service, service_len);
  req.field_bytes(2, method, method_len);
  req.field_varint(3, log_id);
  PbWriter meta;
  meta.field_bytes(1, req.out.data(), req.out.size());
  meta.field_varint(4, cid);
  meta.field_varint(5, att_size);
  return std::move(meta.out);
}

std::string pack_response_meta(uint64_t cid, uint64_t att_size,
                               int32_t error_code = 0,
                               const char* error_text = nullptr) {
  PbWriter meta;
  if (error_code != 0 || error_text) {
    PbWriter resp;
    resp.field_varint(1, static_cast<uint64_t>(error_code));
    if (error_text) resp.field_bytes(2, error_text, strlen(error_text));
    meta.field_bytes(2, resp.out.data(), resp.out.size());
  }
  meta.field_varint(4, cid);
  meta.field_varint(5, att_size);
  return std::move(meta.own);
}

void put_header(char* dst, uint32_t meta_size, uint32_t body_size) {
  memcpy(dst, kMagic, 4);
  uint32_t m = htonl(meta_size), b = htonl(body_size);
  memcpy(dst + 4, &m, 4);
  memcpy(dst + 8, &b, 4);
}

// ---------------------------------------------------------------------------
// IO helpers
// ---------------------------------------------------------------------------

int set_nodelay(int fd) {
  int one = 1;
  return setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
}

// write fully (blocking fd)
bool write_all(int fd, const char* p, size_t n) {
  while (n) {
    ssize_t w = ::write(fd, p, n);
    if (w < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

// write an iovec array fully (blocking fd), advancing across partials
bool writev_all(int fd, iovec* iov, int cnt) {
  int idx = 0;
  while (idx < cnt) {
    ssize_t n = ::writev(fd, iov + idx, cnt - idx);
    if (n < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    size_t left = static_cast<size_t>(n);
    while (idx < cnt && left >= iov[idx].iov_len) {
      left -= iov[idx].iov_len;
      idx++;
    }
    if (idx < cnt && left) {
      iov[idx].iov_base = static_cast<char*>(iov[idx].iov_base) + left;
      iov[idx].iov_len -= left;
    }
  }
  return true;
}

bool read_exact(int fd, char* p, size_t n, int timeout_ms) {
  while (n) {
    if (timeout_ms >= 0) {
      struct pollfd pfd {fd, POLLIN, 0};
      int rc = ::poll(&pfd, 1, timeout_ms);
      if (rc == 0) {
        errno = ETIMEDOUT;
        return false;
      }
      if (rc < 0) {
        if (errno == EINTR) continue;
        return false;
      }
    }
    ssize_t r = ::read(fd, p, n);
    if (r == 0) {
      errno = ECONNRESET;
      return false;
    }
    if (r < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

// ---------------------------------------------------------------------------
// server
// ---------------------------------------------------------------------------

using PyDispatch = void (*)(uint64_t conn_id, uint32_t proto,
                            const uint8_t* frame, uint64_t len);

// ---------------------------------------------------------------------------
// generic native method registry
//
// The dispatch mechanism is generic (reference: any C++ service runs on
// the C++ path); a handler is a C function pointer so services written
// in any native language — or ctypes callbacks, at GIL cost — plug into
// the same frame cycle.  The built-in echo fast path is just the first
// registered NativeMethod.  Returning <0 declines the frame (falls to
// the Python dispatch for full framework semantics); >=0 is the
// response error_code (0 = ok).
// ---------------------------------------------------------------------------

// Response builder: an ordered list of parts, each either owned bytes
// (stored in the arena; recorded as offsets since the arena reallocs)
// or a borrowed view into the request frame (valid until the frame is
// consumed — burst_append_response copies synchronously).  Views let
// echo-style handlers move the payload frame→burst with ONE memcpy.
struct RespPart {
  bool is_view;
  size_t off_or_ptr;  // arena offset, or the view pointer
  size_t len;
};

struct NativeRespCtx {
  std::string arena;
  std::vector<RespPart> payload_parts;
  std::string attachment;
  const uint8_t* att_view = nullptr;
  size_t att_view_len = 0;

  void clear() {
    arena.clear();
    payload_parts.clear();
    attachment.clear();
    att_view = nullptr;
    att_view_len = 0;
  }
  void payload_owned(const char* p, size_t n) {
    payload_parts.push_back({false, arena.size(), n});
    arena.append(p, n);
  }
  void payload_view(const uint8_t* p, size_t n) {
    payload_parts.push_back({true, reinterpret_cast<size_t>(p), n});
  }
  size_t payload_size() const {
    size_t n = 0;
    for (const RespPart& part : payload_parts) n += part.len;
    return n;
  }
  size_t att_size() const { return attachment.size() + att_view_len; }
};

using NativeMethodFn = int32_t (*)(void* user_data, const uint8_t* req,
                                   uint64_t req_len, const uint8_t* att,
                                   uint64_t att_len, void* resp_ctx);

struct NativeMethod {
  NativeMethodFn fn = nullptr;
  void* user_data = nullptr;
  std::atomic<int32_t> inflight{0};
  std::atomic<int32_t> max_concurrency{0};  // 0 = unlimited
  // fast-path completions bypass Python MethodStatus; these counters
  // are harvested into it (ns_method_stats) so /status stays correct
  std::atomic<uint64_t> count{0};
  std::atomic<uint64_t> latency_ns_sum{0};
  std::atomic<uint64_t> rejected{0};
  std::atomic<uint64_t> errors{0};
};

// EchoRequest view (protos/echo.proto): message=1 code=2 server_fail=3
// close_fd=4 sleep_us=5.  Any fault-injection field present → decline.
struct EchoView {
  const uint8_t* msg = nullptr;
  size_t msg_len = 0;
  uint64_t code = 0;
  bool plain = true;  // no fault-injection fields
};

bool parse_echo(const uint8_t* data, size_t len, EchoView* e) {
  PbReader r{data, data + len};
  uint32_t wire;
  while (uint32_t f = r.next(&wire)) {
    if (f == 1 && wire == 2) {
      if (!r.bytes(&e->msg, &e->msg_len)) return false;
    } else if (f == 2 && wire == 0) {
      e->code = r.varint();
    } else if (f == 3 || f == 4 || f == 5) {
      e->plain = false;
      r.skip(wire);
    } else {
      r.skip(wire);
    }
  }
  return r.ok;
}

// built-in echo handler; user_data bit 0 = attach_echo
int32_t builtin_echo_method(void* user_data, const uint8_t* req,
                            uint64_t req_len, const uint8_t* att,
                            uint64_t att_len, void* resp_ctx) {
  EchoView e;
  if (!parse_echo(req, req_len, &e) || !e.plain) return -1;
  NativeRespCtx* ctx = static_cast<NativeRespCtx*>(resp_ctx);
  // response pb = field1 header + message VIEW (borrowed from the
  // request frame: frame→burst is the only copy) + field2 tail
  if (e.msg_len) {
    PbWriter hdr;
    hdr.tag(1, 2);
    hdr.varint(e.msg_len);
    ctx->payload_owned(hdr.own.data(), hdr.own.size());
    ctx->payload_view(e.msg, e.msg_len);
  }
  PbWriter tail;
  tail.field_varint(2, e.code);
  if (!tail.own.empty()) ctx->payload_owned(tail.own.data(), tail.own.size());
  if ((reinterpret_cast<intptr_t>(user_data) & 1) && att_len) {
    ctx->att_view = att;  // borrow: frame outlives the burst append
    ctx->att_view_len = att_len;
  }
  return 0;
}

// per-connection protocol, sniffed from the first bytes (reference
// InputMessenger tries protocols in order on every new connection,
// input_messenger.cpp:317-382; here the port speaks tpu_std plus any
// protocol the server enabled via ns_enable_protocols)
enum ConnProto : int {
  P_UNKNOWN = 0,
  P_TPU = 1,
  P_HTTP = 2,
  P_REDIS = 3,
};

struct Conn {
  int fd = -1;
  uint64_t id = 0;
  int proto = P_UNKNOWN;
  bool close_after = false;  // HTTP Connection: close — after flush
  // frames handed to Python and not yet answered (http/redis only):
  // while >0 the engine neither reads nor cuts this connection, so
  // pipelined replies cannot overtake the Python one (RESP and
  // HTTP/1.1 have no correlation ids — order IS the protocol).
  // tpu_std is exempt: its frames carry correlation ids.
  std::atomic<int> py_pending{0};
  ByteBuf in;                // partial-frame accumulation
  std::deque<std::string> outq;  // pending writes (epoll-out driven)
  size_t out_off = 0;        // offset into outq.front()
  std::mutex out_mu;
  bool want_out = false;     // EPOLLOUT armed
  std::atomic<bool> dead{false};
  ~Conn() { NS_TSAN_MUTEX_DESTROY(&out_mu); }
};

struct Worker;

struct NativeServer {
  std::vector<std::thread> threads;
  std::vector<Worker*> workers;
  int listen_fd = -1;
  std::thread acceptor;
  std::atomic<bool> running{false};
  std::atomic<uint64_t> next_conn_id{1};
  std::atomic<uint32_t> rr{0};
  PyDispatch dispatch = nullptr;
  // native method registry: "service\0method" → handler + stats.
  // Methods are registered before listen() and never erased, so
  // workers read the map without reg_mu after start (values are
  // pointers; the atomics inside are the only mutated state).
  std::unordered_map<std::string, NativeMethod*> methods;
  // native HTTP registry: request path → handler (req = body bytes).
  // Registered before listen(), read lock-free by workers.
  std::unordered_map<std::string, NativeMethod*> http_methods;
  // which ConnProto bits this port answers (tpu_std always on)
  uint32_t proto_mask = 1u << P_TPU;
  // native redis KV: sharded map answering GET/SET/DEL/EXISTS/INCR/
  // PING entirely in C (the reference's redis_server example is a C++
  // RedisService; this is its native analog).  Other commands fall to
  // the Python RedisService dispatch.
  bool redis_native_kv = false;
  static constexpr int kKvShards = 16;
  std::mutex kv_mu[kKvShards];
  std::unordered_map<std::string, std::string> kv[kKvShards];
  std::mutex reg_mu;
  std::mutex conns_mu;
  std::unordered_map<uint64_t, std::pair<Worker*, Conn*>> conns;
  // server response-ring step log (ns_ring_stats): windows = reply burst
  // flushes — flush_pending_burst on the native fast-path lane plus
  // ns_send_burst on the Python-dispatch lane, one per harvested window
  // per conn either way; responses = frames those windows carried;
  // flush_bursts = conn_write_parts invocations (ring-lane traffic
  // shows bursts ≈ windows, a per-call reply path would not).
  std::atomic<uint64_t> ring_windows{0};
  std::atomic<uint64_t> ring_responses{0};
  std::atomic<uint64_t> flush_bursts{0};

  ~NativeServer() {
    for (auto& kv : methods) delete kv.second;
    NS_TSAN_MUTEX_DESTROY(&reg_mu);
    NS_TSAN_MUTEX_DESTROY(&conns_mu);
    for (int i = 0; i < kKvShards; i++) NS_TSAN_MUTEX_DESTROY(&kv_mu[i]);
  }

  NativeMethod* method_lookup(const std::string& svc, const std::string& m) {
    thread_local std::string key;  // reused: no per-frame allocation
    key.assign(svc);
    key.push_back('\0');
    key.append(m);
    auto it = methods.find(key);
    return it == methods.end() ? nullptr : it->second;
  }

  NativeMethod* method_get_or_create(const char* svc, const char* m) {
    std::lock_guard<std::mutex> g(reg_mu);
    std::string key = std::string(svc) + '\0' + m;
    auto it = methods.find(key);
    if (it != methods.end()) return it->second;
    NativeMethod* nm = new NativeMethod();
    methods[key] = nm;
    return nm;
  }
};

struct Worker {
  NativeServer* srv;
  int epfd = -1;
  int wake_fd = -1;  // eventfd: new conns / pending writes / stop
  std::mutex mu;
  std::vector<Conn*> incoming;
  std::vector<Conn*> writable;  // conns with queued output to arm
  std::vector<Conn*> resume;    // py_done'd conns: re-cut + re-arm
  std::atomic<bool> stop{false};

  void notify() {
    uint64_t one = 1;
    ssize_t n = ::write(wake_fd, &one, sizeof(one));
    (void)n;
  }
  ~Worker() { NS_TSAN_MUTEX_DESTROY(&mu); }
};

void conn_queue_write(Worker* w, Conn* c, std::string&& data) {
  bool need_arm = false;
  {
    std::lock_guard<std::mutex> g(c->out_mu);
    if (c->dead.load()) return;
    if (c->outq.empty()) {
      // try inline write first (StartWrite analog: first writer writes)
      size_t off = 0;
      while (off < data.size()) {
        ssize_t n = ::write(c->fd, data.data() + off, data.size() - off);
        if (n > 0) {
          off += static_cast<size_t>(n);
          continue;
        }
        if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) break;
        if (n < 0 && errno == EINTR) continue;
        c->dead.store(true);
        return;
      }
      if (off == data.size()) return;  // fully written inline
      c->outq.emplace_back(data.substr(off));
      need_arm = !c->want_out;
    } else {
      c->outq.emplace_back(std::move(data));
      need_arm = !c->want_out;
    }
  }
  if (need_arm) {
    std::lock_guard<std::mutex> g(w->mu);
    w->writable.push_back(c);
    w->notify();
  }
}

// drain queued output on EPOLLOUT; returns false on fatal error
bool conn_flush(Conn* c) {
  std::lock_guard<std::mutex> g(c->out_mu);
  while (!c->outq.empty()) {
    std::string& front = c->outq.front();
    while (c->out_off < front.size()) {
      size_t wmax = front.size() - c->out_off;
      bool short_after = false;
      uint64_t farg = 0;
      uint32_t fact = fault_check(FS_SRV_WRITE, &farg);
      if (fact == FA_EAGAIN) return true;  // EPOLLOUT (LT) refires
      if (fact == FA_RESET) return false;
      if (fact == FA_DELAY) fault_sleep_us(farg);
      if (fact == FA_SHORT) {
        size_t cap = farg ? static_cast<size_t>(farg) : 1;
        if (cap < wmax) wmax = cap;
        short_after = true;
      }
      ssize_t n = ::write(c->fd, front.data() + c->out_off, wmax);
      if (n > 0) {
        c->out_off += static_cast<size_t>(n);
        if (short_after) return true;  // remainder drains on the next
        continue;                      // level-triggered EPOLLOUT
      }
      if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) return true;
      if (n < 0 && errno == EINTR) continue;
      return false;
    }
    c->out_off = 0;
    c->outq.pop_front();
  }
  return true;
}

void close_conn(NativeServer* srv, Worker* w, Conn* c) {
  epoll_ctl(w->epfd, EPOLL_CTL_DEL, c->fd, nullptr);
  {
    // dead + close move together UNDER out_mu: a sender inside
    // conn_queue_write (it checked dead, it is mid-::write) must fully
    // leave the fd before the close, or a recycled fd NUMBER would
    // receive the tail of its write (caught by the TSan lane).  The
    // fds are non-blocking, so the wait here is bounded by one write.
    std::lock_guard<std::mutex> g(c->out_mu);
    c->dead.store(true);
    ::close(c->fd);
    c->fd = -1;
  }
  // ns_send holds conns_mu while touching a Conn, so erasing under the
  // same lock before delete makes the free safe against sender threads
  {
    std::lock_guard<std::mutex> g(srv->conns_mu);
    srv->conns.erase(c->id);
  }
  // purge any stale pointers queued for this worker (we ARE the worker
  // thread, the only consumer of these lists)
  {
    std::lock_guard<std::mutex> g(w->mu);
    for (auto it = w->writable.begin(); it != w->writable.end();) {
      it = (*it == c) ? w->writable.erase(it) : it + 1;
    }
    for (auto it = w->incoming.begin(); it != w->incoming.end();) {
      it = (*it == c) ? w->incoming.erase(it) : it + 1;
    }
    for (auto it = w->resume.begin(); it != w->resume.end();) {
      it = (*it == c) ? w->resume.erase(it) : it + 1;
    }
  }
  delete c;
}

// One entry of a scatter-gather response burst: either a [off,len)
// range of the burst string (owned bytes) or a borrowed view into the
// request frame.  Views let large echoed payloads reach the kernel via
// writev with ZERO user-space copies (reference Socket::DoWrite writev,
// socket.cpp:1584-1790) — the burst copy was why throughput FELL with
// payload size instead of rising.
struct OutPart {
  bool is_view;
  size_t off_or_ptr;  // burst offset, or the view pointer
  size_t len;
};

// views at or above this size ride writev; smaller ones are cheaper to
// memcpy into the burst than to spend an iovec entry on
constexpr size_t kViewThreshold = 16 * 1024;

void parts_add_burst_range(std::vector<OutPart>* parts, size_t off,
                           size_t len) {
  if (!len) return;
  if (!parts->empty() && !parts->back().is_view &&
      parts->back().off_or_ptr + parts->back().len == off) {
    parts->back().len += len;  // coalesce adjacent burst ranges
    return;
  }
  parts->push_back({false, off, len});
}

void burst_append_response(std::string* burst, std::vector<OutPart>* parts,
                           const std::string& meta_out,
                           const NativeRespCtx& ctx) {
  size_t base = burst->size();
  burst->resize(base + kHeader);
  put_header(&(*burst)[base], meta_out.size(),
             ctx.payload_size() + ctx.att_size());
  *burst += meta_out;
  for (const RespPart& part : ctx.payload_parts) {
    const char* p = part.is_view
                        ? reinterpret_cast<const char*>(part.off_or_ptr)
                        : ctx.arena.data() + part.off_or_ptr;
    if (part.is_view && part.len >= kViewThreshold) {
      parts_add_burst_range(parts, base, burst->size() - base);
      base = burst->size();
      parts->push_back({true, part.off_or_ptr, part.len});
    } else {
      burst->append(p, part.len);
    }
  }
  *burst += ctx.attachment;
  if (ctx.att_view_len) {
    if (ctx.att_view_len >= kViewThreshold) {
      parts_add_burst_range(parts, base, burst->size() - base);
      base = burst->size();
      parts->push_back(
          {true, reinterpret_cast<size_t>(ctx.att_view), ctx.att_view_len});
    } else {
      burst->append(reinterpret_cast<const char*>(ctx.att_view),
                    ctx.att_view_len);
    }
  }
  parts_add_burst_range(parts, base, burst->size() - base);
}

// Flush one read-cycle's scatter-gather burst on the worker thread that
// owns the connection.  Inline writev first; whatever the kernel won't
// take is COPIED into the ordered outq (views must not outlive the read
// buffer) and EPOLLOUT drains it.
void conn_write_parts(Worker* w, Conn* c, const std::string& burst,
                      const std::vector<OutPart>& parts) {
  w->srv->flush_bursts.fetch_add(1, std::memory_order_relaxed);
  std::lock_guard<std::mutex> g(c->out_mu);
  if (c->dead.load()) return;
  size_t idx = 0, part_off = 0;
  if (c->outq.empty()) {
    while (idx < parts.size()) {
      iovec iov[64];
      int cnt = 0;
      size_t j = idx, joff = part_off;
      while (j < parts.size() && cnt < 64) {
        const OutPart& p = parts[j];
        const char* base = p.is_view
                               ? reinterpret_cast<const char*>(p.off_or_ptr)
                               : burst.data() + p.off_or_ptr;
        iov[cnt].iov_base = const_cast<char*>(base + joff);
        iov[cnt].iov_len = p.len - joff;
        cnt++;
        j++;
        joff = 0;
      }
      // chaos srv_write site: an injected partial write diverts the
      // burst remainder through the outq + EPOLLOUT drain, which is
      // exactly the reply-ordering machinery the invariant suite
      // exercises (HTTP/RESP order survives partial flushes).
      bool short_after = false;
      uint64_t farg = 0;
      uint32_t fact = fault_check(FS_SRV_WRITE, &farg);
      if (fact == FA_EAGAIN) break;
      if (fact == FA_RESET) {
        c->dead.store(true);
        return;
      }
      if (fact == FA_DELAY) fault_sleep_us(farg);
      if (fact == FA_SHORT) {
        cnt = 1;  // one iovec, capped: a genuine short writev
        size_t cap = farg ? static_cast<size_t>(farg) : 1;
        if (cap < iov[0].iov_len) iov[0].iov_len = cap;
        short_after = true;
      }
      ssize_t n = ::writev(c->fd, iov, cnt);
      if (n < 0) {
        if (errno == EINTR) continue;
        if (errno == EAGAIN || errno == EWOULDBLOCK) break;
        c->dead.store(true);
        return;
      }
      size_t left = static_cast<size_t>(n);
      while (left) {
        size_t avail = parts[idx].len - part_off;
        if (left >= avail) {
          left -= avail;
          idx++;
          part_off = 0;
        } else {
          part_off += left;
          left = 0;
        }
      }
      if (short_after && idx < parts.size()) break;
    }
    if (idx >= parts.size()) return;  // fully written inline
  }
  // copy the unsent remainder (ordered after any existing outq)
  std::string rest;
  size_t total = 0;
  for (size_t i = idx; i < parts.size(); i++)
    total += parts[i].len - (i == idx ? part_off : 0);
  rest.reserve(total);
  for (size_t i = idx; i < parts.size(); i++) {
    const OutPart& p = parts[i];
    const char* base = p.is_view
                           ? reinterpret_cast<const char*>(p.off_or_ptr)
                           : burst.data() + p.off_or_ptr;
    size_t skip = (i == idx) ? part_off : 0;
    rest.append(base + skip, p.len - skip);
  }
  c->outq.emplace_back(std::move(rest));
  if (!c->want_out) {
    // we ARE the owning worker thread: arm EPOLLOUT directly
    c->want_out = true;
    epoll_event ev{};
    ev.events = EPOLLIN | EPOLLOUT;
    ev.data.ptr = c;
    epoll_ctl(w->epfd, EPOLL_CTL_MOD, c->fd, &ev);
  }
}

// Reply ordering: native replies accumulated in this read cycle's burst
// must reach the connection's write path BEFORE a frame is dispatched
// to Python.  ns_send replies write straight to the socket (inline when
// outq is empty) and would otherwise overtake the unflushed burst —
// HTTP/1.x and RESP carry no correlation ids, so order IS the protocol.
// Flushing here (inside the cut, before srv->dispatch) also covers the
// conn_resume path, which re-cuts buffered bytes after ns_py_done.
void flush_pending_burst(Worker* w, Conn* c, std::string* burst,
                         std::vector<OutPart>* parts) {
  if (!parts->empty()) {
    // the native-lane half of the server response ring's step log:
    // one window per non-empty read-cycle flush, same contract as
    // ns_send_burst on the Python-dispatch lane
    w->srv->ring_windows.fetch_add(1, std::memory_order_relaxed);
    conn_write_parts(w, c, *burst, *parts);
    parts->clear();
  }
  burst->clear();
}

// handle one complete frame; returns false → close connection.
// Fast-path responses append to *burst (ONE write per read burst — the
// NOSIGNAL batching analog, input_messenger.cpp:169-190); Python
// fallback frames dispatch out-of-band as before.
bool server_on_frame(NativeServer* srv, Worker* w, Conn* c,
                     const uint8_t* frame, size_t len, std::string* burst,
                     std::vector<OutPart>* parts, std::string* py_burst) {
  uint32_t meta_size, body_size;
  memcpy(&meta_size, frame + 4, 4);
  memcpy(&body_size, frame + 8, 4);
  meta_size = ntohl(meta_size);
  body_size = ntohl(body_size);
  const uint8_t* meta_p = frame + kHeader;
  const uint8_t* body_p = meta_p + meta_size;

  MetaView m;
  if (parse_meta(meta_p, meta_size, &m) && m.has_request && !m.has_response &&
      !m.compress_type && !m.has_stream && !m.has_auth && !m.has_device_segs &&
      m.attachment_size <= body_size) {
    NativeMethod* nm = srv->method_lookup(m.service, m.method);
    if (nm != nullptr) {
      // concurrency gate: fast-path rejection mirrors the Python
      // transport's admission shed (server/admission.py): EOVERCROWDED
      // = "this server is overloaded, retry elsewhere" (docs/overload.md)
      int32_t limit = nm->max_concurrency.load(std::memory_order_relaxed);
      int32_t cur = nm->inflight.fetch_add(1, std::memory_order_relaxed) + 1;
      if (limit > 0 && cur > limit) {
        nm->inflight.fetch_sub(1, std::memory_order_relaxed);
        nm->rejected.fetch_add(1, std::memory_order_relaxed);
        NativeRespCtx empty;
        srv->ring_responses.fetch_add(1, std::memory_order_relaxed);
        burst_append_response(
            burst, parts,
            pack_response_meta(m.correlation_id, 0, 1011,  // EOVERCROWDED
                               "method concurrency limit reached "
                               "(retry elsewhere)"),
            empty);
        return true;
      }
      struct timespec t0, t1;
      clock_gettime(CLOCK_MONOTONIC, &t0);
      thread_local NativeRespCtx ctx;  // reuse arena capacity
      ctx.clear();
      size_t req_len = body_size - m.attachment_size;
      int32_t ec = nm->fn(nm->user_data, body_p, req_len, body_p + req_len,
                          m.attachment_size, &ctx);
      nm->inflight.fetch_sub(1, std::memory_order_relaxed);
      if (ec >= 0) {
        clock_gettime(CLOCK_MONOTONIC, &t1);
        uint64_t dt = (t1.tv_sec - t0.tv_sec) * 1000000000ull +
                      (t1.tv_nsec - t0.tv_nsec);
        nm->count.fetch_add(1, std::memory_order_relaxed);
        nm->latency_ns_sum.fetch_add(dt, std::memory_order_relaxed);
        if (ec != 0) nm->errors.fetch_add(1, std::memory_order_relaxed);
        srv->ring_responses.fetch_add(1, std::memory_order_relaxed);
        burst_append_response(
            burst, parts,
            pack_response_meta(m.correlation_id, ctx.att_size(), ec),
            ctx);
        return true;
      }
      // ec < 0: handler declined → full Python semantics below
    }
  }
  // ---- Python fallback: full framework semantics ----
  // Frames accumulate into *py_burst and dispatch ONCE per read burst
  // after the cut loop (cut_frames): a client ring window of N calls
  // (nc_mux_submit_many) that lands in one read then crosses into
  // Python as ONE dispatch, and the server-side micro-batcher sees it
  // as one accumulation.  Safe for tpu_std only: frames carry
  // correlation ids, so replies need no ordering against the native
  // burst flush (unlike HTTP/RESP, which never reach this path).
  if (srv->dispatch) {
    py_burst->append(reinterpret_cast<const char*>(frame), len);
    return !c->dead.load();
  }
  return false;
}

// Cut complete frames out of [data, data+len); appends fast-path
// responses to *burst.  Returns bytes consumed; sets *fatal.
size_t cut_frames(NativeServer* srv, Worker* w, Conn* c, const uint8_t* data,
                  size_t len, std::string* burst,
                  std::vector<OutPart>* parts, bool* fatal) {
  size_t off = 0;
  // Python-fallback frames from this read burst, dispatched as ONE
  // crossing after the loop (see server_on_frame).  thread_local keeps
  // the capacity warm across bursts; the worker never re-enters
  // cut_frames while dispatch runs (conn_resume is re-queued, not
  // recursive), so a single buffer per worker thread is safe.
  static thread_local std::string py_burst;
  py_burst.clear();
  while (!*fatal) {
    size_t avail = len - off;
    if (avail < kHeader) break;
    const uint8_t* p = data + off;
    if (memcmp(p, kMagic, 4) != 0) {
      *fatal = true;  // non-tpu_std traffic: native port speaks one
      break;
    }
    uint32_t ms, bs;
    memcpy(&ms, p + 4, 4);
    memcpy(&bs, p + 8, 4);
    ms = ntohl(ms);
    bs = ntohl(bs);
    if (static_cast<uint64_t>(ms) + bs > kMaxBody) {
      *fatal = true;
      break;
    }
    size_t total = kHeader + ms + bs;
    if (avail < total) break;
    if (!server_on_frame(srv, w, c, p, total, burst, parts, &py_burst))
      *fatal = true;
    off += total;
  }
  if (!py_burst.empty() && srv->dispatch) {
    srv->dispatch(c->id, P_TPU,
                  reinterpret_cast<const uint8_t*>(py_burst.data()),
                  py_burst.size());
    py_burst.clear();
    if (c->dead.load()) *fatal = true;
  }
  return off;
}

// ---------------------------------------------------------------------------
// HTTP/1.1 server framer (native fast path for registered paths;
// reference http parsing lives in details/http_message.cpp — this is a
// purpose-built cut for the hot server loop, full semantics fall back
// to the Python http stack)
// ---------------------------------------------------------------------------

bool ascii_ieq(const char* a, const char* b, size_t n) {
  for (size_t i = 0; i < n; i++) {
    char ca = a[i], cb = b[i];
    if (ca >= 'A' && ca <= 'Z') ca += 32;
    if (cb >= 'A' && cb <= 'Z') cb += 32;
    if (ca != cb) return false;
  }
  return true;
}

// find a header's value inside [hdrs, hdrs+len); returns false if absent
bool http_find_header(const char* hdrs, size_t len, const char* name,
                      size_t name_len, const char** val, size_t* val_len) {
  size_t i = 0;
  while (i < len) {
    // line start at i
    size_t eol = i;
    while (eol < len && hdrs[eol] != '\n') eol++;
    size_t line_end = (eol > i && hdrs[eol - 1] == '\r') ? eol - 1 : eol;
    if (line_end - i > name_len && hdrs[i + name_len] == ':' &&
        ascii_ieq(hdrs + i, name, name_len)) {
      size_t v = i + name_len + 1;
      while (v < line_end && (hdrs[v] == ' ' || hdrs[v] == '\t')) v++;
      *val = hdrs + v;
      *val_len = line_end - v;
      return true;
    }
    i = eol + 1;
  }
  return false;
}

constexpr size_t kMaxHttpHeader = 64 * 1024;

// emit a simple HTTP/1.1 response with scatter-gather body parts
void http_emit_response(std::string* burst, std::vector<OutPart>* parts,
                        int status, const char* reason,
                        const NativeRespCtx& ctx, bool keep_alive) {
  char head[256];
  size_t blen = ctx.payload_size() + ctx.att_size();
  int n = snprintf(head, sizeof(head),
                   "HTTP/1.1 %d %s\r\nContent-Type: "
                   "application/octet-stream\r\nContent-Length: %zu\r\n%s\r\n",
                   status, reason, blen,
                   keep_alive ? "" : "Connection: close\r\n");
  size_t base = burst->size();
  burst->append(head, n);
  for (const RespPart& part : ctx.payload_parts) {
    const char* p = part.is_view
                        ? reinterpret_cast<const char*>(part.off_or_ptr)
                        : ctx.arena.data() + part.off_or_ptr;
    if (part.is_view && part.len >= kViewThreshold) {
      parts_add_burst_range(parts, base, burst->size() - base);
      base = burst->size();
      parts->push_back({true, part.off_or_ptr, part.len});
    } else {
      burst->append(p, part.len);
    }
  }
  burst->append(ctx.attachment);
  if (ctx.att_view_len) {
    if (ctx.att_view_len >= kViewThreshold) {
      parts_add_burst_range(parts, base, burst->size() - base);
      base = burst->size();
      parts->push_back(
          {true, reinterpret_cast<size_t>(ctx.att_view), ctx.att_view_len});
    } else {
      burst->append(reinterpret_cast<const char*>(ctx.att_view),
                    ctx.att_view_len);
    }
  }
  parts_add_burst_range(parts, base, burst->size() - base);
}

// echo handler for the native http registry: response body = request body
int32_t builtin_http_echo(void*, const uint8_t* req, uint64_t req_len,
                          const uint8_t*, uint64_t, void* resp_ctx) {
  NativeRespCtx* ctx = static_cast<NativeRespCtx*>(resp_ctx);
  if (req_len) ctx->payload_view(req, req_len);
  return 0;
}

// cut complete HTTP/1.1 requests; native-registered paths answer in C,
// everything else (and chunked bodies) dispatches raw to Python
size_t http_cut(NativeServer* srv, Worker* w, Conn* c, const uint8_t* data,
                size_t len, std::string* burst, std::vector<OutPart>* parts,
                bool* fatal) {
  size_t off = 0;
  while (!*fatal && !c->close_after &&
         c->py_pending.load(std::memory_order_acquire) == 0) {
    const char* p = reinterpret_cast<const char*>(data) + off;
    size_t avail = len - off;
    if (avail < 16) break;
    // find end of headers
    const char* hdr_end = nullptr;
    size_t scan = avail < kMaxHttpHeader ? avail : kMaxHttpHeader;
    for (size_t i = 3; i < scan; i++) {
      if (p[i] == '\n' && p[i - 1] == '\r' && p[i - 2] == '\n' &&
          p[i - 3] == '\r') {
        hdr_end = p + i + 1;
        break;
      }
    }
    if (hdr_end == nullptr) {
      if (avail >= kMaxHttpHeader) *fatal = true;
      break;
    }
    size_t hdrs_len = static_cast<size_t>(hdr_end - p);
    // request line: METHOD SP PATH SP VERSION
    const char* sp1 = static_cast<const char*>(memchr(p, ' ', hdrs_len));
    if (!sp1) {
      *fatal = true;
      break;
    }
    const char* sp2 = static_cast<const char*>(
        memchr(sp1 + 1, ' ', hdrs_len - (sp1 + 1 - p)));
    if (!sp2) {
      *fatal = true;
      break;
    }
    const char* val;
    size_t val_len;
    bool chunked = false;
    uint64_t content_len = 0;
    if (http_find_header(p, hdrs_len, "transfer-encoding", 17, &val,
                         &val_len)) {
      chunked = true;  // any transfer-encoding → Python semantics
    } else if (http_find_header(p, hdrs_len, "content-length", 14, &val,
                                &val_len)) {
      for (size_t i = 0; i < val_len; i++) {
        if (val[i] < '0' || val[i] > '9') {
          *fatal = true;
          return off;
        }
        content_len = content_len * 10 + (val[i] - '0');
        if (content_len > kMaxBody) {  // in-loop: a 20-digit value
          *fatal = true;               // would wrap uint64 past the
          return off;                  // single post-loop check
        }
      }
    }
    size_t total;
    if (chunked) {
      // scan chunk framing to find the request's full extent
      size_t i = hdrs_len;
      bool complete = false;
      while (i + 2 <= avail) {
        uint64_t csize = 0;
        size_t j = i;
        while (j < avail && p[j] != '\r' && p[j] != ';') {
          char ch = p[j];
          uint64_t d;
          if (ch >= '0' && ch <= '9') d = ch - '0';
          else if (ch >= 'a' && ch <= 'f') d = ch - 'a' + 10;
          else if (ch >= 'A' && ch <= 'F') d = ch - 'A' + 10;
          else { *fatal = true; return off; }
          csize = csize * 16 + d;
          if (csize > kMaxBody) { *fatal = true; return off; }
          j++;
        }
        // skip to end of chunk-size line
        while (j < avail && p[j] != '\n') j++;
        if (j >= avail) break;
        j++;  // past \n
        if (csize == 0) {
          // trailer: expect CRLF (no trailer headers support)
          if (j + 2 > avail) break;
          if (p[j] == '\r' && p[j + 1] == '\n') {
            i = j + 2;
            complete = true;
          } else {
            *fatal = true;
            return off;
          }
          break;
        }
        if (j + csize + 2 > avail) { i = avail; break; }
        j += csize;
        if (p[j] != '\r' || p[j + 1] != '\n') { *fatal = true; return off; }
        i = j + 2;
      }
      if (!complete) break;  // need more bytes
      total = i;
    } else {
      total = hdrs_len + content_len;
      if (avail < total) break;
    }
    // keep-alive: HTTP/1.1 defaults to keep unless "Connection: close";
    // HTTP/1.0 defaults to CLOSE unless the client opts in with
    // "Connection: keep-alive" (RFC 7230 §6.3 / RFC 1945 appendix) —
    // holding a 1.0 connection open would wedge clients that detect
    // end-of-body by EOF.
    size_t rl_end = hdrs_len;  // end of request line, before CRLF
    {
      const char* nl = static_cast<const char*>(memchr(p, '\n', hdrs_len));
      if (nl) rl_end = static_cast<size_t>(nl - p);
      if (rl_end && p[rl_end - 1] == '\r') rl_end--;
    }
    const char* ver = sp2 + 1;
    bool http10 = static_cast<size_t>(ver - p) + 8 <= rl_end &&
                  memcmp(ver, "HTTP/1.0", 8) == 0;
    bool keep_alive = !http10;
    if (http_find_header(p, hdrs_len, "connection", 10, &val, &val_len)) {
      if (val_len == 5 && ascii_ieq(val, "close", 5)) {
        keep_alive = false;
      } else if (val_len == 10 && ascii_ieq(val, "keep-alive", 10)) {
        keep_alive = true;
      }
    }
    NativeMethod* nm = nullptr;
    if (!chunked && !srv->http_methods.empty()) {
      thread_local std::string pkey;
      pkey.assign(sp1 + 1, sp2 - sp1 - 1);
      // strip query string: registry keys are bare paths
      size_t q = pkey.find('?');
      if (q != std::string::npos) pkey.resize(q);
      auto it = srv->http_methods.find(pkey);
      if (it != srv->http_methods.end()) nm = it->second;
    }
    if (nm != nullptr) {
      int32_t limit = nm->max_concurrency.load(std::memory_order_relaxed);
      int32_t cur = nm->inflight.fetch_add(1, std::memory_order_relaxed) + 1;
      if (limit > 0 && cur > limit) {
        nm->inflight.fetch_sub(1, std::memory_order_relaxed);
        nm->rejected.fetch_add(1, std::memory_order_relaxed);
        NativeRespCtx empty;
        http_emit_response(burst, parts, 503, "Service Unavailable", empty,
                           keep_alive);
      } else {
        struct timespec t0, t1;
        clock_gettime(CLOCK_MONOTONIC, &t0);
        thread_local NativeRespCtx hctx;
        hctx.clear();
        int32_t ec = nm->fn(
            nm->user_data, reinterpret_cast<const uint8_t*>(p) + hdrs_len,
            total - hdrs_len, nullptr, 0, &hctx);
        nm->inflight.fetch_sub(1, std::memory_order_relaxed);
        clock_gettime(CLOCK_MONOTONIC, &t1);
        uint64_t dt = (t1.tv_sec - t0.tv_sec) * 1000000000ull +
                      (t1.tv_nsec - t0.tv_nsec);
        nm->count.fetch_add(1, std::memory_order_relaxed);
        nm->latency_ns_sum.fetch_add(dt, std::memory_order_relaxed);
        if (ec > 0) nm->errors.fetch_add(1, std::memory_order_relaxed);
        if (ec == 0) {
          http_emit_response(burst, parts, 200, "OK", hctx, keep_alive);
        } else if (ec < 0) {
          // declined → full Python semantics (Python owns the close
          // decision and the reply ORDER: pause cutting until py_done)
          if (srv->dispatch) {
            flush_pending_burst(w, c, burst, parts);
            c->py_pending.fetch_add(1, std::memory_order_release);
            srv->dispatch(c->id, P_HTTP,
                          reinterpret_cast<const uint8_t*>(p), total);
            keep_alive = true;
            off += total;
            return off;
          }
          *fatal = true;
        } else {
          NativeRespCtx empty;
          http_emit_response(burst, parts, 500, "Internal Server Error",
                             empty, keep_alive);
        }
      }
    } else if (srv->dispatch) {
      // Python owns the close decision for dispatched requests AND the
      // reply order: no further frame is cut (and no byte read) on
      // this connection until ns_py_done
      flush_pending_burst(w, c, burst, parts);
      c->py_pending.fetch_add(1, std::memory_order_release);
      srv->dispatch(c->id, P_HTTP, reinterpret_cast<const uint8_t*>(p),
                    total);
      off += total;
      return off;
    } else {
      *fatal = true;
      break;
    }
    if (!keep_alive) c->close_after = true;
    off += total;
  }
  return off;
}

// ---------------------------------------------------------------------------
// RESP (redis) server framer — native sharded KV for the hot commands,
// Python RedisService dispatch for the rest (reference redis.h
// RedisService / redis_protocol.cpp)
// ---------------------------------------------------------------------------

void resp_bulk(std::string* out, const char* p, size_t n) {
  char h[24];
  out->append(h, snprintf(h, sizeof(h), "$%zu\r\n", n));
  out->append(p, n);
  out->append("\r\n", 2);
}

// parse one client RESP array of bulk strings; returns bytes consumed
// (0 = incomplete), argv filled with (ptr,len) views; *bad on garbage
size_t resp_parse(const uint8_t* data, size_t len,
                  std::vector<std::pair<const char*, size_t>>* argv,
                  bool* bad) {
  argv->clear();
  const char* p = reinterpret_cast<const char*>(data);
  if (len < 4) return 0;
  if (p[0] != '*') {
    *bad = true;
    return 0;
  }
  size_t i = 1;
  int64_t nelem = 0;
  while (i < len && p[i] != '\r') {
    if (p[i] < '0' || p[i] > '9' || nelem > 1024 * 1024) {
      *bad = true;
      return 0;
    }
    nelem = nelem * 10 + (p[i] - '0');
    i++;
  }
  if (i + 2 > len) return 0;
  i += 2;  // \r\n
  for (int64_t e = 0; e < nelem; e++) {
    if (i >= len) return 0;
    if (p[i] != '$') {
      *bad = true;
      return 0;
    }
    i++;
    int64_t blen = 0;
    while (i < len && p[i] != '\r') {
      if (p[i] < '0' || p[i] > '9' || blen > (1 << 30)) {
        *bad = true;
        return 0;
      }
      blen = blen * 10 + (p[i] - '0');
      i++;
    }
    if (i + 2 > len) return 0;
    i += 2;
    if (i + static_cast<size_t>(blen) + 2 > len) return 0;
    argv->push_back({p + i, static_cast<size_t>(blen)});
    i += blen;
    if (p[i] != '\r' || p[i + 1] != '\n') {
      *bad = true;
      return 0;
    }
    i += 2;
  }
  return i;
}

size_t resp_cut(NativeServer* srv, Worker* w, Conn* c, const uint8_t* data,
                size_t len, std::string* burst,
                std::vector<OutPart>* parts, bool* fatal) {
  thread_local std::vector<std::pair<const char*, size_t>> argv;
  std::hash<std::string> hasher;
  size_t off = 0;
  // resp replies are all small owned bytes: cover everything appended
  // here with one burst-range part so the shared flush path picks it up
  size_t b0 = burst->size();
  while (!*fatal && c->py_pending.load(std::memory_order_acquire) == 0) {
    bool bad = false;
    size_t used = resp_parse(data + off, len - off, &argv, &bad);
    if (bad) {
      *fatal = true;
      break;
    }
    if (!used) break;
    bool handled = false;
    if (srv->redis_native_kv && !argv.empty()) {
      thread_local std::string cmd;
      cmd.assign(argv[0].first, argv[0].second);
      for (char& ch : cmd)
        if (ch >= 'a' && ch <= 'z') ch -= 32;
      handled = true;
      if (cmd == "PING" && argv.size() == 1) {
        burst->append("+PONG\r\n", 7);
      } else if (cmd == "SET" && argv.size() == 3) {
        // option-bearing SET (NX/XX/EX/PX/GET…) falls through to the
        // Python RedisService: silently ignoring options would ack
        // writes with semantics the client never got
        std::string key(argv[1].first, argv[1].second);
        int shard = hasher(key) & (NativeServer::kKvShards - 1);
        {
          std::lock_guard<std::mutex> g(srv->kv_mu[shard]);
          srv->kv[shard][std::move(key)].assign(argv[2].first,
                                                argv[2].second);
        }
        burst->append("+OK\r\n", 5);
      } else if (cmd == "GET" && argv.size() == 2) {
        std::string key(argv[1].first, argv[1].second);
        int shard = hasher(key) & (NativeServer::kKvShards - 1);
        std::lock_guard<std::mutex> g(srv->kv_mu[shard]);
        auto it = srv->kv[shard].find(key);
        if (it == srv->kv[shard].end())
          burst->append("$-1\r\n", 5);
        else
          resp_bulk(burst, it->second.data(), it->second.size());
      } else if (cmd == "DEL" && argv.size() >= 2) {
        int64_t removed = 0;
        for (size_t a = 1; a < argv.size(); a++) {
          std::string key(argv[a].first, argv[a].second);
          int shard = hasher(key) & (NativeServer::kKvShards - 1);
          std::lock_guard<std::mutex> g(srv->kv_mu[shard]);
          removed += srv->kv[shard].erase(key);
        }
        char h[24];
        burst->append(h, snprintf(h, sizeof(h), ":%lld\r\n",
                                  static_cast<long long>(removed)));
      } else if (cmd == "EXISTS" && argv.size() == 2) {
        std::string key(argv[1].first, argv[1].second);
        int shard = hasher(key) & (NativeServer::kKvShards - 1);
        std::lock_guard<std::mutex> g(srv->kv_mu[shard]);
        burst->append(srv->kv[shard].count(key) ? ":1\r\n" : ":0\r\n", 4);
      } else if (cmd == "INCR" && argv.size() == 2) {
        std::string key(argv[1].first, argv[1].second);
        int shard = hasher(key) & (NativeServer::kKvShards - 1);
        std::lock_guard<std::mutex> g(srv->kv_mu[shard]);
        std::string& v = srv->kv[shard][key];
        long long cur = 0;
        bool numeric = true;
        if (!v.empty()) {
          char* endp = nullptr;
          cur = strtoll(v.c_str(), &endp, 10);
          numeric = endp != nullptr && *endp == 0;
        }
        if (!numeric) {
          burst->append("-ERR value is not an integer or out of range\r\n");
        } else {
          cur += 1;
          char num[24];
          v.assign(num, snprintf(num, sizeof(num), "%lld", cur));
          char h[28];
          burst->append(h, snprintf(h, sizeof(h), ":%lld\r\n", cur));
        }
      } else {
        handled = false;  // unknown command → Python RedisService
      }
    }
    if (!handled) {
      if (srv->dispatch) {
        // pause: RESP replies must stay in command order, so no later
        // command may be answered (natively or otherwise) until Python
        // finishes this one (ns_py_done resumes the cut) — and the
        // native replies already accumulated must hit the wire first
        if (burst->size() > b0)
          parts_add_burst_range(parts, b0, burst->size() - b0);
        flush_pending_burst(w, c, burst, parts);
        c->py_pending.fetch_add(1, std::memory_order_release);
        srv->dispatch(c->id, P_REDIS, data + off, used);
        off += used;
        return off;
      }
      *fatal = true;
      break;
    }
    off += used;
  }
  if (burst->size() > b0)
    parts_add_burst_range(parts, b0, burst->size() - b0);
  return off;
}

// sniff + route one read chunk through the connection's protocol
size_t proto_cut(NativeServer* srv, Worker* w, Conn* c, const uint8_t* data,
                 size_t len, std::string* burst,
                 std::vector<OutPart>* parts, bool* fatal) {
  if (c->proto == P_UNKNOWN) {
    if (len >= 4 && memcmp(data, kMagic, 4) == 0) {
      c->proto = P_TPU;
    } else if ((srv->proto_mask & (1u << P_REDIS)) && data[0] == '*') {
      c->proto = P_REDIS;
    } else {
      bool is_http = false, maybe_http = false;
      if (srv->proto_mask & (1u << P_HTTP)) {
        static const char* kMethods[] = {"GET ",  "POST ",   "PUT ",
                                         "HEAD ", "DELETE ", "OPTIONS ",
                                         "PATCH "};
        for (const char* m : kMethods) {
          size_t ml = strlen(m);
          if (len >= ml) {
            if (memcmp(data, m, ml) == 0) {
              is_http = true;
              break;
            }
          } else if (memcmp(data, m, len) == 0) {
            maybe_http = true;
          }
        }
      }
      if (is_http) {
        c->proto = P_HTTP;
      } else {
        // a short first read may still grow into TRPC magic or an
        // HTTP method — only kill once no enabled protocol can match
        bool maybe_tpu =
            len < 4 && memcmp(data, kMagic, len) == 0;
        if (maybe_tpu || maybe_http) return 0;
        *fatal = true;
        return 0;
      }
    }
  }
  switch (c->proto) {
    case P_TPU:
      return cut_frames(srv, w, c, data, len, burst, parts, fatal);
    case P_HTTP:
      return http_cut(srv, w, c, data, len, burst, parts, fatal);
    case P_REDIS:
      return resp_cut(srv, w, c, data, len, burst, parts, fatal);
  }
  *fatal = true;
  return 0;
}

// Re-cut a connection's buffered bytes after Python answered its
// dispatched frame (ns_py_done), then re-arm EPOLLIN.  Runs on the
// owning worker thread.
void conn_resume(NativeServer* srv, Worker* w, Conn* c) {
  if (c->dead.load()) {
    close_conn(srv, w, c);
    return;
  }
  static thread_local std::string burst;
  static thread_local std::vector<OutPart> oparts;
  burst.clear();
  oparts.clear();
  bool fatal = false;
  if (!c->in.empty()) {
    size_t off = proto_cut(srv, w, c, c->in.data(), c->in.size(), &burst,
                           &oparts, &fatal);
    if (!fatal && !oparts.empty()) {
      srv->ring_windows.fetch_add(1, std::memory_order_relaxed);
      conn_write_parts(w, c, burst, oparts);
    }
    if (c->dead.load()) fatal = true;
    if (!fatal && off) c->in.erase_front(off);
  }
  if (fatal) {
    close_conn(srv, w, c);
    return;
  }
  if (c->close_after) {
    std::lock_guard<std::mutex> g(c->out_mu);
    if (c->outq.empty()) {
      fatal = true;
    }
  }
  if (fatal) {
    close_conn(srv, w, c);
    return;
  }
  if (c->py_pending.load(std::memory_order_acquire) == 0) {
    std::lock_guard<std::mutex> g(c->out_mu);
    epoll_event ev{};
    ev.events = EPOLLIN | (c->want_out ? EPOLLOUT : 0);
    ev.data.ptr = c;
    epoll_ctl(w->epfd, EPOLL_CTL_MOD, c->fd, &ev);
  }
}

void worker_loop(NativeServer* srv, Worker* w) {
  epoll_event evs[128];
  std::vector<Conn*> res_pending;  // resumes deferred past the batch
  while (!w->stop.load()) {
    int n = epoll_wait(w->epfd, evs, 128, 500);
    if (n < 0) {
      if (errno == EINTR) continue;
      break;
    }
    res_pending.clear();
    for (int i = 0; i < n; i++) {
      if (evs[i].data.ptr == nullptr) {  // wake eventfd
        uint64_t junk;
        while (::read(w->wake_fd, &junk, sizeof(junk)) > 0) {
        }
        std::vector<Conn*> add, arm, res;
        {
          std::lock_guard<std::mutex> g(w->mu);
          add.swap(w->incoming);
          arm.swap(w->writable);
          res.swap(w->resume);
        }
        // resumes may CLOSE (delete) a conn, and a later event in THIS
        // batch may still reference it — defer them past the loop
        res_pending.insert(res_pending.end(), res.begin(), res.end());
        for (Conn* c : add) {
          epoll_event ev{};
          ev.events = EPOLLIN;
          ev.data.ptr = c;
          if (epoll_ctl(w->epfd, EPOLL_CTL_ADD, c->fd, &ev) < 0) {
            close_conn(srv, w, c);
          }
        }
        for (Conn* c : arm) {
          if (c->dead.load()) continue;
          std::lock_guard<std::mutex> g(c->out_mu);
          if (!c->outq.empty() && !c->want_out) {
            c->want_out = true;
            epoll_event ev{};
            ev.events = EPOLLIN | EPOLLOUT;
            ev.data.ptr = c;
            epoll_ctl(w->epfd, EPOLL_CTL_MOD, c->fd, &ev);
          }
        }
        continue;
      }
      Conn* c = static_cast<Conn*>(evs[i].data.ptr);
      bool fatal = false;
      if (evs[i].events & (EPOLLHUP | EPOLLERR)) fatal = true;
      if (!fatal && (evs[i].events & EPOLLOUT)) {
        if (!conn_flush(c)) {
          fatal = true;
        } else {
          std::lock_guard<std::mutex> g(c->out_mu);
          if (c->outq.empty() && c->close_after) fatal = true;
          if (!fatal && c->outq.empty() && c->want_out) {
            c->want_out = false;
            epoll_event ev{};
            ev.events = EPOLLIN;
            ev.data.ptr = c;
            epoll_ctl(w->epfd, EPOLL_CTL_MOD, c->fd, &ev);
          }
        }
      }
      if (!fatal && (evs[i].events & EPOLLIN)) {
        // level-triggered read: pull what's there, cut complete frames.
        // When no partial frame is pending, frames are cut DIRECTLY
        // from the read buffer (no staging copy); only the trailing
        // partial frame is stashed in c->in — and once a frame IS
        // pending, later reads land straight in c->in's tail (ByteBuf:
        // no zero-fill, no stage-then-copy), so a large frame costs
        // ONE kernel→user copy however many reads deliver it.
        // Responses from one read chunk coalesce into one writev whose
        // large payload views point STRAIGHT into the buffer that was
        // cut — flushed before the next read() can clobber/realloc
        // what they reference.
        constexpr size_t kReadChunk = 1024 * 1024;
        static thread_local ByteBuf rdbuf;
        static thread_local std::string burst;
        static thread_local std::vector<OutPart> oparts;
        rdbuf.reserve(kReadChunk);
        for (;;) {
          burst.clear();
          oparts.clear();
          bool direct = c->in.empty();
          char* dst =
              direct ? reinterpret_cast<char*>(rdbuf.data())
                     : reinterpret_cast<char*>(c->in.tail(kReadChunk));
          // chaos srv_read site: short reads force the in-place
          // partial-frame completion path; EAGAIN/reset/delay model a
          // flaky peer.  Disarmed cost: one relaxed atomic load.
          size_t want = kReadChunk;
          uint64_t farg = 0;
          uint32_t fact = fault_check(FS_SRV_READ, &farg);
          if (fact == FA_SHORT) {
            // min(arg, kReadChunk); arg==0 degenerates to 1 byte
            want = farg == 0 ? 1
                   : farg < kReadChunk ? static_cast<size_t>(farg)
                                       : kReadChunk;
          } else if (fact == FA_EAGAIN) {
            break;  // level-triggered epoll re-delivers the event
          } else if (fact == FA_RESET) {
            fatal = true;
            break;
          } else if (fact == FA_DELAY) {
            fault_sleep_us(farg);
          }
          ssize_t r = ::read(c->fd, dst, want);
          if (r > 0) {
            const uint8_t* data;
            size_t dlen;
            if (direct) {
              data = rdbuf.data();
              dlen = static_cast<size_t>(r);
            } else {
              c->in.advance(static_cast<size_t>(r));
              data = c->in.data();
              dlen = c->in.size();
            }
            size_t off =
                proto_cut(srv, w, c, data, dlen, &burst, &oparts, &fatal);
            if (fatal) break;
            if (!oparts.empty()) {
              // one response-ring window per harvested read cycle —
              // the native-lane half of the ns_ring_stats step log
              srv->ring_windows.fetch_add(1, std::memory_order_relaxed);
              conn_write_parts(w, c, burst, oparts);
            }
            if (c->dead.load()) {
              fatal = true;
              break;
            }
            if (c->close_after) {
              // HTTP "Connection: close": close once the response has
              // fully left (immediately if it went out inline, else
              // when EPOLLOUT drains the queue)
              std::lock_guard<std::mutex> g(c->out_mu);
              if (c->outq.empty()) fatal = true;
              break;
            }
            if (c->py_pending.load(std::memory_order_acquire) > 0) {
              // Python owns the next reply: stop reading (replies must
              // stay ordered) and disarm EPOLLIN — level-triggered
              // epoll would spin otherwise.  ns_py_done re-arms.
              std::lock_guard<std::mutex> g(c->out_mu);
              epoll_event ev{};
              ev.events = c->want_out ? EPOLLOUT : 0;
              ev.data.ptr = c;
              epoll_ctl(w->epfd, EPOLL_CTL_MOD, c->fd, &ev);
              // stash any uncut remainder before leaving the loop
              if (direct && off < dlen) {
                stash_direct_remainder(&c->in, &rdbuf, off, dlen);
                rdbuf.reserve(kReadChunk);
              } else if (!direct && off) {
                c->in.erase_front(off);
              }
              break;
            }
            if (direct) {
              if (off < dlen) {
                size_t rest = dlen - off;
                if (rest >= kHeader && memcmp(data + off, kMagic, 4) == 0) {
                  uint32_t ms2, bs2;
                  memcpy(&ms2, data + off + 4, 4);
                  memcpy(&bs2, data + off + 8, 4);
                  uint64_t tot =
                      kHeader + (uint64_t)ntohl(ms2) + ntohl(bs2);
                  if (tot <= kMaxBody && (off || rest < kStealThreshold))
                    c->in.reserve(tot);
                }
                stash_direct_remainder(&c->in, &rdbuf, off, dlen);
                rdbuf.reserve(kReadChunk);
              }
            } else if (off) {
              c->in.erase_front(off);
            }
            if (static_cast<size_t>(r) < kReadChunk) break;
            continue;
          }
          if (r == 0) {
            fatal = true;
            break;
          }
          if (errno == EAGAIN || errno == EWOULDBLOCK) break;
          if (errno == EINTR) continue;
          fatal = true;
          break;
        }
        if (c->dead.load()) fatal = true;
      }
      if (fatal) {
        close_conn(srv, w, c);
        // close purges any deferred resume for this conn (it runs
        // under w->mu against the queue, but our local list was
        // already swapped) — drop it here too
        for (auto it = res_pending.begin(); it != res_pending.end();) {
          it = (*it == c) ? res_pending.erase(it) : it + 1;
        }
      }
    }
    for (Conn* c : res_pending) conn_resume(srv, w, c);
  }
}

void acceptor_loop(NativeServer* srv) {
  while (srv->running.load()) {
    struct pollfd pfd {srv->listen_fd, POLLIN, 0};
    int rc = ::poll(&pfd, 1, 300);
    if (rc <= 0) continue;
    int fd = ::accept4(srv->listen_fd, nullptr, nullptr, SOCK_NONBLOCK);
    if (fd < 0) continue;
    set_nodelay(fd);
    Conn* c = new Conn();
    c->fd = fd;
    c->id = srv->next_conn_id.fetch_add(1);
    Worker* w =
        srv->workers[srv->rr.fetch_add(1) % srv->workers.size()];
    {
      std::lock_guard<std::mutex> g(srv->conns_mu);
      srv->conns[c->id] = {w, c};
    }
    {
      std::lock_guard<std::mutex> g(w->mu);
      w->incoming.push_back(c);
    }
    w->notify();
  }
}

// ---------------------------------------------------------------------------
// client pool
// ---------------------------------------------------------------------------

struct PooledFd {
  int fd;
  int rcvtimeo_ms;  // currently-set SO_RCVTIMEO (avoid per-call setsockopt)
};

struct ClientPool {
  std::string host;
  int port;
  int connect_timeout_ms;
  std::mutex mu;
  std::vector<PooledFd> free_fds;
  std::atomic<uint64_t> next_cid{1};
  ~ClientPool() { NS_TSAN_MUTEX_DESTROY(&mu); }
};

void fd_set_timeout(PooledFd* pf, int timeout_ms) {
  if (pf->rcvtimeo_ms == timeout_ms) return;
  struct timeval tv;
  if (timeout_ms < 0) {
    tv.tv_sec = 0;
    tv.tv_usec = 0;  // 0 = block forever
  } else {
    tv.tv_sec = timeout_ms / 1000;
    tv.tv_usec = (timeout_ms % 1000) * 1000;
  }
  setsockopt(pf->fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  pf->rcvtimeo_ms = timeout_ms;
}

int pool_connect(ClientPool* p) {
  // host starting with '/' = unix domain socket path (UDS is
  // first-class in the reference's EndPoint too)
  if (!p->host.empty() && p->host[0] == '/') {
    if (p->host.size() >= sizeof(sockaddr_un{}.sun_path)) return -1;
    int fd = ::socket(AF_UNIX, SOCK_STREAM, 0);
    if (fd < 0) return -1;
    sockaddr_un ua{};
    ua.sun_family = AF_UNIX;
    snprintf(ua.sun_path, sizeof(ua.sun_path), "%s", p->host.c_str());
    if (::connect(fd, reinterpret_cast<sockaddr*>(&ua), sizeof(ua)) < 0) {
      ::close(fd);
      return -1;
    }
    return fd;
  }
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(p->port));
  if (inet_pton(AF_INET, p->host.c_str(), &addr.sin_addr) != 1) {
    ::close(fd);
    return -1;
  }
  if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
    ::close(fd);
    return -1;
  }
  set_nodelay(fd);
  return fd;
}

bool pool_acquire(ClientPool* p, PooledFd* out) {
  {
    std::lock_guard<std::mutex> g(p->mu);
    if (!p->free_fds.empty()) {
      *out = p->free_fds.back();
      p->free_fds.pop_back();
      return true;
    }
  }
  int fd = pool_connect(p);
  if (fd < 0) return false;
  *out = PooledFd{fd, 0};
  return true;
}

void pool_release(ClientPool* p, PooledFd pf) {
  std::lock_guard<std::mutex> g(p->mu);
  p->free_fds.push_back(pf);
}

// ---------------------------------------------------------------------------
// multiplexed async client (reactor): many in-flight RPCs over a few
// connections, submissions batched into single writes, completions
// harvested in batches.  This is the async-CallMethod data path — and
// on a single shared core it is the only honest way past the
// syscall-per-RPC qps ceiling (requests/responses amortize syscalls).
// ---------------------------------------------------------------------------

struct MuxCompletion {
  uint64_t tag;
  int32_t rc;  // 0 | -ETIMEDOUT | -EPIPE
  int32_t error_code;
  int32_t compress_type;
  uint32_t attachment_size;
  uint64_t body_len;
  uint8_t* data;  // malloc'd; consumer calls nc_free
  char error_text[96];  // response meta error_text (truncated)
};

struct MuxConn {
  // atomic: only the reactor writes it (connect/reset), but submitter
  // threads read the `fd < 0` staging-backpressure hint concurrently
  std::atomic<int> fd{-1};
  std::mutex stage_mu;      // guards staged only: submitters vs flush
  std::string staged;       // submitters append under stage_mu
  std::string outbuf;       // reactor-owned write backlog
  size_t out_off = 0;
  ByteBuf in;
  bool want_out = false;
  std::unordered_map<uint64_t, uint64_t> inflight;  // cid → tag (m->mu)
  std::unordered_map<uint64_t, int64_t> deadlines;  // cid → ms clock
  ~MuxConn() { NS_TSAN_MUTEX_DESTROY(&stage_mu); }
};

// One blocking caller parked on its own completion (nc_mux_call): the
// reactor routes the completion straight to the waiter instead of the
// shared done queue, so N sync caller threads multiplex over the same
// few connections with per-call wakeups — no pooled-fd exclusivity and
// no shared-queue thundering herd.  This is how Python sync stubs ride
// the mux reactor (reference: the public CallMethod IS the pipelined
// hot path, channel.cpp:407-584).
struct MuxWaiter {
  std::mutex mu;
  std::condition_variable cv;
  bool ready = false;
  MuxCompletion comp{};
  // stack-allocated: successive call frames reuse the address
  ~MuxWaiter() { NS_TSAN_MUTEX_DESTROY(&mu); }
};

struct MuxClient {
  std::string host;
  int port = 0;
  std::vector<MuxConn*> conns;
  std::mutex mu;  // guards staged buffers, inflight maps, done queue
  std::deque<MuxCompletion> done;
  std::condition_variable done_cv;
  // tag → parked sync caller; tags for waiter calls are the pointer
  // value itself (unique while the call frame lives)
  std::unordered_map<uint64_t, MuxWaiter*> waiters;
  int epfd = -1, wake_fd = -1;
  std::thread reactor;
  std::atomic<uint64_t> next_cid{1};
  std::atomic<bool> stopping{false};
  // suppress redundant wake syscalls: set by submitters, cleared by the
  // reactor right before it flushes (a pipelined submitter stream then
  // pays ~one eventfd write per reactor wake, not one per RPC)
  std::atomic<bool> wake_pending{false};
  // sync-call stats, maintained here so the Python fast path does ZERO
  // per-call recorder work: nc_mux_stats hands these to the channel's
  // LatencyRecorder, which harvests deltas lazily (~1 Hz / on read)
  std::atomic<uint64_t> stat_ok{0};
  std::atomic<uint64_t> stat_fail{0};
  std::atomic<uint64_t> stat_lat_us_sum{0};
  std::atomic<uint64_t> stat_lat_us_max{0};
  // ---- submission/completion ring lane (nc_mux_submit_many /
  // nc_mux_harvest) ----
  // Completions whose tag has kRingTagBit set route to their own queue:
  // the channel's always-running background harvester drains m->done
  // via nc_mux_poll and drops tags it doesn't know, so ring windows
  // need a lane that harvester can never steal from.
  std::deque<MuxCompletion> ring_done;
  std::condition_variable ring_cv;
  // ring step-log counters (nc_mux_ring_stats): a silently-degraded
  // ring — one crossing per call instead of per window — shows up here
  // as windows ≈ calls, and the bench smoke guard fails loudly.
  std::atomic<uint64_t> stat_ring_windows{0};
  std::atomic<uint64_t> stat_ring_calls{0};
  std::atomic<uint64_t> stat_ring_harvests{0};
  std::atomic<uint64_t> stat_ring_completions{0};
  ~MuxClient() { NS_TSAN_MUTEX_DESTROY(&mu); }
};

// Tag bit that routes a completion to the ring lane instead of the
// shared done queue (set by the Python side when reserving ring tags).
constexpr uint64_t kRingTagBit = 1ull << 63;

int64_t now_ms() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec * 1000ll + ts.tv_nsec / 1000000;
}

void mux_complete_locked(MuxClient* m, uint64_t tag, int rc, MetaView* mv,
                         uint8_t* body, uint64_t blen) {
  MuxCompletion c{};
  c.tag = tag;
  c.rc = rc;
  if (mv) {
    c.error_code = mv->error_code;
    c.compress_type = static_cast<int32_t>(mv->compress_type);
    c.attachment_size = static_cast<uint32_t>(mv->attachment_size);
    if (!mv->error_text.empty())
      snprintf(c.error_text, sizeof(c.error_text), "%s",
               mv->error_text.c_str());
  }
  c.data = body;
  c.body_len = blen;
  // a parked sync caller gets its completion directly (and its own
  // wakeup); everything else goes to the shared done queue
  auto wit = m->waiters.find(tag);
  if (wit != m->waiters.end()) {
    MuxWaiter* wtr = wit->second;
    m->waiters.erase(wit);
    {
      std::lock_guard<std::mutex> wg(wtr->mu);
      wtr->comp = c;
      wtr->ready = true;
      // notify UNDER wtr->mu: the waiter lives on nc_mux_call's STACK,
      // and the instant it can observe ready=true unlocked it may
      // return and destroy the frame — a notify after releasing the
      // lock races the condvar's destruction (caught by the TSan lane).
      // Held, the waiter cannot leave pthread_cond_wait until we drop
      // the mutex, and we touch nothing of *wtr after this scope.
      wtr->cv.notify_one();
    }
    return;
  }
  if (tag & kRingTagBit) {
    m->ring_done.push_back(c);
    return;
  }
  m->done.push_back(c);
}

// Non-blocking connect with a BOUNDED wait (200ms): the reactor thread
// calls this, and an unbounded kernel connect timeout (~2min) would
// stall every other connection's IO and the timeout sweep.
bool mux_connect(MuxClient* m, MuxConn* c) {
  // host starting with '/' = unix-domain path, like pool_connect
  sockaddr_storage ss{};
  socklen_t slen;
  int fd;
  if (!m->host.empty() && m->host[0] == '/') {
    if (m->host.size() >= sizeof(sockaddr_un{}.sun_path)) return false;
    sockaddr_un* ua = reinterpret_cast<sockaddr_un*>(&ss);
    ua->sun_family = AF_UNIX;
    snprintf(ua->sun_path, sizeof(ua->sun_path), "%s", m->host.c_str());
    slen = sizeof(sockaddr_un);
    fd = ::socket(AF_UNIX, SOCK_STREAM | SOCK_NONBLOCK, 0);
  } else {
    sockaddr_in* addr = reinterpret_cast<sockaddr_in*>(&ss);
    addr->sin_family = AF_INET;
    addr->sin_port = htons(static_cast<uint16_t>(m->port));
    if (inet_pton(AF_INET, m->host.c_str(), &addr->sin_addr) != 1)
      return false;
    slen = sizeof(sockaddr_in);
    fd = ::socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
  }
  if (fd < 0) return false;
  int rc = ::connect(fd, reinterpret_cast<sockaddr*>(&ss), slen);
  if (rc < 0 && errno == EINPROGRESS) {
    struct pollfd pfd {fd, POLLOUT, 0};
    if (::poll(&pfd, 1, 200) <= 0) {
      ::close(fd);
      return false;
    }
    int err = 0;
    socklen_t elen = sizeof(err);
    getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &elen);
    if (err != 0) {
      ::close(fd);
      return false;
    }
  } else if (rc < 0) {
    ::close(fd);
    return false;
  }
  set_nodelay(fd);
  c->fd = fd;
  epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.ptr = c;
  epoll_ctl(m->epfd, EPOLL_CTL_ADD, fd, &ev);
  return true;
}

// fail everything in flight on this conn and reconnect
void mux_conn_reset(MuxClient* m, MuxConn* c) {
  std::vector<std::pair<uint64_t, uint64_t>> dead;
  // order matters against a concurrent submitter (which registers its
  // cid under m->mu FIRST, then stages under stage_mu): clearing
  // staged before inflight means any call whose frame we wipe still
  // has its cid in inflight when we sweep it below → it gets -EPIPE.
  // The opposite order could wipe a frame while keeping its cid,
  // leaving a deadline-less call parked forever.
  {
    std::lock_guard<std::mutex> g(c->stage_mu);
    c->staged.clear();
  }
  {
    std::lock_guard<std::mutex> g(m->mu);
    for (auto& kv : c->inflight) dead.push_back({kv.first, kv.second});
    c->inflight.clear();
    c->deadlines.clear();
  }
  c->outbuf.clear();
  c->out_off = 0;
  c->in.clear();
  c->want_out = false;
  if (c->fd >= 0) {
    epoll_ctl(m->epfd, EPOLL_CTL_DEL, c->fd, nullptr);
    ::close(c->fd);
    c->fd = -1;
  }
  {
    std::lock_guard<std::mutex> g(m->mu);
    for (auto& d : dead) mux_complete_locked(m, d.second, -EPIPE, nullptr,
                                             nullptr, 0);
  }
  if (!dead.empty()) {
    m->done_cv.notify_all();
    m->ring_cv.notify_all();
  }
  if (!m->stopping.load()) mux_connect(m, c);
}

void mux_flush(MuxClient* m, MuxConn* c) {
  {
    std::lock_guard<std::mutex> g(c->stage_mu);
    if (!c->staged.empty()) {
      if (c->outbuf.empty()) {
        c->outbuf.swap(c->staged);
        c->out_off = 0;
      } else {
        c->outbuf += c->staged;
        c->staged.clear();
      }
    }
  }
  if (c->fd < 0) return;
  while (c->out_off < c->outbuf.size()) {
    ssize_t n = ::write(c->fd, c->outbuf.data() + c->out_off,
                        c->outbuf.size() - c->out_off);
    if (n > 0) {
      c->out_off += static_cast<size_t>(n);
      continue;
    }
    if (n < 0 && errno == EINTR) continue;
    if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) break;
    mux_conn_reset(m, c);
    return;
  }
  if (c->out_off == c->outbuf.size()) {
    c->outbuf.clear();
    c->out_off = 0;
    if (c->want_out) {
      c->want_out = false;
      epoll_event ev{};
      ev.events = EPOLLIN;
      ev.data.ptr = c;
      epoll_ctl(m->epfd, EPOLL_CTL_MOD, c->fd, &ev);
    }
  } else if (!c->want_out) {
    c->want_out = true;
    epoll_event ev{};
    ev.events = EPOLLIN | EPOLLOUT;
    ev.data.ptr = c;
    epoll_ctl(m->epfd, EPOLL_CTL_MOD, c->fd, &ev);
  }
}

// Cut response frames from [data, data+len); returns consumed bytes or
// SIZE_MAX if the connection was reset (caller must bail immediately).
size_t mux_cut_frames(MuxClient* m, MuxConn* c, const uint8_t* data,
                      size_t len, bool* notified) {
  size_t off = 0;
  while (true) {
    size_t avail = len - off;
    if (avail < kHeader) break;
    const uint8_t* p = data + off;
    if (memcmp(p, kMagic, 4) != 0) {
      mux_conn_reset(m, c);
      return SIZE_MAX;
    }
    uint32_t ms, bs;
    memcpy(&ms, p + 4, 4);
    memcpy(&bs, p + 8, 4);
    ms = ntohl(ms);
    bs = ntohl(bs);
    if (static_cast<uint64_t>(ms) + bs > kMaxBody) {
      mux_conn_reset(m, c);
      return SIZE_MAX;
    }
    size_t total = kHeader + ms + bs;
    if (avail < total) break;
    MetaView mv;
    if (parse_meta(p + kHeader, ms, &mv) && mv.attachment_size <= bs) {
      std::lock_guard<std::mutex> g(m->mu);
      auto it = c->inflight.find(mv.correlation_id);
      if (it != c->inflight.end()) {
        uint8_t* body = static_cast<uint8_t*>(malloc(bs ? bs : 1));
        memcpy(body, p + kHeader + ms, bs);
        mux_complete_locked(m, it->second, 0, &mv, body, bs);
        c->inflight.erase(it);
        c->deadlines.erase(mv.correlation_id);
        *notified = true;
      }
    }
    off += total;
  }
  return off;
}

void mux_read(MuxClient* m, MuxConn* c) {
  // Same direct-cut structure as the server worker: frames are parsed
  // straight out of the read buffer; only a trailing partial frame is
  // staged in c->in, and later reads complete it IN PLACE (ByteBuf
  // tail reads — no stage-then-copy for multi-read frames).
  constexpr size_t kMuxReadChunk = 512 * 1024;
  static thread_local ByteBuf rdbuf;
  rdbuf.reserve(kMuxReadChunk);
  bool notified = false;
  for (;;) {
    bool direct = c->in.empty();
    char* dst = direct
                    ? reinterpret_cast<char*>(rdbuf.data())
                    : reinterpret_cast<char*>(c->in.tail(kMuxReadChunk));
    ssize_t r = ::read(c->fd, dst, kMuxReadChunk);
    if (r > 0) {
      const uint8_t* data;
      size_t dlen;
      if (direct) {
        data = rdbuf.data();
        dlen = static_cast<size_t>(r);
      } else {
        c->in.advance(static_cast<size_t>(r));
        data = c->in.data();
        dlen = c->in.size();
      }
      size_t off = mux_cut_frames(m, c, data, dlen, &notified);
      if (off == SIZE_MAX) {  // reset: c->in already cleared
        if (notified) {
          m->done_cv.notify_all();
          m->ring_cv.notify_all();
        }
        return;
      }
      if (direct) {
        if (off < dlen) {
          stash_direct_remainder(&c->in, &rdbuf, off, dlen);
          rdbuf.reserve(kMuxReadChunk);
        }
      } else if (off) {
        c->in.erase_front(off);
      }
      if (static_cast<size_t>(r) < kMuxReadChunk) break;
      continue;
    }
    if (r < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) break;
    if (r < 0 && errno == EINTR) continue;
    mux_conn_reset(m, c);
    break;
  }
  if (notified) {
    m->done_cv.notify_all();
    m->ring_cv.notify_all();
  }
}

void mux_sweep_timeouts(MuxClient* m) {
  int64_t now = now_ms();
  bool notified = false;
  std::lock_guard<std::mutex> g(m->mu);
  for (MuxConn* c : m->conns) {
    for (auto it = c->deadlines.begin(); it != c->deadlines.end();) {
      if (it->second >= 0 && now > it->second) {
        auto fit = c->inflight.find(it->first);
        if (fit != c->inflight.end()) {
          mux_complete_locked(m, fit->second, -ETIMEDOUT, nullptr, nullptr, 0);
          c->inflight.erase(fit);
          notified = true;
        }
        it = c->deadlines.erase(it);
      } else {
        ++it;
      }
    }
  }
  if (notified) {
    m->done_cv.notify_all();
    m->ring_cv.notify_all();
  }
}

void mux_reactor(MuxClient* m) {
  epoll_event evs[64];
  int64_t last_sweep = now_ms();
  // wake_pending protocol: submitters skip the eventfd syscall while it
  // is already true.  The reactor leaves it TRUE across busy cycles —
  // flushing staged work every loop anyway — and clears it only right
  // before blocking in epoll (re-checking staged after the clear to
  // close the race).  Under steady pipelined load this reduces wakeup
  // syscalls to ~zero: the exchange() in submit sees true and skips.
  while (!m->stopping.load()) {
    bool busy = m->wake_pending.load(std::memory_order_relaxed);
    int timeout_ms = 50;
    if (busy) {
      timeout_ms = 0;  // work may be staged: poll IO, don't block
    } else {
      // nothing pending when we looked; block until IO or a wake
      timeout_ms = 50;
    }
    int n = epoll_wait(m->epfd, evs, 64, timeout_ms);
    if (n < 0) {
      if (errno == EINTR) continue;
      break;
    }
    for (int i = 0; i < n; i++) {
      if (evs[i].data.ptr == nullptr) {
        uint64_t junk;
        while (::read(m->wake_fd, &junk, sizeof(junk)) > 0) {
        }
        continue;
      }
      MuxConn* c = static_cast<MuxConn*>(evs[i].data.ptr);
      if (evs[i].events & (EPOLLHUP | EPOLLERR)) {
        mux_conn_reset(m, c);
        continue;
      }
      if (evs[i].events & EPOLLIN) mux_read(m, c);
      if (c->fd >= 0 && (evs[i].events & EPOLLOUT)) mux_flush(m, c);
    }
    if (busy) {
      // consume the pending flag only when about to potentially block
      // next cycle; staged bytes appended after this store trigger a
      // fresh wake (or are caught by the post-clear flush below)
      m->wake_pending.store(false);
    }
    // flush staged submissions every cycle (covers both the woken case
    // and bytes staged after the clear above)
    for (MuxConn* c : m->conns)
      if (c->fd >= 0) mux_flush(m, c);
    int64_t now = now_ms();
    if (now - last_sweep >= 20) {
      mux_sweep_timeouts(m);
      last_sweep = now;
      // revive dead connections (a failed (re)connect leaves fd=-1;
      // staged submissions accumulated meanwhile flush on success)
      for (MuxConn* c : m->conns) {
        if (c->fd < 0 && !m->stopping.load() && mux_connect(m, c))
          mux_flush(m, c);
      }
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// ---- fault injection (chaos/) ----
// Program one site's fault knob (process-wide; see FaultSite /
// FaultAction above).  prob_u32 is the fire threshold out of 2^32
// (0xffffffff ~= always); max_hits < 0 = unlimited.  Counters reset.
void ns_set_fault(int site, int action, uint64_t arg, uint32_t prob_u32,
                  uint64_t seed, long long max_hits) {
  if (site < 0 || site >= FS_COUNT) return;
  FaultState& f = g_faults[site];
  f.arg.store(arg, std::memory_order_relaxed);
  f.prob.store(prob_u32, std::memory_order_relaxed);
  f.seed.store(seed, std::memory_order_relaxed);
  f.max_hits.store(max_hits, std::memory_order_relaxed);
  f.evals.store(0, std::memory_order_relaxed);
  f.hits.store(0, std::memory_order_relaxed);
  f.action.store(static_cast<uint32_t>(action), std::memory_order_release);
  uint32_t any = 0;
  for (int i = 0; i < FS_COUNT; i++)
    if (g_faults[i].action.load(std::memory_order_relaxed)) any = 1;
  g_faults_armed.store(any, std::memory_order_release);
}

void ns_clear_faults() {
  for (int i = 0; i < FS_COUNT; i++) {
    g_faults[i].action.store(0, std::memory_order_relaxed);
    g_faults[i].evals.store(0, std::memory_order_relaxed);
    g_faults[i].hits.store(0, std::memory_order_relaxed);
  }
  g_faults_armed.store(0, std::memory_order_release);
}

unsigned long long ns_fault_hits(int site) {
  if (site < 0 || site >= FS_COUNT) return 0;
  return g_faults[site].hits.load(std::memory_order_relaxed);
}

// ---- server ----
void* ns_create() { return new NativeServer(); }

void ns_set_dispatch(void* h, PyDispatch cb) {
  static_cast<NativeServer*>(h)->dispatch = cb;
}

// Register an arbitrary native method handler (generic dispatch: the
// same hook the built-in echo uses).  Must be called before ns_listen.
void ns_register_native_method(void* h, const char* service,
                               const char* method, NativeMethodFn fn,
                               void* user_data) {
  NativeServer* srv = static_cast<NativeServer*>(h);
  NativeMethod* nm = srv->method_get_or_create(service, method);
  nm->fn = fn;
  nm->user_data = user_data;
}

void ns_register_native_echo(void* h, const char* service, const char* method,
                             int attach_echo) {
  ns_register_native_method(
      h, service, method, builtin_echo_method,
      reinterpret_cast<void*>(static_cast<intptr_t>(attach_echo ? 1 : 0)));
}

// response-builder appends for native handlers (callable from any
// language that can hold a C pointer)
void ns_resp_append_payload(void* resp_ctx, const uint8_t* data,
                            uint64_t len) {
  static_cast<NativeRespCtx*>(resp_ctx)->payload_owned(
      reinterpret_cast<const char*>(data), len);
}

void ns_resp_append_attachment(void* resp_ctx, const uint8_t* data,
                               uint64_t len) {
  static_cast<NativeRespCtx*>(resp_ctx)->attachment.append(
      reinterpret_cast<const char*>(data), len);
}

// enable extra wire protocols on the port (bitmask of ConnProto bits;
// tpu_std is always on).  Call before ns_listen.
void ns_enable_protocols(void* h, uint32_t mask) {
  static_cast<NativeServer*>(h)->proto_mask |= mask;
}

// register a native HTTP handler for `path` (request body → handler →
// response body; 200 on rc 0, 500 on rc>0, rc<0 declines to Python).
// Must be called before ns_listen.
void ns_register_native_http(void* h, const char* path, NativeMethodFn fn,
                             void* user_data) {
  NativeServer* srv = static_cast<NativeServer*>(h);
  std::lock_guard<std::mutex> g(srv->reg_mu);
  auto it = srv->http_methods.find(path);
  NativeMethod* nm;
  if (it != srv->http_methods.end()) {
    nm = it->second;
  } else {
    nm = new NativeMethod();
    srv->http_methods[path] = nm;
    // expose stats under ("http", path) for ns_method_stats
    srv->methods[std::string("http") + '\0' + path] = nm;
  }
  nm->fn = fn;
  nm->user_data = user_data;
}

void ns_register_native_http_echo(void* h, const char* path) {
  ns_register_native_http(h, path, builtin_http_echo, nullptr);
}

// answer GET/SET/DEL/EXISTS/INCR/PING natively from a sharded in-engine
// KV map (the redis_server example's C++ RedisService, natively);
// unrecognized commands still dispatch to the Python RedisService
void ns_redis_enable_native_kv(void* h) {
  static_cast<NativeServer*>(h)->redis_native_kv = true;
}

// 0 = unlimited.  Callable while serving (harvest loops push updated
// auto-limiter values through this) — lookup-only, because inserting
// into the map would race the lock-free worker reads.
void ns_set_method_max_concurrency(void* h, const char* service,
                                   const char* method, int32_t limit) {
  NativeServer* srv = static_cast<NativeServer*>(h);
  std::lock_guard<std::mutex> g(srv->reg_mu);
  auto it = srv->methods.find(std::string(service) + '\0' + method);
  if (it != srv->methods.end())
    it->second->max_concurrency.store(limit, std::memory_order_relaxed);
}

// out[0]=count out[1]=latency_ns_sum out[2]=rejected out[3]=errors
// (cumulative; the Python harvester diffs against its last snapshot)
int ns_method_stats(void* h, const char* service, const char* method,
                    uint64_t* out) {
  NativeServer* srv = static_cast<NativeServer*>(h);
  std::lock_guard<std::mutex> g(srv->reg_mu);
  auto it = srv->methods.find(std::string(service) + '\0' + method);
  if (it == srv->methods.end()) return -1;
  NativeMethod* nm = it->second;
  out[0] = nm->count.load(std::memory_order_relaxed);
  out[1] = nm->latency_ns_sum.load(std::memory_order_relaxed);
  out[2] = nm->rejected.load(std::memory_order_relaxed);
  out[3] = nm->errors.load(std::memory_order_relaxed);
  return 0;
}

// returns bound port (0 for UDS), or -errno. host starting with '/'
// listens on that unix-domain path instead of TCP.
int ns_listen(void* h, const char* host, int port, int nworkers) {
  NativeServer* srv = static_cast<NativeServer*>(h);
  int fd;
  sockaddr_in bound{};
  if (host && host[0] == '/') {
    if (strlen(host) >= sizeof(sockaddr_un{}.sun_path))
      return -ENAMETOOLONG;  // silent truncation would bind elsewhere
    sockaddr_un ua{};
    ua.sun_family = AF_UNIX;
    snprintf(ua.sun_path, sizeof(ua.sun_path), "%s", host);
    // only remove a STALE socket file: hijacking a live server's path
    // must fail with EADDRINUSE like the TCP bind would
    int probe = ::socket(AF_UNIX, SOCK_STREAM, 0);
    if (probe >= 0) {
      if (::connect(probe, reinterpret_cast<sockaddr*>(&ua), sizeof(ua)) ==
          0) {
        ::close(probe);
        return -EADDRINUSE;
      }
      ::close(probe);
    }
    ::unlink(host);
    fd = ::socket(AF_UNIX, SOCK_STREAM | SOCK_NONBLOCK, 0);
    if (fd < 0) return -errno;
    if (::bind(fd, reinterpret_cast<sockaddr*>(&ua), sizeof(ua)) < 0 ||
        ::listen(fd, 1024) < 0) {
      int e = errno;
      ::close(fd);
      return -e;
    }
  } else {
    fd = ::socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
    if (fd < 0) return -errno;
    int one = 1;
    setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
      ::close(fd);
      return -EINVAL;
    }
    if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
        ::listen(fd, 1024) < 0) {
      int e = errno;
      ::close(fd);
      return -e;
    }
    socklen_t blen = sizeof(bound);
    getsockname(fd, reinterpret_cast<sockaddr*>(&bound), &blen);
  }
  srv->listen_fd = fd;
  srv->running.store(true);
  if (nworkers < 1) nworkers = 1;
  for (int i = 0; i < nworkers; i++) {
    Worker* w = new Worker();
    w->srv = srv;
    w->epfd = epoll_create1(0);
    w->wake_fd = eventfd(0, EFD_NONBLOCK);
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.ptr = nullptr;
    epoll_ctl(w->epfd, EPOLL_CTL_ADD, w->wake_fd, &ev);
    srv->workers.push_back(w);
    srv->threads.emplace_back(worker_loop, srv, w);
  }
  srv->acceptor = std::thread(acceptor_loop, srv);
  return ntohs(bound.sin_port);
}

// thread-safe response send from Python fallback handlers
int ns_send(void* h, uint64_t conn_id, const uint8_t* data, uint64_t len) {
  NativeServer* srv = static_cast<NativeServer*>(h);
  // conns_mu held for the whole send: close_conn erases under the same
  // lock before deleting, so the Conn cannot be freed under us
  std::lock_guard<std::mutex> g(srv->conns_mu);
  auto it = srv->conns.find(conn_id);
  if (it == srv->conns.end()) return -ENOTCONN;
  Worker* w = it->second.first;
  Conn* c = it->second.second;
  conn_queue_write(w, c, std::string(reinterpret_cast<const char*>(data), len));
  return c->dead.load() ? -EPIPE : 0;
}

// Server response ring: flush one harvested window of completions for a
// connection as ONE scatter-gather burst (the server half of
// nc_mux_submit_many).  Small frames coalesce into a contiguous burst
// range — a window of 4KB replies reaches the kernel through a SINGLE
// iovec — while frames ≥ kViewThreshold ride writev as borrowed views.
// Views are safe: the caller's frame bytes outlive this call, and
// conn_write_parts COPIES any unsent remainder into the outq before
// returning, so nothing borrowed survives the call.
int ns_send_burst(void* h, uint64_t conn_id, const uint8_t* const* frames,
                  const uint64_t* lens, int n) {
  NativeServer* srv = static_cast<NativeServer*>(h);
  // conns_mu held for the whole burst, same lifetime rule as ns_send
  std::lock_guard<std::mutex> g(srv->conns_mu);
  auto it = srv->conns.find(conn_id);
  if (it == srv->conns.end()) return -ENOTCONN;
  Worker* w = it->second.first;
  Conn* c = it->second.second;
  // heap holders with trivially-destructible TLS slots, NOT plain
  // thread_local objects: ns_send_burst runs on Python-created threads
  // (server dispatch), and a C++ TLS destructor registered there races
  // glibc's _dl_deallocate_tls at thread exit (TSan-visible).  The
  // buffers intentionally live for the thread's lifetime to keep
  // capacity warm across windows.
  thread_local std::string* burst_p = new std::string();
  thread_local std::vector<OutPart>* parts_p = new std::vector<OutPart>();
  std::string& burst = *burst_p;
  std::vector<OutPart>& parts = *parts_p;
  burst.clear();
  parts.clear();
  for (int i = 0; i < n; i++) {
    if (lens[i] >= kViewThreshold) {
      parts.push_back(
          {true, reinterpret_cast<size_t>(frames[i]), (size_t)lens[i]});
    } else {
      size_t base = burst.size();
      burst.append(reinterpret_cast<const char*>(frames[i]), lens[i]);
      parts_add_burst_range(&parts, base, (size_t)lens[i]);
    }
  }
  srv->ring_windows.fetch_add(1, std::memory_order_relaxed);
  srv->ring_responses.fetch_add((uint64_t)n, std::memory_order_relaxed);
  conn_write_parts(w, c, burst, parts);
  return c->dead.load() ? -EPIPE : 0;
}

// out[0..2] = ring windows flushed, responses carried, writev bursts
void ns_ring_stats(void* h, uint64_t* out) {
  NativeServer* srv = static_cast<NativeServer*>(h);
  out[0] = srv->ring_windows.load(std::memory_order_relaxed);
  out[1] = srv->ring_responses.load(std::memory_order_relaxed);
  out[2] = srv->flush_bursts.load(std::memory_order_relaxed);
}

// Python finished answering a dispatched http/redis frame: resume
// cutting (and reading) the connection.  Pairs 1:1 with each
// P_HTTP/P_REDIS dispatch callback.
void ns_py_done(void* h, uint64_t conn_id) {
  NativeServer* srv = static_cast<NativeServer*>(h);
  // conns_mu held across the resume push: close_conn purges the
  // worker's resume list under w->mu BEFORE delete, but only for
  // entries already pushed — holding conns_mu here means a concurrent
  // close either runs fully before us (we find nothing) or after our
  // push (purge removes it)
  std::lock_guard<std::mutex> g(srv->conns_mu);
  auto it = srv->conns.find(conn_id);
  if (it == srv->conns.end()) return;
  Worker* w = it->second.first;
  Conn* c = it->second.second;
  if (c->py_pending.fetch_sub(1, std::memory_order_acq_rel) == 1) {
    {
      std::lock_guard<std::mutex> g2(w->mu);
      w->resume.push_back(c);
    }
    w->notify();
  }
}

// Python fallback asks to close (Controller::CloseConnection analog)
void ns_close_conn(void* h, uint64_t conn_id) {
  NativeServer* srv = static_cast<NativeServer*>(h);
  std::lock_guard<std::mutex> g(srv->conns_mu);
  auto it = srv->conns.find(conn_id);
  if (it == srv->conns.end()) return;
  Conn* c = it->second.second;
  c->dead.store(true);
  it->second.first->notify();
  // actual close happens on the worker when the conn next polls
  // readable.  The shutdown rides out_mu like every other fd user:
  // close_conn closes + invalidates the fd under that lock, so we can
  // never shut down a recycled fd number (TSan-lane finding).
  {
    std::lock_guard<std::mutex> g2(c->out_mu);
    if (c->fd >= 0) ::shutdown(c->fd, SHUT_RDWR);
  }
}

void ns_stop(void* h) {
  NativeServer* srv = static_cast<NativeServer*>(h);
  if (!srv->running.exchange(false)) return;
  ::close(srv->listen_fd);
  if (srv->acceptor.joinable()) srv->acceptor.join();
  for (Worker* w : srv->workers) {
    w->stop.store(true);
    w->notify();
  }
  for (auto& t : srv->threads) t.join();
  {
    std::lock_guard<std::mutex> g(srv->conns_mu);
    for (auto& kv : srv->conns) {
      ::close(kv.second.second->fd);
      delete kv.second.second;
    }
    srv->conns.clear();
  }
  for (Worker* w : srv->workers) {
    ::close(w->epfd);
    ::close(w->wake_fd);
    delete w;
  }
  srv->workers.clear();
  srv->threads.clear();
}

void ns_destroy(void* h) {
  ns_stop(h);
  delete static_cast<NativeServer*>(h);
}

// ---- client ----
void* nc_pool_create(const char* host, int port, int connect_timeout_ms) {
  ClientPool* p = new ClientPool();
  p->host = host;
  p->port = port;
  p->connect_timeout_ms = connect_timeout_ms;
  return p;
}

void nc_pool_destroy(void* h) {
  ClientPool* p = static_cast<ClientPool*>(h);
  {
    std::lock_guard<std::mutex> g(p->mu);
    for (PooledFd& pf : p->free_fds) ::close(pf.fd);
  }
  delete p;
}

// Response out-params struct (mirrored by ctypes)
struct NcResponse {
  uint8_t* data;        // malloc'd full body (payload+attachment); nc_free it
  uint64_t body_len;
  uint64_t attachment_size;
  int32_t error_code;
  int32_t compress_type;  // response meta compress_type (Python decompresses)
  char error_text[240];
};

void nc_free(uint8_t* p) { free(p); }

// One pooled-connection RPC round trip.  Packs meta in C, writes
// header+meta+payload(+attachment), reads exactly one response frame
// for our correlation id.  Returns 0 ok; -ETIMEDOUT; -EPIPE on IO fail;
// -EBADMSG on protocol garbage.
int nc_call(void* h, const char* service, const char* method, uint64_t log_id,
            const uint8_t* payload, uint64_t payload_len,
            const uint8_t* attachment, uint64_t attachment_len, int timeout_ms,
            NcResponse* out) {
  ClientPool* p = static_cast<ClientPool*>(h);
  out->data = nullptr;
  out->body_len = 0;
  out->attachment_size = 0;
  out->error_code = 0;
  out->error_text[0] = 0;
  uint64_t cid = p->next_cid.fetch_add(1);
  std::string meta =
      pack_request_meta(service, strlen(service), method, strlen(method), cid,
                        attachment_len, log_id);
  // header+meta in one small buffer; payload/attachment ride writev
  // straight from the caller's memory — zero user-space copies on the
  // large-payload path (small payloads coalesce below so tiny requests
  // still cost ONE syscall)
  std::string hm;
  hm.reserve(kHeader + meta.size() +
             (payload_len + attachment_len < kViewThreshold
                  ? payload_len + attachment_len
                  : 0));
  hm.resize(kHeader);
  put_header(&hm[0], meta.size(), payload_len + attachment_len);
  hm += meta;
  bool coalesce = payload_len + attachment_len < kViewThreshold;
  if (coalesce) {
    if (payload_len)
      hm.append(reinterpret_cast<const char*>(payload), payload_len);
    if (attachment_len)
      hm.append(reinterpret_cast<const char*>(attachment), attachment_len);
  }

  // one reconnect retry on stale pooled fd (server may have closed it)
  for (int attempt = 0; attempt < 2; attempt++) {
    PooledFd pf;
    if (attempt == 0) {
      if (!pool_acquire(p, &pf)) return -ECONNREFUSED;
    } else {
      int fd = pool_connect(p);
      if (fd < 0) return -ECONNREFUSED;
      pf = PooledFd{fd, 0};
    }
    fd_set_timeout(&pf, timeout_ms);
    bool wrote;
    if (coalesce) {
      wrote = write_all(pf.fd, hm.data(), hm.size());
    } else {
      iovec iov[3];
      iov[0] = {const_cast<char*>(hm.data()), hm.size()};
      int cnt = 1;
      if (payload_len)
        iov[cnt++] = {const_cast<uint8_t*>(payload), payload_len};
      if (attachment_len)
        iov[cnt++] = {const_cast<uint8_t*>(attachment), attachment_len};
      wrote = writev_all(pf.fd, iov, cnt);
    }
    if (!wrote) {
      ::close(pf.fd);
      continue;  // stale fd: retry once on a fresh connection
    }
    // single recv loop: header lands with (usually all of) the body in
    // one read; SO_RCVTIMEO supplies the deadline with no poll() calls.
    // The staging buffer is capped at the view threshold: small
    // responses still complete in one recv, while anything larger
    // spills at most 16KB and then reads STRAIGHT into the body malloc
    // (a 64KB staging buffer re-copied most of a 64KB response).
    uint8_t hdr_buf[16 * 1024];
    size_t have = 0;
    uint32_t ms = 0, bs = 0;
    uint8_t* body = nullptr;  // malloc'd once sizes are known
    std::vector<uint8_t> meta_buf;
    bool fail = false, timed_out = false;
    size_t total_rest = 0;  // ms + bs
    while (true) {
      if (have >= kHeader && body == nullptr) {
        if (memcmp(hdr_buf, kMagic, 4) != 0) {
          fail = true;
          break;
        }
        memcpy(&ms, hdr_buf + 4, 4);
        memcpy(&bs, hdr_buf + 8, 4);
        ms = ntohl(ms);
        bs = ntohl(bs);
        if (static_cast<uint64_t>(ms) + bs > kMaxBody) {
          fail = true;
          break;
        }
        total_rest = static_cast<size_t>(ms) + bs;
        meta_buf.resize(ms);
        body = static_cast<uint8_t*>(malloc(bs ? bs : 1));
        // move any bytes already read past the header into place
        size_t extra = have - kHeader;
        if (extra > total_rest) {  // trailing garbage beyond our frame
          fail = true;
          break;
        }
        size_t mcopy = extra < ms ? extra : ms;
        memcpy(meta_buf.data(), hdr_buf + kHeader, mcopy);
        if (extra > mcopy)
          memcpy(body, hdr_buf + kHeader + mcopy, extra - mcopy);
        have = kHeader + extra;
      }
      if (body != nullptr && have == kHeader + total_rest) break;
      // choose destination for the next read
      char* dst;
      size_t want;
      if (body == nullptr) {
        dst = reinterpret_cast<char*>(hdr_buf) + have;
        want = sizeof(hdr_buf) - have;
      } else {
        size_t got_rest = have - kHeader;
        if (got_rest < ms) {
          dst = reinterpret_cast<char*>(meta_buf.data()) + got_rest;
          want = ms - got_rest;
        } else {
          dst = reinterpret_cast<char*>(body) + (got_rest - ms);
          want = total_rest - got_rest;
        }
      }
      ssize_t r = ::recv(pf.fd, dst, want, 0);
      if (r > 0) {
        have += static_cast<size_t>(r);
        continue;
      }
      if (r < 0 && errno == EINTR) continue;
      if (r < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        timed_out = true;  // SO_RCVTIMEO expired
        break;
      }
      fail = true;  // EOF or hard error
      break;
    }
    if (timed_out) {
      free(body);
      ::close(pf.fd);
      return -ETIMEDOUT;
    }
    if (fail) {
      bool fresh_fd_never_answered = (body == nullptr && have == 0);
      free(body);
      ::close(pf.fd);
      if (attempt == 0 && fresh_fd_never_answered)
        continue;  // reset while idle in pool → retry once
      return body == nullptr && have < kHeader ? -EPIPE : -EBADMSG;
    }
    MetaView m;
    if (!parse_meta(meta_buf.data(), ms, &m) || m.correlation_id != cid) {
      // one-in-flight per fd: a mismatched cid means the fd carried
      // stale state — don't pool it back
      free(body);
      ::close(pf.fd);
      return -EBADMSG;
    }
    if (m.attachment_size > bs) {  // server-controlled size: validate
      free(body);
      ::close(pf.fd);
      return -EBADMSG;
    }
    pool_release(p, pf);
    out->data = body;
    out->body_len = bs;
    out->attachment_size = m.attachment_size;
    out->error_code = m.error_code;
    out->compress_type = static_cast<int32_t>(m.compress_type);
    snprintf(out->error_text, sizeof(out->error_text), "%s",
             m.error_text.c_str());
    return 0;
  }
  return -EPIPE;
}

// ---- multiplexed async client ----
void* nc_mux_create(const char* host, int port, int nconns) {
  MuxClient* m = new MuxClient();
  m->host = host;
  m->port = port;
  m->epfd = epoll_create1(0);
  m->wake_fd = eventfd(0, EFD_NONBLOCK);
  epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.ptr = nullptr;
  epoll_ctl(m->epfd, EPOLL_CTL_ADD, m->wake_fd, &ev);
  if (nconns < 1) nconns = 1;
  for (int i = 0; i < nconns; i++) {
    MuxConn* c = new MuxConn();
    if (!mux_connect(m, c)) {
      // leave fd=-1; reactor retries via reset on use
    }
    m->conns.push_back(c);
  }
  m->reactor = std::thread(mux_reactor, m);
  return m;
}

// enqueue one RPC; returns the correlation id (>0) or 0 on shutdown
uint64_t nc_mux_submit(void* h, const char* service, const char* method,
                       uint64_t log_id, const uint8_t* payload,
                       uint64_t payload_len, const uint8_t* attachment,
                       uint64_t attachment_len, int timeout_ms,
                       uint64_t tag) {
  MuxClient* m = static_cast<MuxClient*>(h);
  if (m->stopping.load()) return 0;
  uint64_t cid = m->next_cid.fetch_add(1);
  std::string meta =
      pack_request_meta(service, strlen(service), method, strlen(method), cid,
                        attachment_len, log_id);
  MuxConn* c = m->conns[cid % m->conns.size()];
  int64_t deadline = timeout_ms > 0 ? now_ms() + timeout_ms : -1;
  // register the cid BEFORE staging bytes: once staged, the reactor
  // may flush and the response may arrive — an unregistered cid's
  // response would be dropped.  Maps ride m->mu, staging rides the
  // per-conn stage_mu so submitters don't contend with the reactor's
  // completion processing.
  {
    std::lock_guard<std::mutex> g(m->mu);
    c->inflight[cid] = tag;
    c->deadlines[cid] = deadline;
  }
  {
    std::lock_guard<std::mutex> g(c->stage_mu);
    if (c->fd < 0 && c->staged.size() > (16u << 20)) {
      // connection down and backlog already deep: fail fast instead of
      // queueing without bound (deadline-less submits would otherwise
      // grow staged forever against a dead peer)
      std::lock_guard<std::mutex> g2(m->mu);
      c->inflight.erase(cid);
      c->deadlines.erase(cid);
      return 0;
    }
    size_t base = c->staged.size();
    c->staged.resize(base + kHeader);
    put_header(&c->staged[base], meta.size(), payload_len + attachment_len);
    c->staged += meta;
    if (payload_len)
      c->staged.append(reinterpret_cast<const char*>(payload), payload_len);
    if (attachment_len)
      c->staged.append(reinterpret_cast<const char*>(attachment),
                       attachment_len);
  }
  if (!m->wake_pending.exchange(true)) {
    uint64_t one = 1;
    ssize_t r = ::write(m->wake_fd, &one, sizeof(one));
    (void)r;
  }
  return cid;
}

// Stage a WINDOW of n same-method RPCs in one crossing: ONE cid-range
// registration under m->mu, ONE staging append under the conn's
// stage_mu, ONE reactor wake — amortizing nc_mux_submit's three
// lock/syscall touches over the whole window.  The whole window lands
// on one connection so the reactor flushes it as one writev burst and
// the server's cut loop sees it as one read burst (the PR 5 batcher
// then accumulates it as one window).  Tags are tag_base + i; the
// caller sets kRingTagBit in tag_base so completions route to the
// ring lane (nc_mux_harvest), not the shared done queue.  Returns the
// number of calls staged: k < n means calls k..n-1 were NOT staged
// (shutdown or a dead conn with a deep backlog) and the caller must
// fail those slots itself.
int nc_mux_submit_many(void* h, const char* service, const char* method,
                       uint64_t log_id, const uint8_t* const* payloads,
                       const uint64_t* lens, int n, int timeout_ms,
                       uint64_t tag_base) {
  MuxClient* m = static_cast<MuxClient*>(h);
  if (n <= 0 || m->stopping.load()) return 0;
  uint64_t cid0 = m->next_cid.fetch_add(static_cast<uint64_t>(n));
  MuxConn* c = m->conns[cid0 % m->conns.size()];
  int64_t deadline = timeout_ms > 0 ? now_ms() + timeout_ms : -1;
  size_t slen = strlen(service), mlen = strlen(method);
  // register ALL cids before staging ANY bytes (same
  // response-before-registration rule as nc_mux_submit)
  {
    std::lock_guard<std::mutex> g(m->mu);
    if (m->stopping.load()) return 0;
    for (int i = 0; i < n; i++) {
      c->inflight[cid0 + i] = tag_base + static_cast<uint64_t>(i);
      c->deadlines[cid0 + i] = deadline;
    }
  }
  {
    std::lock_guard<std::mutex> g(c->stage_mu);
    if (c->fd < 0 && c->staged.size() > (16u << 20)) {
      std::lock_guard<std::mutex> g2(m->mu);
      for (int i = 0; i < n; i++) {
        c->inflight.erase(cid0 + i);
        c->deadlines.erase(cid0 + i);
      }
      return 0;
    }
    size_t need = 0;
    for (int i = 0; i < n; i++) need += kHeader + lens[i];
    c->staged.reserve(c->staged.size() + need + 64 * n);
    for (int i = 0; i < n; i++) {
      std::string meta = pack_request_meta(service, slen, method, mlen,
                                           cid0 + i, 0, log_id);
      size_t base = c->staged.size();
      c->staged.resize(base + kHeader);
      put_header(&c->staged[base], meta.size(), lens[i]);
      c->staged += meta;
      if (lens[i])
        c->staged.append(reinterpret_cast<const char*>(payloads[i]),
                         lens[i]);
    }
  }
  m->stat_ring_windows.fetch_add(1, std::memory_order_relaxed);
  m->stat_ring_calls.fetch_add(static_cast<uint64_t>(n),
                               std::memory_order_relaxed);
  if (!m->wake_pending.exchange(true)) {
    uint64_t one = 1;
    ssize_t r = ::write(m->wake_fd, &one, sizeof(one));
    (void)r;
  }
  return n;
}

// Harvest up to max_n RING-lane completions (tags carrying
// kRingTagBit), blocking up to timeout_ms for the first.  Mirrors
// nc_mux_poll against the separate ring queue.  out[i].data is
// malloc'd; caller frees.
int nc_mux_harvest(void* h, MuxCompletion* out, int max_n, int timeout_ms) {
  MuxClient* m = static_cast<MuxClient*>(h);
  std::unique_lock<std::mutex> lk(m->mu);
  if (m->ring_done.empty()) {
    ns_cv_wait_for_ms(m->ring_cv, lk, timeout_ms, [m] {
      return !m->ring_done.empty() || m->stopping.load();
    });
  }
  int n = 0;
  while (n < max_n && !m->ring_done.empty()) {
    out[n++] = m->ring_done.front();
    m->ring_done.pop_front();
  }
  if (n > 0) {
    m->stat_ring_harvests.fetch_add(1, std::memory_order_relaxed);
    m->stat_ring_completions.fetch_add(static_cast<uint64_t>(n),
                                       std::memory_order_relaxed);
  }
  return n;
}

// Ring step-log counters: out[0]=windows staged out[1]=calls staged
// out[2]=harvest batches out[3]=completions harvested.
void nc_mux_ring_stats(void* h, uint64_t* out) {
  MuxClient* m = static_cast<MuxClient*>(h);
  out[0] = m->stat_ring_windows.load(std::memory_order_relaxed);
  out[1] = m->stat_ring_calls.load(std::memory_order_relaxed);
  out[2] = m->stat_ring_harvests.load(std::memory_order_relaxed);
  out[3] = m->stat_ring_completions.load(std::memory_order_relaxed);
}

// One SYNC RPC multiplexed over the mux reactor: stage the frame, park
// on a per-call waiter, return the completion.  Many caller threads
// share the reactor's few connections; submissions from concurrent
// callers batch into single writes.  Returns 0 ok, -ETIMEDOUT, -EPIPE,
// -ECANCELED on shutdown.  out->data is malloc'd; caller frees
// (nc_free) — unless the caller copies it out first (the CPython
// extension does) and frees inline.
int nc_mux_call(void* h, const char* service, size_t service_len,
                const char* method, size_t method_len, uint64_t log_id,
                const uint8_t* payload, uint64_t payload_len,
                const uint8_t* attachment, uint64_t attachment_len,
                int timeout_ms, NcResponse* out) {
  MuxClient* m = static_cast<MuxClient*>(h);
  out->data = nullptr;
  out->body_len = 0;
  out->attachment_size = 0;
  out->error_code = 0;
  out->compress_type = 0;
  out->error_text[0] = 0;
  if (m->stopping.load()) return -ECANCELED;
  struct timespec ts0;
  clock_gettime(CLOCK_MONOTONIC, &ts0);
  MuxWaiter waiter;
  uint64_t tag = reinterpret_cast<uint64_t>(&waiter);
  uint64_t cid = m->next_cid.fetch_add(1);
  std::string meta = pack_request_meta(service, service_len, method,
                                       method_len, cid, attachment_len,
                                       log_id);
  MuxConn* c = m->conns[cid % m->conns.size()];
  int64_t deadline = timeout_ms > 0 ? now_ms() + timeout_ms : -1;
  // register cid + waiter BEFORE staging (see nc_mux_submit: a staged
  // frame can be answered before an unregistered cid would be mapped)
  {
    std::lock_guard<std::mutex> g(m->mu);
    if (m->stopping.load()) return -ECANCELED;
    c->inflight[cid] = tag;
    c->deadlines[cid] = deadline;
    m->waiters[tag] = &waiter;
  }
  {
    std::lock_guard<std::mutex> g(c->stage_mu);
    if (c->fd < 0 && c->staged.size() > (16u << 20)) {
      std::lock_guard<std::mutex> g2(m->mu);
      c->inflight.erase(cid);
      c->deadlines.erase(cid);
      m->waiters.erase(tag);
      m->stat_fail.fetch_add(1, std::memory_order_relaxed);
      return -EPIPE;
    }
    size_t base = c->staged.size();
    c->staged.resize(base + kHeader);
    put_header(&c->staged[base], meta.size(), payload_len + attachment_len);
    c->staged += meta;
    if (payload_len)
      c->staged.append(reinterpret_cast<const char*>(payload), payload_len);
    if (attachment_len)
      c->staged.append(reinterpret_cast<const char*>(attachment),
                       attachment_len);
  }
  if (!m->wake_pending.exchange(true)) {
    uint64_t one = 1;
    ssize_t r = ::write(m->wake_fd, &one, sizeof(one));
    (void)r;
  }
  bool got;
  {
    std::unique_lock<std::mutex> lk(waiter.mu);
    // the reactor's timeout sweep delivers -ETIMEDOUT; this wait bound
    // is only a backstop against a wedged reactor
    int64_t backstop_ms = timeout_ms > 0 ? timeout_ms + 2000 : 3600 * 1000;
    got = ns_cv_wait_for_ms(waiter.cv, lk, backstop_ms,
                            [&] { return waiter.ready; });
  }  // drop waiter.mu BEFORE m->mu: routing takes m->mu then waiter.mu
  if (!got) {
    bool deregistered = false;
    {
      std::lock_guard<std::mutex> g(m->mu);
      auto wit = m->waiters.find(tag);
      if (wit != m->waiters.end()) {
        // nobody routed the completion yet and now nobody can: safe to
        // abandon the call (a late response hits an unknown cid)
        m->waiters.erase(wit);
        c->inflight.erase(cid);
        c->deadlines.erase(cid);
        deregistered = true;
      }
    }
    if (deregistered) {
      m->stat_fail.fetch_add(1, std::memory_order_relaxed);
      return -ETIMEDOUT;
    }
    // completion routing is mid-flight (erased from waiters under
    // m->mu, ready about to be set): finish the handoff
    std::unique_lock<std::mutex> lk(waiter.mu);
    waiter.cv.wait(lk, [&] { return waiter.ready; });
  }
  MuxCompletion& comp = waiter.comp;
  if (comp.rc != 0 || comp.error_code != 0) {
    m->stat_fail.fetch_add(1, std::memory_order_relaxed);
  } else {
    struct timespec ts1;
    clock_gettime(CLOCK_MONOTONIC, &ts1);
    uint64_t us = (ts1.tv_sec - ts0.tv_sec) * 1000000ull +
                  (ts1.tv_nsec - ts0.tv_nsec) / 1000;
    m->stat_ok.fetch_add(1, std::memory_order_relaxed);
    m->stat_lat_us_sum.fetch_add(us, std::memory_order_relaxed);
    uint64_t prev = m->stat_lat_us_max.load(std::memory_order_relaxed);
    while (us > prev && !m->stat_lat_us_max.compare_exchange_weak(
                            prev, us, std::memory_order_relaxed)) {
    }
  }
  if (comp.rc != 0) {
    if (comp.data) free(comp.data);
    return comp.rc;
  }
  out->data = comp.data;
  out->body_len = comp.body_len;
  out->attachment_size = comp.attachment_size;
  out->error_code = comp.error_code;
  out->compress_type = comp.compress_type;
  snprintf(out->error_text, sizeof(out->error_text), "%s", comp.error_text);
  return 0;
}

// Cumulative sync-call stats: out[0]=ok_count out[1]=latency_us_sum
// out[2]=latency_us_max (reset to 0 by this read — windowed max)
// out[3]=fail_count.  The Python harvester diffs counts/sums against
// its last snapshot (same protocol as ns_method_stats).
void nc_mux_stats(void* h, uint64_t* out) {
  MuxClient* m = static_cast<MuxClient*>(h);
  out[0] = m->stat_ok.load(std::memory_order_relaxed);
  out[1] = m->stat_lat_us_sum.load(std::memory_order_relaxed);
  out[2] = m->stat_lat_us_max.exchange(0, std::memory_order_relaxed);
  out[3] = m->stat_fail.load(std::memory_order_relaxed);
}

// harvest up to max completions (blocks up to timeout_ms); returns count
int nc_mux_poll(void* h, MuxCompletion* out, int max_n, int timeout_ms) {
  MuxClient* m = static_cast<MuxClient*>(h);
  std::unique_lock<std::mutex> lk(m->mu);
  if (m->done.empty()) {
    ns_cv_wait_for_ms(m->done_cv, lk, timeout_ms, [m] {
      return !m->done.empty() || m->stopping.load();
    });
  }
  int n = 0;
  while (n < max_n && !m->done.empty()) {
    out[n++] = m->done.front();
    m->done.pop_front();
  }
  return n;
}

void nc_mux_destroy(void* h);  // defined below, used by press_worker

// ---- native load generator (the rpc_press engine, reference
// tools/rpc_press is likewise native) ----
struct NcBenchResult {
  uint64_t ok;
  uint64_t failed;
  double qps;
  double p50_us;
  double p99_us;
  double p999_us;
  double avg_us;
};

// One press worker: sync pooled round trips against service/method
// "EchoService"/"Echo" with a `payload_len`-byte message, recording
// microsecond latencies until the deadline.
static void press_worker(const char* host, int port, const char* service,
                         const char* method, int payload_len,
                         int64_t deadline_ms, std::vector<uint32_t>* lats,
                         uint64_t* failed, int depth, int conns) {
  void* pool_h = nc_pool_create(host, port, 3000);
  // request payload: EchoRequest{message: 'x' * payload_len}
  PbWriter req;
  std::string msg(payload_len, 'x');
  req.field_bytes(1, msg.data(), msg.size());
  const uint8_t* payload = reinterpret_cast<const uint8_t*>(req.out.data());
  uint64_t plen = req.out.size();
  NcResponse resp;
  if (depth <= 1) {
    // sync mode: one in-flight, pooled fd
    while (now_ms() < deadline_ms) {
      int64_t t0 = now_ms();
      struct timespec ts0, ts1;
      clock_gettime(CLOCK_MONOTONIC, &ts0);
      int rc = nc_call(pool_h, service, method, 0, payload, plen,
                       nullptr, 0, 3000, &resp);
      clock_gettime(CLOCK_MONOTONIC, &ts1);
      (void)t0;
      if (rc == 0 && resp.error_code == 0) {
        if (resp.data) free(resp.data);
        uint64_t us = (ts1.tv_sec - ts0.tv_sec) * 1000000ull +
                      (ts1.tv_nsec - ts0.tv_nsec) / 1000;
        lats->push_back(static_cast<uint32_t>(us));
      } else {
        if (resp.data) free(resp.data);
        (*failed)++;
      }
    }
  } else {
    // pipelined mode: `depth` in-flight over a mux client with `conns`
    // connections (in-flight RPCs round-robin over them by cid)
    void* mux_h = nc_mux_create(host, port, conns < 1 ? 1 : conns);
    std::unordered_map<uint64_t, struct timespec> t0s;
    std::vector<MuxCompletion> comps(depth);
    int inflight = 0;
    uint64_t tag = 0;
    while (now_ms() < deadline_ms || inflight > 0) {
      bool deadline_past = now_ms() >= deadline_ms;
      while (!deadline_past && inflight < depth) {
        struct timespec ts0;
        clock_gettime(CLOCK_MONOTONIC, &ts0);
        ++tag;
        if (!nc_mux_submit(mux_h, service, method, 0, payload, plen,
                           nullptr, 0, 3000, tag))
          break;
        t0s[tag] = ts0;
        inflight++;
      }
      int n = nc_mux_poll(mux_h, comps.data(), depth, 100);
      struct timespec ts1;
      clock_gettime(CLOCK_MONOTONIC, &ts1);
      for (int i = 0; i < n; i++) {
        inflight--;
        auto it = t0s.find(comps[i].tag);
        if (comps[i].rc == 0 && comps[i].error_code == 0 &&
            it != t0s.end()) {
          uint64_t us = (ts1.tv_sec - it->second.tv_sec) * 1000000ull +
                        (ts1.tv_nsec - it->second.tv_nsec) / 1000;
          lats->push_back(static_cast<uint32_t>(us));
        } else {
          (*failed)++;
        }
        if (it != t0s.end()) t0s.erase(it);
        if (comps[i].data) free(comps[i].data);
      }
      if (n == 0 && now_ms() >= deadline_ms + 3500) break;  // stuck drain
    }
    nc_mux_destroy(mux_h);
  }
  nc_pool_destroy(pool_h);
}

// End-to-end echo load test with zero Python in the loop (both sides of
// the wire are this framework's native engine).  depth<=1 → sync
// threads; depth>1 → each thread pipelines `depth` in-flight RPCs.
int nc_bench_echo(const char* host, int port, const char* service,
                  const char* method, int payload_len, int concurrency,
                  int duration_ms, int depth, int conns,
                  NcBenchResult* out) {
  if (concurrency < 1) concurrency = 1;
  int64_t t_start = now_ms();
  int64_t deadline = t_start + duration_ms;
  std::vector<std::vector<uint32_t>> lats(concurrency);
  std::vector<uint64_t> fails(concurrency, 0);
  std::vector<std::thread> threads;
  for (int i = 0; i < concurrency; i++) {
    lats[i].reserve(1 << 18);
    threads.emplace_back(press_worker, host, port, service, method,
                         payload_len, deadline, &lats[i], &fails[i], depth,
                         conns);
  }
  for (auto& t : threads) t.join();
  int64_t t_end = now_ms();
  std::vector<uint32_t> all;
  uint64_t failed = 0;
  for (int i = 0; i < concurrency; i++) {
    all.insert(all.end(), lats[i].begin(), lats[i].end());
    failed += fails[i];
  }
  out->ok = all.size();
  out->failed = failed;
  double wall_s = (t_end - t_start) / 1000.0;
  out->qps = wall_s > 0 ? all.size() / wall_s : 0;
  if (all.empty()) {
    out->p50_us = out->p99_us = out->p999_us = out->avg_us = -1;
    return 0;
  }
  std::sort(all.begin(), all.end());
  out->p50_us = all[all.size() / 2];
  out->p99_us = all[std::min(all.size() - 1, all.size() * 99 / 100)];
  out->p999_us = all[std::min(all.size() - 1, all.size() * 999 / 1000)];
  double sum = 0;
  for (uint32_t v : all) sum += v;
  out->avg_us = sum / all.size();
  return 0;
}

// ---- native HTTP / redis load generators (tools/rpc_press analogs:
// the reference benchmarks its http/redis servers with native clients;
// a Python client would measure the GIL, not the server) ----

static int bench_connect(const char* host, int port) {
  ClientPool p;
  p.host = host;
  p.port = port;
  p.connect_timeout_ms = 3000;
  int fd = pool_connect(&p);
  if (fd >= 0) {
    struct timeval tv {3, 0};
    setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  }
  return fd;
}

static void http_press_worker(const char* host, int port, const char* path,
                              int payload_len, int64_t deadline_ms,
                              int depth, std::vector<uint32_t>* lats,
                              uint64_t* failed) {
  int fd = bench_connect(host, port);
  if (fd < 0) {
    (*failed)++;
    return;
  }
  std::string req;
  {
    char head[256];
    int n = snprintf(head, sizeof(head),
                     "POST %s HTTP/1.1\r\nHost: bench\r\nContent-Type: "
                     "application/octet-stream\r\nContent-Length: %d\r\n\r\n",
                     path, payload_len);
    req.assign(head, n);
    req.append(static_cast<size_t>(payload_len), 'x');
  }
  std::deque<struct timespec> pend;
  std::vector<char> rbuf(1 << 20);
  size_t rlen = 0;
  bool dead = false;
  while (!dead && (now_ms() < deadline_ms || !pend.empty())) {
    while (static_cast<int>(pend.size()) < depth && now_ms() < deadline_ms) {
      struct timespec t0;
      clock_gettime(CLOCK_MONOTONIC, &t0);
      if (!write_all(fd, req.data(), req.size())) {
        dead = true;
        break;
      }
      pend.push_back(t0);
    }
    if (pend.empty()) break;
    if (rlen == rbuf.size()) rbuf.resize(rbuf.size() * 2);
    ssize_t r = ::read(fd, rbuf.data() + rlen, rbuf.size() - rlen);
    if (r <= 0) {
      dead = true;
      break;
    }
    rlen += static_cast<size_t>(r);
    size_t off = 0;
    struct timespec t1;
    clock_gettime(CLOCK_MONOTONIC, &t1);
    while (!pend.empty()) {
      // find end of headers
      size_t he = 0;
      const char* p = rbuf.data() + off;
      size_t avail = rlen - off;
      for (size_t i = 3; i < avail; i++) {
        if (p[i] == '\n' && p[i - 1] == '\r' && p[i - 2] == '\n' &&
            p[i - 3] == '\r') {
          he = i + 1;
          break;
        }
      }
      if (!he) break;
      const char* val;
      size_t val_len;
      uint64_t cl = 0;
      if (http_find_header(p, he, "content-length", 14, &val, &val_len)) {
        for (size_t i = 0; i < val_len; i++)
          cl = cl * 10 + (val[i] - '0');
      }
      if (avail < he + cl) break;
      bool ok = avail >= 12 && memcmp(p, "HTTP/1.1 200", 12) == 0;
      struct timespec t0 = pend.front();
      pend.pop_front();
      if (ok) {
        uint64_t us = (t1.tv_sec - t0.tv_sec) * 1000000ull +
                      (t1.tv_nsec - t0.tv_nsec) / 1000;
        lats->push_back(static_cast<uint32_t>(us));
      } else {
        (*failed)++;
      }
      off += he + cl;
    }
    if (off) {
      memmove(rbuf.data(), rbuf.data() + off, rlen - off);
      rlen -= off;
    }
  }
  *failed += pend.size();
  ::close(fd);
}

int nc_bench_http(const char* host, int port, const char* path,
                  int payload_len, int concurrency, int duration_ms,
                  int depth, NcBenchResult* out) {
  if (concurrency < 1) concurrency = 1;
  if (depth < 1) depth = 1;
  int64_t t_start = now_ms();
  int64_t deadline = t_start + duration_ms;
  std::vector<std::vector<uint32_t>> lats(concurrency);
  std::vector<uint64_t> fails(concurrency, 0);
  std::vector<std::thread> threads;
  for (int i = 0; i < concurrency; i++) {
    lats[i].reserve(1 << 16);
    threads.emplace_back(http_press_worker, host, port, path, payload_len,
                         deadline, depth, &lats[i], &fails[i]);
  }
  for (auto& t : threads) t.join();
  int64_t t_end = now_ms();
  std::vector<uint32_t> all;
  uint64_t failed = 0;
  for (int i = 0; i < concurrency; i++) {
    all.insert(all.end(), lats[i].begin(), lats[i].end());
    failed += fails[i];
  }
  out->ok = all.size();
  out->failed = failed;
  double wall_s = (t_end - t_start) / 1000.0;
  out->qps = wall_s > 0 ? all.size() / wall_s : 0;
  if (all.empty()) {
    out->p50_us = out->p99_us = out->p999_us = out->avg_us = -1;
    return 0;
  }
  std::sort(all.begin(), all.end());
  out->p50_us = all[all.size() / 2];
  out->p99_us = all[std::min(all.size() - 1, all.size() * 99 / 100)];
  out->p999_us = all[std::min(all.size() - 1, all.size() * 999 / 1000)];
  double sum = 0;
  for (uint32_t v : all) sum += v;
  out->avg_us = sum / all.size();
  return 0;
}

// one RESP reply's wire length at p (0 = incomplete, SIZE_MAX = bad)
static size_t resp_reply_len(const char* p, size_t len) {
  if (len < 3) return 0;
  char t = p[0];
  const char* nl = static_cast<const char*>(memchr(p, '\n', len));
  if (!nl) return 0;
  size_t line = static_cast<size_t>(nl - p) + 1;
  if (t == '+' || t == '-' || t == ':') return line;
  if (t == '$') {
    long n = strtol(p + 1, nullptr, 10);
    if (n < 0) return line;  // nil bulk
    size_t total = line + static_cast<size_t>(n) + 2;
    return len >= total ? total : 0;
  }
  if (t == '*') {
    long n = strtol(p + 1, nullptr, 10);
    size_t off = line;
    for (long i = 0; i < n; i++) {
      size_t r = resp_reply_len(p + off, len - off);
      if (r == 0 || r == SIZE_MAX) return r;
      off += r;
    }
    return off;
  }
  return SIZE_MAX;
}

static void redis_press_worker(const char* host, int port, int value_len,
                               int64_t deadline_ms, int depth, int wid,
                               std::vector<uint32_t>* lats,
                               uint64_t* failed) {
  int fd = bench_connect(host, port);
  if (fd < 0) {
    (*failed)++;
    return;
  }
  // alternating SET key:<wid> <val> / GET key:<wid> — each command is
  // one op (reference redis benchmarks count commands)
  char key[32];
  int klen = snprintf(key, sizeof(key), "bench:%d", wid);
  std::string val(static_cast<size_t>(value_len), 'v');
  std::string set_cmd, get_cmd;
  {
    char h[64];
    set_cmd.append("*3\r\n$3\r\nSET\r\n");
    set_cmd.append(h, snprintf(h, sizeof(h), "$%d\r\n", klen));
    set_cmd.append(key, klen);
    set_cmd.append("\r\n");
    set_cmd.append(h, snprintf(h, sizeof(h), "$%d\r\n", value_len));
    set_cmd += val;
    set_cmd.append("\r\n");
    get_cmd.append("*2\r\n$3\r\nGET\r\n");
    get_cmd.append(h, snprintf(h, sizeof(h), "$%d\r\n", klen));
    get_cmd.append(key, klen);
    get_cmd.append("\r\n");
  }
  std::deque<struct timespec> pend;
  std::vector<char> rbuf(1 << 20);
  size_t rlen = 0;
  uint64_t seq = 0;
  bool dead = false;
  while (!dead && (now_ms() < deadline_ms || !pend.empty())) {
    while (static_cast<int>(pend.size()) < depth && now_ms() < deadline_ms) {
      const std::string& cmd = (seq++ & 1) ? get_cmd : set_cmd;
      struct timespec t0;
      clock_gettime(CLOCK_MONOTONIC, &t0);
      if (!write_all(fd, cmd.data(), cmd.size())) {
        dead = true;
        break;
      }
      pend.push_back(t0);
    }
    if (pend.empty()) break;
    if (rlen == rbuf.size()) rbuf.resize(rbuf.size() * 2);
    ssize_t r = ::read(fd, rbuf.data() + rlen, rbuf.size() - rlen);
    if (r <= 0) {
      dead = true;
      break;
    }
    rlen += static_cast<size_t>(r);
    size_t off = 0;
    struct timespec t1;
    clock_gettime(CLOCK_MONOTONIC, &t1);
    while (!pend.empty()) {
      size_t n = resp_reply_len(rbuf.data() + off, rlen - off);
      if (n == 0) break;
      if (n == SIZE_MAX) {
        dead = true;
        break;
      }
      struct timespec t0 = pend.front();
      pend.pop_front();
      if (rbuf[off] == '-') {
        (*failed)++;
      } else {
        uint64_t us = (t1.tv_sec - t0.tv_sec) * 1000000ull +
                      (t1.tv_nsec - t0.tv_nsec) / 1000;
        lats->push_back(static_cast<uint32_t>(us));
      }
      off += n;
    }
    if (off) {
      memmove(rbuf.data(), rbuf.data() + off, rlen - off);
      rlen -= off;
    }
  }
  *failed += pend.size();
  ::close(fd);
}

int nc_bench_redis(const char* host, int port, int value_len,
                   int concurrency, int duration_ms, int depth,
                   NcBenchResult* out) {
  if (concurrency < 1) concurrency = 1;
  if (depth < 1) depth = 1;
  int64_t t_start = now_ms();
  int64_t deadline = t_start + duration_ms;
  std::vector<std::vector<uint32_t>> lats(concurrency);
  std::vector<uint64_t> fails(concurrency, 0);
  std::vector<std::thread> threads;
  for (int i = 0; i < concurrency; i++) {
    lats[i].reserve(1 << 16);
    threads.emplace_back(redis_press_worker, host, port, value_len,
                         deadline, depth, i, &lats[i], &fails[i]);
  }
  for (auto& t : threads) t.join();
  int64_t t_end = now_ms();
  std::vector<uint32_t> all;
  uint64_t failed = 0;
  for (int i = 0; i < concurrency; i++) {
    all.insert(all.end(), lats[i].begin(), lats[i].end());
    failed += fails[i];
  }
  out->ok = all.size();
  out->failed = failed;
  double wall_s = (t_end - t_start) / 1000.0;
  out->qps = wall_s > 0 ? all.size() / wall_s : 0;
  if (all.empty()) {
    out->p50_us = out->p99_us = out->p999_us = out->avg_us = -1;
    return 0;
  }
  std::sort(all.begin(), all.end());
  out->p50_us = all[all.size() / 2];
  out->p99_us = all[std::min(all.size() - 1, all.size() * 99 / 100)];
  out->p999_us = all[std::min(all.size() - 1, all.size() * 999 / 1000)];
  double sum = 0;
  for (uint32_t v : all) sum += v;
  out->avg_us = sum / all.size();
  return 0;
}

void nc_mux_destroy(void* h) {
  MuxClient* m = static_cast<MuxClient*>(h);
  m->stopping.store(true);
  uint64_t one = 1;
  ssize_t r = ::write(m->wake_fd, &one, sizeof(one));
  (void)r;
  m->done_cv.notify_all();
  m->ring_cv.notify_all();
  if (m->reactor.joinable()) m->reactor.join();
  // fail whatever the reactor never answered — this also wakes sync
  // callers parked in nc_mux_call so they can't outlive the client
  {
    std::lock_guard<std::mutex> g(m->mu);
    for (MuxConn* c : m->conns) {
      for (auto& kv : c->inflight)
        mux_complete_locked(m, kv.second, -ECANCELED, nullptr, nullptr, 0);
      c->inflight.clear();
      c->deadlines.clear();
    }
  }
  m->done_cv.notify_all();
  m->ring_cv.notify_all();
  for (MuxConn* c : m->conns) {
    if (c->fd >= 0) ::close(c->fd);
    delete c;
  }
  {
    std::lock_guard<std::mutex> g(m->mu);
    for (auto& d : m->done)
      if (d.data) free(d.data);
    m->done.clear();
    for (auto& d : m->ring_done)
      if (d.data) free(d.data);
    m->ring_done.clear();
  }
  ::close(m->epfd);
  ::close(m->wake_fd);
  delete m;
}

}  // extern "C"
