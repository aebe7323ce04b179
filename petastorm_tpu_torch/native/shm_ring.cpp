// Shared-memory SPSC ring for worker->main result transport (petastorm_tpu_torch).
//
// The port's own copy of petastorm_tpu/native/shm_ring.cpp, whole and
// unchanged below this header: one single-producer/single-consumer byte ring
// per worker process in POSIX shared memory, so a decoded row-group payload
// crosses the process boundary with one memcpy in and one out (or none, with
// the in-place reservation and the zero-copy peek). The port binds the SPSC
// ring (pstpu_ring_*) and pstpu_guard_protect; the broadcast ring
// (pstpu_bcast_*) is compiled but not bound yet.
//
// Layout: [RingHeader][data area of `capacity` bytes]. `head`/`tail` are
// monotonically increasing byte positions (index = pos % capacity). Messages
// are 8-byte little-endian length + payload, wrapping byte-wise. Producer:
// load head (acquire) -> check space -> write -> store tail (release).
// Consumer: load tail (acquire) -> read -> store head (release). Blocking is
// left to the Python callers (sleep-poll), keeping the C side lock-free.
//
// Build: python -m petastorm_tpu_torch.native.build (plain g++, no
// third-party headers).

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <string>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct RingHeader {
  std::atomic<uint64_t> head;  // consumer position
  std::atomic<uint64_t> tail;  // producer position
  uint64_t capacity;
  uint64_t magic;
  char pad[64 - 4 * sizeof(uint64_t)];  // keep the data area cache-aligned
};

constexpr uint64_t kMagic = 0x70737470755F7268ULL;  // "pstpu_rh"

// Length-prefix flag marking a PAD region (no payload): the producer's
// in-place reservation needs a CONTIGUOUS slot, so when the next message
// would wrap it first emits an 8-byte pad marker whose low bits hold the
// number of dead bytes to skip; consumers jump over pads transparently.
// Real message lengths are < 2^63, so the flag is unambiguous.
constexpr uint64_t kPadFlag = 1ULL << 63;

struct RingHandle {
  RingHeader* hdr;
  uint8_t* data;
  size_t map_len;
  std::string name;
  bool owner;
  // producer-side pending in-place reservation (single producer: plain fields)
  uint64_t pending_tail = 0;
  uint64_t pending_pad = 0;   // pad marker + dead bytes emitted before the slot
  uint64_t pending_max = 0;   // reserved payload capacity
  bool pending = false;
  // consumer-side zero-copy peek cursor (single consumer: plain field).
  // Invariant head <= peek_head <= tail; bytes in [head, peek_head) are lent
  // out as views and only pstpu_ring_release retires them to the producer.
  uint64_t peek_head = 0;
};

thread_local std::string g_error;

void set_error(const std::string& msg) { g_error = msg; }

void copy_in(RingHandle* r, uint64_t pos, const uint8_t* src, uint64_t len) {
  const uint64_t cap = r->hdr->capacity;
  const uint64_t idx = pos % cap;
  const uint64_t first = (idx + len <= cap) ? len : cap - idx;
  std::memcpy(r->data + idx, src, first);
  if (first < len) std::memcpy(r->data, src + first, len - first);
}

void copy_out(RingHandle* r, uint64_t pos, uint8_t* dst, uint64_t len) {
  const uint64_t cap = r->hdr->capacity;
  const uint64_t idx = pos % cap;
  const uint64_t first = (idx + len <= cap) ? len : cap - idx;
  std::memcpy(dst, r->data + idx, first);
  if (first < len) std::memcpy(dst + first, r->data, len - first);
}

}  // namespace

extern "C" {

const char* pstpu_ring_last_error() { return g_error.c_str(); }

// Create (consumer side). Returns NULL on failure.
void* pstpu_ring_create(const char* name, uint64_t capacity) {
  if (capacity < 4096) {
    set_error("ring capacity must be >= 4096 bytes");
    return nullptr;
  }
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) {
    set_error(std::string("shm_open(create) failed: ") + std::strerror(errno));
    return nullptr;
  }
  const size_t map_len = sizeof(RingHeader) + capacity;
  if (ftruncate(fd, static_cast<off_t>(map_len)) != 0) {
    set_error(std::string("ftruncate failed: ") + std::strerror(errno));
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  // Pre-fault the whole segment NOW: ftruncate on tmpfs succeeds beyond the
  // /dev/shm quota and the first store past it delivers SIGBUS (killing the
  // process uncatchably). posix_fallocate reserves the blocks up front and
  // reports exhaustion as a plain error the caller can fall back from.
  int falloc_rc = posix_fallocate(fd, 0, static_cast<off_t>(map_len));
  if (falloc_rc != 0 && falloc_rc != EOPNOTSUPP && falloc_rc != EINVAL) {
    set_error(std::string("posix_fallocate failed (is /dev/shm large enough?): ") +
              std::strerror(falloc_rc));
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* mem = mmap(nullptr, map_len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) {
    set_error(std::string("mmap failed: ") + std::strerror(errno));
    shm_unlink(name);
    return nullptr;
  }
  auto* hdr = new (mem) RingHeader();
  hdr->head.store(0, std::memory_order_relaxed);
  hdr->tail.store(0, std::memory_order_relaxed);
  hdr->capacity = capacity;
  hdr->magic = kMagic;
  auto* handle = new RingHandle{hdr, reinterpret_cast<uint8_t*>(mem) + sizeof(RingHeader),
                                map_len, name, /*owner=*/true};
  return handle;
}

// Attach (producer side). Returns NULL on failure.
void* pstpu_ring_attach(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) {
    set_error(std::string("shm_open(attach) failed: ") + std::strerror(errno));
    return nullptr;
  }
  struct stat st;
  if (fstat(fd, &st) != 0 || static_cast<size_t>(st.st_size) < sizeof(RingHeader)) {
    set_error("ring shm segment too small");
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ | PROT_WRITE,
                   MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) {
    set_error(std::string("mmap failed: ") + std::strerror(errno));
    return nullptr;
  }
  auto* hdr = reinterpret_cast<RingHeader*>(mem);
  if (hdr->magic != kMagic ||
      sizeof(RingHeader) + hdr->capacity != static_cast<uint64_t>(st.st_size)) {
    set_error("ring header corrupt (magic/capacity mismatch)");
    munmap(mem, static_cast<size_t>(st.st_size));
    return nullptr;
  }
  auto* handle = new RingHandle{hdr, reinterpret_cast<uint8_t*>(mem) + sizeof(RingHeader),
                                static_cast<size_t>(st.st_size), name, /*owner=*/false};
  return handle;
}

uint64_t pstpu_ring_capacity(void* h) {
  return static_cast<RingHandle*>(h)->hdr->capacity;
}

// Space currently free for writing (bytes, including the 8-byte length prefix).
uint64_t pstpu_ring_free_space(void* h) {
  auto* r = static_cast<RingHandle*>(h);
  const uint64_t head = r->hdr->head.load(std::memory_order_acquire);
  const uint64_t tail = r->hdr->tail.load(std::memory_order_relaxed);
  return r->hdr->capacity - (tail - head);
}

// Non-blocking write of one message. 1 = written, 0 = would block (not enough
// space right now), -1 = message can never fit this ring.
int pstpu_ring_write(void* h, const void* data, uint64_t len) {
  auto* r = static_cast<RingHandle*>(h);
  const uint64_t need = len + 8;
  if (need > r->hdr->capacity) {
    set_error("message larger than ring capacity");
    return -1;
  }
  const uint64_t head = r->hdr->head.load(std::memory_order_acquire);
  const uint64_t tail = r->hdr->tail.load(std::memory_order_relaxed);
  if (r->hdr->capacity - (tail - head) < need) return 0;
  uint64_t len_le = len;  // assume little-endian host (x86/arm TPU hosts)
  copy_in(r, tail, reinterpret_cast<const uint8_t*>(&len_le), 8);
  copy_in(r, tail + 8, static_cast<const uint8_t*>(data), len);
  r->hdr->tail.store(tail + need, std::memory_order_release);
  return 1;
}

// Gather write: header + payload as ONE message, no caller-side concat copy.
// Same return convention as pstpu_ring_write.
int pstpu_ring_write2(void* h, const void* a, uint64_t a_len, const void* b, uint64_t b_len) {
  auto* r = static_cast<RingHandle*>(h);
  const uint64_t len = a_len + b_len;
  const uint64_t need = len + 8;
  if (need > r->hdr->capacity) {
    set_error("message larger than ring capacity");
    return -1;
  }
  const uint64_t head = r->hdr->head.load(std::memory_order_acquire);
  const uint64_t tail = r->hdr->tail.load(std::memory_order_relaxed);
  if (r->hdr->capacity - (tail - head) < need) return 0;
  uint64_t len_le = len;
  copy_in(r, tail, reinterpret_cast<const uint8_t*>(&len_le), 8);
  copy_in(r, tail + 8, static_cast<const uint8_t*>(a), a_len);
  copy_in(r, tail + 8 + a_len, static_cast<const uint8_t*>(b), b_len);
  r->hdr->tail.store(tail + need, std::memory_order_release);
  return 1;
}

// Gather write of N segments as ONE message — the generalization of write2
// the serializer's parts channel uses: a whole column block (header + every
// column/cell buffer) lands in the ring with exactly one copy per byte and no
// caller-side join. Same return convention as pstpu_ring_write.
int pstpu_ring_writev(void* h, const void* const* bufs, const uint64_t* lens, int32_t n) {
  auto* r = static_cast<RingHandle*>(h);
  uint64_t len = 0;
  for (int32_t i = 0; i < n; i++) len += lens[i];
  const uint64_t need = len + 8;
  if (need > r->hdr->capacity) {
    set_error("message larger than ring capacity");
    return -1;
  }
  const uint64_t head = r->hdr->head.load(std::memory_order_acquire);
  const uint64_t tail = r->hdr->tail.load(std::memory_order_relaxed);
  if (r->hdr->capacity - (tail - head) < need) return 0;
  uint64_t len_le = len;
  copy_in(r, tail, reinterpret_cast<const uint8_t*>(&len_le), 8);
  uint64_t off = tail + 8;
  for (int32_t i = 0; i < n; i++) {
    if (lens[i] == 0) continue;
    copy_in(r, off, static_cast<const uint8_t*>(bufs[i]), lens[i]);
    off += lens[i];
  }
  r->hdr->tail.store(tail + need, std::memory_order_release);
  return 1;
}

// Reserve a CONTIGUOUS writable region of up to max_len payload bytes inside
// the ring (the in-place channel: a fused batch decode lands its rows
// directly in the slot the consumer will map — the publish is then a header
// write, not a copy). When the slot would wrap, a pad marker is staged first
// so the payload starts at the ring's physical start. Nothing becomes visible
// to the consumer until pstpu_ring_commit. Exactly one reservation may be
// pending per ring (single producer). *status: 1 = reserved (returns the
// payload pointer), 0 = not enough free space right now (retry), -1 = can
// never fit / a reservation is already pending.
void* pstpu_ring_reserve(void* h, uint64_t max_len, int32_t* status) {
  auto* r = static_cast<RingHandle*>(h);
  const uint64_t cap = r->hdr->capacity;
  if (r->pending || max_len + 16 > cap) {  // worst case: pad marker + header
    set_error(r->pending ? "a reservation is already pending"
                         : "message larger than ring capacity");
    if (status) *status = -1;
    return nullptr;
  }
  const uint64_t head = r->hdr->head.load(std::memory_order_acquire);
  const uint64_t tail = r->hdr->tail.load(std::memory_order_relaxed);
  const uint64_t idx = tail % cap;
  const uint64_t data_start = (idx + 8) % cap;
  uint64_t pad = 0;
  if (data_start + max_len > cap) {
    // dead bytes from after the pad marker to the physical end; the real
    // header then sits so its payload begins at index 0
    pad = 8 + (cap - data_start);
  }
  if (pad + 8 + max_len > cap) {
    // wrapping at this tail position costs more than the ring holds: a drained
    // ring would still never fit it, so retrying is a livelock — fail so the
    // caller takes the copy channel (single producer: tail can't move under us)
    set_error("message larger than ring capacity");
    if (status) *status = -1;
    return nullptr;
  }
  if (cap - (tail - head) < pad + 8 + max_len) {
    if (status) *status = 0;
    return nullptr;
  }
  if (pad != 0) {
    uint64_t marker = kPadFlag | (pad - 8);
    copy_in(r, tail, reinterpret_cast<const uint8_t*>(&marker), 8);
  }
  r->pending = true;
  r->pending_tail = tail;
  r->pending_pad = pad;
  r->pending_max = max_len;
  if (status) *status = 1;
  return r->data + ((tail + pad + 8) % cap);
}

// Publish a pending reservation with its actual payload length (<= the
// reserved max). Returns 0, or -1 when no reservation is pending / the
// length exceeds the reservation.
int pstpu_ring_commit(void* h, uint64_t actual_len) {
  auto* r = static_cast<RingHandle*>(h);
  if (!r->pending || actual_len > r->pending_max) {
    set_error(r->pending ? "commit exceeds reservation" : "no pending reservation");
    return -1;
  }
  uint64_t len_le = actual_len;
  copy_in(r, r->pending_tail + r->pending_pad,
          reinterpret_cast<const uint8_t*>(&len_le), 8);
  r->pending = false;
  r->hdr->tail.store(r->pending_tail + r->pending_pad + 8 + actual_len,
                     std::memory_order_release);
  return 0;
}

// Drop a pending reservation; nothing was ever visible to the consumer.
void pstpu_ring_abort(void* h) {
  static_cast<RingHandle*>(h)->pending = false;
}

// Skip any pad markers at the head; returns the head position of the next
// real message, or UINT64_MAX when the readable region is empty.
static uint64_t skip_pads(RingHandle* r) {
  const uint64_t tail = r->hdr->tail.load(std::memory_order_acquire);
  uint64_t head = r->hdr->head.load(std::memory_order_relaxed);
  while (head != tail) {
    uint64_t len_le = 0;
    copy_out(r, head, reinterpret_cast<uint8_t*>(&len_le), 8);
    if (!(len_le & kPadFlag)) return head;
    head += 8 + (len_le & ~kPadFlag);
    r->hdr->head.store(head, std::memory_order_release);
  }
  return UINT64_MAX;
}

// Length of the next unread message, or -1 when the ring is empty.
int64_t pstpu_ring_next_len(void* h) {
  auto* r = static_cast<RingHandle*>(h);
  const uint64_t head = skip_pads(r);
  if (head == UINT64_MAX) return -1;
  uint64_t len_le = 0;
  copy_out(r, head, reinterpret_cast<uint8_t*>(&len_le), 8);
  return static_cast<int64_t>(len_le);
}

// Read one message into buf. Returns its length, -1 when empty, -2 when buf
// is too small (message left in place; call pstpu_ring_next_len first).
int64_t pstpu_ring_read(void* h, void* buf, uint64_t buf_cap) {
  auto* r = static_cast<RingHandle*>(h);
  const uint64_t head = skip_pads(r);
  if (head == UINT64_MAX) return -1;
  uint64_t len_le = 0;
  copy_out(r, head, reinterpret_cast<uint8_t*>(&len_le), 8);
  if (len_le > buf_cap) return -2;
  copy_out(r, head + 8, static_cast<uint8_t*>(buf), len_le);
  r->hdr->head.store(head + 8 + len_le, std::memory_order_release);
  return static_cast<int64_t>(len_le);
}

// Zero-copy take of the next message (lifetime-tracked consumer views,
// docs/native.md). Without advancing the SHARED head, locate the next unread
// message past the handle's local peek cursor and advance that cursor over
// it. out[0] = payload address inside the mapped data area, out[1] = payload
// length, out[2] = span (pads + header + payload bytes) the matching
// pstpu_ring_release must retire once every consumer view of the payload
// died. Returns 1 when out holds a contiguous message, 2 when the next
// message wraps the physical end (out[1]/out[2] still filled; the caller
// copies it out via pstpu_ring_peek_copy), 0 when empty, -1 when out_count
// is too small. Only reserve-committed messages are contiguous by
// construction (pad markers); plain writes wrap byte-wise, hence status 2.
long long pstpu_ring_peek(void* h, unsigned long long* out,
                          unsigned long long out_count) {
  if (out_count < 3) {
    set_error("pstpu_ring_peek needs a 3-slot out array");
    return -1;
  }
  auto* r = static_cast<RingHandle*>(h);
  const uint64_t cap = r->hdr->capacity;
  const uint64_t tail = r->hdr->tail.load(std::memory_order_acquire);
  const uint64_t head = r->hdr->head.load(std::memory_order_relaxed);
  if (r->peek_head < head) r->peek_head = head;  // resync after copy reads
  uint64_t pos = r->peek_head;
  while (pos != tail) {
    uint64_t len_le = 0;
    copy_out(r, pos, reinterpret_cast<uint8_t*>(&len_le), 8);
    if (len_le & kPadFlag) {
      pos += 8 + (len_le & ~kPadFlag);
      continue;
    }
    if (len_le > cap) {
      set_error("ring message length exceeds capacity (corrupt header)");
      return -1;
    }
    const uint64_t idx = (pos + 8) % cap;
    out[1] = len_le;
    out[2] = (pos + 8 + len_le) - r->peek_head;
    if (idx + len_le > cap) {
      out[0] = 0;  // physically wrapped: no contiguous view exists
      return 2;
    }
    out[0] = reinterpret_cast<unsigned long long>(r->data + idx);
    r->peek_head = pos + 8 + len_le;
    return 1;
  }
  return 0;
}

// Copy-out companion of pstpu_ring_peek for wrapped messages: copies the
// next message past the peek cursor into dst and advances the cursor;
// *span_out = the span pstpu_ring_release must retire. Returns the payload
// length, -1 when empty, -2 when dst_cap is too small (cursor unmoved).
long long pstpu_ring_peek_copy(void* h, void* dst, unsigned long long dst_cap,
                               unsigned long long* span_out) {
  auto* r = static_cast<RingHandle*>(h);
  const uint64_t tail = r->hdr->tail.load(std::memory_order_acquire);
  const uint64_t head = r->hdr->head.load(std::memory_order_relaxed);
  if (r->peek_head < head) r->peek_head = head;
  uint64_t pos = r->peek_head;
  while (pos != tail) {
    uint64_t len_le = 0;
    copy_out(r, pos, reinterpret_cast<uint8_t*>(&len_le), 8);
    if (len_le & kPadFlag) {
      pos += 8 + (len_le & ~kPadFlag);
      continue;
    }
    if (len_le > dst_cap) return -2;
    copy_out(r, pos + 8, static_cast<uint8_t*>(dst), len_le);
    if (span_out) *span_out = (pos + 8 + len_le) - r->peek_head;
    r->peek_head = pos + 8 + len_le;
    return static_cast<long long>(len_le);
  }
  return -1;
}

// Non-consuming probe that respects the peek cursor: 1 when a payload
// message exists PAST max(peek_head, head), else 0. pstpu_ring_next_len
// probes from the shared head, so under zero-copy peeks it keeps reporting
// already-delivered (but not yet released) messages — drain/close logic
// needs "unread", not "unreleased".
int pstpu_ring_has_unread(void* h) {
  auto* r = static_cast<RingHandle*>(h);
  const uint64_t tail = r->hdr->tail.load(std::memory_order_acquire);
  const uint64_t head = r->hdr->head.load(std::memory_order_relaxed);
  uint64_t pos = r->peek_head < head ? head : r->peek_head;
  while (pos != tail) {
    uint64_t len_le = 0;
    copy_out(r, pos, reinterpret_cast<uint8_t*>(&len_le), 8);
    if (!(len_le & kPadFlag)) return 1;
    pos += 8 + (len_le & ~kPadFlag);
  }
  return 0;
}

// Retire span_bytes of peeked-and-released messages: the producer may reuse
// those bytes from here on. Spans MUST be released in take order (the Python
// RingBorrowLedger serializes out-of-order finalizers into FIFO releases).
// Returns 0, or -1 when the release would pass the peek cursor (caller bug:
// the bytes are still lent out).
int pstpu_ring_release(void* h, unsigned long long span_bytes) {
  auto* r = static_cast<RingHandle*>(h);
  const uint64_t head = r->hdr->head.load(std::memory_order_relaxed);
  const uint64_t limit = r->peek_head < head ? head : r->peek_head;
  if (head + span_bytes > limit) {
    set_error("ring release span passes the peek cursor");
    return -1;
  }
  r->hdr->head.store(head + span_bytes, std::memory_order_release);
  return 0;
}

// Debug guard (PSTPU_LIFETIME_GUARD=1): remap the fully page-covered bytes
// of [addr, addr+len) to PROT_NONE (prot_none=1) or back to read/write (0),
// so a use-after-release faults loudly instead of reading recycled bytes.
// Returns the number of bytes whose protection changed (0 when the range
// spans no full page), -1 on mprotect failure.
long long pstpu_guard_protect(void* addr, unsigned long long len,
                              int prot_none) {
  const uint64_t page = static_cast<uint64_t>(sysconf(_SC_PAGESIZE));
  const uint64_t a = reinterpret_cast<uint64_t>(addr);
  const uint64_t start = (a + page - 1) & ~(page - 1);
  const uint64_t end = (a + len) & ~(page - 1);
  if (end <= start) return 0;
  const int prot = prot_none ? PROT_NONE : (PROT_READ | PROT_WRITE);
  if (mprotect(reinterpret_cast<void*>(start), end - start, prot) != 0) {
    set_error(std::string("mprotect failed: ") + std::strerror(errno));
    return -1;
  }
  return static_cast<long long>(end - start);
}

// Unmap; the creator also unlinks the shm name.
void pstpu_ring_close(void* h) {
  auto* r = static_cast<RingHandle*>(h);
  munmap(r->hdr, r->map_len);
  if (r->owner) shm_unlink(r->name.c_str());
  delete r;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Broadcast ring: single producer, K attached consumers (the serve daemon's
// fan-out transport, docs/serve.md). A published message is logically
// reference-counted across the attached consumers WITHOUT a per-slot count:
// each consumer owns a head cursor, advancing it IS that consumer's release,
// and the slot is reclaimed when the slowest attached cursor passes it —
// min-head reclamation makes "released exactly once per attached consumer"
// structural rather than accounted. Consumer slots are granted by the
// PRODUCER (pstpu_bcast_join runs daemon-side between writes), so a joiner's
// head=tail snapshot can never race a concurrent write — the control-plane
// ATTACH round trip is the synchronization. Eviction (producer-side) flips a
// slot to EVICTED: its cursor stops constraining the producer, and the
// consumer's next read reports it (seqlock-style post-copy validation keeps a
// torn read from ever being delivered as data).
// ---------------------------------------------------------------------------

namespace {

constexpr uint64_t kBcastMagic = 0x70737470755F6263ULL;  // "pstpu_bc"
constexpr uint64_t kBcastSlots = 8;
// slot states
constexpr uint64_t kSlotFree = 0;
constexpr uint64_t kSlotAttached = 1;
constexpr uint64_t kSlotEvicted = 2;

struct BcastHeader {
  std::atomic<uint64_t> tail;       // producer position
  uint64_t capacity;
  uint64_t magic;
  uint64_t max_consumers;           // == kBcastSlots of the creating build
  std::atomic<uint64_t> epoch;      // bumps on every attach/evict (observability)
  char pad0[24];                    // keep the slot arrays cache-aligned
  std::atomic<uint64_t> heads[8];   // per-slot consumer position
  std::atomic<uint64_t> states[8];  // kSlotFree / kSlotAttached / kSlotEvicted
  std::atomic<uint64_t> gens[8];    // bumps per join: stale tokens are detectable
};

struct BcastHandle {
  BcastHeader* hdr;
  uint8_t* data;
  size_t map_len;
  std::string name;
  bool owner;
  // producer-side pending in-place reservation (single producer: plain fields)
  uint64_t pending_tail = 0;
  uint64_t pending_pad = 0;
  uint64_t pending_max = 0;
  bool pending = false;
};

void bcast_copy_in(BcastHandle* r, uint64_t pos, const uint8_t* src, uint64_t len) {
  const uint64_t cap = r->hdr->capacity;
  const uint64_t idx = pos % cap;
  const uint64_t first = (idx + len <= cap) ? len : cap - idx;
  std::memcpy(r->data + idx, src, first);
  if (first < len) std::memcpy(r->data, src + first, len - first);
}

void bcast_copy_out(BcastHandle* r, uint64_t pos, uint8_t* dst, uint64_t len) {
  const uint64_t cap = r->hdr->capacity;
  const uint64_t idx = pos % cap;
  const uint64_t first = (idx + len <= cap) ? len : cap - idx;
  std::memcpy(dst, r->data + idx, first);
  if (first < len) std::memcpy(dst + first, r->data, len - first);
}

// Slowest attached cursor; `tail` when no consumer is attached (messages
// published into the void are reclaimed immediately — the Python pump gates
// on consumer_count, so this only covers detach races).
uint64_t bcast_min_head(BcastHeader* h, uint64_t tail) {
  uint64_t m = tail;
  for (uint64_t i = 0; i < kBcastSlots; i++) {
    if (h->states[i].load(std::memory_order_acquire) == kSlotAttached) {
      const uint64_t head = h->heads[i].load(std::memory_order_acquire);
      if (tail - head > tail - m) m = head;  // head furthest behind tail
    }
  }
  return m;
}

// Decompose/validate a consumer token ((gen << 8) | slot). Returns slot index
// or -1 when the token is stale (slot re-granted) or malformed.
int64_t bcast_slot_of(BcastHeader* h, int64_t token) {
  if (token < 0) return -1;
  const uint64_t slot = static_cast<uint64_t>(token) & 0xffULL;
  const uint64_t gen = static_cast<uint64_t>(token) >> 8;
  if (slot >= kBcastSlots) return -1;
  if (h->gens[slot].load(std::memory_order_acquire) != gen) return -1;
  return static_cast<int64_t>(slot);
}

}  // namespace

extern "C" {

// Create (producer side). Returns NULL on failure.
void* pstpu_bcast_create(const char* name, uint64_t capacity) {
  if (capacity < 4096) {
    set_error("bcast ring capacity must be >= 4096 bytes");
    return nullptr;
  }
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) {
    set_error(std::string("shm_open(create) failed: ") + std::strerror(errno));
    return nullptr;
  }
  const size_t map_len = sizeof(BcastHeader) + capacity;
  if (ftruncate(fd, static_cast<off_t>(map_len)) != 0) {
    set_error(std::string("ftruncate failed: ") + std::strerror(errno));
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  // same pre-faulting stance as pstpu_ring_create: tmpfs exhaustion must be a
  // catchable error here, not a SIGBUS at first touch
  int falloc_rc = posix_fallocate(fd, 0, static_cast<off_t>(map_len));
  if (falloc_rc != 0 && falloc_rc != EOPNOTSUPP && falloc_rc != EINVAL) {
    set_error(std::string("posix_fallocate failed (is /dev/shm large enough?): ") +
              std::strerror(falloc_rc));
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* mem = mmap(nullptr, map_len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) {
    set_error(std::string("mmap failed: ") + std::strerror(errno));
    shm_unlink(name);
    return nullptr;
  }
  auto* hdr = new (mem) BcastHeader();
  hdr->tail.store(0, std::memory_order_relaxed);
  hdr->capacity = capacity;
  hdr->magic = kBcastMagic;
  hdr->max_consumers = kBcastSlots;
  hdr->epoch.store(0, std::memory_order_relaxed);
  for (uint64_t i = 0; i < kBcastSlots; i++) {
    hdr->heads[i].store(0, std::memory_order_relaxed);
    hdr->states[i].store(kSlotFree, std::memory_order_relaxed);
    hdr->gens[i].store(0, std::memory_order_relaxed);
  }
  auto* handle = new BcastHandle{hdr,
                                 reinterpret_cast<uint8_t*>(mem) + sizeof(BcastHeader),
                                 map_len, name, /*owner=*/true};
  return handle;
}

// Attach a consumer-side mapping. Reads require a token from pstpu_bcast_join
// (granted by the producer over the control plane). Returns NULL on failure.
void* pstpu_bcast_attach(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) {
    set_error(std::string("shm_open(attach) failed: ") + std::strerror(errno));
    return nullptr;
  }
  struct stat st;
  if (fstat(fd, &st) != 0 || static_cast<size_t>(st.st_size) < sizeof(BcastHeader)) {
    set_error("bcast shm segment too small");
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ | PROT_WRITE,
                   MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) {
    set_error(std::string("mmap failed: ") + std::strerror(errno));
    return nullptr;
  }
  auto* hdr = reinterpret_cast<BcastHeader*>(mem);
  if (hdr->magic != kBcastMagic || hdr->max_consumers != kBcastSlots ||
      sizeof(BcastHeader) + hdr->capacity != static_cast<uint64_t>(st.st_size)) {
    set_error("bcast header corrupt (magic/capacity/slot-count mismatch)");
    munmap(mem, static_cast<size_t>(st.st_size));
    return nullptr;
  }
  auto* handle = new BcastHandle{hdr,
                                 reinterpret_cast<uint8_t*>(mem) + sizeof(BcastHeader),
                                 static_cast<size_t>(st.st_size), name, /*owner=*/false};
  return handle;
}

uint64_t pstpu_bcast_capacity(void* h) {
  return static_cast<BcastHandle*>(h)->hdr->capacity;
}

// PRODUCER-side slot grant (between writes, so head=tail cannot race a write
// in flight). Returns a consumer token ((gen << 8) | slot), or -1 when every
// slot is taken by an attached consumer.
int64_t pstpu_bcast_join(void* h) {
  auto* r = static_cast<BcastHandle*>(h);
  BcastHeader* hdr = r->hdr;
  for (uint64_t i = 0; i < kBcastSlots; i++) {
    const uint64_t state = hdr->states[i].load(std::memory_order_acquire);
    if (state == kSlotAttached) continue;
    const uint64_t gen = hdr->gens[i].load(std::memory_order_relaxed) + 1;
    hdr->gens[i].store(gen, std::memory_order_release);
    hdr->heads[i].store(hdr->tail.load(std::memory_order_relaxed),
                        std::memory_order_release);
    hdr->states[i].store(kSlotAttached, std::memory_order_seq_cst);
    hdr->epoch.fetch_add(1, std::memory_order_relaxed);
    return static_cast<int64_t>((gen << 8) | i);
  }
  set_error("bcast ring has no free consumer slots");
  return -1;
}

// Graceful detach: the slot stops constraining the producer and is free for
// re-grant. Safe from either side (state writes are monotonic-harmless for
// the producer's min-head scan). Returns 0, or -1 for a stale token.
int64_t pstpu_bcast_leave(void* h, int64_t token) {
  auto* r = static_cast<BcastHandle*>(h);
  const int64_t slot = bcast_slot_of(r->hdr, token);
  if (slot < 0) return -1;
  r->hdr->states[slot].store(kSlotFree, std::memory_order_seq_cst);
  r->hdr->epoch.fetch_add(1, std::memory_order_relaxed);
  return 0;
}

// PRODUCER-side eviction of a lagging consumer: the slot flips to EVICTED
// (its cursor no longer bounds the producer; the consumer's next read reports
// -3). The slot stays EVICTED until the consumer acknowledges by leaving —
// re-grant before that would hand its unread region to a new consumer.
int64_t pstpu_bcast_evict(void* h, int64_t token) {
  auto* r = static_cast<BcastHandle*>(h);
  const int64_t slot = bcast_slot_of(r->hdr, token);
  if (slot < 0) return -1;
  r->hdr->states[slot].store(kSlotEvicted, std::memory_order_seq_cst);
  r->hdr->epoch.fetch_add(1, std::memory_order_relaxed);
  return 0;
}

// Slot state for a token: 1 attached, 2 evicted, 0 freed, -1 stale token.
int64_t pstpu_bcast_state(void* h, int64_t token) {
  auto* r = static_cast<BcastHandle*>(h);
  const int64_t slot = bcast_slot_of(r->hdr, token);
  if (slot < 0) return -1;
  return static_cast<int64_t>(r->hdr->states[slot].load(std::memory_order_acquire));
}

// Unconsumed bytes behind the producer for one consumer (its lag), or -1 for
// a stale token. The producer's eviction policy reads this.
int64_t pstpu_bcast_lag(void* h, int64_t token) {
  auto* r = static_cast<BcastHandle*>(h);
  const int64_t slot = bcast_slot_of(r->hdr, token);
  if (slot < 0) return -1;
  const uint64_t tail = r->hdr->tail.load(std::memory_order_acquire);
  const uint64_t head = r->hdr->heads[slot].load(std::memory_order_acquire);
  return static_cast<int64_t>(tail - head);
}

int64_t pstpu_bcast_consumer_count(void* h) {
  auto* r = static_cast<BcastHandle*>(h);
  int64_t n = 0;
  for (uint64_t i = 0; i < kBcastSlots; i++) {
    if (r->hdr->states[i].load(std::memory_order_acquire) == kSlotAttached) n++;
  }
  return n;
}

uint64_t pstpu_bcast_free_space(void* h) {
  auto* r = static_cast<BcastHandle*>(h);
  const uint64_t tail = r->hdr->tail.load(std::memory_order_relaxed);
  return r->hdr->capacity - (tail - bcast_min_head(r->hdr, tail));
}

// Monotonic producer position (bytes ever published incl. framing/pads).
// The serve daemon's blob GC compares recorded frame-end positions against
// min_head (= tail - max attached lag) to learn when every attached consumer
// has consumed past a frame.
uint64_t pstpu_bcast_tail(void* h) {
  return static_cast<BcastHandle*>(h)->hdr->tail.load(std::memory_order_acquire);
}

// Slowest attached cursor (== tail when no consumer is attached): everything
// below this position has been consumed-or-abandoned by the whole fleet.
uint64_t pstpu_bcast_min_head(void* h) {
  auto* r = static_cast<BcastHandle*>(h);
  const uint64_t tail = r->hdr->tail.load(std::memory_order_acquire);
  return bcast_min_head(r->hdr, tail);
}

// Non-blocking broadcast write. 1 = written (visible to every attached
// consumer), 0 = a consumer is too far behind (retry / evict), -1 = the
// message can never fit this ring.
int pstpu_bcast_write(void* h, const void* data, uint64_t len) {
  auto* r = static_cast<BcastHandle*>(h);
  const uint64_t need = len + 8;
  if (need > r->hdr->capacity) {
    set_error("message larger than bcast ring capacity");
    return -1;
  }
  const uint64_t tail = r->hdr->tail.load(std::memory_order_relaxed);
  if (r->hdr->capacity - (tail - bcast_min_head(r->hdr, tail)) < need) return 0;
  uint64_t len_le = len;
  bcast_copy_in(r, tail, reinterpret_cast<const uint8_t*>(&len_le), 8);
  bcast_copy_in(r, tail + 8, static_cast<const uint8_t*>(data), len);
  r->hdr->tail.store(tail + need, std::memory_order_release);
  return 1;
}

// Gather write of N segments as ONE broadcast message (the serve pump's
// zero-join publish channel). Same return convention as pstpu_bcast_write.
int pstpu_bcast_writev(void* h, const void* const* bufs, const uint64_t* lens, int32_t n) {
  auto* r = static_cast<BcastHandle*>(h);
  uint64_t len = 0;
  for (int32_t i = 0; i < n; i++) len += lens[i];
  const uint64_t need = len + 8;
  if (need > r->hdr->capacity) {
    set_error("message larger than bcast ring capacity");
    return -1;
  }
  const uint64_t tail = r->hdr->tail.load(std::memory_order_relaxed);
  if (r->hdr->capacity - (tail - bcast_min_head(r->hdr, tail)) < need) return 0;
  uint64_t len_le = len;
  bcast_copy_in(r, tail, reinterpret_cast<const uint8_t*>(&len_le), 8);
  uint64_t off = tail + 8;
  for (int32_t i = 0; i < n; i++) {
    if (lens[i] == 0) continue;
    bcast_copy_in(r, off, static_cast<const uint8_t*>(bufs[i]), lens[i]);
    off += lens[i];
  }
  r->hdr->tail.store(tail + need, std::memory_order_release);
  return 1;
}

// In-place reservation on the broadcast ring — identical contract and pad
// scheme to pstpu_ring_reserve (PR 6's in-place channel, preserved for the
// fan-out transport): *status 1 = reserved, 0 = retry, -1 = can never fit /
// reservation already pending.
void* pstpu_bcast_reserve(void* h, uint64_t max_len, int32_t* status) {
  auto* r = static_cast<BcastHandle*>(h);
  const uint64_t cap = r->hdr->capacity;
  if (r->pending || max_len + 16 > cap) {  // worst case: pad marker + header
    set_error(r->pending ? "a reservation is already pending"
                         : "message larger than bcast ring capacity");
    if (status) *status = -1;
    return nullptr;
  }
  const uint64_t tail = r->hdr->tail.load(std::memory_order_relaxed);
  const uint64_t idx = tail % cap;
  const uint64_t data_start = (idx + 8) % cap;
  uint64_t pad = 0;
  if (data_start + max_len > cap) {
    pad = 8 + (cap - data_start);
  }
  if (pad + 8 + max_len > cap) {
    // same never-fits-at-this-offset livelock guard as the SPSC ring
    set_error("message larger than bcast ring capacity");
    if (status) *status = -1;
    return nullptr;
  }
  if (cap - (tail - bcast_min_head(r->hdr, tail)) < pad + 8 + max_len) {
    if (status) *status = 0;
    return nullptr;
  }
  if (pad != 0) {
    uint64_t marker = kPadFlag | (pad - 8);
    bcast_copy_in(r, tail, reinterpret_cast<const uint8_t*>(&marker), 8);
  }
  r->pending = true;
  r->pending_tail = tail;
  r->pending_pad = pad;
  r->pending_max = max_len;
  if (status) *status = 1;
  return r->data + ((tail + pad + 8) % cap);
}

int pstpu_bcast_commit(void* h, uint64_t actual_len) {
  auto* r = static_cast<BcastHandle*>(h);
  if (!r->pending || actual_len > r->pending_max) {
    set_error(r->pending ? "commit exceeds reservation" : "no pending reservation");
    return -1;
  }
  uint64_t len_le = actual_len;
  bcast_copy_in(r, r->pending_tail + r->pending_pad,
                reinterpret_cast<const uint8_t*>(&len_le), 8);
  r->pending = false;
  r->hdr->tail.store(r->pending_tail + r->pending_pad + 8 + actual_len,
                     std::memory_order_release);
  return 0;
}

void pstpu_bcast_abort(void* h) {
  static_cast<BcastHandle*>(h)->pending = false;
}

// Length of the next unread message for this consumer, skipping pad markers.
// -1 = empty, -3 = evicted, -4 = stale/freed token.
int64_t pstpu_bcast_next_len(void* h, int64_t token) {
  auto* r = static_cast<BcastHandle*>(h);
  BcastHeader* hdr = r->hdr;
  const int64_t slot = bcast_slot_of(hdr, token);
  if (slot < 0) return -4;
  const uint64_t state = hdr->states[slot].load(std::memory_order_seq_cst);
  if (state == kSlotEvicted) return -3;
  if (state != kSlotAttached) return -4;
  const uint64_t tail = hdr->tail.load(std::memory_order_acquire);
  uint64_t head = hdr->heads[slot].load(std::memory_order_relaxed);
  while (head != tail) {
    uint64_t len_le = 0;
    bcast_copy_out(r, head, reinterpret_cast<uint8_t*>(&len_le), 8);
    if (!(len_le & kPadFlag)) {
      // seqlock validation: only trust the prefix if the slot stayed attached
      // (an eviction lets the producer overwrite the bytes we just read)
      std::atomic_thread_fence(std::memory_order_seq_cst);
      if (hdr->states[slot].load(std::memory_order_seq_cst) != kSlotAttached)
        return -3;
      return static_cast<int64_t>(len_le);
    }
    head += 8 + (len_le & ~kPadFlag);
    hdr->heads[slot].store(head, std::memory_order_release);
  }
  return -1;
}

// Read one message for this consumer into buf. Returns its length; -1 empty,
// -2 buf too small (message left in place), -3 evicted (any partially-copied
// bytes must be discarded), -4 stale/freed token. Advancing the head IS this
// consumer's release of the slot (min-head reclamation).
int64_t pstpu_bcast_read(void* h, int64_t token, void* buf, uint64_t buf_cap) {
  auto* r = static_cast<BcastHandle*>(h);
  BcastHeader* hdr = r->hdr;
  const int64_t n = pstpu_bcast_next_len(h, token);
  if (n < 0) return n;
  if (static_cast<uint64_t>(n) > buf_cap) return -2;
  const int64_t slot = bcast_slot_of(hdr, token);
  if (slot < 0) return -4;
  const uint64_t head = hdr->heads[slot].load(std::memory_order_relaxed);
  bcast_copy_out(r, head + 8, static_cast<uint8_t*>(buf), static_cast<uint64_t>(n));
  // seqlock validation (same fence pairing as next_len): if the producer
  // evicted us mid-copy it may already be overwriting these bytes — report
  // eviction and let the caller discard the torn buffer
  std::atomic_thread_fence(std::memory_order_seq_cst);
  if (hdr->states[slot].load(std::memory_order_seq_cst) != kSlotAttached)
    return -3;
  hdr->heads[slot].store(head + 8 + static_cast<uint64_t>(n),
                         std::memory_order_release);
  return n;
}

// Unmap; the creator also unlinks the shm name.
void pstpu_bcast_close(void* h) {
  auto* r = static_cast<BcastHandle*>(h);
  munmap(r->hdr, r->map_len);
  if (r->owner) shm_unlink(r->name.c_str());
  delete r;
}

}  // extern "C"
