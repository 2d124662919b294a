// Shared-memory object store: the plasma equivalent; the port's copy of
// ray_tpu/native/object_store.cc, built by ray_tpu_torch/core/store_build.py.
//
// Role parity with the reference's plasma store
// (ref: src/ray/object_manager/plasma/store.h:55, object_lifecycle_manager.h,
// eviction_policy.h, plasma_allocator.h) with a different, simpler design
// suited to a per-host daemonless data plane:
//
//   * One directory on tmpfs (/dev/shm) per node; one file per object.
//     Writers create `<id>.building`, fill it, then atomically rename to
//     `<id>` on seal — readers can only ever observe sealed objects.
//   * A control region (`.index` file) mmap'd into every client holds an
//     open-addressing hash table of slots with process-shared atomics:
//     state, refcount, size, LRU clock. A robust process-shared mutex
//     guards structural changes; a crashed holder is recovered via
//     EOWNERDEAD.
//   * Zero-copy reads: clients mmap the object file read-only; numpy/arrow
//     buffers alias the mapping directly.
//   * LRU eviction of sealed, refcount-0 objects when capacity is exceeded
//     (ref behavior: plasma LRU eviction + fallback allocation); spill to a
//     disk directory is handled a level up by the node daemon.
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <ctime>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x52545055'53544F52ULL;  // "RTPUSTOR"
constexpr uint32_t kIdSize = 20;

enum SlotState : uint32_t {
  kEmpty = 0,
  kCreating = 1,
  kSealed = 2,
  kTombstone = 3,
};

struct Slot {
  uint8_t id[kIdSize];
  std::atomic<uint32_t> state;
  std::atomic<uint32_t> refcount;
  std::atomic<uint64_t> size;
  std::atomic<uint64_t> lru_tick;
  std::atomic<uint64_t> create_ts;  // unix seconds; stale-kCreating reclaim
};

// A writer that died between create and seal/abort leaves kCreating forever;
// reclaim such slots after this many seconds.
constexpr uint64_t kStaleCreatingSecs = 300;

// Warm-file recycle pool: deleting/evicting a LARGE object parks its tmpfs
// file here (pages stay resident and faulted-in) instead of unlinking it;
// the next large create claims a matching file via rename and writes onto
// already-warm pages.  Fresh tmpfs page allocation is the dominant cost of
// a large create (~1.3 GB/s fault-bound vs ~6 GB/s rewriting warm pages on
// this class of host), so steady-state put/transfer traffic that cycles
// similar sizes runs at warm-page speed.  The pool is bounded (entry count
// and a byte cap derived from capacity) and its bytes count toward the
// store's tmpfs footprint, so eviction drains it before touching live
// objects.
constexpr uint32_t kRecycleSlots = 64;
constexpr uint64_t kRecycleMinBytes = 1ULL << 20;  // only pool files >= 1 MiB

struct RecycleEntry {
  std::atomic<uint64_t> size;  // 0 = empty
  std::atomic<uint32_t> seq;   // names the file: .recycle.<idx>.<seq>
  uint32_t pad;
};

struct IndexHeader {
  uint64_t magic;
  uint64_t capacity;
  uint64_t num_slots;
  std::atomic<uint64_t> used;
  std::atomic<uint64_t> clock;
  std::atomic<uint64_t> num_objects;
  std::atomic<uint64_t> recycle_bytes;
  std::atomic<uint32_t> recycle_seq;
  uint32_t pad0;
  RecycleEntry recycle[kRecycleSlots];
  pthread_mutex_t mutex;  // robust, process-shared
};

struct Store {
  char dir[4096];
  IndexHeader* hdr;
  Slot* slots;
  size_t index_bytes;
};

uint64_t HashId(const uint8_t* id) {
  // FNV-1a over the 20-byte id.
  uint64_t h = 1469598103934665603ULL;
  for (uint32_t i = 0; i < kIdSize; i++) {
    h ^= id[i];
    h *= 1099511628211ULL;
  }
  return h;
}

void IdToHex(const uint8_t* id, char* out) {
  static const char* hex = "0123456789abcdef";
  for (uint32_t i = 0; i < kIdSize; i++) {
    out[2 * i] = hex[id[i] >> 4];
    out[2 * i + 1] = hex[id[i] & 0xf];
  }
  out[2 * kIdSize] = '\0';
}

void ObjectPath(const Store* s, const uint8_t* id, bool building, char* out,
                size_t outlen) {
  char hexid[2 * kIdSize + 1];
  IdToHex(id, hexid);
  snprintf(out, outlen, "%s/%s%s", s->dir, hexid, building ? ".building" : "");
}

void RecyclePath(const Store* s, uint32_t idx, uint32_t seq, char* out,
                 size_t outlen) {
  snprintf(out, outlen, "%s/.recycle.%u.%u", s->dir, idx, seq);
}

uint64_t RecycleCap(const Store* s) { return s->hdr->capacity / 8; }

// Unlink pooled files until `need` bytes are freed (UINT64_MAX = drain all).
// Caller holds the index lock.  Returns bytes freed.
uint64_t DrainRecycleLocked(Store* s, uint64_t need) {
  uint64_t freed = 0;
  for (uint32_t i = 0; i < kRecycleSlots && freed < need; i++) {
    RecycleEntry* e = &s->hdr->recycle[i];
    uint64_t sz = e->size.load(std::memory_order_acquire);
    if (sz == 0) continue;
    char path[4300];
    RecyclePath(s, i, e->seq.load(), path, sizeof(path));
    e->size.store(0, std::memory_order_release);
    s->hdr->recycle_bytes.fetch_sub(sz);
    unlink(path);
    freed += sz;
  }
  return freed;
}

// Try to park a sealed object's file in the recycle pool instead of
// unlinking it.  Caller holds the index lock.  Returns true when the file
// was renamed into the pool (caller must NOT unlink it).
bool TryRecycleLocked(Store* s, const uint8_t* id, uint64_t size) {
  if (size < kRecycleMinBytes) return false;
  if (s->hdr->recycle_bytes.load() + size > RecycleCap(s)) return false;
  for (uint32_t i = 0; i < kRecycleSlots; i++) {
    RecycleEntry* e = &s->hdr->recycle[i];
    if (e->size.load(std::memory_order_acquire) != 0) continue;
    uint32_t seq = s->hdr->recycle_seq.fetch_add(1);
    char src[4300], dst[4300];
    ObjectPath(s, id, /*building=*/false, src, sizeof(src));
    RecyclePath(s, i, seq, dst, sizeof(dst));
    if (rename(src, dst) != 0) return false;
    e->seq.store(seq);
    e->size.store(size, std::memory_order_release);
    s->hdr->recycle_bytes.fetch_add(size);
    return true;
  }
  return false;
}

int LockIndex(Store* s) {
  int rc = pthread_mutex_lock(&s->hdr->mutex);
  if (rc == EOWNERDEAD) {
    // Previous holder died mid-update; the table is slot-atomic so marking
    // consistent is safe.
    pthread_mutex_consistent(&s->hdr->mutex);
    rc = 0;
  }
  return rc;
}

void UnlockIndex(Store* s) { pthread_mutex_unlock(&s->hdr->mutex); }

// Find the slot for `id`, or (if absent and want_insert) an empty slot.
// Caller holds the index lock for inserts.
Slot* FindSlot(Store* s, const uint8_t* id, bool want_insert) {
  uint64_t n = s->hdr->num_slots;
  uint64_t idx = HashId(id) % n;
  Slot* first_free = nullptr;
  for (uint64_t probe = 0; probe < n; probe++) {
    Slot* slot = &s->slots[(idx + probe) % n];
    uint32_t st = slot->state.load(std::memory_order_acquire);
    if (st == kEmpty) {
      if (want_insert) return first_free ? first_free : slot;
      return nullptr;
    }
    if (st == kTombstone) {
      if (first_free == nullptr) first_free = slot;
      continue;
    }
    if (memcmp(slot->id, id, kIdSize) == 0) return slot;
  }
  return first_free;  // table full (or nullptr)
}

}  // namespace

extern "C" {

int rts_release(void* handle, const uint8_t* id);

// Error codes
enum {
  RTS_OK = 0,
  RTS_ERR_IO = -1,
  RTS_ERR_EXISTS = -2,
  RTS_ERR_NOT_FOUND = -3,
  RTS_ERR_FULL = -4,
  RTS_ERR_STATE = -5,
};

// Connect to (creating if needed) the store rooted at `dir`.
void* rts_connect(const char* dir, uint64_t capacity, uint64_t num_slots) {
  if (num_slots == 0) num_slots = 65536;
  Store* s = new Store();
  snprintf(s->dir, sizeof(s->dir), "%s", dir);
  mkdir(dir, 0777);

  char index_path[4200];
  snprintf(index_path, sizeof(index_path), "%s/.index", dir);
  s->index_bytes = sizeof(IndexHeader) + num_slots * sizeof(Slot);

  int fd = open(index_path, O_RDWR | O_CREAT | O_EXCL, 0666);
  bool creator = fd >= 0;
  if (!creator) {
    if (errno != EEXIST) {
      delete s;
      return nullptr;
    }
    fd = open(index_path, O_RDWR);
    if (fd < 0) {
      delete s;
      return nullptr;
    }
    // Joiners must use the creator's num_slots (a mismatched caller value
    // would map the wrong size and read past the mapping). Wait for init
    // (magic set last), then read the header.
    struct stat st;
    for (int i = 0; i < 10000; i++) {
      if (fstat(fd, &st) == 0 &&
          (size_t)st.st_size >= sizeof(IndexHeader))
        break;
      usleep(1000);
    }
    void* hdr_mem = mmap(nullptr, sizeof(IndexHeader),
                         PROT_READ, MAP_SHARED, fd, 0);
    if (hdr_mem == MAP_FAILED) {
      close(fd);
      delete s;
      return nullptr;
    }
    IndexHeader* hdr = reinterpret_cast<IndexHeader*>(hdr_mem);
    bool ready = false;
    for (int i = 0; i < 10000; i++) {
      if (hdr->magic == kMagic) {
        ready = true;
        break;
      }
      usleep(1000);
    }
    num_slots = ready ? hdr->num_slots : 0;
    munmap(hdr_mem, sizeof(IndexHeader));
    if (!ready) {
      close(fd);
      delete s;
      return nullptr;
    }
    s->index_bytes = sizeof(IndexHeader) + num_slots * sizeof(Slot);
  } else {
    if (ftruncate(fd, s->index_bytes) != 0) {
      close(fd);
      unlink(index_path);
      delete s;
      return nullptr;
    }
  }

  void* mem = mmap(nullptr, s->index_bytes, PROT_READ | PROT_WRITE, MAP_SHARED,
                   fd, 0);
  close(fd);
  if (mem == MAP_FAILED) {
    delete s;
    return nullptr;
  }
  s->hdr = reinterpret_cast<IndexHeader*>(mem);
  s->slots = reinterpret_cast<Slot*>(reinterpret_cast<char*>(mem) +
                                     sizeof(IndexHeader));

  if (creator) {
    s->hdr->capacity = capacity;
    s->hdr->num_slots = num_slots;
    s->hdr->used.store(0);
    s->hdr->clock.store(1);
    s->hdr->num_objects.store(0);
    pthread_mutexattr_t attr;
    pthread_mutexattr_init(&attr);
    pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
    pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
    pthread_mutex_init(&s->hdr->mutex, &attr);
    pthread_mutexattr_destroy(&attr);
    std::atomic_thread_fence(std::memory_order_release);
    s->hdr->magic = kMagic;
  } else {
    for (int i = 0; i < 10000 && s->hdr->magic != kMagic; i++) usleep(1000);
    if (s->hdr->magic != kMagic) {
      munmap(mem, s->index_bytes);
      delete s;
      return nullptr;
    }
  }
  return s;
}

void rts_disconnect(void* handle) {
  Store* s = static_cast<Store*>(handle);
  if (s == nullptr) return;
  munmap(s->hdr, s->index_bytes);
  delete s;
}

uint64_t rts_capacity(void* handle) {
  return static_cast<Store*>(handle)->hdr->capacity;
}

uint64_t rts_used(void* handle) {
  return static_cast<Store*>(handle)->hdr->used.load();
}

uint64_t rts_num_objects(void* handle) {
  return static_cast<Store*>(handle)->hdr->num_objects.load();
}

// Evict up to `bytes_needed` of sealed, unreferenced objects (LRU order).
// Returns bytes actually freed. Caller must NOT hold the lock.
uint64_t rts_evict(void* handle, uint64_t bytes_needed) {
  Store* s = static_cast<Store*>(handle);
  uint64_t freed = 0;
  if (LockIndex(s) != 0) return 0;
  // Pooled warm files are the cheapest bytes to give back: no live object
  // dies when they go.
  freed += DrainRecycleLocked(s, bytes_needed);
  // Reclaim slots orphaned in kCreating by a crashed writer.
  uint64_t now = (uint64_t)time(nullptr);
  for (uint64_t i = 0; i < s->hdr->num_slots; i++) {
    Slot* slot = &s->slots[i];
    if (slot->state.load() == kCreating &&
        now > slot->create_ts.load() + kStaleCreatingSecs) {
      char path[4300];
      ObjectPath(s, slot->id, /*building=*/true, path, sizeof(path));
      unlink(path);
      s->hdr->used.fetch_sub(slot->size.load());
      s->hdr->num_objects.fetch_sub(1);
      slot->state.store(kTombstone);
      freed += slot->size.load();
    }
  }
  while (freed < bytes_needed) {
    Slot* victim = nullptr;
    uint64_t best_tick = UINT64_MAX;
    for (uint64_t i = 0; i < s->hdr->num_slots; i++) {
      Slot* slot = &s->slots[i];
      if (slot->state.load() == kSealed && slot->refcount.load() == 0) {
        uint64_t tick = slot->lru_tick.load();
        if (tick < best_tick) {
          best_tick = tick;
          victim = slot;
        }
      }
    }
    if (victim == nullptr) break;
    char path[4300];
    ObjectPath(s, victim->id, false, path, sizeof(path));
    unlink(path);
    uint64_t sz = victim->size.load();
    victim->state.store(kTombstone, std::memory_order_release);
    s->hdr->used.fetch_sub(sz);
    s->hdr->num_objects.fetch_sub(1);
    freed += sz;
  }
  UnlockIndex(s);
  return freed;
}

// Create a new object of `size` bytes. On success returns RTS_OK and sets
// *fd_out to a writable fd (caller mmaps and must close). Evicts LRU
// objects if needed.
int rts_create(void* handle, const uint8_t* id, uint64_t size, int* fd_out) {
  Store* s = static_cast<Store*>(handle);
  if (LockIndex(s) != 0) return RTS_ERR_IO;
  // Capacity check + eviction, decided under the lock so concurrent
  // creators cannot both pass and oversubscribe tmpfs.  Pooled warm files
  // count toward the footprint (their pages are still resident) and are
  // drained before any live object is evicted.
  if (s->hdr->used.load() + s->hdr->recycle_bytes.load() + size >
      s->hdr->capacity) {
    uint64_t need = s->hdr->used.load() + s->hdr->recycle_bytes.load() +
                    size - s->hdr->capacity;
    uint64_t drained = DrainRecycleLocked(s, need);
    if (drained < need) {
      UnlockIndex(s);
      rts_evict(handle, need - drained);
      if (LockIndex(s) != 0) return RTS_ERR_IO;
    }
    if (s->hdr->used.load() + s->hdr->recycle_bytes.load() + size >
        s->hdr->capacity) {
      UnlockIndex(s);
      return RTS_ERR_FULL;
    }
  }
  Slot* slot = FindSlot(s, id, /*want_insert=*/true);
  if (slot == nullptr) {
    UnlockIndex(s);
    return RTS_ERR_FULL;
  }
  uint32_t st = slot->state.load();
  if (st == kCreating || st == kSealed) {
    UnlockIndex(s);
    return RTS_ERR_EXISTS;
  }
  memcpy(slot->id, id, kIdSize);
  slot->refcount.store(0);
  slot->size.store(size);
  slot->lru_tick.store(s->hdr->clock.fetch_add(1));
  slot->create_ts.store((uint64_t)time(nullptr));
  slot->state.store(kCreating, std::memory_order_release);
  s->hdr->used.fetch_add(size);
  s->hdr->num_objects.fetch_add(1);
  // Claim a pooled warm file of a compatible size (>= requested, bounded
  // waste) while still under the lock; the rename happens after unlock —
  // the claimed entry is already ours (size zeroed), so no racer can touch
  // the file.
  uint64_t reuse_sz = 0;
  char reuse_path[4300];
  if (size >= kRecycleMinBytes) {
    for (uint32_t i = 0; i < kRecycleSlots; i++) {
      RecycleEntry* e = &s->hdr->recycle[i];
      uint64_t rsz = e->size.load(std::memory_order_acquire);
      if (rsz >= size && rsz <= 2 * size) {
        RecyclePath(s, i, e->seq.load(), reuse_path, sizeof(reuse_path));
        e->size.store(0, std::memory_order_release);
        s->hdr->recycle_bytes.fetch_sub(rsz);
        reuse_sz = rsz;
        break;
      }
    }
  }
  UnlockIndex(s);

  char path[4300];
  ObjectPath(s, id, /*building=*/true, path, sizeof(path));
  int fd = -1;
  if (reuse_sz > 0) {
    if (rename(reuse_path, path) == 0) {
      fd = open(path, O_RDWR);
      if (fd >= 0 && reuse_sz != size && ftruncate(fd, size) != 0) {
        close(fd);
        fd = -1;
      }
    } else {
      unlink(reuse_path);  // claimed but unusable; don't leak the file
    }
  }
  if (fd < 0) {
    fd = open(path, O_RDWR | O_CREAT | O_TRUNC, 0666);
    if (fd >= 0 && size > 0 && ftruncate(fd, size) != 0) {
      close(fd);
      fd = -1;
    }
  }
  if (fd < 0) {
    unlink(path);
    LockIndex(s);
    slot->state.store(kTombstone);
    s->hdr->used.fetch_sub(size);
    s->hdr->num_objects.fetch_sub(1);
    UnlockIndex(s);
    return RTS_ERR_IO;
  }
  *fd_out = fd;
  return RTS_OK;
}

// Seal a created object: atomic rename makes it visible to readers.
int rts_seal(void* handle, const uint8_t* id) {
  Store* s = static_cast<Store*>(handle);
  if (LockIndex(s) != 0) return RTS_ERR_IO;
  Slot* slot = FindSlot(s, id, false);
  if (slot == nullptr || slot->state.load() != kCreating) {
    UnlockIndex(s);
    return slot == nullptr ? RTS_ERR_NOT_FOUND : RTS_ERR_STATE;
  }
  char src[4300], dst[4300];
  ObjectPath(s, id, true, src, sizeof(src));
  ObjectPath(s, id, false, dst, sizeof(dst));
  if (rename(src, dst) != 0) {
    UnlockIndex(s);
    return RTS_ERR_IO;
  }
  slot->state.store(kSealed, std::memory_order_release);
  UnlockIndex(s);
  return RTS_OK;
}

// Abort a create-in-progress (e.g. writer failed).
int rts_abort(void* handle, const uint8_t* id) {
  Store* s = static_cast<Store*>(handle);
  if (LockIndex(s) != 0) return RTS_ERR_IO;
  Slot* slot = FindSlot(s, id, false);
  if (slot == nullptr || slot->state.load() != kCreating) {
    UnlockIndex(s);
    return slot == nullptr ? RTS_ERR_NOT_FOUND : RTS_ERR_STATE;
  }
  char path[4300];
  ObjectPath(s, id, true, path, sizeof(path));
  unlink(path);
  slot->state.store(kTombstone);
  s->hdr->used.fetch_sub(slot->size.load());
  s->hdr->num_objects.fetch_sub(1);
  UnlockIndex(s);
  return RTS_OK;
}

// Get a sealed object: increments refcount, returns size and a read-only fd.
// The incref happens under the index lock so it cannot race an evictor that
// has already sampled refcount==0 (a lock-free incref could otherwise leave a
// stale release corrupting a recreated object's refcount).
int rts_get(void* handle, const uint8_t* id, uint64_t* size_out, int* fd_out) {
  Store* s = static_cast<Store*>(handle);
  if (LockIndex(s) != 0) return RTS_ERR_IO;
  Slot* slot = FindSlot(s, id, false);
  if (slot == nullptr ||
      slot->state.load(std::memory_order_acquire) != kSealed) {
    UnlockIndex(s);
    return RTS_ERR_NOT_FOUND;
  }
  slot->refcount.fetch_add(1);
  slot->lru_tick.store(s->hdr->clock.fetch_add(1));
  UnlockIndex(s);
  char path[4300];
  ObjectPath(s, id, false, path, sizeof(path));
  int fd = open(path, O_RDONLY);
  if (fd < 0) {
    rts_release(handle, id);
    return RTS_ERR_IO;
  }
  *size_out = slot->size.load();
  *fd_out = fd;
  return RTS_OK;
}

// Release a get() reference.
int rts_release(void* handle, const uint8_t* id) {
  Store* s = static_cast<Store*>(handle);
  if (LockIndex(s) != 0) return RTS_ERR_IO;
  Slot* slot = FindSlot(s, id, false);
  if (slot == nullptr || slot->state.load() != kSealed ||
      memcmp(slot->id, id, kIdSize) != 0) {
    UnlockIndex(s);
    return RTS_ERR_NOT_FOUND;
  }
  slot->refcount.fetch_sub(1);
  UnlockIndex(s);
  return RTS_OK;
}

// Introspect a slot without touching refcounts or the LRU clock:
// state/size/refcount out-params. Backs the transfer-plane leak
// assertions (a sealed object whose transfer finished must be back at
// refcount 0) and lets the daemon observe create-then-fill progress.
// Returns RTS_OK, or RTS_ERR_NOT_FOUND for empty/tombstoned slots.
int rts_stat(void* handle, const uint8_t* id, uint32_t* state_out,
             uint64_t* size_out, uint32_t* refcount_out) {
  Store* s = static_cast<Store*>(handle);
  if (LockIndex(s) != 0) return RTS_ERR_IO;
  Slot* slot = FindSlot(s, id, false);
  if (slot == nullptr) {
    UnlockIndex(s);
    return RTS_ERR_NOT_FOUND;
  }
  uint32_t st = slot->state.load(std::memory_order_acquire);
  if (st == kEmpty || st == kTombstone) {
    UnlockIndex(s);
    return RTS_ERR_NOT_FOUND;
  }
  *state_out = st;
  *size_out = slot->size.load();
  *refcount_out = slot->refcount.load();
  UnlockIndex(s);
  return RTS_OK;
}

int rts_contains(void* handle, const uint8_t* id) {
  Store* s = static_cast<Store*>(handle);
  Slot* slot = FindSlot(s, id, false);
  return (slot != nullptr &&
          slot->state.load(std::memory_order_acquire) == kSealed)
             ? 1
             : 0;
}

// Delete a sealed object regardless of LRU position (refcount must be 0
// unless force). Used by the owner's distributed GC.
int rts_delete(void* handle, const uint8_t* id, int force) {
  Store* s = static_cast<Store*>(handle);
  if (LockIndex(s) != 0) return RTS_ERR_IO;
  Slot* slot = FindSlot(s, id, false);
  if (slot == nullptr || slot->state.load() != kSealed) {
    UnlockIndex(s);
    return RTS_ERR_NOT_FOUND;
  }
  if (!force && slot->refcount.load() != 0) {
    UnlockIndex(s);
    return RTS_ERR_STATE;
  }
  uint64_t sz = slot->size.load();
  // Explicit GC delete is the steady-state recycling point: large files
  // park in the warm pool for the next large create instead of unlinking.
  if (!TryRecycleLocked(s, id, sz)) {
    char path[4300];
    ObjectPath(s, id, false, path, sizeof(path));
    unlink(path);
  }
  s->hdr->used.fetch_sub(sz);
  s->hdr->num_objects.fetch_sub(1);
  slot->state.store(kTombstone);
  UnlockIndex(s);
  return RTS_OK;
}

// Bytes held by the warm-file recycle pool (introspection: the pool is
// tmpfs footprint but neither `used` nor an object — the quiescence leak
// guard asserts it stays bounded).
uint64_t rts_recycle_bytes(void* handle) {
  return static_cast<Store*>(handle)->hdr->recycle_bytes.load();
}

// List up to `max` sealed object ids into out (max * 20 bytes). Returns count.
uint64_t rts_list(void* handle, uint8_t* out, uint64_t max) {
  Store* s = static_cast<Store*>(handle);
  uint64_t count = 0;
  for (uint64_t i = 0; i < s->hdr->num_slots && count < max; i++) {
    Slot* slot = &s->slots[i];
    if (slot->state.load(std::memory_order_acquire) == kSealed) {
      memcpy(out + count * kIdSize, slot->id, kIdSize);
      count++;
    }
  }
  return count;
}

// Destroy the store: unlink every object file and the index.
int rts_destroy(const char* dir) {
  char index_path[4200];
  snprintf(index_path, sizeof(index_path), "%s/.index", dir);
  unlink(index_path);
  return 0;
}

}  // extern "C"
