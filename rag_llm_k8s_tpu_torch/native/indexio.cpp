// Checksummed, durable snapshot codec for the vector-index payload; the
// port's copy of rag_llm_k8s_tpu/native/indexio.cpp (same on-disk format, so
// a snapshot written by either package loads in the other).
//
// The reference persists its index through faiss's C++ writer plus a python
// pickle (its llm/rag.py:62,82-84) — no checksum, no fsync, two
// files that can desync. This codec is the framework's native counterpart
// for the payload half (survey §2b: "C++ host-side index store for
// serialize/append semantics"): one self-describing file, CRC32-verified on
// read, written tmp-then-fsync-then-rename so a crash at any point leaves
// either the old snapshot or the new one, never a torn file. Metadata stays
// JSON on the python side (human-readable parity with /index_info).
//
// Layout (little-endian):
//   0:8   magic   "TPURIDX1"
//   8:8   dim     (int64)
//  16:8   count   (int64)   rows actually populated
//  24:8   generation (int64)
//  32:8   payload_bytes (int64) == count * dim * 4
//  40:8   crc32 of payload (int64, low 32 bits)
//  48:..  payload: count*dim float32
//
// Driven via ctypes; plain C ABI.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

#include <fcntl.h>
#include <sys/types.h>
#include <unistd.h>

namespace {

constexpr char kMagic[8] = {'T', 'P', 'U', 'R', 'I', 'D', 'X', '1'};
constexpr int64_t kHeaderBytes = 48;

struct Crc32Tables {
  // slicing-by-8: 8 derived tables -> one table lookup per byte becomes
  // 8 bytes per loop iteration (~5-8x faster; a multi-GB payload would
  // otherwise spend seconds under the store's writer lock per save)
  uint32_t t[8][256];
  Crc32Tables() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int j = 0; j < 8; j++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[0][i] = c;
    }
    for (int k = 1; k < 8; k++)
      for (uint32_t i = 0; i < 256; i++)
        t[k][i] = t[0][t[k - 1][i] & 0xFF] ^ (t[k - 1][i] >> 8);
  }
};

uint32_t crc32(const uint8_t* data, int64_t n) {
  // C++11 magic static: thread-safe one-time construction (a racy manual
  // ready-flag could let a second thread read a half-built table and stamp
  // a wrong CRC into a perfectly good snapshot)
  static const Crc32Tables tables;
  const auto& t = tables.t;
  uint32_t c = 0xFFFFFFFFu;
  int64_t i = 0;
  for (; i + 8 <= n; i += 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, data + i, 4);
    std::memcpy(&hi, data + i + 4, 4);
    lo ^= c;
    c = t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF] ^
        t[4][lo >> 24] ^ t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^
        t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
  }
  for (; i < n; i++) c = t[0][(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// fsync the parent directory so a rename is itself durable — without it a
// power cut after save() can resurrect the OLD payload next to NEW metadata
int fsync_parent(const char* path) {
  std::string dir(path);
  const size_t slash = dir.find_last_of('/');
  dir = (slash == std::string::npos) ? "." : dir.substr(0, slash);
  const int dfd = ::open(dir.c_str(), O_RDONLY);
  if (dfd < 0) return -1;
  const int rc = ::fsync(dfd);
  ::close(dfd);
  return rc;
}

struct Header {
  char magic[8];
  int64_t dim;
  int64_t count;
  int64_t generation;
  int64_t payload_bytes;
  int64_t crc;
};
static_assert(sizeof(Header) == kHeaderBytes, "header must be 48 bytes");

}  // namespace

extern "C" {

// Write a snapshot: tmp file in the same directory, fsync, atomic rename.
// Returns 0 on success, negative errno-style codes on failure.
int32_t indexio_write(const char* path, int64_t dim, int64_t count,
                      int64_t generation, const float* data) {
  const int64_t payload = count * dim * static_cast<int64_t>(sizeof(float));
  Header h;
  std::memcpy(h.magic, kMagic, 8);
  h.dim = dim;
  h.count = count;
  h.generation = generation;
  h.payload_bytes = payload;
  h.crc = crc32(reinterpret_cast<const uint8_t*>(data), payload);

  // unique temp name (pid + monotonic counter): concurrent savers — e.g.
  // two pods on a shared volume, where no in-process lock can help — must
  // never truncate each other's half-written temp; each writes its own
  // file and the last complete rename wins, like the python mkstemp path
  static int counter = 0;
  const std::string tmp = std::string(path) + ".tmp." +
                          std::to_string(::getpid()) + "." +
                          std::to_string(__atomic_add_fetch(&counter, 1, __ATOMIC_SEQ_CST));
  const int fd = ::open(tmp.c_str(), O_WRONLY | O_CREAT | O_EXCL, 0644);
  if (fd < 0) return -1;
  bool ok = ::write(fd, &h, sizeof(h)) == static_cast<ssize_t>(sizeof(h));
  const uint8_t* p = reinterpret_cast<const uint8_t*>(data);
  int64_t left = payload;
  while (ok && left > 0) {
    const ssize_t n = ::write(fd, p, static_cast<size_t>(left));
    if (n <= 0) { ok = false; break; }
    p += n;
    left -= n;
  }
  // durability: payload reaches the platter/SSD BEFORE the rename publishes
  // it — np.save + rename alone can lose the payload on power cut
  ok = ok && ::fsync(fd) == 0;
  ok = (::close(fd) == 0) && ok;
  if (!ok) { ::unlink(tmp.c_str()); return -2; }
  if (::rename(tmp.c_str(), path) != 0) { ::unlink(tmp.c_str()); return -3; }
  if (fsync_parent(path) != 0) return -7;  // rename published but not durable
  return 0;
}

// Read the header: out = [dim, count, generation, payload_bytes].
// Returns 0 on success, -1 open failure, -4 bad magic/short header.
int32_t indexio_read_header(const char* path, int64_t* out) {
  const int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -1;
  Header h;
  const bool ok = ::read(fd, &h, sizeof(h)) == static_cast<ssize_t>(sizeof(h));
  ::close(fd);
  if (!ok || std::memcmp(h.magic, kMagic, 8) != 0) return -4;
  out[0] = h.dim;
  out[1] = h.count;
  out[2] = h.generation;
  out[3] = h.payload_bytes;
  return 0;
}

// Read + CRC-verify the payload into caller-allocated memory of
// payload_bytes (from indexio_read_header). Returns 0 ok, -1 open,
// -4 bad header, -5 short payload, -6 checksum mismatch (corruption).
int32_t indexio_read(const char* path, float* data, int64_t payload_bytes) {
  const int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -1;
  Header h;
  if (::read(fd, &h, sizeof(h)) != static_cast<ssize_t>(sizeof(h)) ||
      std::memcmp(h.magic, kMagic, 8) != 0 || h.payload_bytes != payload_bytes) {
    ::close(fd);
    return -4;
  }
  uint8_t* p = reinterpret_cast<uint8_t*>(data);
  int64_t left = payload_bytes;
  while (left > 0) {
    const ssize_t n = ::read(fd, p, static_cast<size_t>(left));
    if (n <= 0) { ::close(fd); return -5; }
    p += n;
    left -= n;
  }
  ::close(fd);
  const uint32_t got = crc32(reinterpret_cast<const uint8_t*>(data), payload_bytes);
  if (static_cast<int64_t>(got) != h.crc) return -6;
  return 0;
}

}  // extern "C"
