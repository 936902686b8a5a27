// owshen_store: a small native log-structured key-value store with atomic
// batch commit (the port's copy of owshen_tpu/native/store.cc; the file
// format is the same, byte for byte) — the equivalent of the storage engine
// the Owshen node links natively (LevelDB via the `leveldb` crate;
// reference: src/db/disk.rs:26-63, trait KvStore src/db/mod.rs:24-52).
//
// Design (deliberately simpler than LevelDB, same contract the reference
// actually uses):
//   * One append-only log file.  Records: [u32 klen][u32 vlen][u32 crc]
//     [key bytes][val bytes].  vlen==0xFFFFFFFF is a tombstone.  klen==0
//     is REJECTED at the API (put/delete return -1): an empty-key record
//     would be framed identically to a COMMIT marker, and replay would
//     mis-parse it and truncate away later committed batches.  Python
//     wrappers enforce the same rule.
//   * A batch is a run of records terminated by a COMMIT marker (klen==0,
//     vlen==0, crc over the batch's record count).  On open, a trailing
//     run without its COMMIT marker is discarded — this is the atomic
//     Writebatch semantics Owshenchain::atomic relies on
//     (src/blockchain/mod.rs:90-99 -> DiskKvStore::batch_put_raw).
//   * close() DISCARDS uncommitted records (truncates back to the last
//     commit marker) — the same discard-on-close contract as the Python
//     engine, so forgetting commit() behaves identically under both.
//     compact() refuses (-1) while a batch is pending for the same reason.
//   * The full index (key -> offset,len) lives in memory, rebuilt by a
//     sequential scan on open; torn tails (bad crc / short read) truncate.
//   * compact() rewrites the live set into a fresh log and atomically
//     renames it over the old one.
//
// Exposed as a flat C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <string>
#include <vector>

#if defined(_WIN32)
#error "posix only"
#endif
#include <unistd.h>

namespace {

// Standard reflected CRC-32 (poly 0xEDB88320), slice-by-8: the same values
// as the bit-at-a-time loop of owshen_tpu/native/store.cc, so the two
// engines' files are interchangeable, at a few GB/s instead of ~0.1 GB/s (a
// checkpoint's prover tables are gigabytes, checked on write and on open).
struct Crc32Tables {
  uint32_t t[8][256];
  Crc32Tables() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c >> 1) ^ (0xEDB88320u & (~(c & 1) + 1));
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; i++)
      for (int s = 1; s < 8; s++) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

uint32_t crc32_update(uint32_t crc, const uint8_t* p, size_t n) {
  static const Crc32Tables tables;
  const auto& T = tables.t;
  crc = ~crc;
  for (; n >= 8; p += 8, n -= 8) {   // little-endian words, as the log's headers
    uint32_t lo, hi;
    std::memcpy(&lo, p, 4);
    std::memcpy(&hi, p + 4, 4);
    lo ^= crc;
    crc = T[7][lo & 0xFF] ^ T[6][(lo >> 8) & 0xFF] ^ T[5][(lo >> 16) & 0xFF] ^
          T[4][lo >> 24] ^ T[3][hi & 0xFF] ^ T[2][(hi >> 8) & 0xFF] ^
          T[1][(hi >> 16) & 0xFF] ^ T[0][hi >> 24];
  }
  for (; n; p++, n--) crc = (crc >> 8) ^ T[0][(crc ^ *p) & 0xFF];
  return ~crc;
}

constexpr uint32_t kTombstone = 0xFFFFFFFFu;

struct Store {
  std::string path;
  FILE* f = nullptr;
  // key -> (value offset in file, value length); tombstones removed
  std::map<std::string, std::pair<uint64_t, uint32_t>> index;
  // records appended since the last commit marker (for rollback bookkeeping)
  uint64_t committed_size = 0;  // file size at last commit marker
  uint32_t pending_records = 0;
  bool dirty = false;

  bool replay() {
    // scan the log; keep only fully-committed batches
    std::fseek(f, 0, SEEK_END);
    long endl = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    uint64_t end = (uint64_t)endl;
    uint64_t pos = 0;
    uint64_t last_commit = 0;
    std::map<std::string, std::pair<uint64_t, uint32_t>> batch_idx;
    uint32_t batch_records = 0;
    std::vector<uint8_t> buf;
    while (pos + 12 <= end) {
      uint32_t hdr[3];
      if (std::fread(hdr, 4, 3, f) != 3) break;
      uint32_t klen = hdr[0], vlen = hdr[1], crc = hdr[2];
      if (klen == 0 && (vlen == 0 || vlen == kTombstone)) {
        // commit marker: crc covers the record count of this batch
        uint8_t cnt[4];
        std::memcpy(cnt, &batch_records, 4);
        if (crc32_update(0, cnt, 4) != crc) break;  // torn marker
        for (auto& kv : batch_idx) {
          if (kv.second.second == kTombstone) index.erase(kv.first);
          else index[kv.first] = kv.second;
        }
        batch_idx.clear();
        batch_records = 0;
        pos += 12;
        last_commit = pos;
        continue;
      }
      uint32_t real_vlen = (vlen == kTombstone) ? 0 : vlen;
      if (klen > (1u << 30) || real_vlen > (1u << 30)) break;
      if (pos + 12 + klen + real_vlen > end) break;
      buf.resize(klen + real_vlen);
      if (buf.size() && std::fread(buf.data(), 1, buf.size(), f) != buf.size()) break;
      if (crc32_update(crc32_update(0, buf.data(), klen),
                       buf.data() + klen, real_vlen) != crc) break;
      std::string key((char*)buf.data(), klen);
      batch_idx[key] = {pos + 12 + klen, vlen};
      batch_records++;
      pos += 12 + klen + real_vlen;
    }
    committed_size = last_commit;
    // drop any torn tail so future appends start at a clean boundary
    if (last_commit < end) {
      if (truncate(path.c_str(), (off_t)last_commit) != 0) return false;
    }
    std::fseek(f, 0, SEEK_END);
    return true;
  }

  bool append_record(const uint8_t* k, uint32_t klen, const uint8_t* v,
                     uint32_t vlen) {
    uint32_t real_vlen = (vlen == kTombstone) ? 0 : vlen;
    uint32_t crc = crc32_update(crc32_update(0, k, klen), v, real_vlen);
    uint32_t hdr[3] = {klen, vlen, crc};
    if (std::fwrite(hdr, 4, 3, f) != 3) return false;
    if (klen && std::fwrite(k, 1, klen, f) != klen) return false;
    if (real_vlen && std::fwrite(v, 1, real_vlen, f) != real_vlen) return false;
    long off = std::ftell(f);
    std::string key((char*)k, klen);
    if (vlen == kTombstone) index.erase(key);
    else index[key] = {(uint64_t)off - real_vlen, vlen};
    pending_records++;
    dirty = true;
    return true;
  }

  bool commit() {
    uint32_t crc = crc32_update(0, (uint8_t*)&pending_records, 4);
    uint32_t hdr[3] = {0, 0, crc};
    if (std::fwrite(hdr, 4, 3, f) != 3) return false;
    if (std::fflush(f) != 0) return false;
    if (fsync(fileno(f)) != 0) return false;
    committed_size = (uint64_t)std::ftell(f);
    pending_records = 0;
    dirty = false;
    return true;
  }
};

}  // namespace

extern "C" {

void* owshen_store_open(const char* path) {
  Store* s = new Store();
  s->path = path;
  s->f = std::fopen(path, "r+b");
  if (!s->f) s->f = std::fopen(path, "w+b");
  if (!s->f || !s->replay()) {
    if (s->f) std::fclose(s->f);
    delete s;
    return nullptr;
  }
  return s;
}

int owshen_store_put(void* h, const uint8_t* k, uint32_t klen,
                     const uint8_t* v, uint32_t vlen) {
  Store* s = (Store*)h;
  if (klen == 0) return -1;  // would alias the COMMIT marker framing
  if (vlen == kTombstone) return -1;
  return s->append_record(k, klen, v, vlen) ? 0 : -1;
}

int owshen_store_delete(void* h, const uint8_t* k, uint32_t klen) {
  Store* s = (Store*)h;
  if (klen == 0) return -1;  // would alias the COMMIT marker framing
  return s->append_record(k, klen, nullptr, kTombstone) ? 0 : -1;
}

int owshen_store_commit(void* h) { return ((Store*)h)->commit() ? 0 : -1; }

// Returns value length, or -1 if absent.  If out != null and cap >= len,
// copies the value bytes into out.
int64_t owshen_store_get(void* h, const uint8_t* k, uint32_t klen,
                         uint8_t* out, uint64_t cap) {
  Store* s = (Store*)h;
  auto it = s->index.find(std::string((char*)k, klen));
  if (it == s->index.end()) return -1;
  uint32_t vlen = it->second.second;
  if (vlen == kTombstone) return -1;
  if (out && cap >= vlen) {
    long save = std::ftell(s->f);
    std::fseek(s->f, (long)it->second.first, SEEK_SET);
    size_t got = std::fread(out, 1, vlen, s->f);
    std::fseek(s->f, save, SEEK_SET);
    if (got != vlen) return -1;
  }
  return (int64_t)vlen;
}

uint64_t owshen_store_count(void* h) { return ((Store*)h)->index.size(); }

// Iterate keys: writes the i-th key (sorted order) into out, returns its
// length or -1.  Host-side iteration helper for checkpoint enumeration.
int64_t owshen_store_key_at(void* h, uint64_t i, uint8_t* out, uint64_t cap) {
  Store* s = (Store*)h;
  if (i >= s->index.size()) return -1;
  auto it = s->index.begin();
  std::advance(it, (long)i);
  if (out && cap >= it->first.size())
    std::memcpy(out, it->first.data(), it->first.size());
  return (int64_t)it->first.size();
}

int owshen_store_compact(void* h) {
  Store* s = (Store*)h;
  if (s->dirty) return -1;  // pending batch: commit or close-discard first
  std::string tmp = s->path + ".compact";
  FILE* nf = std::fopen(tmp.c_str(), "w+b");
  if (!nf) return -1;
  Store ns;
  ns.path = tmp;
  ns.f = nf;
  std::vector<uint8_t> buf;
  for (auto& kv : s->index) {
    uint32_t vlen = kv.second.second;
    buf.resize(vlen);
    std::fseek(s->f, (long)kv.second.first, SEEK_SET);
    if (vlen && std::fread(buf.data(), 1, vlen, s->f) != vlen) {
      std::fclose(nf);
      return -1;
    }
    if (!ns.append_record((const uint8_t*)kv.first.data(),
                          (uint32_t)kv.first.size(), buf.data(), vlen)) {
      std::fclose(nf);
      return -1;
    }
  }
  if (!ns.commit()) { std::fclose(nf); return -1; }
  std::fclose(nf);
  std::fclose(s->f);
  if (std::rename(tmp.c_str(), s->path.c_str()) != 0) return -1;
  s->f = std::fopen(s->path.c_str(), "r+b");
  s->index.clear();
  s->pending_records = 0;
  return (s->f && s->replay()) ? 0 : -1;
}

void owshen_store_close(void* h) {
  Store* s = (Store*)h;
  if (s->f) {
    if (s->dirty) {
      // discard-on-close: truncate the uncommitted tail so reopen replays
      // exactly the committed state (same contract as PyKvStore.close)
      std::fflush(s->f);
      (void)!truncate(s->path.c_str(), (off_t)s->committed_size);
    }
    std::fclose(s->f);
  }
  delete s;
}

}  // extern "C"
