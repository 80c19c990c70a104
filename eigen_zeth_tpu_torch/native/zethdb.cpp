// zethdb — native KV engine for the rollup pipeline state.
//
// The port's own copy of eigen_zeth_tpu/native/zethdb.cpp (the same engine and
// record format), built with g++ at first use into eigen_zeth_tpu_torch/_build/.
//
// Plays the role libmdbx plays in the reference (src/db/lfs/libmdbx.rs:
// 45-79 via the C libmdbx crate): a durable host-side store for pipeline
// watermarks, step records, and proofs.  Design: append-only log with an
// in-memory hash index, fsync'd writes, replay-on-open; the record format
// is shared byte-for-byte with the pure-python FileDb
// (eigen_zeth_tpu_torch/protocol/kv.py) so either engine can open the other's
// files:
//
//   record := "EZTL" | u32 klen | u32 vlen (0xFFFFFFFF = tombstone) | k | v
//
// C ABI (consumed via ctypes from eigen_zeth_tpu_torch/native/zethdb.py):
//   void*  zethdb_open(const char* path)
//   int    zethdb_put(void*, const uint8_t* k, uint32_t klen,
//                            const uint8_t* v, uint32_t vlen)
//   int    zethdb_get(void*, const uint8_t* k, uint32_t klen,
//                            uint8_t** out, uint32_t* out_len)   // malloc'd
//   int    zethdb_del(void*, const uint8_t* k, uint32_t klen)    // 1 if existed
//   void   zethdb_free(uint8_t* p)
//   void   zethdb_close(void*)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

#ifdef _WIN32
#error "posix only"
#endif
#include <unistd.h>

namespace {

constexpr uint32_t kTombstone = 0xFFFFFFFFu;
const char kMagic[4] = {'E', 'Z', 'T', 'L'};

struct Db {
  std::mutex mu;
  std::unordered_map<std::string, std::string> index;
  FILE* log = nullptr;
};

bool append_record(Db* db, const std::string& key, const std::string* val) {
  uint32_t klen = static_cast<uint32_t>(key.size());
  uint32_t vlen = val ? static_cast<uint32_t>(val->size()) : kTombstone;
  if (fwrite(kMagic, 1, 4, db->log) != 4) return false;
  if (fwrite(&klen, 4, 1, db->log) != 1) return false;
  if (fwrite(&vlen, 4, 1, db->log) != 1) return false;
  if (klen && fwrite(key.data(), 1, klen, db->log) != klen) return false;
  if (val && !val->empty() &&
      fwrite(val->data(), 1, val->size(), db->log) != val->size())
    return false;
  if (fflush(db->log) != 0) return false;
  return fsync(fileno(db->log)) == 0;
}

void replay(Db* db, const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return;
  std::vector<char> magic(4);
  for (;;) {
    if (fread(magic.data(), 1, 4, f) != 4) break;
    if (memcmp(magic.data(), kMagic, 4) != 0) break;  // torn tail
    uint32_t klen, vlen;
    if (fread(&klen, 4, 1, f) != 1) break;
    if (fread(&vlen, 4, 1, f) != 1) break;
    std::string key(klen, '\0');
    if (klen && fread(&key[0], 1, klen, f) != klen) break;
    if (vlen == kTombstone) {
      db->index.erase(key);
      continue;
    }
    std::string val(vlen, '\0');
    if (vlen && fread(&val[0], 1, vlen, f) != vlen) break;
    db->index[std::move(key)] = std::move(val);
  }
  fclose(f);
}

}  // namespace

extern "C" {

void* zethdb_open(const char* path) {
  Db* db = new Db();
  replay(db, path);
  db->log = fopen(path, "ab");
  if (!db->log) {
    delete db;
    return nullptr;
  }
  return db;
}

int zethdb_put(void* h, const uint8_t* k, uint32_t klen, const uint8_t* v,
               uint32_t vlen) {
  Db* db = static_cast<Db*>(h);
  std::string key(reinterpret_cast<const char*>(k), klen);
  std::string val(reinterpret_cast<const char*>(v), vlen);
  std::lock_guard<std::mutex> lock(db->mu);
  if (!append_record(db, key, &val)) return -1;
  db->index[std::move(key)] = std::move(val);
  return 0;
}

int zethdb_get(void* h, const uint8_t* k, uint32_t klen, uint8_t** out,
               uint32_t* out_len) {
  Db* db = static_cast<Db*>(h);
  std::string key(reinterpret_cast<const char*>(k), klen);
  std::lock_guard<std::mutex> lock(db->mu);
  auto it = db->index.find(key);
  if (it == db->index.end()) return 0;
  *out_len = static_cast<uint32_t>(it->second.size());
  *out = static_cast<uint8_t*>(malloc(it->second.size() ? it->second.size() : 1));
  memcpy(*out, it->second.data(), it->second.size());
  return 1;
}

int zethdb_del(void* h, const uint8_t* k, uint32_t klen) {
  Db* db = static_cast<Db*>(h);
  std::string key(reinterpret_cast<const char*>(k), klen);
  std::lock_guard<std::mutex> lock(db->mu);
  auto it = db->index.find(key);
  if (it == db->index.end()) return 0;
  if (!append_record(db, key, nullptr)) return -1;
  db->index.erase(it);
  return 1;
}

void zethdb_free(uint8_t* p) { free(p); }

void zethdb_close(void* h) {
  Db* db = static_cast<Db*>(h);
  {
    std::lock_guard<std::mutex> lock(db->mu);
    if (db->log) fclose(db->log);
    db->log = nullptr;
  }
  delete db;
}

uint64_t zethdb_count(void* h) {
  Db* db = static_cast<Db*>(h);
  std::lock_guard<std::mutex> lock(db->mu);
  return db->index.size();
}

}  // extern "C"
