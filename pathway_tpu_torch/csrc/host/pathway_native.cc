// pathway_tpu_torch host helpers: update consolidation, batched keyed
// blake2b row hashing and the batched WordPiece tokenizer (the engine's
// host hot paths), plus the keyed blob store, snapshot log and shard
// routing that the persistence plane will use.
//
// A copy of the reference package's native/pathway_native.cc, the
// counterpart of upstream Pathway's Rust state layer (src/engine/
// dataflow.rs arrangements, src/persistence/). The device compute plane is
// PyTorch + CUDA; this library is the host-side runtime the Python engine
// drives. Built with g++ by pathway_tpu_torch/native.py, never by nvcc.
//
// C ABI only (consumed via ctypes). All blobs are owned copies.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>
#include <fstream>
#include <thread>
#include <unordered_map>
#include <vector>

#if !defined(_WIN32)
#include <unistd.h>
#endif

#if defined(_WIN32)
#define PN_EXPORT extern "C" __declspec(dllexport)
#else
#define PN_EXPORT extern "C" __attribute__((visibility("default")))
#endif

namespace {

// ---------------------------------------------------------------------------
// hashing (splitmix64 — matches pathway_tpu.engine.value.hash_int_array)
// ---------------------------------------------------------------------------

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

// FNV-1a over bytes, for grouping serialized rows during consolidation.
inline uint64_t fnv1a(const uint8_t* data, uint64_t len) {
  uint64_t h = 0xCBF29CE484222325ULL;
  for (uint64_t i = 0; i < len; ++i) {
    h ^= data[i];
    h *= 0x100000001B3ULL;
  }
  return h;
}

// ---------------------------------------------------------------------------
// CRC32 (for the snapshot log; table-driven, polynomial 0xEDB88320)
// ---------------------------------------------------------------------------

struct Crc32Table {
  uint32_t t[256];
  Crc32Table() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[i] = c;
    }
  }
};
const Crc32Table kCrc;

inline uint32_t crc32(const uint8_t* data, uint64_t len, uint32_t seed = 0) {
  uint32_t c = seed ^ 0xFFFFFFFFu;
  for (uint64_t i = 0; i < len; ++i) c = kCrc.t[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

struct Blob {
  std::string data;
};

struct Store {
  std::unordered_map<uint64_t, std::string> map;
  // scratch returned to Python; valid until the next call on this store
  std::string scratch;
};

struct StoreIter {
  Store* store;
  std::unordered_map<uint64_t, std::string>::const_iterator it;
};

// Shared output buffer object: Python frees it with pn_buf_free.
struct Buf {
  std::vector<uint8_t> data;
};

inline void put_u32(std::vector<uint8_t>& out, uint32_t v) {
  out.insert(out.end(), reinterpret_cast<uint8_t*>(&v), reinterpret_cast<uint8_t*>(&v) + 4);
}
inline void put_u64(std::vector<uint8_t>& out, uint64_t v) {
  out.insert(out.end(), reinterpret_cast<uint8_t*>(&v), reinterpret_cast<uint8_t*>(&v) + 8);
}
inline void put_i64(std::vector<uint8_t>& out, int64_t v) {
  out.insert(out.end(), reinterpret_cast<uint8_t*>(&v), reinterpret_cast<uint8_t*>(&v) + 8);
}

}  // namespace

// ===========================================================================
// Keyed blob store (operator state / arrangement equivalent)
// ===========================================================================

PN_EXPORT void* pn_store_new() { return new Store(); }

PN_EXPORT void pn_store_free(void* s) { delete static_cast<Store*>(s); }

PN_EXPORT uint64_t pn_store_len(void* s) {
  return static_cast<Store*>(s)->map.size();
}

// Insert/replace. Returns 1 if a previous value existed (copied to scratch,
// readable via pn_store_scratch), else 0.
PN_EXPORT int32_t pn_store_upsert(void* sv, uint64_t key, const uint8_t* blob,
                                  uint64_t len) {
  Store* s = static_cast<Store*>(sv);
  auto it = s->map.find(key);
  if (it != s->map.end()) {
    s->scratch.swap(it->second);
    it->second.assign(reinterpret_cast<const char*>(blob), len);
    return 1;
  }
  s->map.emplace(key, std::string(reinterpret_cast<const char*>(blob), len));
  return 0;
}

// Remove. Returns 1 if present (old value in scratch), else 0.
PN_EXPORT int32_t pn_store_remove(void* sv, uint64_t key) {
  Store* s = static_cast<Store*>(sv);
  auto it = s->map.find(key);
  if (it == s->map.end()) return 0;
  s->scratch.swap(it->second);
  s->map.erase(it);
  return 1;
}

// Lookup. Returns 1 and sets (*ptr, *len) to internal storage if present.
PN_EXPORT int32_t pn_store_get(void* sv, uint64_t key, const uint8_t** ptr,
                               uint64_t* len) {
  Store* s = static_cast<Store*>(sv);
  auto it = s->map.find(key);
  if (it == s->map.end()) return 0;
  *ptr = reinterpret_cast<const uint8_t*>(it->second.data());
  *len = it->second.size();
  return 1;
}

PN_EXPORT int32_t pn_store_contains(void* sv, uint64_t key) {
  Store* s = static_cast<Store*>(sv);
  return s->map.count(key) ? 1 : 0;
}

PN_EXPORT void pn_store_clear(void* sv) { static_cast<Store*>(sv)->map.clear(); }

PN_EXPORT void pn_store_scratch(void* sv, const uint8_t** ptr, uint64_t* len) {
  Store* s = static_cast<Store*>(sv);
  *ptr = reinterpret_cast<const uint8_t*>(s->scratch.data());
  *len = s->scratch.size();
}

PN_EXPORT void* pn_store_iter_new(void* sv) {
  Store* s = static_cast<Store*>(sv);
  StoreIter* it = new StoreIter{s, s->map.cbegin()};
  return it;
}

PN_EXPORT int32_t pn_store_iter_next(void* iv, uint64_t* key,
                                     const uint8_t** ptr, uint64_t* len) {
  StoreIter* it = static_cast<StoreIter*>(iv);
  if (it->it == it->store->map.cend()) return 0;
  *key = it->it->first;
  *ptr = reinterpret_cast<const uint8_t*>(it->it->second.data());
  *len = it->it->second.size();
  ++it->it;
  return 1;
}

PN_EXPORT void pn_store_iter_free(void* iv) { delete static_cast<StoreIter*>(iv); }

// ===========================================================================
// Consolidation kernel
// ===========================================================================
// Input: packed records  [u64 key][i64 diff][u32 idx][u32 len][len bytes]...
// where `idx` indexes the caller's row list and the bytes are a canonical
// serialization of the row (equal rows serialize equally).  Semantics match
// pathway_tpu.engine.dataflow.consolidate: group by (key, row bytes), sum
// diffs, drop zeros; emit per first-seen key order, retractions before
// insertions within a key; |diff| copies each.
// Output (Buf): [u32 n] then n × ([u32 idx][i64 diff-sign-unit]) — one
// record per emitted unit update, referring to input row `idx`.

PN_EXPORT void* pn_consolidate(const uint8_t* in, uint64_t in_len) {
  struct Ent {
    uint32_t idx;
    int64_t diff;
    uint64_t rowhash;
    const uint8_t* bytes;
    uint32_t len;
  };
  // key -> entries (distinct rows); also remember key order
  std::unordered_map<uint64_t, std::vector<Ent>> groups;
  std::vector<uint64_t> key_order;
  const uint8_t* p = in;
  const uint8_t* end = in + in_len;
  while (p + 24 <= end) {
    uint64_t key;
    int64_t diff;
    uint32_t idx, len;
    memcpy(&key, p, 8);
    memcpy(&diff, p + 8, 8);
    memcpy(&idx, p + 16, 4);
    memcpy(&len, p + 20, 4);
    p += 24;
    if (p + len > end) break;
    const uint8_t* bytes = p;
    p += len;
    uint64_t rh = fnv1a(bytes, len);
    auto ins = groups.emplace(key, std::vector<Ent>());
    if (ins.second) key_order.push_back(key);
    std::vector<Ent>& bucket = ins.first->second;
    bool merged = false;
    for (Ent& e : bucket) {
      if (e.rowhash == rh && e.len == len && memcmp(e.bytes, bytes, len) == 0) {
        e.diff += diff;
        merged = true;
        break;
      }
    }
    if (!merged) bucket.push_back(Ent{idx, diff, rh, bytes, len});
  }
  Buf* out = new Buf();
  put_u32(out->data, 0);  // patched below
  uint32_t n = 0;
  for (uint64_t key : key_order) {
    std::vector<Ent>& bucket = groups[key];
    // retractions first (stable within equal diff sign)
    std::vector<const Ent*> neg, pos;
    for (const Ent& e : bucket) {
      if (e.diff < 0) neg.push_back(&e);
      else if (e.diff > 0) pos.push_back(&e);
    }
    for (const Ent* e : neg) {
      for (int64_t i = 0; i < -e->diff; ++i) {
        put_u32(out->data, e->idx);
        put_i64(out->data, -1);
        ++n;
      }
    }
    for (const Ent* e : pos) {
      for (int64_t i = 0; i < e->diff; ++i) {
        put_u32(out->data, e->idx);
        put_i64(out->data, 1);
        ++n;
      }
    }
  }
  memcpy(out->data.data(), &n, 4);
  return out;
}

PN_EXPORT void pn_buf_read(void* bv, const uint8_t** ptr, uint64_t* len) {
  Buf* b = static_cast<Buf*>(bv);
  *ptr = b->data.data();
  *len = b->data.size();
}

PN_EXPORT void pn_buf_free(void* bv) { delete static_cast<Buf*>(bv); }

// ===========================================================================
// Snapshot log (persistence backend)
// ===========================================================================
// File format: 8-byte magic "PNLOG1\0\0", then records:
//   [u8 kind][u64 time][u64 key][u64 len][len bytes][u32 crc]
// crc is CRC32 over (kind..bytes).  A torn tail (crash mid-append) fails
// the CRC/length check and reading stops there — crash-tolerant replay,
// mirroring the reference's chunk-per-file + metadata scheme
// (upstream Pathway's src/persistence/backends/file.rs) collapsed into one
// CRC-delimited log.

namespace {
const char kMagic[8] = {'P', 'N', 'L', 'O', 'G', '1', 0, 0};

struct LogWriter {
  FILE* f = nullptr;
  std::vector<uint8_t> rec;  // reusable record scratch
};

struct LogReader {
  FILE* f = nullptr;
  std::vector<uint8_t> blob;
};
}  // namespace

namespace {
// Scan an existing log and return the byte offset just past the last valid
// record (>= 8, the magic). Used to truncate a torn tail before appending —
// otherwise records written after a crash would sit beyond the corruption
// and be unreachable (pn_log_next stops at the first bad record).
long valid_prefix_end(FILE* f) {
  long good = 8;
  if (fseek(f, 8, SEEK_SET) != 0) return 8;
  std::vector<uint8_t> buf;
  for (;;) {
    uint8_t head[25];
    if (fread(head, 1, 25, f) != 25) break;
    uint64_t blen;
    memcpy(&blen, head + 17, 8);
    if (blen > (1ULL << 31)) break;
    buf.assign(head, head + 25);
    size_t base = buf.size();
    buf.resize(base + blen + 4);
    if (blen && fread(buf.data() + base, 1, blen, f) != blen) break;
    uint32_t crc_stored;
    if (fread(&crc_stored, 1, 4, f) != 4) break;
    if (crc32(buf.data(), base + blen) != crc_stored) break;
    good = ftell(f);
  }
  return good;
}
}  // namespace

PN_EXPORT void* pn_log_open_write(const char* path, int32_t append) {
  LogWriter* w = new LogWriter();
  bool fresh = true;
  long resume_at = 8;
  if (append) {
    FILE* probe = fopen(path, "rb");
    if (probe) {
      char m[8];
      fresh = fread(m, 1, 8, probe) != 8 || memcmp(m, kMagic, 8) != 0;
      if (!fresh) resume_at = valid_prefix_end(probe);
      fclose(probe);
    }
  }
  if (append && !fresh) {
    // r+b so we can truncate a torn tail and continue from the last
    // valid record
    w->f = fopen(path, "r+b");
    if (!w->f) {
      delete w;
      return nullptr;
    }
    fseek(w->f, resume_at, SEEK_SET);
#if !defined(_WIN32)
    if (ftruncate(fileno(w->f), resume_at) != 0) { /* best effort */ }
#endif
  } else {
    w->f = fopen(path, "wb");
    if (!w->f) {
      delete w;
      return nullptr;
    }
    fwrite(kMagic, 1, 8, w->f);
  }
  return w;
}

PN_EXPORT int32_t pn_log_append(void* wv, uint8_t kind, uint64_t time,
                                uint64_t key, const uint8_t* blob,
                                uint64_t len) {
  LogWriter* w = static_cast<LogWriter*>(wv);
  std::vector<uint8_t>& r = w->rec;
  r.clear();
  r.push_back(kind);
  put_u64(r, time);
  put_u64(r, key);
  put_u64(r, len);
  r.insert(r.end(), blob, blob + len);
  uint32_t crc = crc32(r.data(), r.size());
  put_u32(r, crc);
  return fwrite(r.data(), 1, r.size(), w->f) == r.size() ? 1 : 0;
}

PN_EXPORT int32_t pn_log_flush(void* wv) {
  LogWriter* w = static_cast<LogWriter*>(wv);
  if (fflush(w->f) != 0) return 0;
#if !defined(_WIN32)
  // fsync for durability across process crashes
  if (fileno(w->f) >= 0) fsync(fileno(w->f));
#endif
  return 1;
}

PN_EXPORT void pn_log_close_write(void* wv) {
  LogWriter* w = static_cast<LogWriter*>(wv);
  if (w->f) fclose(w->f);
  delete w;
}

PN_EXPORT void* pn_log_open_read(const char* path) {
  LogReader* r = new LogReader();
  r->f = fopen(path, "rb");
  if (!r->f) {
    delete r;
    return nullptr;
  }
  char m[8];
  if (fread(m, 1, 8, r->f) != 8 || memcmp(m, kMagic, 8) != 0) {
    fclose(r->f);
    delete r;
    return nullptr;
  }
  return r;
}

// Returns 1 on a valid record, 0 on EOF or first corrupt/torn record.
PN_EXPORT int32_t pn_log_next(void* rv, uint8_t* kind, uint64_t* time,
                              uint64_t* key, const uint8_t** ptr,
                              uint64_t* len) {
  LogReader* r = static_cast<LogReader*>(rv);
  uint8_t head[25];
  if (fread(head, 1, 25, r->f) != 25) return 0;
  uint64_t blen;
  memcpy(&blen, head + 17, 8);
  if (blen > (1ULL << 31)) return 0;  // implausible; treat as corruption
  try {
    r->blob.resize(blen);
  } catch (const std::bad_alloc&) {
    return 0;  // corrupt length field; never throw across the C ABI
  }
  if (blen && fread(r->blob.data(), 1, blen, r->f) != blen) return 0;
  uint32_t crc_stored;
  if (fread(&crc_stored, 1, 4, r->f) != 4) return 0;
  std::vector<uint8_t> whole(head, head + 25);
  whole.insert(whole.end(), r->blob.begin(), r->blob.end());
  if (crc32(whole.data(), whole.size()) != crc_stored) return 0;
  *kind = head[0];
  memcpy(time, head + 1, 8);
  memcpy(key, head + 9, 8);
  *ptr = r->blob.data();
  *len = blen;
  return 1;
}

PN_EXPORT void pn_log_close_read(void* rv) {
  LogReader* r = static_cast<LogReader*>(rv);
  if (r->f) fclose(r->f);
  delete r;
}

// ---- store <-> log bridges: full-state snapshot without touching Python ----

// Writes every (key, blob) of the store as records with the given kind/time.
// Returns the number of records written, or -1 on IO error.
PN_EXPORT int64_t pn_store_snapshot(void* sv, void* wv, uint8_t kind,
                                    uint64_t time) {
  Store* s = static_cast<Store*>(sv);
  int64_t n = 0;
  for (const auto& kvp : s->map) {
    if (!pn_log_append(wv, kind, time, kvp.first,
                       reinterpret_cast<const uint8_t*>(kvp.second.data()),
                       kvp.second.size()))
      return -1;
    ++n;
  }
  return n;
}

// Loads records of `kind` from the reader into the store (upsert per key).
// Returns number loaded.
PN_EXPORT int64_t pn_store_load(void* sv, void* rv, uint8_t want_kind) {
  Store* s = static_cast<Store*>(sv);
  uint8_t kind;
  uint64_t time, key, len;
  const uint8_t* ptr;
  int64_t n = 0;
  while (pn_log_next(rv, &kind, &time, &key, &ptr, &len)) {
    if (kind != want_kind) continue;
    s->map[key].assign(reinterpret_cast<const char*>(ptr), len);
    ++n;
  }
  return n;
}

// ===========================================================================
// Batch key kernels (shard routing)
// ===========================================================================

PN_EXPORT void pn_hash64_batch(const uint64_t* in, uint64_t n, uint64_t* out) {
  for (uint64_t i = 0; i < n; ++i) out[i] = splitmix64(in[i]);
}

// shard = (key & mask) % n_shards  (reference shard.rs:15-20 + value.rs:38)
PN_EXPORT void pn_shard_batch(const uint64_t* keys, uint64_t n, uint64_t mask,
                              uint32_t n_shards, uint32_t* out) {
  for (uint64_t i = 0; i < n; ++i)
    out[i] = static_cast<uint32_t>((keys[i] & mask) % n_shards);
}


// ===========================================================================
// Batched WordPiece tokenizer (embedder host hot path)
//
// Mirrors pathway_tpu/models/tokenizer.py exactly for ASCII text: basic
// split into [A-Za-z0-9]+ runs / single other chars (UTF-8 codepoints
// count as one char), hash-mode ids 999 + crc32(word) % (V - 1000), or
// greedy longest-match WordPiece when a vocab is loaded. The pure-
// Python tokenizer tops out near 50k texts/s — below a single chip's
// embed rate — so the framework path runs this instead (reference runs
// HF fast tokenizers in Rust for the same reason).
// ===========================================================================

namespace {

struct Tok {
  bool lowercase = true;
  uint32_t vocab_size = 30522;
  int32_t cls_id = 101, sep_id = 102, pad_id = 0, unk_id = 100;
  bool has_vocab = false;
  std::unordered_map<std::string, int32_t> vocab;
  int max_chars = 100;
};

inline bool is_ascii_alnum(uint8_t c) {
  return (c >= '0' && c <= '9') || (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z');
}
inline bool is_ascii_space(uint8_t c) {
  // python's \s on str also covers \x1c-\x1f (file/group/record/unit
  // separators) — required for id parity with tokenizer.py
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
         c == '\v' || (c >= 0x1c && c <= 0x1f);
}
inline int utf8_len(uint8_t lead) {
  if (lead < 0x80) return 1;
  if ((lead >> 5) == 0x6) return 2;
  if ((lead >> 4) == 0xe) return 3;
  if ((lead >> 3) == 0x1e) return 4;
  return 1;  // invalid byte: treat as single char
}

// append the ids of one word; returns false when the caller's budget
// (max_len - 1) is already met, mirroring the python early break
inline void word_ids(const Tok& t, const std::string& w, std::vector<int32_t>& out) {
  if (!t.has_vocab) {
    out.push_back(static_cast<int32_t>(
        999 + crc32(reinterpret_cast<const uint8_t*>(w.data()), w.size()) %
                  (t.vocab_size - 1000)));
    return;
  }
  if (static_cast<int>(w.size()) > t.max_chars) {
    out.push_back(t.unk_id);
    return;
  }
  size_t before = out.size();
  size_t start = 0;
  while (start < w.size()) {
    size_t end = w.size();
    int32_t cur = -1;
    std::string sub;
    while (start < end) {
      sub.assign(w, start, end - start);
      if (start > 0) sub = "##" + sub;
      auto it = t.vocab.find(sub);
      if (it != t.vocab.end()) {
        cur = it->second;
        break;
      }
      --end;
    }
    if (cur < 0) {
      out.resize(before);
      out.push_back(t.unk_id);
      return;
    }
    out.push_back(cur);
    start = end;
  }
}

}  // namespace

PN_EXPORT void* pn_tok_new(const char* vocab_file, uint32_t vocab_size, int lowercase,
                           int32_t max_chars) {
  Tok* t = new Tok();
  t->lowercase = lowercase != 0;
  t->vocab_size = vocab_size;
  t->max_chars = max_chars > 0 ? max_chars : 100;
  if (vocab_file && *vocab_file) {
    std::ifstream f(vocab_file);
    if (f) {
      std::string line;
      int32_t i = 0;
      while (std::getline(f, line)) {
        if (!line.empty() && line.back() == '\r') line.pop_back();
        t->vocab.emplace(line, i++);
      }
      t->has_vocab = !t->vocab.empty();
      auto g = [&](const char* k, int32_t d) {
        auto it = t->vocab.find(k);
        return it == t->vocab.end() ? d : it->second;
      };
      t->cls_id = g("[CLS]", 101);
      t->sep_id = g("[SEP]", 102);
      t->pad_id = g("[PAD]", 0);
      t->unk_id = g("[UNK]", 100);
    }
  }
  return t;
}

PN_EXPORT void pn_tok_free(void* tv) { delete static_cast<Tok*>(tv); }

PN_EXPORT void pn_tok_info(void* tv, int32_t* cls_id, int32_t* sep_id,
                           int32_t* pad_id, int32_t* unk_id, int32_t* has_vocab) {
  Tok* t = static_cast<Tok*>(tv);
  *cls_id = t->cls_id;
  *sep_id = t->sep_id;
  *pad_id = t->pad_id;
  *unk_id = t->unk_id;
  *has_vocab = t->has_vocab ? 1 : 0;
}

// texts: concatenated UTF-8; offsets: n+1 byte offsets. Writes ids into
// out_ids[i*max_len ..] (pad_id filled) and true lengths into out_lens.
namespace {

void tok_encode_range(const Tok* t, const uint8_t* texts, const uint64_t* offsets,
                      uint64_t row_begin, uint64_t row_end, int32_t max_len,
                      int32_t* out_ids, int32_t* out_lens) {
  std::vector<int32_t> ids;
  std::string word;
  for (uint64_t row = row_begin; row < row_end; ++row) {
    const uint8_t* p = texts + offsets[row];
    const uint8_t* endp = texts + offsets[row + 1];
    ids.clear();
    ids.push_back(t->cls_id);
    const size_t budget = static_cast<size_t>(max_len) - 1;
    while (p < endp && ids.size() < budget) {
      uint8_t c = *p;
      if (is_ascii_space(c)) {
        ++p;
        continue;
      }
      word.clear();
      if (is_ascii_alnum(c)) {
        while (p < endp && is_ascii_alnum(*p)) {
          uint8_t b = *p++;
          if (t->lowercase && b >= 'A' && b <= 'Z') b += 32;
          word.push_back(static_cast<char>(b));
        }
      } else {
        int len = utf8_len(c);
        for (int i = 0; i < len && p < endp; ++i) word.push_back(static_cast<char>(*p++));
      }
      word_ids(*t, word, ids);
    }
    if (ids.size() > budget) ids.resize(budget);
    ids.push_back(t->sep_id);
    int32_t* dst = out_ids + row * max_len;
    for (int32_t i = 0; i < max_len; ++i)
      dst[i] = i < static_cast<int32_t>(ids.size()) ? ids[i] : t->pad_id;
    out_lens[row] = static_cast<int32_t>(ids.size());
  }
}

}  // namespace

PN_EXPORT void pn_tok_encode_batch(void* tv, const uint8_t* texts,
                                   const uint64_t* offsets, uint64_t n,
                                   int32_t max_len, int32_t* out_ids,
                                   int32_t* out_lens) {
  const Tok* t = static_cast<Tok*>(tv);
  unsigned hw = std::thread::hardware_concurrency();
  uint64_t nt = hw ? (hw < 8 ? hw : 8) : 1;
  if (n < 4096 || nt <= 1) {
    tok_encode_range(t, texts, offsets, 0, n, max_len, out_ids, out_lens);
    return;
  }
  std::vector<std::thread> threads;
  uint64_t chunk = (n + nt - 1) / nt;
  for (uint64_t i = 0; i < nt; ++i) {
    uint64_t b = i * chunk, e = b + chunk < n ? b + chunk : n;
    if (b >= e) break;
    threads.emplace_back(tok_encode_range, t, texts, offsets, b, e, max_len,
                         out_ids, out_lens);
  }
  for (auto& th : threads) th.join();
}

// Shard entry for the collaborative host-ingest stage: encodes rows
// [row_begin, row_end) of a shared blob into a shared matrix. Callers
// (Python threads — ctypes releases the GIL around this call) give each
// worker a disjoint row range, so no synchronization is needed here.
PN_EXPORT void pn_tok_encode_shard(void* tv, const uint8_t* texts,
                                   const uint64_t* offsets, uint64_t row_begin,
                                   uint64_t row_end, int32_t max_len,
                                   int32_t* out_ids, int32_t* out_lens) {
  const Tok* t = static_cast<Tok*>(tv);
  tok_encode_range(t, texts, offsets, row_begin, row_end, max_len, out_ids,
                   out_lens);
}

// ---------------------------------------------------------------------------
// blake2b (RFC 7693), batched keyed 8-byte digests.
//
// Matches python hashlib.blake2b(msg, digest_size=8, key=K) exactly — the
// canonical key derivation of pathway_tpu.engine.value.ref_scalar (the
// reference's seeded key hashing, python_api.rs:3369). Batched so the
// columnar groupby/re-key path hashes a whole delta batch per call.
// ---------------------------------------------------------------------------

namespace {

static const uint64_t B2B_IV[8] = {
    0x6A09E667F3BCC908ULL, 0xBB67AE8584CAA73BULL, 0x3C6EF372FE94F82BULL,
    0xA54FF53A5F1D36F1ULL, 0x510E527FADE682D1ULL, 0x9B05688C2B3E6C1FULL,
    0x1F83D9ABFB41BD6BULL, 0x5BE0CD19137E2179ULL};

static const uint8_t B2B_SIGMA[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3}};

inline uint64_t rotr64(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

inline void b2b_compress(uint64_t h[8], const uint8_t block[128], uint64_t t0,
                         bool last) {
  uint64_t m[16];
  std::memcpy(m, block, 128);  // little-endian host
  uint64_t v[16];
  for (int i = 0; i < 8; ++i) {
    v[i] = h[i];
    v[i + 8] = B2B_IV[i];
  }
  v[12] ^= t0;  // t1 is always 0 at these message sizes
  if (last) v[14] = ~v[14];
#define PN_B2B_G(a, b, c, d, x, y)            \
  v[a] = v[a] + v[b] + (x);                   \
  v[d] = rotr64(v[d] ^ v[a], 32);             \
  v[c] = v[c] + v[d];                         \
  v[b] = rotr64(v[b] ^ v[c], 24);             \
  v[a] = v[a] + v[b] + (y);                   \
  v[d] = rotr64(v[d] ^ v[a], 16);             \
  v[c] = v[c] + v[d];                         \
  v[b] = rotr64(v[b] ^ v[c], 63);
  for (int r = 0; r < 12; ++r) {
    const uint8_t* s = B2B_SIGMA[r];
    PN_B2B_G(0, 4, 8, 12, m[s[0]], m[s[1]]);
    PN_B2B_G(1, 5, 9, 13, m[s[2]], m[s[3]]);
    PN_B2B_G(2, 6, 10, 14, m[s[4]], m[s[5]]);
    PN_B2B_G(3, 7, 11, 15, m[s[6]], m[s[7]]);
    PN_B2B_G(0, 5, 10, 15, m[s[8]], m[s[9]]);
    PN_B2B_G(1, 6, 11, 12, m[s[10]], m[s[11]]);
    PN_B2B_G(2, 7, 8, 13, m[s[12]], m[s[13]]);
    PN_B2B_G(3, 4, 9, 14, m[s[14]], m[s[15]]);
  }
#undef PN_B2B_G
  for (int i = 0; i < 8; ++i) h[i] ^= v[i] ^ v[i + 8];
}

void b2b8_range(const uint8_t* data, const uint64_t* offsets, uint64_t begin,
                uint64_t end, const uint64_t* hkey, uint64_t* out) {
  uint8_t block[128];
  for (uint64_t i = begin; i < end; ++i) {
    const uint8_t* msg = data + offsets[i];
    uint64_t len = offsets[i + 1] - offsets[i];
    uint64_t h[8];
    std::memcpy(h, hkey, sizeof(h));
    uint64_t t = 128;  // key block already consumed
    while (len > 128) {
      t += 128;
      b2b_compress(h, msg, t, false);
      msg += 128;
      len -= 128;
    }
    std::memset(block, 0, 128);
    std::memcpy(block, msg, len);
    b2b_compress(h, block, t + len, true);
    out[i] = h[0];  // first 8 little-endian bytes == h[0]
  }
}

}  // namespace

// Keyed blake2b, digest_size=8, over n variable-length messages laid out in
// `data` at `offsets` (n+1 entries). Empty messages are NOT supported (the
// serialized tuple header is never empty).
PN_EXPORT void pn_blake2b8_batch(const uint8_t* data, const uint64_t* offsets,
                                 uint64_t n, const uint8_t* key,
                                 uint32_t key_len, uint64_t* out) {
  uint64_t h0[8];
  for (int i = 0; i < 8; ++i) h0[i] = B2B_IV[i];
  // param block: digest_len=8, key_len, fanout=1, depth=1
  h0[0] ^= 0x01010000ULL ^ (static_cast<uint64_t>(key_len) << 8) ^ 8ULL;
  uint8_t keyblock[128];
  std::memset(keyblock, 0, 128);
  if (key_len > 128) key_len = 128;
  std::memcpy(keyblock, key, key_len);
  // the key block state is shared by every message: compress it once
  b2b_compress(h0, keyblock, 128, false);
  unsigned hw = std::thread::hardware_concurrency();
  uint64_t nt = hw ? (hw < 8 ? hw : 8) : 1;
  if (n < 16384 || nt <= 1) {
    b2b8_range(data, offsets, 0, n, h0, out);
    return;
  }
  std::vector<std::thread> threads;
  uint64_t chunk = (n + nt - 1) / nt;
  for (uint64_t i = 0; i < nt; ++i) {
    uint64_t b = i * chunk, e = b + chunk < n ? b + chunk : n;
    if (b >= e) break;
    threads.emplace_back(b2b8_range, data, offsets, b, e, h0, out);
  }
  for (auto& th : threads) th.join();
}

PN_EXPORT const char* pn_version() { return "pathway-native 1.0"; }
