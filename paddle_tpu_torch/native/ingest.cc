// Native ingest engine of paddle_tpu_torch: a copy of paddle_tpu's
// native/ingest.cc (the port imports nothing of the JAX package), so the
// same files and seed give the same samples in the same order in both.
// The counterpart of the reference's C++ Dataset/DataFeed stack
// (paddle/fluid/framework/data_set.h:157 InMemoryDataset, data_feed.h:302
// InMemoryDataFeed, MultiSlotDataFeed): multithreaded file-sharded parsing
// into an in-memory sample store, global shuffle, and dense minibatch
// assembly — all off the Python interpreter.
//
// Format: numeric text, one sample per line, fields separated by spaces,
// tabs or commas; every line must have exactly the configured column count
// (fixed width; ragged slots go through the MultiSlot format below).
// Values are stored as float64 so integer ids up to 2^53 round-trip
// exactly.
//
// Exposed as a plain C ABI, loaded with ctypes.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

// Slot value type tags (C ABI): 0 = float32, 1 = int64.
enum SlotType : int64_t { kFloat32 = 0, kInt64 = 1 };

// One typed slot's storage: padded fixed-stride values + true lengths —
// the dense TPU mapping of the reference's ragged MultiSlot LoD columns
// (data_feed.h:302 MultiSlotDataFeed / MultiSlotType).
struct SlotStore {
  SlotType type = kFloat32;
  int64_t max_len = 1;
  std::vector<float> f32;      // nsamples * max_len when type == kFloat32
  std::vector<int64_t> i64;    // nsamples * max_len when type == kInt64
  std::vector<int64_t> lens;   // nsamples true lengths
};

struct Store {
  int64_t ncols = 0;                // dense mode: fixed column count
  std::vector<double> arena;        // dense mode: nsamples * ncols
  std::vector<SlotStore> slots;     // multislot mode (empty in dense mode)
  std::vector<int64_t> order;       // shuffle permutation
  std::string error;                // first error, if any
  bool multislot() const { return !slots.empty(); }
};

// Parse one MultiSlot-format line into per-thread slot parts:
//   <count> v... <count> v... ...   (one group per declared slot; the
// reference DataGenerator emits exactly this).  Returns false on error.
bool ParseMultiSlotLine(const char* p, const std::vector<SlotStore>& schema,
                        std::vector<SlotStore>* parts, const std::string& file,
                        int64_t lineno, std::mutex* err_mu, std::string* err,
                        std::atomic<bool>* failed) {
  auto fail = [&](const std::string& what) {
    std::lock_guard<std::mutex> g(*err_mu);
    if (err->empty())
      *err = file + ":" + std::to_string(lineno) + ": " + what;
    failed->store(true);
    return false;
  };
  auto skip_ws = [&]() {
    while (*p == ' ' || *p == '\t' || *p == ',' || *p == '\r') ++p;
  };
  // hand-rolled base-10 i64: ~3x strtoll at this call density (no locale,
  // no errno); falls back to "unparsable" via the ok flag
  auto parse_i64 = [&](long long* out) -> bool {
    const char* q = p;
    bool neg = false;
    if (*q == '-' || *q == '+') { neg = (*q == '-'); ++q; }
    if (*q < '0' || *q > '9') return false;
    unsigned long long v = 0;
    const unsigned long long lim =
        neg ? 9223372036854775808ULL : 9223372036854775807ULL;
    while (*q >= '0' && *q <= '9') {
      unsigned d = static_cast<unsigned>(*q - '0');
      if (v > (lim - d) / 10) return false;  // would overflow int64: reject
      v = v * 10 + d;
      ++q;
    }
    *out = neg ? -static_cast<long long>(v) : static_cast<long long>(v);
    p = q;
    return true;
  };
  skip_ws();
  if (*p == '\0' || *p == '\n') return true;  // blank line: skip
  for (size_t si = 0; si < schema.size(); ++si) {
    const SlotStore& sc = schema[si];
    SlotStore& out = (*parts)[si];
    skip_ws();
    long long cnt = 0;
    if (!parse_i64(&cnt))
      return fail("expected slot " + std::to_string(si) + " count near '" +
                  std::string(p).substr(0, 16) + "'");
    if (cnt < 0 || cnt > sc.max_len)
      return fail("slot " + std::to_string(si) + " count " +
                  std::to_string(cnt) + " outside [0, " +
                  std::to_string(sc.max_len) + "] (raise max_len or bucket "
                  "upstream)");
    out.lens.push_back(cnt);
    size_t base_f = out.f32.size();
    size_t base_i = out.i64.size();
    if (sc.type == kFloat32)
      out.f32.resize(base_f + sc.max_len, 0.0f);
    else
      out.i64.resize(base_i + sc.max_len, 0);
    for (long long k = 0; k < cnt; ++k) {
      skip_ws();
      if (sc.type == kFloat32) {
        char* fend = nullptr;
        double v = std::strtod(p, &fend);
        if (fend == p)
          return fail("slot " + std::to_string(si) + " value " +
                      std::to_string(k) + " unparsable near '" +
                      std::string(p).substr(0, 16) + "'");
        out.f32[base_f + k] = static_cast<float>(v);
        p = fend;
      } else {
        long long v = 0;
        if (!parse_i64(&v))
          return fail("slot " + std::to_string(si) + " value " +
                      std::to_string(k) + " unparsable near '" +
                      std::string(p).substr(0, 16) + "'");
        out.i64[base_i + k] = static_cast<int64_t>(v);
      }
    }
  }
  skip_ws();
  if (*p != '\0' && *p != '\n')
    return fail(std::string("trailing fields near '") +
                std::string(p).substr(0, 16) + "'");
  return true;
}

// One reader thread over its file share, MultiSlot format.  The whole
// file is read with one fread and parsed by pointer in place — the
// per-line fgets/std::string path costs ~2x in libc overhead at this
// parse density (measured on the micro-bench).
void ParseFilesMultiSlot(const std::vector<std::string>* files, size_t begin,
                         size_t stride, const std::vector<SlotStore>* schema,
                         std::vector<SlotStore>* parts,
                         std::atomic<bool>* failed, std::mutex* err_mu,
                         std::string* err) {
  std::vector<char> buf;
  for (size_t fi = begin; fi < files->size(); fi += stride) {
    if (failed->load(std::memory_order_relaxed)) return;
    FILE* f = std::fopen((*files)[fi].c_str(), "rb");
    if (!f) {
      std::lock_guard<std::mutex> g(*err_mu);
      if (err->empty())
        *err = "cannot open " + (*files)[fi] + ": " + std::strerror(errno);
      failed->store(true);
      return;
    }
    std::fseek(f, 0, SEEK_END);
    long fsz = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    if (fsz < 0) {
      std::fclose(f);
      std::lock_guard<std::mutex> g(*err_mu);
      if (err->empty())
        *err = "cannot size " + (*files)[fi] + ": " + std::strerror(errno);
      failed->store(true);
      return;
    }
    buf.resize(static_cast<size_t>(fsz) + 1);
    size_t got = std::fread(buf.data(), 1, static_cast<size_t>(fsz), f);
    bool short_read = got != static_cast<size_t>(fsz) && std::ferror(f);
    std::fclose(f);
    if (short_read) {
      // a silent truncation here would be silent training-data loss
      std::lock_guard<std::mutex> g(*err_mu);
      if (err->empty())
        *err = "short read on " + (*files)[fi] + ": " + std::strerror(errno);
      failed->store(true);
      return;
    }
    buf[got] = '\0';

    int64_t lineno = 0;
    char* p = buf.data();
    char* end = buf.data() + got;
    bool aborted = false;
    while (p < end) {
      char* nl = static_cast<char*>(std::memchr(p, '\n', end - p));
      if (nl) *nl = '\0';
      ++lineno;
      if (!ParseMultiSlotLine(p, *schema, parts, (*files)[fi], lineno,
                              err_mu, err, failed)) {
        aborted = true;
        break;
      }
      p = nl ? nl + 1 : end;
    }
    if (aborted) return;
  }
}

// One reader thread: parse its share of files into a private arena.
void ParseFiles(const std::vector<std::string>* files, size_t begin,
                size_t stride, int64_t ncols, std::vector<double>* out,
                std::atomic<bool>* failed, std::mutex* err_mu,
                std::string* err) {
  for (size_t fi = begin; fi < files->size(); fi += stride) {
    if (failed->load(std::memory_order_relaxed)) return;
    FILE* f = std::fopen((*files)[fi].c_str(), "r");
    if (!f) {
      std::lock_guard<std::mutex> g(*err_mu);
      if (err->empty())
        *err = "cannot open " + (*files)[fi] + ": " + std::strerror(errno);
      failed->store(true);
      return;
    }

    int64_t lineno = 0;
    auto parse_line = [&](const char* p) -> bool {  // false = abort file
      ++lineno;
      int64_t got = 0;
      bool blank = true;
      while (*p) {
        while (*p == ' ' || *p == '\t' || *p == ',' || *p == '\r') ++p;
        if (*p == '\0' || *p == '\n') break;
        blank = false;
        char* end = nullptr;
        double v = std::strtod(p, &end);
        if (end == p) {
          std::lock_guard<std::mutex> g(*err_mu);
          if (err->empty())
            *err = (*files)[fi] + ":" + std::to_string(lineno) +
                   ": unparsable field near '" +
                   std::string(p).substr(0, 16) + "'";
          failed->store(true);
          return false;
        }
        out->push_back(v);
        ++got;
        p = end;
      }
      if (blank) return true;  // skip empty lines
      if (got != ncols) {
        std::lock_guard<std::mutex> g(*err_mu);
        if (err->empty())
          *err = (*files)[fi] + ":" + std::to_string(lineno) + ": expected " +
                 std::to_string(ncols) + " columns, got " +
                 std::to_string(got);
        failed->store(true);
        return false;
      }
      return true;
    };

    char buf[1 << 16];
    std::string pending;
    bool aborted = false;
    while (std::fgets(buf, sizeof(buf), f)) {
      size_t blen = std::strlen(buf);
      const char* p = buf;
      if (!pending.empty() || (blen + 1 == sizeof(buf) &&
                               buf[blen - 1] != '\n' && !std::feof(f))) {
        // rare path: a line longer than the read buffer
        pending += buf;
        if (pending.back() != '\n' && !std::feof(f)) continue;
        p = pending.c_str();
      }
      if (!parse_line(p)) {
        aborted = true;
        break;
      }
      pending.clear();
    }
    // a final unterminated line can be left in `pending` when its length
    // is an exact multiple of the read buffer (fgets fills the buffer
    // without seeing EOF) — parse it, don't drop it
    if (!aborted && !pending.empty() && !parse_line(pending.c_str()))
      aborted = true;
    std::fclose(f);
    if (aborted) return;
  }
}

}  // namespace

extern "C" {

// Returns an opaque store handle, or 0 on allocation failure.
void* ingest_create(int64_t ncols) {
  if (ncols <= 0) return nullptr;
  Store* s = new (std::nothrow) Store();
  if (!s) return nullptr;
  s->ncols = ncols;
  return s;
}

// Typed multi-slot store (reference MultiSlotDataFeed, data_feed.h:302):
// `types[i]` ∈ {0: float32, 1: int64}; `max_lens[i]` the padded width of
// slot i (variable-length slots pad with zeros; true lengths are kept).
void* ingest_create_multislot(int64_t nslots, const int64_t* types,
                              const int64_t* max_lens) {
  if (nslots <= 0) return nullptr;
  Store* s = new (std::nothrow) Store();
  if (!s) return nullptr;
  s->slots.resize(nslots);
  for (int64_t i = 0; i < nslots; ++i) {
    if ((types[i] != kFloat32 && types[i] != kInt64) || max_lens[i] <= 0) {
      delete s;
      return nullptr;
    }
    s->slots[i].type = static_cast<SlotType>(types[i]);
    s->slots[i].max_len = max_lens[i];
  }
  return s;
}

void ingest_destroy(void* h) { delete static_cast<Store*>(h); }

// Parse `nfiles` paths with `nthreads` workers.  Thread k takes files
// k, k+n, k+2n... (file-sharded, like the reference's per-thread channel
// split, data_set.h filelist distribution).  Appends to the store.
// Returns number of samples loaded, or -1 (check ingest_error).
int64_t ingest_load(void* h, const char** paths, int64_t nfiles,
                    int64_t nthreads) {
  Store* s = static_cast<Store*>(h);
  if (!s) return -1;
  s->error.clear();  // a previous failed load's message must not shadow ours
  std::vector<std::string> files(paths, paths + nfiles);
  if (nthreads < 1) nthreads = 1;
  if (nthreads > nfiles) nthreads = nfiles;
  std::vector<std::thread> workers;
  std::atomic<bool> failed(false);
  std::mutex err_mu;

  if (s->multislot()) {
    int64_t nslots = static_cast<int64_t>(s->slots.size());
    std::vector<std::vector<SlotStore>> parts(
        nthreads, std::vector<SlotStore>(nslots));
    for (int64_t t = 0; t < nthreads; ++t) {
      workers.emplace_back(ParseFilesMultiSlot, &files, t, nthreads,
                           &s->slots, &parts[t], &failed, &err_mu, &s->error);
    }
    for (auto& w : workers) w.join();
    if (failed.load()) return -1;
    int64_t before = static_cast<int64_t>(s->order.size());
    for (int64_t t = 0; t < nthreads; ++t) {
      for (int64_t si = 0; si < nslots; ++si) {
        SlotStore& dst = s->slots[si];
        SlotStore& src = parts[t][si];
        dst.f32.insert(dst.f32.end(), src.f32.begin(), src.f32.end());
        dst.i64.insert(dst.i64.end(), src.i64.begin(), src.i64.end());
        dst.lens.insert(dst.lens.end(), src.lens.begin(), src.lens.end());
        src = SlotStore();
      }
    }
    int64_t n = static_cast<int64_t>(s->slots[0].lens.size());
    s->order.resize(n);
    for (int64_t i = 0; i < n; ++i) s->order[i] = i;
    return n - before;
  }

  std::vector<std::vector<double>> parts(nthreads);
  for (int64_t t = 0; t < nthreads; ++t) {
    workers.emplace_back(ParseFiles, &files, t, nthreads, s->ncols, &parts[t],
                         &failed, &err_mu, &s->error);
  }
  for (auto& w : workers) w.join();
  if (failed.load()) return -1;
  int64_t before = static_cast<int64_t>(s->arena.size()) / s->ncols;
  size_t total = s->arena.size();
  for (auto& p : parts) total += p.size();
  s->arena.reserve(total);
  for (auto& p : parts) {
    s->arena.insert(s->arena.end(), p.begin(), p.end());
    p.clear();
    p.shrink_to_fit();
  }
  int64_t n = static_cast<int64_t>(s->arena.size()) / s->ncols;
  s->order.resize(n);
  for (int64_t i = 0; i < n; ++i) s->order[i] = i;
  return n - before;
}

// Copy up to `count` samples of one slot (shuffle-permuted, like
// ingest_copy_rows) into caller-allocated buffers: `out_values` is
// count*max_len of the slot's dtype (f32 or i64), `out_lens` (optional)
// count int64 true lengths.  Returns rows written.
int64_t ingest_copy_slot(void* h, int64_t slot, int64_t start,
                         int64_t count, void* out_values,
                         int64_t* out_lens) {
  Store* s = static_cast<Store*>(h);
  if (!s || !s->multislot() || slot < 0 ||
      slot >= static_cast<int64_t>(s->slots.size()) || count <= 0 ||
      start < 0)
    return 0;
  const SlotStore& sc = s->slots[slot];
  int64_t n = static_cast<int64_t>(s->order.size());
  int64_t take = n - start;
  if (take <= 0) return 0;
  if (take > count) take = count;
  for (int64_t r = 0; r < take; ++r) {
    int64_t src_row = s->order[start + r];
    if (sc.type == kFloat32) {
      std::memcpy(static_cast<float*>(out_values) + r * sc.max_len,
                  sc.f32.data() + src_row * sc.max_len,
                  sizeof(float) * static_cast<size_t>(sc.max_len));
    } else {
      std::memcpy(static_cast<int64_t*>(out_values) + r * sc.max_len,
                  sc.i64.data() + src_row * sc.max_len,
                  sizeof(int64_t) * static_cast<size_t>(sc.max_len));
    }
    if (out_lens) out_lens[r] = sc.lens[src_row];
  }
  return take;
}

int64_t ingest_size(void* h) {
  Store* s = static_cast<Store*>(h);
  return s ? static_cast<int64_t>(s->order.size()) : -1;
}

const char* ingest_error(void* h) {
  Store* s = static_cast<Store*>(h);
  return s ? s->error.c_str() : "null store";
}

// Fisher–Yates over the sample permutation (the data never moves — the
// reference's global_shuffle also permutes channel order, data_set.h:
// global shuffle path).  The permutation restarts from identity, so a
// given seed yields the same order regardless of prior shuffles.
void ingest_shuffle(void* h, uint64_t seed) {
  Store* s = static_cast<Store*>(h);
  if (!s) return;
  std::mt19937_64 rng(seed);
  int64_t n = static_cast<int64_t>(s->order.size());
  for (int64_t i = 0; i < n; ++i) s->order[i] = i;
  for (int64_t i = n - 1; i > 0; --i) {
    int64_t j = static_cast<int64_t>(rng() % static_cast<uint64_t>(i + 1));
    std::swap(s->order[i], s->order[j]);
  }
}

// Copy up to `count` samples starting at permutation position `start`
// into `out` (count*ncols f64, caller-allocated).  Returns rows written;
// 0 = past the end.  The CALLER owns the cursor — concurrent iterators
// over one store each keep their own position.
int64_t ingest_copy_rows(void* h, double* out, int64_t start, int64_t count) {
  Store* s = static_cast<Store*>(h);
  if (!s || count <= 0 || start < 0) return 0;
  int64_t n = static_cast<int64_t>(s->order.size());
  int64_t take = n - start;
  if (take <= 0) return 0;
  if (take > count) take = count;
  for (int64_t r = 0; r < take; ++r) {
    const double* src = s->arena.data() + s->order[start + r] * s->ncols;
    std::memcpy(out + r * s->ncols, src,
                sizeof(double) * static_cast<size_t>(s->ncols));
  }
  return take;
}

void ingest_clear(void* h) {
  Store* s = static_cast<Store*>(h);
  if (!s) return;
  s->arena.clear();
  s->arena.shrink_to_fit();
  for (auto& sl : s->slots) {
    sl.f32.clear();
    sl.f32.shrink_to_fit();
    sl.i64.clear();
    sl.i64.shrink_to_fit();
    sl.lens.clear();
    sl.lens.shrink_to_fit();
  }
  s->order.clear();
  s->error.clear();
}

}  // extern "C"
