// Native default-mode oracle engine (engine A): byte-exact, stream-order-
// exact reimplementation of oracle/engines.py::process_word — the
// reference's primary path (recursive DFS, longest-key-first probes,
// scan resumes past replacement text, min==0 bumped to 1 by the CALLER'S
// contract being preserved here too).  The Python oracle remains the
// parity anchor; tests/test_torch_native.py pins this engine byte-for-byte
// against it (including duplicate multiplicity, Q7).
//
// C ABI + ctypes (no pybind11 in this environment); output streams
// through a chunk callback so candidate floods never materialize in one
// allocation.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

struct SvHash {
  using is_transparent = void;
  size_t operator()(std::string_view sv) const noexcept {
    return std::hash<std::string_view>{}(sv);
  }
  size_t operator()(const std::string& s) const noexcept {
    return std::hash<std::string_view>{}(std::string_view(s));
  }
};

struct Table {
  std::unordered_map<std::string, std::vector<std::string>, SvHash,
                     std::equal_to<>>
      map;
  // Keys in ascending byte order (== Python sorted(bytes)) — the
  // substitute-all engines enumerate and cascade in this order (Q4
  // canonicalization, mirroring engines.unique_patterns_in_word).
  std::vector<std::string> sorted_keys;
  size_t kmax = 0;
};

// Returns 0 to continue, nonzero to abort the enumeration (the Python
// side uses this to surface sink exceptions — ctypes callbacks cannot
// raise through the C frame, so a swallowed BrokenPipeError would
// otherwise run the whole candidate space and report success).
typedef int32_t (*a5_sink_fn)(const uint8_t* data, int64_t len, void* ctx);

struct Emit {
  std::string out;
  size_t chunk;
  a5_sink_fn sink;
  void* uctx;
  int64_t count = 0;
  bool aborted = false;

  void ship() {
    if (sink(reinterpret_cast<const uint8_t*>(out.data()),
             static_cast<int64_t>(out.size()), uctx) != 0)
      aborted = true;
    out.clear();
  }
  void line(const std::string& cand) {
    out.append(cand);
    out.push_back('\n');
    ++count;
    if (out.size() >= chunk) ship();
  }
  void flush() {
    if (!out.empty() && !aborted) ship();
  }
};

// Mirrors engines.process_word's inner generate(): for each position from
// `start`, probe key lengths longest-first; on a match splice each option,
// emit when the count is in [min, max], and recurse past the replacement.
void generate(const Table& t, Emit& e, const std::string& current, int count,
              size_t start, int min_sub, int max_sub) {
  if (e.aborted) return;
  const size_t n = current.size();
  for (size_t i = start; i < n; ++i) {
    size_t maxkl = n - i < t.kmax ? n - i : t.kmax;
    for (size_t kl = maxkl; kl >= 1; --kl) {
      auto it = t.map.find(std::string_view(current).substr(i, kl));
      if (it == t.map.end()) continue;
      for (const std::string& sub : it->second) {
        int nc = count + 1;
        if (nc > max_sub) continue;
        std::string nw;
        nw.reserve(n - kl + sub.size());
        nw.append(current, 0, i);
        nw.append(sub);
        nw.append(current, i + kl, n - i - kl);
        if (nc >= min_sub) e.line(nw);
        generate(t, e, nw, nc, i + sub.size(), min_sub, max_sub);
        if (e.aborted) return;
      }
    }
  }
}

// Python bytes.replace semantics, including the empty-pattern case
// (b"abc".replace(b"", b"X") == b"XaXbXcX") — the oracle engines' spec is
// the PYTHON anchor, which canonicalizes the reference's Go behavior.
std::string replace_all(const std::string& s, const std::string& pat,
                        const std::string& rep) {
  std::string out;
  if (pat.empty()) {
    out.reserve(s.size() + (s.size() + 1) * rep.size());
    out.append(rep);
    for (char c : s) {
      out.push_back(c);
      out.append(rep);
    }
    return out;
  }
  out.reserve(s.size());
  size_t pos = 0;
  while (true) {
    size_t hit = s.find(pat, pos);
    if (hit == std::string::npos) {
      out.append(s, pos, s.size() - pos);
      return out;
    }
    out.append(s, pos, hit - pos);
    out.append(rep);
    pos = hit + pat.size();
  }
}

struct SuballCtx {
  const std::string* word;
  const std::vector<const std::string*>* patterns;  // sorted, present
  const std::vector<const std::vector<std::string>*>* options;
  std::vector<const std::string*> chosen;  // per pattern, null = skip
  int min_sub, max_sub;
  Emit* e;
};

// Mirrors engines.process_word_substitute_all's generate(): options
// first (in table order), then skip; leaf emits the sorted-order
// ReplaceAll cascade when the chosen count is in [min, max].
void gen_suball(SuballCtx& c, size_t pos, int count) {
  if (c.e->aborted) return;
  if (pos >= c.patterns->size()) {
    if (count >= c.min_sub && count <= c.max_sub) {
      std::string result = *c.word;
      for (size_t p = 0; p < c.patterns->size(); ++p) {
        if (c.chosen[p] != nullptr)
          result = replace_all(result, *(*c.patterns)[p], *c.chosen[p]);
      }
      c.e->line(result);
    }
    return;
  }
  // Prune option branches that already exceed the window: count never
  // decreases along a path, so such subtrees cannot emit (identical
  // output to the unpruned Python anchor, exponentially less dead work
  // for tight windows over many patterns).
  if (count + 1 <= c.max_sub) {
    for (const std::string& sub : *(*c.options)[pos]) {
      c.chosen[pos] = &sub;
      gen_suball(c, pos + 1, count + 1);
      if (c.e->aborted) return;
    }
  }
  c.chosen[pos] = nullptr;
  gen_suball(c, pos + 1, count);
}

// Mirrors engines.process_word_substitute_all_reverse's
// generate_subsets(): emit the current subset when in-window, then
// remove each still-chosen pattern from `pos` upward and recurse —
// every subset visited exactly once, full set first.
struct SuballRevCtx {
  const std::string* word;
  const std::vector<const std::string*>* patterns;  // sorted, present
  const std::vector<const std::string*>* first_opt;  // per pattern or null
  std::vector<char> chosen;
  int min_sub, max_sub;
  Emit* e;
};

void gen_suball_rev(SuballRevCtx& c, size_t pos, int count) {
  if (c.e->aborted) return;
  if (count < c.min_sub) return;
  if (count <= c.max_sub) {
    std::string result = *c.word;
    for (size_t p = 0; p < c.patterns->size(); ++p) {
      if (c.chosen[p])
        result = replace_all(result, *(*c.patterns)[p], *(*c.first_opt)[p]);
    }
    c.e->line(result);
  }
  if (count <= c.min_sub) return;
  for (size_t i = pos; i < c.patterns->size(); ++i) {
    if (!c.chosen[i]) continue;
    c.chosen[i] = 0;
    gen_suball_rev(c, i + 1, count - 1);
    c.chosen[i] = 1;
    if (c.e->aborted) return;
  }
}

}  // namespace

extern "C" {

int32_t a5_oracle_abi() { return 4; }

// Flattened table: nk keys (keys_blob + key_lens), each key's options are
// value rows [val_start[k], val_start[k+1]) into (vals_blob + val_lens).
void* a5_oracle_table_new(const uint8_t* keys_blob, const int32_t* key_lens,
                          int32_t nk, const uint8_t* vals_blob,
                          const int32_t* val_lens,
                          const int32_t* val_start) {
  Table* t = new Table();
  std::vector<int64_t> voff(1, 0);
  int32_t nv = val_start[nk];
  for (int32_t v = 0; v < nv; ++v) voff.push_back(voff.back() + val_lens[v]);
  int64_t koff = 0;
  for (int32_t k = 0; k < nk; ++k) {
    std::string key(reinterpret_cast<const char*>(keys_blob) + koff,
                    static_cast<size_t>(key_lens[k]));
    koff += key_lens[k];
    std::vector<std::string> vals;
    for (int32_t v = val_start[k]; v < val_start[k + 1]; ++v) {
      vals.emplace_back(reinterpret_cast<const char*>(vals_blob) + voff[v],
                        static_cast<size_t>(val_lens[v]));
    }
    if (key.size() > t->kmax) t->kmax = key.size();
    t->sorted_keys.push_back(key);
    t->map.emplace(std::move(key), std::move(vals));
  }
  std::sort(t->sorted_keys.begin(), t->sorted_keys.end());
  return t;
}

void a5_oracle_table_free(void* table) { delete static_cast<Table*>(table); }

// Default engine over one word; candidates stream through `sink` as
// newline-terminated chunks (<= chunk_bytes + one candidate each).
// Returns the candidate count.  min==0 is bumped to 1 (Q1), matching
// engines.process_word.
int64_t a5_oracle_process_word(void* table, const uint8_t* word, int32_t wlen,
                               int32_t min_sub, int32_t max_sub,
                               int64_t chunk_bytes, a5_sink_fn sink,
                               void* ctx) {
  const Table& t = *static_cast<Table*>(table);
  if (min_sub == 0) min_sub = 1;
  Emit e{std::string(), static_cast<size_t>(chunk_bytes), sink, ctx};
  e.out.reserve(static_cast<size_t>(chunk_bytes) + 256);
  std::string w(reinterpret_cast<const char*>(word),
                static_cast<size_t>(wlen));
  if (t.kmax > 0) generate(t, e, w, 0, 0, min_sub, max_sub);
  e.flush();
  return e.count;
}

// Substitute-all engine over one word (engine C,
// engines.process_word_substitute_all): per unique PRESENT pattern
// (ascending byte order), choose one option or skip; leaves in-window
// emit the sorted-order ReplaceAll cascade.  No Q1 bump here — suball
// emits the original word at min == 0.
int64_t a5_oracle_suball_word(void* table, const uint8_t* word, int32_t wlen,
                              int32_t min_sub, int32_t max_sub,
                              int64_t chunk_bytes, a5_sink_fn sink,
                              void* ctx) {
  const Table& t = *static_cast<Table*>(table);
  Emit e{std::string(), static_cast<size_t>(chunk_bytes), sink, ctx};
  e.out.reserve(static_cast<size_t>(chunk_bytes) + 256);
  std::string w(reinterpret_cast<const char*>(word),
                static_cast<size_t>(wlen));
  // Present patterns, sorted (mirrors unique_patterns_in_word: an empty
  // key matches any non-empty word).
  std::vector<const std::string*> patterns;
  std::vector<const std::vector<std::string>*> options;
  for (const std::string& k : t.sorted_keys) {
    bool present = k.empty() ? !w.empty() : w.find(k) != std::string::npos;
    if (!present) continue;
    patterns.push_back(&k);
    options.push_back(&t.map.find(std::string_view(k))->second);
  }
  SuballCtx c{&w, &patterns, &options,
              std::vector<const std::string*>(patterns.size(), nullptr),
              min_sub, max_sub, &e};
  gen_suball(c, 0, 0);
  e.flush();
  return e.count;
}

// Substitute-all REVERSE engine (engine D,
// engines.process_word_substitute_all_reverse): start from every present
// pattern substituted with its FIRST option (Q2) and enumerate subsets
// down to the window floor.
int64_t a5_oracle_suball_reverse_word(void* table, const uint8_t* word,
                                      int32_t wlen, int32_t min_sub,
                                      int32_t max_sub, int64_t chunk_bytes,
                                      a5_sink_fn sink, void* ctx) {
  const Table& t = *static_cast<Table*>(table);
  Emit e{std::string(), static_cast<size_t>(chunk_bytes), sink, ctx};
  e.out.reserve(static_cast<size_t>(chunk_bytes) + 256);
  std::string w(reinterpret_cast<const char*>(word),
                static_cast<size_t>(wlen));
  std::vector<const std::string*> patterns;
  std::vector<const std::string*> first_opt;
  for (const std::string& k : t.sorted_keys) {
    bool present = k.empty() ? !w.empty() : w.find(k) != std::string::npos;
    if (!present) continue;
    patterns.push_back(&k);
    const auto& opts = t.map.find(std::string_view(k))->second;
    first_opt.push_back(opts.empty() ? nullptr : &opts[0]);
  }
  // Mirrors the Python early-return: fewer PRESENT patterns than the
  // window floor emits nothing (optionless patterns still count here).
  if (static_cast<int>(patterns.size()) >= min_sub) {
    int count0 = 0;
    std::vector<char> chosen(patterns.size(), 0);
    for (size_t p = 0; p < patterns.size(); ++p) {
      if (first_opt[p] != nullptr) {
        chosen[p] = 1;
        ++count0;
      }
    }
    SuballRevCtx c{&w, &patterns, &first_opt, std::move(chosen),
                   min_sub, max_sub, &e};
    gen_suball_rev(c, 0, count0);
  }
  e.flush();
  return e.count;
}

}  // extern "C"
