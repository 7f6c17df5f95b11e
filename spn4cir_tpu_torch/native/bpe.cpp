// Native CLIP-BPE encoder: the ASCII fast path of tokenizer/bpe.py.
//
// A copy of spn4cir_tpu/native/bpe.cpp with the same C API, built by
// spn4cir_tpu_torch/tokenizer/native_bpe.py with g++ into build/native/.
// The pure-Python BPE runs on the host for every query dispatch and every
// text batch; this implements the exact pipeline — clean (lowercase +
// whitespace collapse), the CLIP split regex, byte-level BPE with
// end-of-word markers, id lookup — for pure-ASCII inputs (all CIR
// captions); anything outside that contract (bytes >= 0x80, HTML entities,
// literal special tokens) returns NEEDS_FALLBACK and the Python tokenizer
// handles it, so behavior is always byte-identical to tokenizer/bpe.py.
//
// ASCII simplification used here: after lowercasing, every non-space ASCII
// char maps to ITSELF under the GPT-2 byte->unicode table (printable range
// '!'..'~' is identity), so "byte encoding" is a no-op and merge pairs /
// vocab entries containing non-ASCII symbols can never apply.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct PairHash {
  size_t operator()(const std::pair<std::string, std::string>& p) const {
    std::hash<std::string> h;
    return h(p.first) * 1000003u ^ h(p.second);
  }
};

struct Bpe {
  std::unordered_map<std::string, int32_t> encoder;
  std::unordered_map<std::pair<std::string, std::string>, int32_t, PairHash>
      rank;
  std::unordered_map<std::string, std::vector<int32_t>> cache;
  std::mutex cache_mu;
};

constexpr int kNeedsFallback = -1;
constexpr int kUnknownToken = -2;

bool is_ws(char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
         c == '\v';
}
bool is_letter(char c) { return c >= 'a' && c <= 'z'; }
bool is_digit(char c) { return c >= '0' && c <= '9'; }

// BPE-merge one cleaned word (no spaces) into id sequence. Returns false on
// a missing vocab entry (caller falls back to Python).
bool merge_word(Bpe* bpe, const std::string& word,
                std::vector<int32_t>* out) {
  {
    std::lock_guard<std::mutex> lk(bpe->cache_mu);
    auto it = bpe->cache.find(word);
    if (it != bpe->cache.end()) {
      out->insert(out->end(), it->second.begin(), it->second.end());
      return true;
    }
  }
  std::vector<std::string> parts;
  parts.reserve(word.size());
  for (size_t i = 0; i + 1 < word.size(); ++i)
    parts.emplace_back(1, word[i]);
  parts.push_back(std::string(1, word.back()) + "</w>");

  while (parts.size() > 1) {
    int32_t best_rank = INT32_MAX;
    size_t best_i = 0;
    for (size_t i = 0; i + 1 < parts.size(); ++i) {
      auto it = bpe->rank.find({parts[i], parts[i + 1]});
      if (it != bpe->rank.end() && it->second < best_rank) {
        best_rank = it->second;
        best_i = i;
      }
    }
    if (best_rank == INT32_MAX) break;
    // merge every occurrence of the best pair, left to right
    const std::string a = parts[best_i], b = parts[best_i + 1];
    std::vector<std::string> merged;
    merged.reserve(parts.size());
    for (size_t i = 0; i < parts.size();) {
      if (i + 1 < parts.size() && parts[i] == a && parts[i + 1] == b) {
        merged.push_back(a + b);
        i += 2;
      } else {
        merged.push_back(parts[i]);
        i += 1;
      }
    }
    parts.swap(merged);
  }

  std::vector<int32_t> ids;
  ids.reserve(parts.size());
  for (const auto& p : parts) {
    auto it = bpe->encoder.find(p);
    if (it == bpe->encoder.end()) return false;
    ids.push_back(it->second);
  }
  out->insert(out->end(), ids.begin(), ids.end());
  {
    std::lock_guard<std::mutex> lk(bpe->cache_mu);
    bpe->cache.emplace(word, std::move(ids));
  }
  return true;
}

}  // namespace

extern "C" {

// encoder_blob: "token\tid\n" lines; ranks_blob: "a\tb\trank\n" lines.
// Only pure-ASCII entries are passed in by the Python wrapper.
void* bpe_create(const char* encoder_blob, const char* ranks_blob) {
  auto* bpe = new Bpe();
  const char* p = encoder_blob;
  while (*p) {
    const char* tab = strchr(p, '\t');
    const char* nl = strchr(p, '\n');
    if (!tab || !nl || tab > nl) break;
    bpe->encoder.emplace(std::string(p, tab - p),
                         (int32_t)strtol(tab + 1, nullptr, 10));
    p = nl + 1;
  }
  p = ranks_blob;
  while (*p) {
    const char* t1 = strchr(p, '\t');
    const char* nl = strchr(p, '\n');
    if (!t1 || !nl || t1 > nl) break;
    const char* t2 = strchr(t1 + 1, '\t');
    if (!t2 || t2 > nl) break;
    bpe->rank.emplace(
        std::make_pair(std::string(p, t1 - p), std::string(t1 + 1, t2 - t1 - 1)),
        (int32_t)strtol(t2 + 1, nullptr, 10));
    p = nl + 1;
  }
  return bpe;
}

void bpe_destroy(void* h) { delete static_cast<Bpe*>(h); }

// Encode one text. Writes up to max_ids ids into out; returns the TOTAL
// number of BPE ids (which may exceed max_ids — the caller decides how to
// truncate/raise), or kNeedsFallback / kUnknownToken (< 0).
int bpe_encode(void* h, const char* text, int32_t* out, int max_ids) {
  auto* bpe = static_cast<Bpe*>(h);

  // contract check + clean (lowercase, collapse whitespace) in one pass
  std::string s;
  s.reserve(strlen(text));
  bool prev_ws = true;  // leading ws stripped
  for (const unsigned char* p = (const unsigned char*)text; *p; ++p) {
    unsigned char c = *p;
    if (c >= 0x80 || c == '&') return kNeedsFallback;  // unicode / entities
    if (c == '<' && p[1] == '|') return kNeedsFallback;  // special tokens
    if (is_ws((char)c)) {
      if (!prev_ws) s.push_back(' ');
      prev_ws = true;
    } else {
      if (c >= 'A' && c <= 'Z') c = (unsigned char)(c - 'A' + 'a');
      s.push_back((char)c);
      prev_ws = false;
    }
  }
  while (!s.empty() && s.back() == ' ') s.pop_back();

  // split: 's|'t|'re|'ve|'m|'ll|'d | [a-z]+ | [0-9] | [^ws letter digit]+
  std::vector<int32_t> ids;
  size_t i = 0;
  const size_t n = s.size();
  while (i < n) {
    if (s[i] == ' ') {
      ++i;
      continue;
    }
    size_t start = i, end = i;
    if (s[i] == '\'' && i + 1 < n) {
      char c1 = s[i + 1];
      char c2 = i + 2 < n ? s[i + 2] : '\0';
      if (c1 == 's' || c1 == 't' || c1 == 'm' || c1 == 'd')
        end = i + 2;
      else if ((c1 == 'r' && c2 == 'e') || (c1 == 'v' && c2 == 'e') ||
               (c1 == 'l' && c2 == 'l'))
        end = i + 3;
    }
    if (end == i) {
      if (is_letter(s[i])) {
        end = i + 1;
        while (end < n && is_letter(s[end])) ++end;
      } else if (is_digit(s[i])) {
        end = i + 1;  // \p{N} matches ONE digit
      } else {
        end = i + 1;
        while (end < n && !is_ws(s[end]) && !is_letter(s[end]) &&
               !is_digit(s[end]))
          ++end;
      }
    }
    if (!merge_word(bpe, s.substr(start, end - start), &ids))
      return kUnknownToken;
    i = end;
  }

  int total = (int)ids.size();
  int write = total < max_ids ? total : max_ids;
  if (write > 0) memcpy(out, ids.data(), (size_t)write * sizeof(int32_t));
  return total;
}

// Encode n texts in ONE call: amortizes the FFI round-trip (~the dominant
// cost at caption scale) and distributes rows over worker threads — the
// batch entry point for dataset iterators / bank extraction, which tokenize
// thousands of captions at a time.
//
// texts: concatenated NUL-terminated strings; offsets[i] = byte offset of
// text i within it. out is (n, max_ids) row-major; lens[i] receives
// bpe_encode's per-text result (total ids, possibly > max_ids, or
// kNeedsFallback / kUnknownToken). n_threads <= 0 picks the hardware
// concurrency (capped at 16 and at n).
void bpe_encode_batch(void* h, const char* texts, const int64_t* offsets,
                      int n, int32_t* out, int32_t* lens, int max_ids,
                      int n_threads) {
  if (n <= 0) return;
  int workers = n_threads > 0 ? n_threads
                              : (int)std::thread::hardware_concurrency();
  // thread spawn+join costs tens of us — more than encoding a small batch
  // of cached captions. Keep >= 32 rows per worker so serving-sized
  // micro-batches (a few dozen captions) stay on the calling thread.
  workers = std::max(1, std::min({workers, n / 32, 16}));

  std::atomic<int> next{0};
  auto run = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1))
      lens[i] = bpe_encode(h, texts + offsets[i],
                           out + (size_t)i * max_ids, max_ids);
  };
  if (workers == 1) {
    run();
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(workers);
  for (int w = 0; w < workers; ++w) pool.emplace_back(run);
  for (auto& t : pool) t.join();
}

}  // extern "C"
