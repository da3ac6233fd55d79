// Native CLIP BPE tokenizer core (ASCII fast path) of the PyTorch port.
//
// A copy of fashionern_aaai2024_tpu/native/fasttokenizer.cpp, kept in the
// port so that the port reads nothing of the JAX package. It mirrors
// models/clip/tokenizer.py::SimpleTokenizer.encode exactly for texts
// whose bytes are all printable ASCII (0x20..0x7E) or ASCII whitespace,
// containing no '&' (HTML entities) and no "<|" (special-token
// literals); everything else returns FT_FALLBACK and the Python
// tokenizer encodes that row. On the fast path the GPT-2 byte<->unicode
// map is the identity, the CLIP split reduces to a linear scan
// (contractions / [a-z]+ / single digit / punctuation runs), and BPE runs
// on interned token pieces with a per-handle memoization cache. Calls
// release the GIL (ctypes), so a multi-threaded serving host tokenizes
// in parallel.

#include <cstdint>
#include <cstring>
#include <mutex>
#include <shared_mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr int FT_OK = 0;
constexpr int FT_FALLBACK = 1;

struct PairHash {
  size_t operator()(const std::pair<std::string, std::string>& p) const {
    std::hash<std::string> h;
    return h(p.first) * 1000003u ^ h(p.second);
  }
};

struct Tokenizer {
  std::unordered_map<std::string, int32_t> encoder;
  std::unordered_map<std::pair<std::string, std::string>, int32_t, PairHash>
      ranks;
  int32_t sot = 0, eot = 0;
  // token -> encoded id sequence (memoized BPE results)
  std::unordered_map<std::string, std::vector<int32_t>> cache;
  std::shared_mutex cache_mu;
};

// GPT-2/CLIP bytes_to_unicode: the printable ranges map to themselves,
// every other byte b maps to codepoint 256+n in gap order. Vocab ids
// follow the PYTHON DICT'S INSERTION ORDER (printable ranges first,
// then the gap bytes ascending) — `vocab = list(byte_encoder.values())`
// in the Python twin — so `ordered` preserves that order here; ids must
// line up exactly with the Python encoder.
void bytes_to_unicode(std::vector<std::string>& ordered) {
  std::vector<int> bs;
  for (int b = 0x21; b <= 0x7E; ++b) bs.push_back(b);
  for (int b = 0xA1; b <= 0xAC; ++b) bs.push_back(b);
  for (int b = 0xAE; b <= 0xFF; ++b) bs.push_back(b);
  bool direct[256] = {false};
  for (int b : bs) direct[b] = true;
  std::vector<int> cs = bs;
  int n = 0;
  for (int b = 0; b < 256; ++b) {
    if (!direct[b]) {
      bs.push_back(b);
      cs.push_back(256 + n++);
    }
  }
  ordered.resize(256);
  for (size_t i = 0; i < bs.size(); ++i) {
    int cp = cs[i];
    std::string s;
    if (cp < 0x80) {
      s.push_back(static_cast<char>(cp));
    } else {  // all cps here are < 0x800 -> 2-byte UTF-8
      s.push_back(static_cast<char>(0xC0 | (cp >> 6)));
      s.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    }
    ordered[i] = s;
  }
}

std::vector<int32_t> bpe_ids(Tokenizer* t, const std::string& token) {
  {
    std::shared_lock<std::shared_mutex> rd(t->cache_mu);
    auto it = t->cache.find(token);
    if (it != t->cache.end()) return it->second;
  }
  // word = chars of token, last char suffixed with </w>  (the Python
  // twin: tuple(token[:-1]) + (token[-1] + "</w>",))
  std::vector<std::string> word;
  for (size_t i = 0; i + 1 < token.size(); ++i)
    word.emplace_back(1, token[i]);
  word.push_back(std::string(1, token.back()) + "</w>");

  while (word.size() > 1) {
    // lowest-rank bigram present in the word
    int32_t best_rank = INT32_MAX;
    std::pair<std::string, std::string> best;
    for (size_t i = 0; i + 1 < word.size(); ++i) {
      auto it = t->ranks.find({word[i], word[i + 1]});
      if (it != t->ranks.end() && it->second < best_rank) {
        best_rank = it->second;
        best = it->first;
      }
    }
    if (best_rank == INT32_MAX) break;
    // merge every (first, second) adjacency, Python-index-scan order
    std::vector<std::string> merged;
    size_t i = 0;
    while (i < word.size()) {
      size_t j = i;
      while (j < word.size() && word[j] != best.first) ++j;
      for (size_t k = i; k < j; ++k) merged.push_back(word[k]);
      if (j >= word.size()) break;
      i = j;
      if (i + 1 < word.size() && word[i + 1] == best.second) {
        merged.push_back(best.first + best.second);
        i += 2;
      } else {
        merged.push_back(word[i]);
        i += 1;
      }
    }
    word.swap(merged);
  }

  std::vector<int32_t> ids;
  ids.reserve(word.size());
  for (const auto& piece : word) {
    auto it = t->encoder.find(piece);
    if (it == t->encoder.end()) return {};  // signals fallback
    ids.push_back(it->second);
  }
  std::unique_lock<std::shared_mutex> wr(t->cache_mu);
  t->cache.emplace(token, ids);
  return ids;
}

inline bool is_lower(char c) { return c >= 'a' && c <= 'z'; }
inline bool is_digit(char c) { return c >= '0' && c <= '9'; }
inline bool is_space(char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\v' ||
         c == '\f';
}

// contraction suffixes in the CLIP regex's alternation order
const char* kContractions[] = {"s", "t", "re", "ve", "m", "ll", "d"};

}  // namespace

extern "C" {

// merges blob: n_merges lines of "first second\n" (UTF-8), exactly the
// slice SimpleTokenizer uses. Returns an opaque handle (never fails on
// well-formed input; malformed lines are skipped like the Python twin).
void* ft_create(const char* blob, int64_t blob_len) {
  auto* t = new Tokenizer();
  std::vector<std::string> byte_tok;
  bytes_to_unicode(byte_tok);

  int32_t next_id = 0;
  for (int b = 0; b < 256; ++b) t->encoder.emplace(byte_tok[b], next_id++);
  for (int b = 0; b < 256; ++b)
    t->encoder.emplace(byte_tok[b] + "</w>", next_id++);

  const char* p = blob;
  const char* end = blob + blob_len;
  int32_t rank = 0;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* line_end = nl ? nl : end;
    const char* sp = static_cast<const char*>(memchr(p, ' ', line_end - p));
    if (sp && sp > p && sp + 1 < line_end) {
      std::string first(p, sp - p);
      std::string second(sp + 1, line_end - (sp + 1));
      t->ranks.emplace(std::make_pair(first, second), rank++);
      t->encoder.emplace(first + second, next_id++);
    }
    p = nl ? nl + 1 : end;
  }
  t->sot = next_id++;
  t->eot = next_id++;
  t->encoder.emplace("<|startoftext|>", t->sot);
  t->encoder.emplace("<|endoftext|>", t->eot);
  return t;
}

void ft_destroy(void* h) { delete static_cast<Tokenizer*>(h); }

int32_t ft_sot(void* h) { return static_cast<Tokenizer*>(h)->sot; }
int32_t ft_eot(void* h) { return static_cast<Tokenizer*>(h)->eot; }

// Encode one text into out[0..context_length): [SOT] ids [EOT],
// truncated with the final slot forced to EOT, zero-padded. Returns
// FT_OK or FT_FALLBACK (caller must use the Python tokenizer).
int ft_encode(void* h, const char* text, int64_t text_len,
              int32_t* out, int32_t context_length) {
  auto* t = static_cast<Tokenizer*>(h);

  // fast-path gate: printable ASCII, no entities, no special tokens
  for (int64_t i = 0; i < text_len; ++i) {
    unsigned char c = text[i];
    bool ws = is_space(static_cast<char>(c));
    if ((c < 0x20 && !ws) || c > 0x7E || c == '&') return FT_FALLBACK;
    if (c == '<' && i + 1 < text_len && text[i + 1] == '|') return FT_FALLBACK;
  }

  // basic_clean (no entities -> unescape is identity) + strip +
  // whitespace_clean + lower, fused into one pass
  std::string s;
  s.reserve(text_len);
  bool pending_space = false;
  for (int64_t i = 0; i < text_len; ++i) {
    char c = text[i];
    if (is_space(c)) {
      pending_space = !s.empty();
      continue;
    }
    if (pending_space) s.push_back(' ');
    pending_space = false;
    if (c >= 'A' && c <= 'Z') c = static_cast<char>(c - 'A' + 'a');
    s.push_back(c);
  }

  std::vector<int32_t> ids;
  ids.push_back(t->sot);
  size_t i = 0;
  const size_t n = s.size();
  while (i < n) {
    char c = s[i];
    if (c == ' ') { ++i; continue; }
    size_t start = i;
    if (c == '\'') {
      bool contraction = false;
      for (const char* suf : kContractions) {
        size_t len = strlen(suf);
        if (i + 1 + len <= n && memcmp(s.data() + i + 1, suf, len) == 0) {
          i += 1 + len;
          contraction = true;
          break;
        }
      }
      if (!contraction) {  // punctuation run starting at '
        while (i < n && s[i] != ' ' && !is_lower(s[i]) && !is_digit(s[i]))
          ++i;
      }
    } else if (is_lower(c)) {
      while (i < n && is_lower(s[i])) ++i;
    } else if (is_digit(c)) {
      ++i;  // [\p{N}] matches a single digit
    } else {
      while (i < n && s[i] != ' ' && !is_lower(s[i]) && !is_digit(s[i]))
        ++i;
    }
    // ASCII printable: byte_encoder is the identity on this range
    std::vector<int32_t> piece = bpe_ids(t, s.substr(start, i - start));
    if (piece.empty()) return FT_FALLBACK;  // unknown piece (foreign table)
    ids.insert(ids.end(), piece.begin(), piece.end());
  }
  ids.push_back(t->eot);

  if (static_cast<int32_t>(ids.size()) > context_length) {
    ids.resize(context_length);
    ids.back() = t->eot;
  }
  memset(out, 0, sizeof(int32_t) * context_length);
  memcpy(out, ids.data(), sizeof(int32_t) * ids.size());
  return FT_OK;
}

// Batch form: texts as one concatenated UTF-8 buffer with offsets
// (offsets[i]..offsets[i+1]); writes out[i*context_length ...] and
// rc[i] = FT_OK / FT_FALLBACK per text.
void ft_encode_batch(void* h, const char* buf, const int64_t* offsets,
                     int32_t n_texts, int32_t* out, int32_t context_length,
                     int8_t* rc) {
  for (int32_t i = 0; i < n_texts; ++i) {
    rc[i] = static_cast<int8_t>(
        ft_encode(h, buf + offsets[i], offsets[i + 1] - offsets[i],
                  out + static_cast<int64_t>(i) * context_length,
                  context_length));
  }
}

}  // extern "C"
