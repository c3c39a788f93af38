// Fast BPE tokenizer — native C++ implementation of the reference's
// Tokenizer.encode semantics (main.zig:219-282) for throughput-critical
// serving frontends (SURVEY.md section 2: the host-side native component).
//
// Exact behavioral contract:
//   * input splits into UTF-8 codepoints; each codepoint's bytes must be a
//     vocab token (no <0xXX> byte fallback — unknown codepoint is an error,
//     main.zig:240-242);
//   * repeatedly merge the adjacent pair whose concatenation is in the vocab
//     with the highest score; strict '>' comparison means the lowest pair
//     index wins ties (main.zig:260-266);
//   * duplicate token strings resolve to the FIRST occurrence (the
//     reference's linear scan, main.zig:208-215).
//
// Where the reference linear-scans 32k tokens per candidate pair
// (O(n^2 * V) encode), this uses one hash map lookup per candidate
// (O(n^2) worst case with tiny constants; the README's "binary search" TODO
// at README.md:179, done one better).
//
// C ABI for ctypes; no exceptions across the boundary.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Tokenizer {
  std::vector<std::string> tokens;
  std::vector<float> scores;
  std::unordered_map<std::string, uint32_t> index;  // first occurrence wins
  uint32_t max_token_len = 0;
};

int utf8_len(unsigned char b) {
  if (b < 0x80) return 1;
  if ((b & 0xE0) == 0xC0) return 2;
  if ((b & 0xF0) == 0xE0) return 3;
  if ((b & 0xF8) == 0xF0) return 4;
  return -1;  // invalid leading byte
}

}  // namespace

extern "C" {

// Returns nullptr on failure (file missing / truncated / corrupt).
// No C++ exception may cross this C boundary: allocation sizes read from
// the file are bounded and the body is wrapped so a corrupt input returns
// nullptr instead of std::terminate'ing the host process.
void* l2t_create(const char* path, int32_t vocab_size) try {
  if (vocab_size <= 0) return nullptr;
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  auto* t = new Tokenizer();
  auto fail = [&]() {
    std::fclose(f);
    delete t;
    return nullptr;
  };
  if (std::fread(&t->max_token_len, 4, 1, f) != 1) return fail();
  t->tokens.reserve(vocab_size);
  t->scores.reserve(vocab_size);
  t->index.reserve(vocab_size * 2);
  for (int32_t i = 0; i < vocab_size; ++i) {
    float score;
    uint32_t len;
    if (std::fread(&score, 4, 1, f) != 1) return fail();
    if (std::fread(&len, 4, 1, f) != 1) return fail();
    if (len > (1u << 20)) return fail();  // corrupt length field
    std::string tok(len, '\0');
    if (len && std::fread(tok.data(), 1, len, f) != len) return fail();
    t->scores.push_back(score);
    t->index.emplace(tok, (uint32_t)i);  // emplace keeps the first occurrence
    t->tokens.push_back(std::move(tok));
  }
  std::fclose(f);
  return t;
} catch (...) {
  return nullptr;
}

void l2t_destroy(void* h) { delete static_cast<Tokenizer*>(h); }

int32_t l2t_max_token_len(void* h) {
  return (int32_t) static_cast<Tokenizer*>(h)->max_token_len;
}

int32_t l2t_vocab_size(void* h) {
  return (int32_t) static_cast<Tokenizer*>(h)->tokens.size();
}

// Token text accessor: copies up to cap bytes, returns length.
int32_t l2t_token(void* h, uint32_t id, char* out, int32_t cap) {
  auto* t = static_cast<Tokenizer*>(h);
  if (id >= t->tokens.size()) return -1;
  const std::string& s = t->tokens[id];
  int32_t n = (int32_t)s.size() < cap ? (int32_t)s.size() : cap;
  std::memcpy(out, s.data(), n);
  return (int32_t)s.size();
}

// Exact lookup: token id or -1.
int32_t l2t_lookup(void* h, const char* piece, int32_t len) {
  auto* t = static_cast<Tokenizer*>(h);
  auto it = t->index.find(std::string(piece, len));
  return it == t->index.end() ? -1 : (int32_t)it->second;
}

// Greedy highest-score BPE encode.
// Returns token count, or -1 = unknown codepoint, -2 = out buffer too small,
// -3 = invalid UTF-8.
int32_t l2t_encode(void* h, const char* text, int32_t text_len, uint32_t* out,
                   int32_t out_cap) {
  auto* t = static_cast<Tokenizer*>(h);
  std::vector<uint32_t> ids;
  ids.reserve(text_len);

  // 1. split into codepoints, exact-lookup each
  for (int32_t i = 0; i < text_len;) {
    int n = utf8_len((unsigned char)text[i]);
    if (n < 0 || i + n > text_len) return -3;
    auto it = t->index.find(std::string(text + i, n));
    if (it == t->index.end()) return -1;
    ids.push_back(it->second);
    i += n;
  }

  // 2. greedy merges: best (highest score, lowest index on ties) each round
  std::string cat;
  cat.reserve(2 * t->max_token_len);
  while (ids.size() > 1) {
    float best_score = -1e10f;
    int32_t best_idx = -1;
    uint32_t best_id = 0;
    for (size_t i = 0; i + 1 < ids.size(); ++i) {
      cat.assign(t->tokens[ids[i]]);
      cat.append(t->tokens[ids[i + 1]]);
      auto it = t->index.find(cat);
      if (it != t->index.end() && t->scores[it->second] > best_score) {
        best_score = t->scores[it->second];
        best_id = it->second;
        best_idx = (int32_t)i;
      }
    }
    if (best_idx < 0) break;
    ids[best_idx] = best_id;
    ids.erase(ids.begin() + best_idx + 1);
  }

  if ((int32_t)ids.size() > out_cap) return -2;
  std::memcpy(out, ids.data(), ids.size() * sizeof(uint32_t));
  return (int32_t)ids.size();
}

}  // extern "C"
