// CLIP BPE tokenizer — native core.
//
// C++ twin of sparsify_clip_tpu/text/tokenizer.py (the behavioral
// golden; parity-tested against it).  The reference stack's tokenizer
// throughput relies on HF's native `tokenizers` crate being installed
// (reference environment.yml:206) while its live path tokenizes
// per-step on the Python main thread (sparsify_clip.py:762) — this
// library gives the data-plane a native encoder with a C ABI consumed
// via ctypes (no pybind11 dependency).
//
// Scope: exact parity with the Python implementation for ASCII text
// (COCO captions).  Non-ASCII input is handled byte-level (grouped as
// punctuation runs), which diverges from the `regex` module's Unicode
// letter classes; the Python tokenizer remains the reference for
// non-ASCII.
//
// Build: see native/tokenizer/Makefile (g++ -O2 -shared -fPIC).

#include <cstdint>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kVocabSize = 49408;
constexpr int kSotId = kVocabSize - 2;
constexpr int kEotId = kVocabSize - 1;

// GPT-2 byte -> visible unicode codepoint map.  `ordered` receives the
// mapped strings in the canonical insertion order (the vocab index
// order of the Python golden's dict); `out` maps raw byte -> string.
static void byte_to_unicode_init(std::string out[256],
                                 std::vector<std::string>* ordered) {
  std::vector<int> bs;
  for (int b = '!'; b <= '~'; ++b) bs.push_back(b);
  for (int b = 0xA1; b <= 0xAC; ++b) bs.push_back(b);
  for (int b = 0xAE; b <= 0xFF; ++b) bs.push_back(b);
  std::vector<bool> present(256, false);
  std::vector<int> cs = bs;
  for (int b : bs) present[b] = true;
  int n = 0;
  for (int b = 0; b < 256; ++b) {
    if (!present[b]) {
      bs.push_back(b);
      cs.push_back(256 + n);
      ++n;
    }
  }
  auto encode_utf8 = [](int cp) {
    std::string s;
    if (cp < 0x80) {
      s.push_back(static_cast<char>(cp));
    } else if (cp < 0x800) {
      s.push_back(static_cast<char>(0xC0 | (cp >> 6)));
      s.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    } else {
      s.push_back(static_cast<char>(0xE0 | (cp >> 12)));
      s.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
      s.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    }
    return s;
  };
  ordered->clear();
  ordered->reserve(256);
  for (size_t i = 0; i < bs.size(); ++i) {
    std::string s = encode_utf8(cs[i]);
    out[bs[i]] = s;
    ordered->push_back(std::move(s));
  }
}

struct PairHash {
  size_t operator()(const std::pair<std::string, std::string>& p) const {
    return std::hash<std::string>()(p.first) * 31 ^ std::hash<std::string>()(p.second);
  }
};

struct Tokenizer {
  std::string byte_enc[256];
  std::unordered_map<std::string, int> encoder;
  std::unordered_map<std::pair<std::string, std::string>, int, PairHash> ranks;
  std::unordered_map<std::string, std::vector<int>> cache;

  explicit Tokenizer(const char* merges_path) {
    std::vector<std::string> ordered;
    byte_to_unicode_init(byte_enc, &ordered);
    std::vector<std::string> vocab;
    vocab.reserve(kVocabSize);
    for (const auto& s : ordered) vocab.push_back(s);
    for (const auto& s : ordered) vocab.push_back(s + "</w>");

    if (merges_path && *merges_path) {
      std::ifstream in(merges_path);
      if (in) {
        std::string line;
        std::getline(in, line);  // header
        int count = 0;
        const int max_merges = kVocabSize - 512 - 2;  // 48894
        while (count < max_merges && std::getline(in, line)) {
          if (line.empty()) continue;
          auto sp = line.find(' ');
          if (sp == std::string::npos) continue;
          std::string a = line.substr(0, sp), b = line.substr(sp + 1);
          if (!b.empty() && b.back() == '\r') b.pop_back();
          ranks.emplace(std::make_pair(a, b), count);
          vocab.push_back(a + b);
          ++count;
        }
      }
    }
    for (size_t i = 0; i < vocab.size(); ++i) encoder.emplace(vocab[i], static_cast<int>(i));
  }

  // BPE merge loop on a pretoken already mapped through byte_enc,
  // split into per-byte unicode strings with </w> on the last.
  std::vector<int> bpe(const std::string& mapped, std::vector<std::string> word) {
    auto it = cache.find(mapped);
    if (it != cache.end()) return it->second;
    if (word.empty()) return {};
    word.back() += "</w>";

    while (word.size() > 1) {
      int best_rank = INT32_MAX;
      size_t best_i = 0;
      for (size_t i = 0; i + 1 < word.size(); ++i) {
        auto r = ranks.find(std::make_pair(word[i], word[i + 1]));
        if (r != ranks.end() && r->second < best_rank) {
          best_rank = r->second;
          best_i = i;
        }
      }
      if (best_rank == INT32_MAX) break;
      // merge every occurrence of this bigram, left to right
      std::vector<std::string> merged;
      const std::string& a = word[best_i];
      const std::string& b = word[best_i + 1];
      for (size_t i = 0; i < word.size();) {
        if (i + 1 < word.size() && word[i] == a && word[i + 1] == b) {
          merged.push_back(a + b);
          i += 2;
        } else {
          merged.push_back(word[i]);
          i += 1;
        }
      }
      word.swap(merged);
    }

    std::vector<int> ids;
    ids.reserve(word.size());
    for (const auto& tok : word) {
      auto e = encoder.find(tok);
      if (e != encoder.end()) ids.push_back(e->second);
    }
    cache.emplace(mapped, ids);
    return ids;
  }

  void encode_pretoken(const std::string& pre, std::vector<int>* out) {
    std::string mapped;
    std::vector<std::string> units;
    units.reserve(pre.size());
    for (unsigned char c : pre) {
      mapped += byte_enc[c];
      units.push_back(byte_enc[c]);
    }
    auto ids = bpe(mapped, std::move(units));
    out->insert(out->end(), ids.begin(), ids.end());
  }

  // Pretokenizer: the CLIP pattern for ASCII — contractions, letter
  // runs, single digits, punctuation runs (whitespace separates).
  void encode(const std::string& raw, std::vector<int>* out) {
    // lowercase + whitespace collapse
    std::string text;
    text.reserve(raw.size());
    bool in_space = true;
    for (unsigned char c : raw) {
      if (c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' || c == '\v') {
        if (!in_space && !text.empty()) text.push_back(' ');
        in_space = true;
      } else {
        text.push_back(static_cast<char>(std::tolower(c)));
        in_space = false;
      }
    }
    while (!text.empty() && text.back() == ' ') text.pop_back();

    auto is_letter = [](unsigned char c) { return (c >= 'a' && c <= 'z') || c >= 0x80; };
    auto is_digit = [](unsigned char c) { return c >= '0' && c <= '9'; };

    size_t i = 0;
    const size_t n = text.size();
    static const char* kContractions[] = {"'s", "'t", "'re", "'ve", "'m", "'ll", "'d"};
    while (i < n) {
      unsigned char c = text[i];
      if (c == ' ') { ++i; continue; }
      // contractions
      if (c == '\'') {
        bool matched = false;
        for (const char* suf : kContractions) {
          size_t len = std::strlen(suf);
          if (n - i >= len && text.compare(i, len, suf) == 0) {
            // must not be followed by more letters (regex longest-match
            // behavior: 're beats 'r + e only when pattern order says so;
            // the python pattern tries contractions before letter runs)
            encode_pretoken(text.substr(i, len), out);
            i += len;
            matched = true;
            break;
          }
        }
        if (matched) continue;
      }
      if (is_letter(c)) {
        size_t j = i;
        while (j < n && is_letter(static_cast<unsigned char>(text[j]))) ++j;
        encode_pretoken(text.substr(i, j - i), out);
        i = j;
        continue;
      }
      if (is_digit(c)) {  // single digit per the pattern
        encode_pretoken(text.substr(i, 1), out);
        ++i;
        continue;
      }
      // punctuation run: [^\s letters digits]+
      size_t j = i;
      while (j < n) {
        unsigned char d = text[j];
        if (d == ' ' || is_letter(d) || is_digit(d)) break;
        ++j;
      }
      encode_pretoken(text.substr(i, j - i), out);
      i = j;
    }
  }
};

}  // namespace

extern "C" {

void* clip_bpe_create(const char* merges_path) {
  return new Tokenizer(merges_path);
}

void clip_bpe_destroy(void* handle) {
  delete static_cast<Tokenizer*>(handle);
}

// Tokenize n texts into out[n * ctx] int32 (sot ... eot, zero-padded,
// truncated with eot pinned at ctx-1).  Returns 0 on success.
int clip_bpe_encode_batch(void* handle, const char** texts, int n, int ctx,
                          int32_t* out) {
  if (!handle || !texts || !out || ctx < 2) return 1;
  auto* tok = static_cast<Tokenizer*>(handle);
  for (int row = 0; row < n; ++row) {
    std::vector<int> ids;
    ids.push_back(kSotId);
    tok->encode(texts[row] ? texts[row] : "", &ids);
    ids.push_back(kEotId);
    if (static_cast<int>(ids.size()) > ctx) {
      ids.resize(ctx);
      ids[ctx - 1] = kEotId;
    }
    int32_t* dst = out + static_cast<size_t>(row) * ctx;
    std::memset(dst, 0, sizeof(int32_t) * ctx);
    for (size_t k = 0; k < ids.size(); ++k) dst[k] = ids[k];
  }
  return 0;
}

int clip_bpe_vocab_size(void*) { return kVocabSize; }

}  // extern "C"
