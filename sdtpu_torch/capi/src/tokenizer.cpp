// The port's copy of csrc/libsdtpu/src/tokenizer.cpp (unchanged but for this line).
#include "tokenizer.h"

#include <fstream>
#include <limits>
#include <sstream>

#include "errors.h"
#include "unicode.h"

namespace sdtpu {
namespace {

// GPT-2/CLIP reversible byte -> unicode map (published construction).
void build_byte_encoder(std::string out[256]) {
  std::vector<int> bs;
  for (int b = int('!'); b <= int('~'); ++b) bs.push_back(b);
  for (int b = 0xA1; b <= 0xAC; ++b) bs.push_back(b);
  for (int b = 0xAE; b <= 0xFF; ++b) bs.push_back(b);
  std::vector<int> cs(bs.begin(), bs.end());
  int n = 0;
  for (int b = 0; b < 256; ++b) {
    bool found = false;
    for (int x : bs)
      if (x == b) { found = true; break; }
    if (!found) {
      bs.push_back(b);
      cs.push_back(256 + n++);
    }
  }
  for (size_t i = 0; i < bs.size(); ++i) {
    std::string s;
    utf8_append(s, uint32_t(cs[i]));
    out[bs[i]] = s;
  }
}

// html.unescape parity: CPython's charref regex + _replace_charref
// semantics verbatim (numeric refs with windows-1252 invalid-charref quirks,
// full HTML5 table incl. the legacy no-semicolon subset, longest-prefix
// fallback). Tables generated from CPython (unicode_tables.inc).
std::string html_unescape(const std::string& s) {
  std::string out;
  out.reserve(s.size());
  size_t i = 0, n = s.size();
  auto name_char = [](char c) {
    return !(c == '\t' || c == '\n' || c == '\f' || c == ' ' || c == '<' ||
             c == '&' || c == '#' || c == ';');
  };
  while (i < n) {
    if (s[i] != '&') {
      out.push_back(s[i++]);
      continue;
    }
    size_t j = i + 1;
    if (j < n && s[j] == '#') {
      size_t k = j + 1;
      int base = 10;
      if (k < n && (s[k] == 'x' || s[k] == 'X')) {
        base = 16;
        ++k;
      }
      size_t dstart = k;
      unsigned long long num = 0;
      bool overflow = false;
      while (k < n) {
        char c = s[k];
        int d;
        if (c >= '0' && c <= '9') d = c - '0';
        else if (base == 16 && c >= 'a' && c <= 'f') d = c - 'a' + 10;
        else if (base == 16 && c >= 'A' && c <= 'F') d = c - 'A' + 10;
        else break;
        num = num * base + d;
        if (num > 0x7FFFFFFFULL) overflow = true;
        ++k;
      }
      if (k == dstart) {  // "&#" with no digits: not a charref match
        out.push_back(s[i++]);
        continue;
      }
      if (k < n && s[k] == ';') ++k;
      if (const char* r = overflow ? nullptr : invalid_charref(uint32_t(num))) {
        out += r;
      } else if (overflow || num > 0x10FFFF ||
                 (num >= 0xD800 && num <= 0xDFFF)) {
        out += "\xEF\xBF\xBD";  // U+FFFD
      } else if (invalid_codepoint(uint32_t(num))) {
        // dropped
      } else {
        utf8_append(out, uint32_t(num));
      }
      i = k;
      continue;
    }
    size_t k = j;
    while (k < n && k - j < 32 && name_char(s[k])) ++k;
    if (k == j) {  // bare '&'
      out.push_back(s[i++]);
      continue;
    }
    bool semi = (k < n && s[k] == ';');
    std::string name = s.substr(j, k - j + (semi ? 1 : 0));
    size_t match_end = j + name.size();
    if (const char* r = entity_lookup(name)) {
      out += r;
      i = match_end;
      continue;
    }
    bool replaced = false;
    for (size_t x = name.size() - 1; x >= 2; --x) {
      if (const char* r = entity_lookup(name.substr(0, x))) {
        out += r;
        out.append(name, x, std::string::npos);
        replaced = true;
        break;
      }
    }
    if (!replaced) {
      out.push_back('&');
      out += name;
    }
    i = match_end;
    continue;
  }
  return out;
}

// does cps[i] start a contraction? returns its codepoint length or 0
size_t contraction_len(const std::vector<uint32_t>& cps, size_t i) {
  if (cps[i] != '\'') return 0;
  auto low = [&](size_t k) -> uint32_t {
    if (k >= cps.size()) return 0;
    uint32_t c = cps[k];
    return (c >= 'A' && c <= 'Z') ? c + 32 : c;
  };
  uint32_t c1 = low(i + 1), c2 = low(i + 2);
  if (c1 == 's' || c1 == 't' || c1 == 'm' || c1 == 'd') return 2;
  if ((c1 == 'r' && c2 == 'e') || (c1 == 'v' && c2 == 'e') ||
      (c1 == 'l' && c2 == 'l'))
    return 3;
  return 0;
}

}  // namespace

Tokenizer Tokenizer::from_flat_file(const std::string& path) {
  std::ifstream f(path);
  if (!f) SDTPU_THROW(SDTPU_INVALID_ARGUMENT, "cannot open " + path);
  Tokenizer tok;
  build_byte_encoder(tok.byte_enc_);
  std::string line;
  while (std::getline(f, line)) {
    if (line.empty()) continue;
    size_t sp = line.find(' ');
    if (sp == std::string::npos) {
      tok.vocab_.push_back(line);
    } else {
      std::string a = line.substr(0, sp), b = line.substr(sp + 1);
      tok.ranks_[a + '\x01' + b] = int32_t(tok.ranks_.size());
      tok.vocab_.push_back(a + b);
    }
  }
  tok.vocab_.push_back("<|startoftext|>");
  tok.vocab_.push_back("<|endoftext|>");
  for (size_t i = 0; i < tok.vocab_.size(); ++i)
    tok.encoder_[tok.vocab_[i]] = int32_t(i);
  tok.sot_ = int32_t(tok.vocab_.size()) - 2;
  tok.eot_ = int32_t(tok.vocab_.size()) - 1;
  return tok;
}

std::string Tokenizer::sanitize(const std::string& text) const {
  // unescape twice (matches the Python pipeline), collapse whitespace,
  // strip, lowercase
  std::string un = html_unescape(html_unescape(text));
  auto cps = utf8_decode(un);
  std::vector<uint32_t> lowered;
  lowered.reserve(cps.size());
  bool in_space = true;  // leading spaces stripped
  for (uint32_t cp : cps) {
    if (is_space(cp)) {
      in_space = true;
      continue;
    }
    if (in_space && !lowered.empty()) lowered.push_back(' ');
    in_space = false;
    to_lower(cp, lowered);
  }
  std::string out;
  for (uint32_t cp : lowered) utf8_append(out, cp);
  return out;
}

std::vector<std::string> Tokenizer::pretokenize(const std::string& text) const {
  // state machine equivalent to the CLIP regex
  // 's|'t|'re|'ve|'m|'ll|'d|\p{L}+|\p{N}|[^\s\p{L}\p{N}]+
  auto cps = utf8_decode(text);
  std::vector<std::string> out;
  size_t i = 0, n = cps.size();
  auto emit = [&](size_t a, size_t b) {
    std::string s;
    for (size_t k = a; k < b; ++k) utf8_append(s, cps[k]);
    out.push_back(std::move(s));
  };
  while (i < n) {
    uint32_t c = cps[i];
    if (is_space(c)) { ++i; continue; }
    if (size_t cl = contraction_len(cps, i); cl) {
      emit(i, i + cl);
      i += cl;
      continue;
    }
    if (is_letter(c)) {
      size_t j = i + 1;
      while (j < n && is_letter(cps[j])) ++j;
      emit(i, j);
      i = j;
      continue;
    }
    if (is_number(c)) {
      emit(i, i + 1);
      ++i;
      continue;
    }
    // "other" run. CLIP's regex tries contractions only at the match START,
    // so apostrophes inside a punctuation run are consumed greedily
    // ("!!'s" -> ["!!'", "s"]).
    size_t j = i;
    while (j < n) {
      uint32_t cj = cps[j];
      if (is_space(cj) || is_letter(cj) || is_number(cj)) break;
      ++j;
    }
    emit(i, j);
    i = j;
  }
  return out;
}

std::vector<std::string> Tokenizer::bpe(const std::string& token) const {
  // split into byte-unicode chars; last gets </w>
  auto cps = utf8_decode(token);
  std::vector<std::string> word;
  word.reserve(cps.size());
  for (size_t i = 0; i < cps.size(); ++i) {
    std::string s;
    utf8_append(s, cps[i]);
    if (i + 1 == cps.size()) s += "</w>";
    word.push_back(std::move(s));
  }
  if (word.size() <= 1) return word;
  constexpr int32_t kNoRank = std::numeric_limits<int32_t>::max();
  while (word.size() > 1) {
    int32_t best = kNoRank;
    size_t best_i = 0;
    for (size_t i = 0; i + 1 < word.size(); ++i) {
      auto it = ranks_.find(word[i] + '\x01' + word[i + 1]);
      if (it != ranks_.end() && it->second < best) {
        best = it->second;
        best_i = i;
      }
    }
    if (best == kNoRank) break;
    const std::string a = word[best_i], b = word[best_i + 1];
    std::vector<std::string> merged;
    merged.reserve(word.size());
    for (size_t i = 0; i < word.size();) {
      if (i + 1 < word.size() && word[i] == a && word[i + 1] == b) {
        merged.push_back(a + b);
        i += 2;
      } else {
        merged.push_back(word[i]);
        i += 1;
      }
    }
    word = std::move(merged);
  }
  return word;
}

std::vector<int32_t> Tokenizer::encode(const std::string& text) const {
  std::vector<int32_t> ids;
  for (const std::string& tok : pretokenize(sanitize(text))) {
    std::string remapped;
    for (unsigned char b : tok) remapped += byte_enc_[b];
    for (const std::string& piece : bpe(remapped)) {
      auto it = encoder_.find(piece);
      if (it == encoder_.end())
        SDTPU_THROW(SDTPU_RUNTIME_ERROR, "piece not in vocab: " + piece);
      ids.push_back(it->second);
    }
  }
  return ids;
}

std::vector<int32_t> Tokenizer::tokenize(const std::string& text,
                                         int32_t context_len) const {
  std::vector<int32_t> ids = encode(text);
  if (int32_t(ids.size()) > context_len - 2) ids.resize(context_len - 2);
  std::vector<int32_t> out;
  out.reserve(context_len);
  out.push_back(sot_);
  out.insert(out.end(), ids.begin(), ids.end());
  while (int32_t(out.size()) < context_len) out.push_back(eot_);
  return out;
}

}  // namespace sdtpu
