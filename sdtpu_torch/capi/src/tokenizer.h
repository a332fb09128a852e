// The port's copy of csrc/libsdtpu/src/tokenizer.h (unchanged but for this line).
// CLIP BPE tokenizer — native implementation, id-identical to the Python
// tokenizer (sdtpu/tokenizer.py). The reference implements the same
// component natively (reference: tokenizer.h:11-41); this is an independent
// rebuild sharing only the published CLIP algorithm.
#pragma once

#include <cstdint>
#include <string>
#include <unordered_map>
#include <vector>

namespace sdtpu {

class Tokenizer {
 public:
  // Flat single-file format: vocab lines (no space) in id order, merge lines
  // ("A B") in rank order; specials appended last.
  static Tokenizer from_flat_file(const std::string& path);

  std::vector<int32_t> tokenize(const std::string& text,
                                int32_t context_len = 77) const;
  std::vector<int32_t> encode(const std::string& text) const;

  int32_t vocab_size() const { return int32_t(vocab_.size()); }
  int32_t sot() const { return sot_; }
  int32_t eot() const { return eot_; }

 private:
  std::vector<std::string> bpe(const std::string& token) const;
  std::vector<std::string> pretokenize(const std::string& text) const;
  std::string sanitize(const std::string& text) const;

  std::vector<std::string> vocab_;
  std::unordered_map<std::string, int32_t> encoder_;
  std::unordered_map<std::string, int32_t> ranks_;  // key: a + '\x01' + b
  std::string byte_enc_[256];  // byte -> unicode char (UTF-8)
  int32_t sot_ = -1, eot_ = -1;
};

}  // namespace sdtpu
