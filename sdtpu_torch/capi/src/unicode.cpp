// The port's copy of csrc/libsdtpu/src/unicode.cpp (unchanged but for this line).
#include "unicode.h"

#include <algorithm>

namespace sdtpu {
namespace {
#include "unicode_tables.inc"

bool in_ranges(const uint32_t (*ranges)[2], size_t n, uint32_t cp) {
  size_t lo = 0, hi = n;
  while (lo < hi) {
    size_t mid = (lo + hi) / 2;
    if (cp < ranges[mid][0]) {
      hi = mid;
    } else if (cp > ranges[mid][1]) {
      lo = mid + 1;
    } else {
      return true;
    }
  }
  return false;
}
}  // namespace

std::vector<uint32_t> utf8_decode(const std::string& s) {
  std::vector<uint32_t> out;
  out.reserve(s.size());
  size_t i = 0, n = s.size();
  while (i < n) {
    unsigned char c = s[i];
    uint32_t cp = 0xFFFD;
    size_t len = 1;
    if (c < 0x80) {
      cp = c;
    } else if ((c >> 5) == 0x6 && i + 1 < n) {
      cp = (c & 0x1F) << 6 | (s[i + 1] & 0x3F);
      len = 2;
    } else if ((c >> 4) == 0xE && i + 2 < n) {
      cp = (c & 0x0F) << 12 | (s[i + 1] & 0x3F) << 6 | (s[i + 2] & 0x3F);
      len = 3;
    } else if ((c >> 3) == 0x1E && i + 3 < n) {
      cp = (c & 0x07) << 18 | (s[i + 1] & 0x3F) << 12 |
           (s[i + 2] & 0x3F) << 6 | (s[i + 3] & 0x3F);
      len = 4;
    }
    out.push_back(cp);
    i += len;
  }
  return out;
}

void utf8_append(std::string& out, uint32_t cp) {
  if (cp < 0x80) {
    out.push_back(char(cp));
  } else if (cp < 0x800) {
    out.push_back(char(0xC0 | (cp >> 6)));
    out.push_back(char(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    out.push_back(char(0xE0 | (cp >> 12)));
    out.push_back(char(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back(char(0x80 | (cp & 0x3F)));
  } else {
    out.push_back(char(0xF0 | (cp >> 18)));
    out.push_back(char(0x80 | ((cp >> 12) & 0x3F)));
    out.push_back(char(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back(char(0x80 | (cp & 0x3F)));
  }
}

bool is_letter(uint32_t cp) {
  return in_ranges(kLetterRanges, kLetterRanges_len, cp);
}
bool is_number(uint32_t cp) {
  return in_ranges(kNumberRanges, kNumberRanges_len, cp);
}
bool is_space(uint32_t cp) {
  return std::binary_search(kSpaceCps, kSpaceCps + kSpaceCps_len, cp);
}

void to_lower(uint32_t cp, std::vector<uint32_t>& out) {
  size_t lo = 0, hi = kLowerMap_len;
  while (lo < hi) {
    size_t mid = (lo + hi) / 2;
    if (kLowerMap[mid].cp < cp) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  if (lo < kLowerMap_len && kLowerMap[lo].cp == cp) {
    for (int i = 0; i < 3 && kLowerMap[lo].lo[i]; ++i)
      out.push_back(kLowerMap[lo].lo[i]);
  } else {
    out.push_back(cp);
  }
}

const char* invalid_charref(uint32_t cp) {
  size_t lo = 0, hi = kInvalidCharrefs_len;
  while (lo < hi) {
    size_t mid = (lo + hi) / 2;
    if (kInvalidCharrefs[mid].cp == cp) return kInvalidCharrefs[mid].utf8;
    if (kInvalidCharrefs[mid].cp < cp) lo = mid + 1; else hi = mid;
  }
  return nullptr;
}

bool invalid_codepoint(uint32_t cp) {
  return std::binary_search(kInvalidCodepoints,
                            kInvalidCodepoints + kInvalidCodepoints_len, cp);
}

const char* entity_lookup(const std::string& name) {
  size_t lo = 0, hi = kEntities_len;
  while (lo < hi) {
    size_t mid = (lo + hi) / 2;
    int c = name.compare(kEntities[mid].name);
    if (c == 0) return kEntities[mid].utf8;
    if (c < 0) hi = mid; else lo = mid + 1;
  }
  return nullptr;
}

}  // namespace sdtpu
