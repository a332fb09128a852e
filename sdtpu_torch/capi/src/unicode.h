// The port's copy of csrc/libsdtpu/src/unicode.h (unchanged but for this line).
// UTF-8 + Unicode classification utilities for the native tokenizer.
// Classification/lowering tables are generated from CPython's unicodedata
// (tools/gen_unicode_tables.py) so native ids match the Python tokenizer.
#pragma once

#include <cstdint>
#include <string>
#include <vector>

namespace sdtpu {

// Decode UTF-8 -> codepoints (invalid bytes become U+FFFD).
std::vector<uint32_t> utf8_decode(const std::string& s);
void utf8_append(std::string& out, uint32_t cp);

bool is_letter(uint32_t cp);
bool is_number(uint32_t cp);
bool is_space(uint32_t cp);
// Append the lowercase expansion of cp (1..3 codepoints, Python str.lower()).
void to_lower(uint32_t cp, std::vector<uint32_t>& out);
// HTML5 named entity, key EXACTLY as CPython stores it (may include the
// trailing ';') -> UTF-8 replacement, or nullptr.
const char* entity_lookup(const std::string& name);
// CPython html._invalid_charrefs (windows-1252 quirks): cp -> utf8 or nullptr
const char* invalid_charref(uint32_t cp);
// CPython html._invalid_codepoints: replaced with the empty string
bool invalid_codepoint(uint32_t cp);

}  // namespace sdtpu
