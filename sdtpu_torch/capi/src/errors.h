// The port's copy of csrc/libsdtpu/src/errors.h (unchanged but for this line).
// Error subsystem: status-code exception + per-context/global last-error
// tables (native mirror of the reference design, errors.h:12-58).
#pragma once

#include <array>
#include <mutex>
#include <optional>
#include <stdexcept>
#include <string>

#include "sdtpu.h"

namespace sdtpu {

class ErrorTable {
 public:
  void record(int code, std::string msg) {
    std::lock_guard<std::mutex> g(mu_);
    if (code >= 0 && code < kCodes) last_[code] = std::move(msg);
  }
  const char* last(int code) {
    std::lock_guard<std::mutex> g(mu_);
    if (code < 0 || code >= kCodes || !last_[code]) return nullptr;
    return last_[code]->c_str();
  }

 private:
  static constexpr int kCodes = 8;
  std::mutex mu_;
  std::array<std::optional<std::string>, kCodes> last_;
};

ErrorTable& global_error_table();

class Error : public std::runtime_error {
 public:
  Error(sdtpu_status code, const std::string& reason, const char* func,
        ErrorTable* table = nullptr)
      : std::runtime_error("[" + std::to_string(int(code)) + "] " + reason),
        code(code) {
    (table ? *table : global_error_table())
        .record(code, reason + " [" + func + "]");
  }
  sdtpu_status code;
};

#define SDTPU_THROW(code, reason) \
  throw ::sdtpu::Error((code), (reason), __func__)
#define SDTPU_THROW_T(table, code, reason) \
  throw ::sdtpu::Error((code), (reason), __func__, (table))

}  // namespace sdtpu
