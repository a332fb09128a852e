// The port's copy of csrc/libsdtpu/src/logging.h (unchanged but for this line).
// Logging: 5 levels, thread-local active logger with RAII scope, relative
// timestamps (native mirror of the reference design, logging.h:12-87).
#pragma once

#include <chrono>
#include <cstdio>
#include <string>

namespace sdtpu {

enum class LogLevel : int {
  kNothing = 0, kError = 1, kInfo = 2, kDebug = 3, kAbusive = 4
};

class Logger {
 public:
  explicit Logger(LogLevel level = LogLevel::kError,
                  std::string name = "sdtpu")
      : level_(level), name_(std::move(name)),
        t0_(std::chrono::steady_clock::now()) {}

  void log(LogLevel level, const std::string& msg) const {
    if (level_ == LogLevel::kNothing || level > level_) return;
    double dt = std::chrono::duration<double>(
                    std::chrono::steady_clock::now() - t0_).count();
    static const char* names[] = {"NOTHING", "ERROR", "INFO", "DEBUG",
                                  "ABUSIVE"};
    std::fprintf(stderr, "[%s +%9.3fs %-7s] %s\n", name_.c_str(), dt,
                 names[int(level)], msg.c_str());
  }
  void error(const std::string& m) const { log(LogLevel::kError, m); }
  void info(const std::string& m) const { log(LogLevel::kInfo, m); }
  void debug(const std::string& m) const { log(LogLevel::kDebug, m); }

  LogLevel level_;
  std::string name_;
  std::chrono::steady_clock::time_point t0_;
};

Logger& default_logger();
Logger* active_logger();

// RAII thread-local activation (reference: logging.cpp:104-115).
class LoggerScope {
 public:
  explicit LoggerScope(Logger* logger);
  ~LoggerScope();

 private:
  Logger* prev_;
};

void log_error(const std::string& m);
void log_info(const std::string& m);
void log_debug(const std::string& m);

}  // namespace sdtpu
