// The port's copy of csrc/libsdtpu/src/logging.cpp (unchanged but for this line).
#include "logging.h"

namespace sdtpu {

Logger& default_logger() {
  static Logger logger(LogLevel::kError, "sdtpu");
  return logger;
}

static thread_local Logger* g_active = nullptr;

Logger* active_logger() { return g_active ? g_active : &default_logger(); }

LoggerScope::LoggerScope(Logger* logger) : prev_(g_active) {
  g_active = logger;
}
LoggerScope::~LoggerScope() { g_active = prev_; }

void log_error(const std::string& m) { active_logger()->error(m); }
void log_info(const std::string& m) { active_logger()->info(m); }
void log_debug(const std::string& m) { active_logger()->debug(m); }

}  // namespace sdtpu
