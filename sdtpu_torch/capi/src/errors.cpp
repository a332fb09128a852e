// The port's copy of csrc/libsdtpu/src/errors.cpp (unchanged but for this line).
#include "errors.h"

namespace sdtpu {

ErrorTable& global_error_table() {
  static ErrorTable table;
  return table;
}

}  // namespace sdtpu
