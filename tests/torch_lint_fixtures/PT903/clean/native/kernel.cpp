#include <cstdint>

int check(uint64_t num_values, uint64_t width, uint64_t cap) {
  if (width == 0) return -1;
  if (num_values > cap / width) return -1;
  return 0;
}
