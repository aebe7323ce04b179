#include <cstdint>

int check(uint64_t num_values, uint64_t width, uint64_t cap) {
  if (num_values * width > cap) return -1;
  return 0;
}
