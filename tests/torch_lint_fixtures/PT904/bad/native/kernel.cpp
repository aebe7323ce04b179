#include <cstdint>
#include <cstring>

void fill(uint8_t* dst, const uint8_t* src, uint64_t n) {
  const uint64_t need = n + 8;
  std::memcpy(dst, src, need);
}
