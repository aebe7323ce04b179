#include <cstdint>
#include <cstring>

void fill(uint8_t* dst, uint64_t dst_cap, const uint8_t* src, uint64_t n) {
  const uint64_t need = n + 8;
  if (need > dst_cap) return;
  std::memcpy(dst, src, need);
}
