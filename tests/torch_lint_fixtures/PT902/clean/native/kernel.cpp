#include <cstdint>

extern "C" {

int demo_write(void* h, const void* data, uint64_t len) {
  (void)h;
  (void)data;
  (void)len;
  return 0;
}

}  // extern "C"
