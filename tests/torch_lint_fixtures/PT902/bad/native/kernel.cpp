#include <cstdint>

extern "C" {

int demo_write(void* h, const void* data) {
  (void)h;
  (void)data;
  return 0;
}

}  // extern "C"
