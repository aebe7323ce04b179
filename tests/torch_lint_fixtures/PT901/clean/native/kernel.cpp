#include <cstdint>

struct DemoCol {
  const uint8_t* chunk;
  uint64_t chunk_len;
  uint8_t* out;
  uint64_t out_cap;
  int32_t mode;
  int32_t status;
};

extern "C" {

long long demo_read(struct DemoCol* cols, int n_cols) {
  (void)cols;
  (void)n_cols;
  return 0;
}

int demo_write(void* h, const void* data, uint64_t len) {
  (void)h;
  (void)data;
  (void)len;
  return 0;
}

}  // extern "C"
