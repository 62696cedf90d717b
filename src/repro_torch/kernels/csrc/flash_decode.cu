// Flash decode for Hopper (sm_90a): the plain C entries. The
// kernels and their launchers are in flash_decode.cuh; each entry dispatches
// by dtype and shape to repro_decode::Kernels<T, D>, whose instances the
// other sources of the library compile. This one instantiates no kernel.
//
// Plain C interface for ctypes. Every launching entry returns
// cudaGetLastError() after its launches (0 on success); launches go to the
// caller's stream. repro_flash_decode_workspace returns the size of the
// split workspace for a given split, so its layout has one owner, this
// file. A split outside 1..SPLIT_MAX returns cudaErrorInvalidValue
// without launching (the workspace size: -1).

#include "flash_decode.cuh"

extern template struct repro_decode::Kernels<float, 64>;
extern template struct repro_decode::Kernels<float, 112>;
extern template struct repro_decode::Kernels<float, 128>;
extern template struct repro_decode::Kernels<float, 160>;
extern template struct repro_decode::Kernels<__nv_bfloat16, 64>;
extern template struct repro_decode::Kernels<__nv_bfloat16, 112>;
extern template struct repro_decode::Kernels<__nv_bfloat16, 128>;
extern template struct repro_decode::Kernels<__nv_bfloat16, 160>;
using repro_decode::Kernels;

// dtype: 0 = float32, 1 = bfloat16. head_dim: 64, 112 (zamba2's shared
// block), 128 or 160 (stablelm-12b). Anything else returns
// cudaErrorInvalidValue without launching. `work` is the split workspace
// the wrapper allocates, repro_flash_decode_workspace floats.
#define DISPATCH(PAGED, ...)                                                               \
  if (dtype == 0 && d == 64) return Kernels<float, 64>::run(PAGED, __VA_ARGS__);           \
  if (dtype == 0 && d == 112) return Kernels<float, 112>::run(PAGED, __VA_ARGS__);         \
  if (dtype == 0 && d == 128) return Kernels<float, 128>::run(PAGED, __VA_ARGS__);         \
  if (dtype == 0 && d == 160) return Kernels<float, 160>::run(PAGED, __VA_ARGS__);         \
  if (dtype == 1 && d == 64) return Kernels<__nv_bfloat16, 64>::run(PAGED, __VA_ARGS__);   \
  if (dtype == 1 && d == 112) return Kernels<__nv_bfloat16, 112>::run(PAGED, __VA_ARGS__); \
  if (dtype == 1 && d == 128) return Kernels<__nv_bfloat16, 128>::run(PAGED, __VA_ARGS__); \
  if (dtype == 1 && d == 160) return Kernels<__nv_bfloat16, 160>::run(PAGED, __VA_ARGS__); \
  return (int)cudaErrorInvalidValue;

extern "C" {

// Floats of the split workspace for B slots of H heads of D and a cache of
// `capacity` key positions a slot (S, or P * page_size when paged), cut
// into splits of `split` positions: (acc, m, l) for every (slot, head,
// split), B * H * ceil(capacity / split) * (D + 2). -1 for a negative
// size, a split outside 1..SPLIT_MAX, or a size that does not fit an int.
int repro_flash_decode_workspace(int b, int h, int d, int capacity, int split) {
  if (b < 0 || h < 0 || d < 0 || capacity < 0 || split < 1 || split > SPLIT_MAX) return -1;
  const long long n = (long long)b * h * ((capacity + split - 1LL) / split) * (d + 2);
  return n > INT32_MAX ? -1 : (int)n;
}

// q, o: (B, 1, H, D); k, v: (B, S, H_kv, D); lengths: (B,) int32
int repro_flash_decode(const void* q, const void* k, const void* v, const void* lengths, void* o,
                       void* work, int b, int h, int h_kv, int s, int d, int dtype, int split,
                       float scale, void* stream) {
  DISPATCH(false, q, k, v, (const int*)lengths, nullptr, o, work, b, h, h_kv, s, 0, split, scale,
           (cudaStream_t)stream)
}

// q, o: (B, 1, H, D); k_pool, v_pool: (N, page_size, H_kv, D); pages: (B, P)
// int32 with -1 = unassigned; lengths: (B,) int32
int repro_flash_decode_paged(const void* q, const void* k_pool, const void* v_pool,
                             const void* pages, const void* lengths, void* o, void* work, int b,
                             int h, int h_kv, int page_size, int p_tab, int d, int dtype,
                             int split, float scale, void* stream) {
  DISPATCH(true, q, k_pool, v_pool, (const int*)lengths, (const int*)pages, o, work, b, h, h_kv,
           page_size, p_tab, split, scale, (cudaStream_t)stream)
}

}  // extern "C"
