// flash_decode.cuh's kernels at T = __nv_bfloat16, D = 64 (flash_decode.cu calls them).

#include "flash_decode.cuh"

template struct repro_decode::Kernels<__nv_bfloat16, 64>;
