// flash_decode.cuh's kernels at T = float, D = 160 (flash_decode.cu calls them).

#include "flash_decode.cuh"

template struct repro_decode::Kernels<float, 160>;
