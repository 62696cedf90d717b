// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_attention.py:
//   flash_fwd_kernel      <- _flash_fwd_kernel      (pallas_call in flash_attention_fwd)
//   flash_bwd_dq_kernel   <- _flash_bwd_dq_kernel   (first pallas_call in flash_attention_bwd)
//   flash_bwd_dkdv_kernel <- _flash_bwd_dkdv_kernel (second pallas_call in flash_attention_bwd)
//
// What bounds them. At the training shapes (S = 2048, D = 64, 112 or 128) each
// kernel does O(S^2 D) arithmetic on O(S D) bytes: hundreds of operations
// per byte, far above the H100's ~295 bf16 operations per byte of device
// memory, so the bound is arithmetic. The card's bf16 rate lives in the
// tensor cores (wgmma); these first kernels do not use them.
//
// What the simple design does about it. Each block keeps its q (or kv)
// tile and the streaming kv (or q) tile in shared memory as f32, so device
// memory is read once per tile pair and the (S, S) scores never leave the
// SM. Products are scalar f32 FMAs over 4 x 4 (scores) and 4 x D/16
// (outputs) register micro-tiles of a 16 x 16 thread grid; rows are padded
// by one float so column walks hit distinct banks. Tiles that the causal
// or window mask hides entirely are skipped, which halves causal work.
// wgmma/TMA pipelines are later work.
//
// The TPU grid walks its last axis in order and carries m/l/acc in VMEM
// scratch between grid steps. Hopper blocks run in no order, so here the
// sequential axis is a loop inside the block: the forward and dQ kernels
// have one block per (b*h, q tile) looping over kv tiles, and the dK/dV
// kernel one block per (b*h, kv tile) looping over q tiles. dQ and dK/dV
// stay two kernels, so no output needs atomics.
//
// Numerics follow the reference: q is scaled by d**-0.5 in f32 before the
// QK^T product; masks are kpos < S, causal qpos >= kpos, and
// kpos > qpos - window; accumulation is f32; O, dQ, dK, dV are written in
// the input type and lse in f32 (0 for a row with no visible key). The
// ragged S edge is masked in the kernel instead of padded.
//
// The forward also serves the suffix prefill of a prefix-shared serving
// cache: sq query rows at absolute positions q_offset .. q_offset + sq - 1
// over sk >= q_offset + sq key rows. A row's result does not depend on
// which q tile holds it: kv tiles start at key 0 whatever q_offset is,
// every tile with a key the row sees is visited in the same order, and a
// visited tile the mask hides from the row adds exactly 0 to it (p = 0,
// correction 1). So the suffix rows carry the bits of the same rows of a
// one-shot forward over the whole prompt.
//
// Plain C interface for ctypes. Every entry returns cudaGetLastError()
// after its launch (0 on success). Launches go to the caller's stream.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;    // q rows per tile
constexpr int BK = 64;    // kv rows per tile
constexpr int NT = 256;   // threads per block: a 16 x 16 grid
constexpr int LS = BK + 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Mask {
  int s, causal, window;
  __device__ __forceinline__ bool ok(int qp, int kp) const {
    bool m = kp < s;
    if (causal) m = m && (qp >= kp);
    if (window > 0) m = m && (kp > qp - window);
    return m;
  }
};

// rows [row0, row0 + 64) of a row-major (s, D) matrix into a [64][D + 1]
// f32 tile, times `mul`; rows at or past s are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0, int s, float mul) {
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, c = i % D;
    const int gr = row0 + r;
    dst[r * (D + 1) + c] = gr < s ? to_f(src[(size_t)gr * D + c]) * mul : 0.f;
  }
}

__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int s) {
  if (threadIdx.x < 64) {
    const int gr = row0 + threadIdx.x;
    dst[threadIdx.x] = gr < s ? src[gr] : 0.f;
  }
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// kv positions a q tile [q0, q0 + 64) can see: [lo, hi)
__device__ __forceinline__ void kv_range(int q0, int s, int causal, int window, int& lo, int& hi) {
  hi = causal ? min(s, q0 + BQ) : s;
  lo = window > 0 ? max(0, q0 - window + 1) : 0;
}

// q positions that can see a kv tile [k0, k0 + 64): [lo, hi)
__device__ __forceinline__ void q_range(int k0, int s, int causal, int window, int& lo, int& hi) {
  lo = causal ? k0 : 0;
  hi = window > 0 ? min(s, k0 + BK - 1 + window) : s;
}

// ------------------------------------------------------------------------
// forward
// ------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse,
                 int sq, int sk, int q_offset, int causal, int window, float scale) {
  constexpr int LD = D + 1, NJ = D / 16;
  extern __shared__ float sm[];
  float* sQ = sm;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sS = sV + BK * LD;
  float* sM = sS + BQ * LS;
  float* sL = sM + BQ;
  float* sC = sL + BQ;

  // q row r of this tile is query q0 + r, at absolute position
  // q_offset + q0 + r; key row c is at position c
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ, qa = q_offset + q0;
  const size_t qbase = (size_t)bh * sq * D, kbase = (size_t)bh * sk * D;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const Mask mask{sk, causal, window};

  load_tile<T, D>(sQ, q + qbase, q0, sq, scale);
  if (tid < BQ) { sM[tid] = -INFINITY; sL[tid] = 0.f; }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  int lo, hi;
  kv_range(qa, sk, causal, window, lo, hi);
  for (int kt = lo / BK; kt * BK < hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(sK, k + kbase, k0, sk, 1.f);
    load_tile<T, D>(sV, v + kbase, k0, sk, 1.f);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], b[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        sS[r * LS + c] = mask.ok(qa + r, k0 + c) ? sc[i][j] : -INFINITY;
      }
    __syncthreads();

    // online softmax: each warp owns 8 rows, each lane two columns
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int r = warp * (BQ / 8) + rr;
      const float x0 = sS[r * LS + lane], x1 = sS[r * LS + lane + 32];
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      float p0 = 0.f, p1 = 0.f, corr = 1.f;
      if (m_new != -INFINITY) {
        p0 = expf(x0 - m_new);
        p1 = expf(x1 - m_new);
        corr = expf(m_old - m_new);
      }
      sS[r * LS + lane] = p0;
      sS[r * LS + lane + 32] = p1;
      const float psum = warp_sum(p0 + p1);
      __syncwarp();  // every lane has read sM[r] before lane 0 rewrites it
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * corr + psum;
        sC[r] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float c = sC[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= c;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sS[(ty + 16 * i) * LS + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float b = sV[kk * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], b, acc[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qp = q0 + r;
    if (qp < sq) {
      const float l = sL[r];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        o[qbase + (size_t)qp * D + tx + 16 * j] = from_f<T>(l > 0.f ? acc[i][j] / l : 0.f);
    }
  }
  if (tid < BQ && q0 + tid < sq) {
    const float l = sL[tid];
    lse[(size_t)bh * sq + q0 + tid] = l > 0.f ? sM[tid] + logf(l) : 0.f;
  }
}

// ------------------------------------------------------------------------
// backward: shared tile math. Fills sP with P = exp(s - lse) and sDS with
// dS = P * (dO V^T - delta) for a (q tile, kv tile) pair; masked entries
// and q rows at or past s are 0.
// ------------------------------------------------------------------------
template <int D>
__device__ __forceinline__ void p_ds_tile(const float* sQ, const float* sdO, const float* sK,
                                          const float* sV, const float* sLse, const float* sDelta,
                                          float* sP, float* sDS, int q0, int k0, const Mask& mask) {
  constexpr int LD = D + 1;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float sc[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) { sc[i][j] = 0.f; dp[i][j] = 0.f; }
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], b[4], e[4], f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) { a[i] = sQ[(ty + 16 * i) * LD + d]; e[i] = sdO[(ty + 16 * i) * LD + d]; }
#pragma unroll
    for (int j = 0; j < 4; ++j) { b[j] = sK[(tx + 16 * j) * LD + d]; f[j] = sV[(tx + 16 * j) * LD + d]; }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = fmaf(a[i], b[j], sc[i][j]);
        dp[i][j] = fmaf(e[i], f[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      const int qp = q0 + r;
      const float p = (qp < mask.s && mask.ok(qp, k0 + c)) ? expf(sc[i][j] - sLse[r]) : 0.f;
      sP[r * LS + c] = p;
      sDS[r * LS + c] = p * (dp[i][j] - sDelta[r]);
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int s, int causal, int window, float scale) {
  constexpr int LD = D + 1, NJ = D / 16;
  extern __shared__ float sm[];
  float* sQ = sm;
  float* sdO = sQ + BQ * LD;
  float* sK = sdO + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;
  float* sDS = sP + BQ * LS;
  float* sLse = sDS + BQ * LS;
  float* sDelta = sLse + BQ;

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const size_t base = (size_t)bh * s * D;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const Mask mask{s, causal, window};

  load_tile<T, D>(sQ, q + base, q0, s, scale);
  load_tile<T, D>(sdO, dout + base, q0, s, 1.f);
  load_rows(sLse, lse + (size_t)bh * s, q0, s);
  load_rows(sDelta, delta + (size_t)bh * s, q0, s);

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  int lo, hi;
  kv_range(q0, s, causal, window, lo, hi);
  for (int kt = lo / BK; kt * BK < hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<T, D>(sK, k + base, k0, s, 1.f);
    load_tile<T, D>(sV, v + base, k0, s, 1.f);
    __syncthreads();
    p_ds_tile<D>(sQ, sdO, sK, sV, sLse, sDelta, sP, sDS, q0, k0, mask);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sDS[(ty + 16 * i) * LS + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float b = sK[kk * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], b, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp < s) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        dq[base + (size_t)qp * D + tx + 16 * j] = from_f<T>(acc[i][j] * scale);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int s, int causal, int window, float scale) {
  constexpr int LD = D + 1, NJ = D / 16;
  extern __shared__ float sm[];
  float* sQ = sm;
  float* sdO = sQ + BQ * LD;
  float* sK = sdO + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;
  float* sDS = sP + BQ * LS;
  float* sLse = sDS + BQ * LS;
  float* sDelta = sLse + BQ;

  const int bh = blockIdx.y, k0 = blockIdx.x * BK;
  const size_t base = (size_t)bh * s * D;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const Mask mask{s, causal, window};

  load_tile<T, D>(sK, k + base, k0, s, 1.f);
  load_tile<T, D>(sV, v + base, k0, s, 1.f);

  // rows are kv positions k0 + ty + 16 i, columns d = tx + 16 j
  float acc_k[4][NJ], acc_v[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) { acc_k[i][j] = 0.f; acc_v[i][j] = 0.f; }

  int lo, hi;
  q_range(k0, s, causal, window, lo, hi);
  for (int qt = lo / BQ; qt * BQ < hi; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    load_tile<T, D>(sQ, q + base, q0, s, scale);
    load_tile<T, D>(sdO, dout + base, q0, s, 1.f);
    load_rows(sLse, lse + (size_t)bh * s, q0, s);
    load_rows(sDelta, delta + (size_t)bh * s, q0, s);
    __syncthreads();
    p_ds_tile<D>(sQ, sdO, sK, sV, sLse, sDelta, sP, sDS, q0, k0, mask);
    __syncthreads();
    // dV += P^T dO, dK += dS^T (scale Q): the stored q tile is pre-scaled
#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      float pa[4], da[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = sP[qq * LS + ty + 16 * i];
        da[i] = sDS[qq * LS + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float g = sdO[qq * LD + tx + 16 * j];
        const float e = sQ[qq * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc_v[i][j] = fmaf(pa[i], g, acc_v[i][j]);
          acc_k[i][j] = fmaf(da[i], e, acc_k[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp < s) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const size_t at = base + (size_t)kp * D + tx + 16 * j;
        dk[at] = from_f<T>(acc_k[i][j]);
        dv[at] = from_f<T>(acc_v[i][j]);
      }
    }
  }
}

constexpr size_t fwd_smem(int d) { return sizeof(float) * ((size_t)(BQ + 2 * BK) * (d + 1) + BQ * LS + 3 * BQ); }
constexpr size_t bwd_smem(int d) { return sizeof(float) * ((size_t)(2 * BQ + 2 * BK) * (d + 1) + 2 * BQ * LS + 2 * BQ); }

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int sq,
        int sk, int q_offset, int causal, int window, float scale, cudaStream_t st) {
  const size_t smem = fwd_smem(D);
  cudaError_t e = allow_smem(flash_fwd_kernel<T, D>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((sq + BQ - 1) / BQ, bh);
  flash_fwd_kernel<T, D><<<grid, NT, smem, st>>>((const T*)q, (const T*)k, (const T*)v, (T*)o,
                                                 lse, sq, sk, q_offset, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, void* dq, int bh, int s, int causal, int window, float scale,
           cudaStream_t st) {
  const size_t smem = bwd_smem(D);
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<T, D>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((s + BQ - 1) / BQ, bh);
  flash_bwd_dq_kernel<T, D><<<grid, NT, smem, st>>>((const T*)q, (const T*)k, (const T*)v,
                                                    (const T*)dout, lse, delta, (T*)dq, s,
                                                    causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int bwd_dkdv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
             const float* delta, void* dk, void* dv, int bh, int s, int causal, int window,
             float scale, cudaStream_t st) {
  const size_t smem = bwd_smem(D);
  cudaError_t e = allow_smem(flash_bwd_dkdv_kernel<T, D>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((s + BK - 1) / BK, bh);
  flash_bwd_dkdv_kernel<T, D><<<grid, NT, smem, st>>>((const T*)q, (const T*)k, (const T*)v,
                                                      (const T*)dout, lse, delta, (T*)dk,
                                                      (T*)dv, s, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. head_dim: 64, 112 (zamba2's shared
// block) or 128; every loop over D steps by one or by 16 (NJ = D / 16
// columns a thread), so D only has to be a multiple of 16. Anything else
// returns cudaErrorInvalidValue without launching.
#define DISPATCH(FN, ...)                                                  \
  if (dtype == 0 && d == 64) return FN<float, 64>(__VA_ARGS__);            \
  if (dtype == 0 && d == 112) return FN<float, 112>(__VA_ARGS__);          \
  if (dtype == 0 && d == 128) return FN<float, 128>(__VA_ARGS__);          \
  if (dtype == 1 && d == 64) return FN<__nv_bfloat16, 64>(__VA_ARGS__);    \
  if (dtype == 1 && d == 112) return FN<__nv_bfloat16, 112>(__VA_ARGS__);  \
  if (dtype == 1 && d == 128) return FN<__nv_bfloat16, 128>(__VA_ARGS__);  \
  return (int)cudaErrorInvalidValue;

extern "C" {

// The forward takes sq query rows and sk key rows; query row i sits at
// absolute position q_offset + i (training: sq == sk, q_offset 0; the
// suffix prefill: the suffix's rows over the prefix and itself).
int repro_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                    int sq, int sk, int q_offset, int d, int dtype, int causal, int window,
                    float scale, void* stream) {
  DISPATCH(fwd, q, k, v, o, (float*)lse, bh, sq, sk, q_offset, causal, window, scale,
           (cudaStream_t)stream)
}

int repro_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dq, int bh, int s, int d,
                       int dtype, int causal, int window, float scale, void* stream) {
  DISPATCH(bwd_dq, q, k, v, dout, (const float*)lse, (const float*)delta, dq, bh, s, causal,
           window, scale, (cudaStream_t)stream)
}

int repro_flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dk, void* dv, int bh, int s,
                         int d, int dtype, int causal, int window, float scale, void* stream) {
  DISPATCH(bwd_dkdv, q, k, v, dout, (const float*)lse, (const float*)delta, dk, dv, bh, s,
           causal, window, scale, (cudaStream_t)stream)
}

}  // extern "C"
