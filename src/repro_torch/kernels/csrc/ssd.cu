// Mamba2 SSD chunk scan for Hopper (sm_90a): forward and backward.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/mamba2_scan.py:
//   ssd_fwd_kernel <- _ssd_kernel / _ssd_fwd_only_kernel (pallas_call in ssd_fwd)
//   ssd_bwd_kernel <- _ssd_bwd_kernel                    (pallas_call in ssd_bwd)
//
// Math (per batch row b and head h; a chunk of L rows, cum = cumsum(A dt)):
//   y     = [(C B^T) * exp(cum_i - cum_j) masked i >= j] (x dt)
//         + (C state^T) * exp(cum)
//   state = exp(cum[-1]) state + (x * exp(cum[-1] - cum) dt)^T B
// and the backward carries d(state) from the last chunk to the first,
// recomputing the chunk's intermediates from its saved input state.
//
// What bounds them. Per chunk the forward needs four products: C B^T and
// M (x dt) over the L (L + 1) / 2 causal (i >= j) pairs, 2 N and 2 P
// flops a pair, then C state^T and (x w)^T B of 2 L P N each; the
// backward needs ten (three over the pairs at 2 N, two at 2 P, five of
// 2 L P N). At zamba2-7b's shape (S 2048, 112 heads, P = N = 64, L = 64)
// one batch row's forward needs ~5.7 GFLOP over ~180 MB (its per-chunk
// states included), the backward ~14.2 GFLOP over ~360 MB. In f32 on the CUDA cores (67 TFLOP/s) that is
// arithmetic-bound; at TF32 on the tensor cores (495 TFLOP/s) the bytes
// would bound it. These first kernels use neither wgmma nor TF32: scalar
// f32 FMAs over register micro-tiles. They also still compute the masked
// upper half of every (L, L) tile, ~1.3x the flops the function needs;
// skipping the 16 x 16 micro-tiles that lie wholly above the diagonal is
// cheap later work.
//
// What the simple design does about it. The TPU grid (B, H, nc) walks the
// chunks in order and carries the (P, N) state in VMEM scratch. Hopper
// blocks run in no order, so one block owns one (b, h) and loops over the
// chunks inside: ascending in the forward, descending in the backward,
// with the state (or d(state)) in shared memory in f32. Every chunk's
// tiles stay in shared memory, so device memory is read once and the
// (L, L) decay and score tiles never leave the SM. The reference's chunk
// of 256 needs (256, 256) f32 tiles, 256 KB each; L = 64 keeps the
// backward's six (L, P|N) and three (L, L) tiles in ~150 KB. Products are
// f32 FMAs over a 16 x 16 thread grid, each thread a (M/16, N/16)
// micro-tile; tile rows are padded by one float so column walks hit
// distinct banks. With one block per (b, h), a micro-batch of one row
// fills only 112 of the 132 SMs with one block each, and the chunk loop
// is serial: splitting the intra-chunk term from the state scan is later
// work.
//
// Numerics follow the reference: dA = A dt in f32; the exponent is masked
// before exp (only i >= j is computed, the rest is 0, so exp never sees a
// positive number); sums are f32 and deterministic (no atomics: row sums
// by warp shuffles in a fixed order, column sums and scans by one warp).
// dB and dC leave as per-head partials, summed over heads outside; the
// dA = A dt chain rule is also outside (ssd.py). The backward writes d(dA)
// as the inclusive suffix sum of d(cum) itself, as the reference does.
//
// Layout is the model's: x, y, dx (B, S, H, P); dt, ddt, d(dA) (B, S, H);
// Bm, Cm (B, S, N); dB, dC partials (B, S, H, N); states (B, H, nc, P, N).
// S is a multiple of L (the wrapper pads with dt = 0).
//
// Plain C interface for ctypes. Every entry returns cudaGetLastError()
// after its launch (0 on success). Launches go to the caller's stream.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int L = 64;     // chunk rows
constexpr int NT = 256;   // threads per block: a 16 x 16 grid
constexpr int LL = L + 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int M, int N>
__device__ __forceinline__ void zero(float (&acc)[M / 16][N / 16]) {
#pragma unroll
  for (int i = 0; i < M / 16; ++i)
#pragma unroll
    for (int j = 0; j < N / 16; ++j) acc[i][j] = 0.f;
}

// acc += A B for an (M, K) x (K, N) product read through accessors
// a(row, k) and b(k, col). Thread (ty, tx) owns rows ty + 16 i and
// columns tx + 16 j.
template <int M, int N, int K, class FA, class FB>
__device__ __forceinline__ void mm(float (&acc)[M / 16][N / 16], FA a, FB b) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[M / 16], bv[N / 16];
#pragma unroll
    for (int i = 0; i < M / 16; ++i) av[i] = a(ty + 16 * i, k);
#pragma unroll
    for (int j = 0; j < N / 16; ++j) bv[j] = b(k, tx + 16 * j);
#pragma unroll
    for (int i = 0; i < M / 16; ++i)
#pragma unroll
      for (int j = 0; j < N / 16; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// sum over the 16 lanes that share a thread row (same ty), in a fixed order
__device__ __forceinline__ float row_sum16(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// inclusive prefix sums of (d0, d1) = rows (2 lane, 2 lane + 1) of a
// 64-row vector held by one warp
__device__ __forceinline__ void warp_scan64(float d0, float d1, float& c0, float& c1) {
  const int lane = threadIdx.x % 32;
  float t = d0 + d1;
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, t, o);
    if (lane >= o) t += u;
  }
  float excl = __shfl_up_sync(0xffffffffu, t, 1);
  if (lane == 0) excl = 0.f;
  c0 = excl + d0;
  c1 = excl + (d0 + d1);
}

// cum = cumsum(v) in place over L = 64 rows, by warp 0
__device__ __forceinline__ void scan_inplace(float* v) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float c0, c1;
    warp_scan64(v[2 * lane], v[2 * lane + 1], c0, c1);
    v[2 * lane] = c0;
    v[2 * lane + 1] = c1;
  }
}

// rows [t0, t0 + L) of head h of a (B, S, H, W) tensor into an [L][W + 1]
// f32 tile
template <typename T, int W>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int bi, int t0, int S, int H,
                                          int h) {
  for (int i = threadIdx.x; i < L * W; i += NT) {
    const int r = i / W, c = i % W;
    dst[r * (W + 1) + c] = to_f(src[(((size_t)bi * S + t0 + r) * H + h) * W + c]);
  }
}

// ------------------------------------------------------------------------
// forward
// ------------------------------------------------------------------------
template <typename T, int P, int N>
__global__ void __launch_bounds__(NT)
ssd_fwd_kernel(const T* __restrict__ x, const T* __restrict__ dt, const float* __restrict__ A,
               const T* __restrict__ bm, const T* __restrict__ cm, T* __restrict__ y,
               float* __restrict__ states, int S, int H) {
  constexpr int LP = P + 1, LN = N + 1;
  extern __shared__ float sm[];
  float* sX = sm;              // [L][LP]  x
  float* sB = sX + L * LP;     // [L][LN]  B
  float* sC = sB + L * LN;     // [L][LN]  C
  float* sSt = sC + L * LN;    // [P][LN]  carried state
  float* sM = sSt + P * LN;    // [L][LL]  m = (C B^T) * decay
  float* sDt = sM + L * LL;    // [L]      dt
  float* sCum = sDt + L;       // [L]      cumsum(A dt)
  float* sW = sCum + L;        // [L]      exp(total - cum) dt

  const int bi = blockIdx.x / H, h = blockIdx.x % H, nc = S / L;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float a = A[h];

  for (int i = tid; i < P * LN; i += NT) sSt[i] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * L;
    __syncthreads();  // the previous chunk's readers are done
    load_rows<T, P>(sX, x, bi, t0, S, H, h);
    load_rows<T, N>(sB, bm, bi, t0, S, 1, 0);
    load_rows<T, N>(sC, cm, bi, t0, S, 1, 0);
    if (tid < L) {
      const float d = to_f(dt[((size_t)bi * S + t0 + tid) * H + h]);
      sDt[tid] = d;
      sCum[tid] = a * d;
    }
    if (states != nullptr) {  // this chunk's input state, the backward's residual
      float* dst = states + (((size_t)bi * H + h) * nc + c) * P * N;
      for (int i = tid; i < P * N; i += NT) dst[i] = sSt[(i / N) * LN + i % N];
    }
    __syncthreads();
    scan_inplace(sCum);
    __syncthreads();
    const float total = sCum[L - 1];
    if (tid < L) sW[tid] = expf(total - sCum[tid]) * sDt[tid];

    {  // m = (C B^T) * exp(cum_i - cum_j), the exponent masked to i >= j
      float acc[L / 16][L / 16];
      zero<L, L>(acc);
      mm<L, L, N>(acc, [&](int r, int k) { return sC[r * LN + k]; },
                  [&](int k, int j) { return sB[j * LN + k]; });
#pragma unroll
      for (int i = 0; i < L / 16; ++i)
#pragma unroll
        for (int j = 0; j < L / 16; ++j) {
          const int r = ty + 16 * i, q = tx + 16 * j;
          sM[r * LL + q] = r >= q ? acc[i][j] * expf(sCum[r] - sCum[q]) : 0.f;
        }
    }
    __syncthreads();

    {  // y = m (x dt) + (C state^T) exp(cum)
      float yi[L / 16][P / 16], ye[L / 16][P / 16];
      zero<L, P>(yi);
      zero<L, P>(ye);
      mm<L, P, L>(yi, [&](int r, int k) { return sM[r * LL + k]; },
                  [&](int k, int p) { return sX[k * LP + p] * sDt[k]; });
      mm<L, P, N>(ye, [&](int r, int k) { return sC[r * LN + k]; },
                  [&](int k, int p) { return sSt[p * LN + k]; });
#pragma unroll
      for (int i = 0; i < L / 16; ++i) {
        const int r = ty + 16 * i;
        const float e = expf(sCum[r]);
        T* row = y + (((size_t)bi * S + t0 + r) * H + h) * P;
#pragma unroll
        for (int j = 0; j < P / 16; ++j) row[tx + 16 * j] = from_f<T>(yi[i][j] + ye[i][j] * e);
      }
    }
    __syncthreads();  // every reader of the old state is done

    {  // state = exp(total) state + (x w)^T B; each thread updates its own entries
      float acc[P / 16][N / 16];
      zero<P, N>(acc);
      mm<P, N, L>(acc, [&](int p, int k) { return sX[k * LP + p] * sW[k]; },
                  [&](int k, int n) { return sB[k * LN + n]; });
      const float et = expf(total);
#pragma unroll
      for (int i = 0; i < P / 16; ++i)
#pragma unroll
        for (int j = 0; j < N / 16; ++j) {
          float* s = sSt + (ty + 16 * i) * LN + tx + 16 * j;
          *s = et * *s + acc[i][j];
        }
    }
  }
}

// ------------------------------------------------------------------------
// backward
// ------------------------------------------------------------------------
template <typename T, int P, int N>
__global__ void __launch_bounds__(NT)
ssd_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dt, const float* __restrict__ A,
               const T* __restrict__ bm, const T* __restrict__ cm,
               const float* __restrict__ states, const T* __restrict__ dy, T* __restrict__ dx,
               float* __restrict__ ddt, float* __restrict__ dda, float* __restrict__ dbh,
               float* __restrict__ dch, int S, int H) {
  constexpr int LP = P + 1, LN = N + 1;
  extern __shared__ float sm[];
  float* sX = sm;               // [L][LP]  x
  float* sDy = sX + L * LP;     // [L][LP]  dy
  float* sB = sDy + L * LP;     // [L][LN]  B
  float* sC = sB + L * LN;      // [L][LN]  C
  float* sS0 = sC + L * LN;     // [P][LN]  the chunk's input state
  float* sDs = sS0 + P * LN;    // [P][LN]  d(output state), then d(input state)
  float* sM = sDs + P * LN;     // [L][LL]  m = scores * decay
  float* sDec = sM + L * LL;    // [L][LL]  decay, then ddiff = dm * m
  float* sDS = sDec + L * LL;   // [L][LL]  dscores = dm * decay
  float* sDt = sDS + L * LL;    // [L]
  float* sCum = sDt + L;        // [L]  cumsum(dA)
  float* sE = sCum + L;         // [L]  exp(cum)
  float* sEtc = sE + L;         // [L]  exp(total - cum)
  float* sW = sEtc + L;         // [L]  exp(total - cum) dt
  float* sDw = sW + L;          // [L]  dw
  float* sDcum = sDw + L;       // [L]  d(cum)
  float* sDdt = sDcum + L;      // [L]  ddt from the intra-chunk term
  float* sRed = sDdt + L;       // [NT / 32]  per-warp partials of sum(ds1 * s0)

  const int bi = blockIdx.x / H, h = blockIdx.x % H, nc = S / L;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const float a = A[h];

  for (int i = tid; i < P * LN; i += NT) sDs[i] = 0.f;  // d(final state) = 0

  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * L;
    __syncthreads();  // the previous chunk's readers are done
    load_rows<T, P>(sX, x, bi, t0, S, H, h);
    load_rows<T, P>(sDy, dy, bi, t0, S, H, h);
    load_rows<T, N>(sB, bm, bi, t0, S, 1, 0);
    load_rows<T, N>(sC, cm, bi, t0, S, 1, 0);
    {
      const float* src = states + (((size_t)bi * H + h) * nc + c) * P * N;
      for (int i = tid; i < P * N; i += NT) sS0[(i / N) * LN + i % N] = src[i];
    }
    if (tid < L) {
      const float d = to_f(dt[((size_t)bi * S + t0 + tid) * H + h]);
      sDt[tid] = d;
      sCum[tid] = a * d;
    }
    __syncthreads();
    scan_inplace(sCum);
    __syncthreads();
    const float total = sCum[L - 1], et = expf(total);

    // ---- phase 1: per-row factors, decay and m, sum(ds1 * s0) ----------
    if (tid < L) {
      sE[tid] = expf(sCum[tid]);
      sEtc[tid] = expf(total - sCum[tid]);
      sW[tid] = sEtc[tid] * sDt[tid];
    }
    {
      float acc[L / 16][L / 16];
      zero<L, L>(acc);
      mm<L, L, N>(acc, [&](int r, int k) { return sC[r * LN + k]; },
                  [&](int k, int j) { return sB[j * LN + k]; });
#pragma unroll
      for (int i = 0; i < L / 16; ++i)
#pragma unroll
        for (int j = 0; j < L / 16; ++j) {
          const int r = ty + 16 * i, q = tx + 16 * j;
          const float dec = r >= q ? expf(sCum[r] - sCum[q]) : 0.f;
          sDec[r * LL + q] = dec;
          sM[r * LL + q] = acc[i][j] * dec;
        }
    }
    {
      float part = 0.f;
      for (int i = tid; i < P * N; i += NT) {
        const int at = (i / N) * LN + i % N;
        part = fmaf(sDs[at], sS0[at], part);
      }
      part = warp_sum(part);
      if (lane == 0) sRed[warp] = part;
    }
    __syncthreads();

    // ---- phase 2: (L, P) products and the dm tile ------------------------
    {  // dxw = B ds1^T, dxdt = m^T dy -> dx, dw, ddt (intra part)
      float dxw[L / 16][P / 16], dxdt[L / 16][P / 16];
      zero<L, P>(dxw);
      zero<L, P>(dxdt);
      mm<L, P, N>(dxw, [&](int r, int k) { return sB[r * LN + k]; },
                  [&](int k, int p) { return sDs[p * LN + k]; });
      mm<L, P, L>(dxdt, [&](int r, int k) { return sM[k * LL + r]; },
                  [&](int k, int p) { return sDy[k * LP + p]; });
#pragma unroll
      for (int i = 0; i < L / 16; ++i) {
        const int r = ty + 16 * i;
        const float w = sW[r], d = sDt[r];
        T* row = dx + (((size_t)bi * S + t0 + r) * H + h) * P;
        float dw = 0.f, dd = 0.f;
#pragma unroll
        for (int j = 0; j < P / 16; ++j) {
          const int p = tx + 16 * j;
          const float xv = sX[r * LP + p];
          row[p] = from_f<T>(w * dxw[i][j] + dxdt[i][j] * d);
          dw = fmaf(xv, dxw[i][j], dw);
          dd = fmaf(dxdt[i][j], xv, dd);
        }
        dw = row_sum16(dw);
        dd = row_sum16(dd);
        if (tx == 0) { sDw[r] = dw; sDdt[r] = dd; }
      }
    }
    {  // y_inter = (C s0^T) exp(cum): dcum += sum_p dy * y_inter
      float yin[L / 16][P / 16];
      zero<L, P>(yin);
      mm<L, P, N>(yin, [&](int r, int k) { return sC[r * LN + k]; },
                  [&](int k, int p) { return sS0[p * LN + k]; });
#pragma unroll
      for (int i = 0; i < L / 16; ++i) {
        const int r = ty + 16 * i;
        const float e = sE[r];
        float dc = 0.f;
#pragma unroll
        for (int j = 0; j < P / 16; ++j) dc = fmaf(sDy[r * LP + tx + 16 * j], yin[i][j] * e, dc);
        dc = row_sum16(dc);
        if (tx == 0) sDcum[r] = dc;
      }
    }
    {  // dm = dy (x dt)^T -> dscores = dm * decay, ddiff = dm * m
      float dm[L / 16][L / 16];
      zero<L, L>(dm);
      mm<L, L, P>(dm, [&](int r, int k) { return sDy[r * LP + k]; },
                  [&](int k, int j) { return sX[j * LP + k] * sDt[j]; });
#pragma unroll
      for (int i = 0; i < L / 16; ++i)
#pragma unroll
        for (int j = 0; j < L / 16; ++j) {
          const int at = (ty + 16 * i) * LL + tx + 16 * j;
          sDS[at] = dm[i][j] * sDec[at];
          sDec[at] = dm[i][j] * sM[at];
        }
    }
    __syncthreads();

    // ---- phase 3: dB, dC partials ----------------------------------------
    {  // db = w (x ds1) + dscores^T C
      float g[L / 16][N / 16], acc[L / 16][N / 16];
      zero<L, N>(g);
      zero<L, N>(acc);
      mm<L, N, P>(g, [&](int r, int k) { return sX[r * LP + k]; },
                  [&](int k, int n) { return sDs[k * LN + n]; });
      mm<L, N, L>(acc, [&](int r, int k) { return sDS[k * LL + r]; },
                  [&](int k, int n) { return sC[k * LN + n]; });
#pragma unroll
      for (int i = 0; i < L / 16; ++i) {
        const int r = ty + 16 * i;
        float* row = dbh + (((size_t)bi * S + t0 + r) * H + h) * N;
#pragma unroll
        for (int j = 0; j < N / 16; ++j) row[tx + 16 * j] = sW[r] * g[i][j] + acc[i][j];
      }
    }
    {  // dc = (dy exp(cum)) s0 + dscores B
      float d1[L / 16][N / 16], d2[L / 16][N / 16];
      zero<L, N>(d1);
      zero<L, N>(d2);
      mm<L, N, P>(d1, [&](int r, int k) { return sDy[r * LP + k] * sE[r]; },
                  [&](int k, int n) { return sS0[k * LN + n]; });
      mm<L, N, L>(d2, [&](int r, int k) { return sDS[r * LL + k]; },
                  [&](int k, int n) { return sB[k * LN + n]; });
#pragma unroll
      for (int i = 0; i < L / 16; ++i) {
        const int r = ty + 16 * i;
        float* row = dch + (((size_t)bi * S + t0 + r) * H + h) * N;
#pragma unroll
        for (int j = 0; j < N / 16; ++j) row[tx + 16 * j] = d1[i][j] + d2[i][j];
      }
    }
    __syncthreads();  // every reader of ds1 is done

    // ---- phase 4: d(input state), d(cum) and ddt -------------------------
    {  // ds0 = exp(total) ds1 + (dy exp(cum))^T C; each thread its own entries
      float acc[P / 16][N / 16];
      zero<P, N>(acc);
      mm<P, N, L>(acc, [&](int p, int k) { return sDy[k * LP + p] * sE[k]; },
                  [&](int k, int n) { return sC[k * LN + n]; });
#pragma unroll
      for (int i = 0; i < P / 16; ++i)
#pragma unroll
        for (int j = 0; j < N / 16; ++j) {
          float* s = sDs + (ty + 16 * i) * LN + tx + 16 * j;
          *s = et * *s + acc[i][j];
        }
    }
    if (tid < L) {
      float rs = 0.f, cs = 0.f;
      for (int q = 0; q < L; ++q) {
        rs += sDec[tid * LL + q];
        cs += sDec[q * LL + tid];
      }
      sDcum[tid] = (-(sDw[tid] * sW[tid]) + sDcum[tid]) + (rs - cs);
      ddt[((size_t)bi * S + t0 + tid) * H + h] = sDw[tid] * sEtc[tid] + sDdt[tid];
    }
    __syncthreads();

    // ---- phase 5: d(total) and d(dA) = inclusive suffix sum of d(cum) ----
    if (warp == 0) {
      float red = 0.f;
      for (int w = 0; w < NT / 32; ++w) red += sRed[w];
      const float dww = warp_sum(sDw[2 * lane] * sW[2 * lane] + sDw[2 * lane + 1] * sW[2 * lane + 1]);
      const float dtotal = et * red + dww;
      const float d0 = sDcum[2 * lane];
      const float d1 = sDcum[2 * lane + 1] + (lane == 31 ? dtotal : 0.f);
      float c0, c1;
      warp_scan64(d0, d1, c0, c1);
      const float last = __shfl_sync(0xffffffffu, c1, 31);
      float* out = dda + ((size_t)bi * S + t0) * H + h;
      out[(size_t)(2 * lane) * H] = (last - c0) + d0;
      out[(size_t)(2 * lane + 1) * H] = (last - c1) + d1;
    }
  }
}

constexpr size_t fwd_smem(int p, int n) {
  return sizeof(float) * ((size_t)L * (p + 1) + 2 * L * (n + 1) + p * (n + 1) + L * LL + 3 * L);
}
constexpr size_t bwd_smem(int p, int n) {
  return sizeof(float) * ((size_t)2 * L * (p + 1) + 2 * L * (n + 1) + 2 * p * (n + 1) +
                          3 * L * LL + 8 * L + NT / 32);
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int P, int N>
int fwd(const void* x, const void* dt, const float* A, const void* bm, const void* cm, void* y,
        float* states, int b, int s, int h, cudaStream_t st) {
  const size_t smem = fwd_smem(P, N);
  cudaError_t e = allow_smem(ssd_fwd_kernel<T, P, N>, smem);
  if (e != cudaSuccess) return (int)e;
  ssd_fwd_kernel<T, P, N><<<b * h, NT, smem, st>>>((const T*)x, (const T*)dt, A, (const T*)bm,
                                                   (const T*)cm, (T*)y, states, s, h);
  return (int)cudaGetLastError();
}

template <typename T, int P, int N>
int bwd(const void* x, const void* dt, const float* A, const void* bm, const void* cm,
        const float* states, const void* dy, void* dx, float* ddt, float* dda, float* dbh,
        float* dch, int b, int s, int h, cudaStream_t st) {
  const size_t smem = bwd_smem(P, N);
  cudaError_t e = allow_smem(ssd_bwd_kernel<T, P, N>, smem);
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_kernel<T, P, N><<<b * h, NT, smem, st>>>(
      (const T*)x, (const T*)dt, A, (const T*)bm, (const T*)cm, states, (const T*)dy, (T*)dx,
      ddt, dda, dbh, dch, s, h);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, dt, Bm, Cm, dy, y, dx). P: 64 or
// 128; N: 16 or 64; S a multiple of 64. Anything else returns
// cudaErrorInvalidValue without launching.
#define DISPATCH(FN, ...)                                                          \
  if (s % L != 0 || b < 1 || h < 1) return (int)cudaErrorInvalidValue;             \
  if (dtype == 0 && p == 64 && n == 64) return FN<float, 64, 64>(__VA_ARGS__);      \
  if (dtype == 0 && p == 64 && n == 16) return FN<float, 64, 16>(__VA_ARGS__);      \
  if (dtype == 0 && p == 128 && n == 64) return FN<float, 128, 64>(__VA_ARGS__);    \
  if (dtype == 0 && p == 128 && n == 16) return FN<float, 128, 16>(__VA_ARGS__);    \
  if (dtype == 1 && p == 64 && n == 64) return FN<__nv_bfloat16, 64, 64>(__VA_ARGS__);   \
  if (dtype == 1 && p == 64 && n == 16) return FN<__nv_bfloat16, 64, 16>(__VA_ARGS__);   \
  if (dtype == 1 && p == 128 && n == 64) return FN<__nv_bfloat16, 128, 64>(__VA_ARGS__); \
  if (dtype == 1 && p == 128 && n == 16) return FN<__nv_bfloat16, 128, 16>(__VA_ARGS__); \
  return (int)cudaErrorInvalidValue;

extern "C" {

// states may be null: the forward then keeps no per-chunk state.
int repro_ssd_fwd(const void* x, const void* dt, const void* A, const void* bm, const void* cm,
                  void* y, void* states, int b, int s, int h, int p, int n, int dtype,
                  void* stream) {
  DISPATCH(fwd, x, dt, (const float*)A, bm, cm, y, (float*)states, b, s, h, (cudaStream_t)stream)
}

int repro_ssd_bwd(const void* x, const void* dt, const void* A, const void* bm, const void* cm,
                  const void* states, const void* dy, void* dx, void* ddt, void* dda, void* dbh,
                  void* dch, int b, int s, int h, int p, int n, int dtype, void* stream) {
  DISPATCH(bwd, x, dt, (const float*)A, bm, cm, (const float*)states, dy, dx, (float*)ddt,
           (float*)dda, (float*)dbh, (float*)dch, b, s, h, (cudaStream_t)stream)
}

}  // extern "C"
