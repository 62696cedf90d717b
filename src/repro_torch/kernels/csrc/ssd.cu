// Mamba2 SSD chunk scan for Hopper (sm_90a): forward and backward, each as
// a narrow state pass followed by a wide chunk pass.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/mamba2_scan.py:
//   ssd_fwd_state_kernel + ssd_fwd_chunk_kernel <- _ssd_kernel /
//       _ssd_fwd_only_kernel (pallas_call in ssd_fwd)
//   ssd_bwd_state_kernel + ssd_bwd_chunk_kernel <- _ssd_bwd_kernel
//       (pallas_call in ssd_bwd)
//
// Math (per batch row b and head h; a chunk of L rows, cum = cumsum(A dt),
// total = cum[-1]):
//   y     = [(C B^T) * exp(cum_i - cum_j) masked i >= j] (x dt)
//         + (C state^T) * exp(cum)
//   state = exp(total) state + (x * exp(total - cum) dt)^T B
// and the backward carries d(state) from the last chunk to the first:
//   ds_{c-1} = exp(total_c) ds_c + (dy_c * exp(cum_c))^T C_c.
//
// Design (the SSD algorithm's own split, Dao & Gu 2024, arXiv:2405.21060
// section 6). The TPU grid (B, H, nc) walks the chunks in order and carries
// the (P, N) state in VMEM. Only that recurrence is serial, and it is
// separable over P, so each direction is two kernels on the caller's
// stream:
// - state pass, one block of 4 warps per (b, h, slab of 16 rows of P):
//   walks the chunks (ascending forward, descending backward) with its
//   (16, N) slab of the state in registers, recomputes the chunk's cumsum
//   (64 values, one warp scan), and writes each chunk's input state
//   (forward: `states`, the backward's residual) or d(output state)
//   (backward: `dstates`, scratch) to memory. The forward's slab starts
//   from an initial state read from memory (a prefill that continues a
//   cached state) or from 0 (training), and its state leaving the last
//   chunk goes to memory when the caller asks for it (the state a prefill
//   hands to decode); the backward starts from 0 and writes no final
//   d(state). The next chunk's slab of x or
//   dy and rows of B or C come in by 16-byte cp.async into a second buffer
//   while this chunk's product runs. (1, 2048, 112, 64, 64): 448 blocks,
//   all resident at once (45 KB of shared memory each).
// - chunk pass, one block of 8 warps per (b, h, chunk), 3584 blocks at
//   that shape: everything else of a chunk, with the state (and d(state))
//   read from memory instead of carried. Warp w owns 16 of the chunk's 64
//   rows and the even or odd 8-wide column tiles of each product, so the
//   causal tiles split evenly too. No atomics; every sum has a fixed order
//   (butterfly shuffles, partials of the two column halves and of the four
//   row groups added in index order), so a row's results do not depend on
//   B, H or the grid. Two blocks fit an SM (80 KB forward, 101 KB backward).
//
// Products run on the tensor cores as 3xTF32: mma.sync m16n8k8 tf32 with
// f32 accumulation, each f32 operand v split into hi = tf32(v) and
// lo = tf32(v - hi) (round to nearest, ties away, as cvt.rna.tf32.f32; done
// with two integer ops) and lo hi + hi lo + hi hi accumulated: ~2^-22
// relative per product (the lo lo term dropped), about f32's accuracy. One
// TF32 pass (2^-11) would be far past the 1e-4 parity limit. The (L, L)
// products (C B^T, m (x dt), m^T dy, dy x^T, dscores^T C, dscores B) skip
// the 8-wide tiles that lie wholly above the diagonal. A tile's row r is
// stored at r * W with column c at c ^ (8 (r & 3) + (r & 4)), an XOR
// swizzle under which the fragment loads of both A and B operands, plain
// or transposed, and the accumulator-layout float2 reads hit 32 distinct
// banks (ldmatrix does not split 32-bit words, so fragments are plain
// 32-bit shared loads). Loops over k stay rolled (unrolled twice): fully
// unrolled, the backward chunk pass, whose blocks each run their code
// once, measured slower (ssd_variants.py).
//
// What bounds them. At (1, 2048, 112, 64, 64) f32 the function moves ~180
// MB forward and ~360 MB backward (each input read once, each output
// written once); this design also writes and reads back the per-chunk
// states (forward) and d(state) (backward), ~295 and ~530 MB, floors of
// 0.089 and 0.159 ms at 3.35 TB/s. The products (5.7 and 14.2 GFLOP over
// the causal pairs) take three tf32 passes, 0.034 and 0.086 ms at 495
// TFLOP/s, so bytes bound the route. On the card the chunk passes are
// bound by issue instead: each mma step needs its operands split and
// addressed (~9 instructions an element), and the state passes by their
// 32 serial chunk steps (ssd_variants.py times each part). Exponents are masked before expf (only i >= j is computed; the
// rest is expf(-inf) = 0). dB and dC leave as per-head partials, summed
// over heads outside; the dA = A dt chain rule is also outside (ssd.py).
// The backward writes d(dA) as the inclusive suffix sum of d(cum), as the
// reference does.
//
// Layout is the model's: x, y, dx, dy (B, S, H, P); dt, ddt, d(dA)
// (B, S, H); Bm, Cm (B, S, N); dB, dC partials (B, S, H, N); states,
// dstates (B, H, nc, P, N) f32; the forward's initial and final states
// (B, H, P, N) f32. S is a multiple of L (the wrapper pads with dt = 0,
// which leaves the state as it is: exp(A 0) = 1 and x dt = 0). x, Bm, Cm, dy and the states are 16-byte aligned.
//
// Plain C interface for ctypes. Every entry returns cudaGetLastError()
// after its launch (0 on success). Launches go to the caller's stream.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int L = 64;      // chunk rows
constexpr int NWS = 4;     // warps per state-pass block
constexpr int NTS = 32 * NWS;
constexpr int SLAB = 16;   // rows of P per state-pass block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// store a pair of adjacent outputs
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---- shared-memory tiles ------------------------------------------------
// A row-major tile of width W (a power of two >= 16) with the XOR swizzle
// of the header; 4-float groups stay contiguous and 16-byte aligned.
template <int W>
struct Swz {
  static __device__ __forceinline__ int at(int r, int c) {
    return r * W + (c ^ ((((r & 3) << 3) | (r & 4)) & (W - 1)));
  }
};
// A row-major tile padded to stride S (the state pass's 16-wide slab, read
// only transposed: S = 24 puts rows t = 0..3 in distinct banks).
template <int S>
struct Pad {
  static __device__ __forceinline__ int at(int r, int c) { return r * S + c; }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ROWS x W elements of a row-major global array (row stride ld) into an f32
// tile of layout Lay: f32 by 16-byte cp.async (the caller commits), bf16
// through registers.
template <typename T, int ROWS, int W, class Lay, int THREADS>
__device__ __forceinline__ void load_tile(float* dst, const T* src, size_t ld) {
  constexpr int CW = W / 4;
  for (int i = threadIdx.x; i < ROWS * CW; i += THREADS) {
    const int r = i / CW, c = (i % CW) * 4;
    const T* g = src + r * ld + c;
    float* s = dst + Lay::at(r, c);
    if constexpr (std::is_same<T, float>::value) {
      cp_async_16(s, g);
    } else {
      const uint2 v = *reinterpret_cast<const uint2*>(g);
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
      *reinterpret_cast<float4*>(s) = make_float4(lo.x, lo.y, hi.x, hi.y);
    }
  }
}

// ---- warp reductions and the chunk's scan ------------------------------
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// inclusive prefix sums of (d0, d1) = rows (2 lane, 2 lane + 1) of a
// 64-row vector held by one warp
__device__ __forceinline__ void warp_scan64(float d0, float d1, float& c0, float& c1) {
  const int lane = threadIdx.x % 32;
  float t = d0 + d1;
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(FULL, t, o);
    if (lane >= o) t += u;
  }
  float excl = __shfl_up_sync(FULL, t, 1);
  if (lane == 0) excl = 0.f;
  c0 = excl + d0;
  c1 = excl + (d0 + d1);
}

// ---- 3xTF32 on mma.sync m16n8k8 ----------------------------------------
// Fragments (PTX ISA, mma.m16n8k8 .tf32; lane = 4 g + t):
//   A (16 x 8):  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8):   b0 (t, g), b1 (t + 4, g)
//   C (16 x 8):  c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
__device__ __forceinline__ uint32_t tf32_rna(uint32_t bits) {
  return (bits + 0x1000u) & 0xffffe000u;  // cvt.rna.tf32.f32 for finite values
}
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(__float_as_uint(v));
  lo = tf32_rna(__float_as_uint(v - __uint_as_float(hi)));
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// a(r, k): element (r, k) of the A operand; rows r0.., columns k0..
template <class F>
__device__ __forceinline__ FragA frag_a(F a, int r0, int k0) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  FragA f;
  split(a(r0 + g, k0 + t), f.hi[0], f.lo[0]);
  split(a(r0 + g + 8, k0 + t), f.hi[1], f.lo[1]);
  split(a(r0 + g, k0 + t + 4), f.hi[2], f.lo[2]);
  split(a(r0 + g + 8, k0 + t + 4), f.hi[3], f.lo[3]);
  return f;
}
// b(k, n): element (k, n) of the B operand; rows k0.., columns n0..
template <class F>
__device__ __forceinline__ FragB frag_b(F b, int k0, int n0) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  FragB f;
  split(b(k0 + t, n0 + g), f.hi[0], f.lo[0]);
  split(b(k0 + t + 4, n0 + g), f.hi[1], f.lo[1]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d += a b at about f32 accuracy: the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

template <int M, int K>
__device__ __forceinline__ void zero(float (&acc)[M][K]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j) acc[i][j] = 0.f;
}

// ------------------------------------------------------------------------
// state passes
// ------------------------------------------------------------------------
// Forward (REV false): u = x, v = B, weights exp(total - cum) dt, chunks
// ascending; out[c] = the state entering chunk c. Backward (REV true):
// u = dy, v = C, weights exp(cum), chunks descending; out[c] = d(the state
// leaving chunk c). Per chunk: out[c] = s; s = exp(total) s + (u wt)^T v
// over the block's 16 rows of P. s starts from init where it is not null
// (else 0), and fin, where it is not null, gets s after the last chunk.
// Warp w holds the n-tiles w, w + NWS, ...
template <typename T, int P, int N, bool REV>
__device__ __forceinline__ void state_pass(const T* __restrict__ u, const T* __restrict__ dt,
                                           const float* __restrict__ A,
                                           const T* __restrict__ v,
                                           const float* __restrict__ init,
                                           float* __restrict__ out, float* __restrict__ fin,
                                           int S, int H) {
  constexpr int XS = SLAB + 8;
  constexpr int NTILE = N / 8;
  constexpr int TPW = (NTILE + NWS - 1) / NWS;
  extern __shared__ float sm[];
  float* sU = sm;                    // [2][L][XS]  the slab of x or dy
  float* sV = sU + 2 * L * XS;       // [2][L][N]   B or C, swizzled
  float* sWt = sV + 2 * L * N;       // [L]         the row weights

  constexpr int slabs = P / SLAB;
  const int bh = blockIdx.x / slabs, p0 = (blockIdx.x % slabs) * SLAB;
  const int bi = bh / H, h = bh % H, nc = S / L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float a = A[h];

  auto issue = [&](int c, int stage) {
    const size_t row0 = (size_t)bi * S + (size_t)c * L;
    load_tile<T, L, SLAB, Pad<XS>, NTS>(sU + stage * L * XS, u + (row0 * H + h) * P + p0,
                                        (size_t)H * P);
    load_tile<T, L, N, Swz<N>, NTS>(sV + stage * L * N, v + row0 * N, N);
    cp_async_commit();
  };
  auto load_dt = [&](int c, float& d0, float& d1) {
    const T* src = dt + ((size_t)bi * S + (size_t)c * L + 2 * lane) * H + h;
    d0 = to_f(src[0]);
    d1 = to_f(src[H]);
  };

  // this thread's entries of the slab: rows g and g + 8, columns
  // nt 8 + 2 t and + 1 of each n-tile nt it holds
  const size_t slab0 = ((size_t)bi * H + h) * P * N + (size_t)p0 * N;
  float st[TPW][4];
  zero(st);
  if (init != nullptr) {  // the state entering chunk 0
#pragma unroll
    for (int j = 0; j < TPW; ++j) {
      const int nt = warp + NWS * j;
      if (nt < NTILE) {
        const float2 lo = *reinterpret_cast<const float2*>(init + slab0 + g * N + nt * 8 + 2 * t);
        const float2 hi =
            *reinterpret_cast<const float2*>(init + slab0 + (g + 8) * N + nt * 8 + 2 * t);
        st[j][0] = lo.x;
        st[j][1] = lo.y;
        st[j][2] = hi.x;
        st[j][3] = hi.y;
      }
    }
  }
  float d0, d1;
  issue(REV ? nc - 1 : 0, 0);
  load_dt(REV ? nc - 1 : 0, d0, d1);
  for (int i = 0; i < nc; ++i) {
    const int c = REV ? nc - 1 - i : i, stage = i & 1;
    const bool more = i + 1 < nc;
    float n0 = 0.f, n1 = 0.f;
    if (more) {  // prefetch the next chunk while this one computes
      issue(REV ? c - 1 : c + 1, stage ^ 1);
      load_dt(REV ? c - 1 : c + 1, n0, n1);
    }
    {
      float* dst = out + (((size_t)bi * H + h) * nc + c) * P * N + (size_t)p0 * N;
#pragma unroll
      for (int j = 0; j < TPW; ++j) {
        const int nt = warp + NWS * j;
        if (nt < NTILE) {
          store2(dst + g * N + nt * 8 + 2 * t, st[j][0], st[j][1]);
          store2(dst + (g + 8) * N + nt * 8 + 2 * t, st[j][2], st[j][3]);
        }
      }
    }
    // the chunk's cumsum, by every warp for itself; warp 0 keeps the weights
    float c0, c1;
    warp_scan64(a * d0, a * d1, c0, c1);
    const float total = __shfl_sync(FULL, c1, 31);
    if (warp == 0) {
      sWt[2 * lane] = REV ? expf(c0) : expf(total - c0) * d0;
      sWt[2 * lane + 1] = REV ? expf(c1) : expf(total - c1) * d1;
    }
    if (more)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();

    // every warp splits the same A operand (u wt)^T for itself: splitting it
    // once into shared memory costs a barrier a chunk and measured slower
    // (ssd_variants.py)
    const float* U = sU + stage * L * XS;
    const float* V = sV + stage * L * N;
    float acc[2 * TPW][4];  // even and odd k-steps: two shorter mma chains
    zero(acc);
#pragma unroll
    for (int k0 = 0; k0 < L; k0 += 8) {
      const FragA fa = frag_a([&](int r, int k) { return U[Pad<XS>::at(k, r)] * sWt[k]; }, 0, k0);
#pragma unroll
      for (int j = 0; j < TPW; ++j) {
        const int nt = warp + NWS * j;
        if (nt < NTILE) {
          const FragB fb = frag_b([&](int k, int n) { return V[Swz<N>::at(k, n)]; }, k0, nt * 8);
          mma3(acc[2 * j + (k0 / 8) % 2], fa, fb);
        }
      }
    }
    const float et = expf(total);
#pragma unroll
    for (int j = 0; j < TPW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[j][e] = et * st[j][e] + (acc[2 * j][e] + acc[2 * j + 1][e]);
    __syncthreads();  // every reader of this stage is done before it is refilled
    d0 = n0;
    d1 = n1;
  }
  if (fin != nullptr) {  // the state leaving the last chunk
#pragma unroll
    for (int j = 0; j < TPW; ++j) {
      const int nt = warp + NWS * j;
      if (nt < NTILE) {
        store2(fin + slab0 + g * N + nt * 8 + 2 * t, st[j][0], st[j][1]);
        store2(fin + slab0 + (g + 8) * N + nt * 8 + 2 * t, st[j][2], st[j][3]);
      }
    }
  }
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(NTS)
ssd_fwd_state_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ bm,
                     const float* __restrict__ init, float* __restrict__ states,
                     float* __restrict__ fin, int S, int H) {
  state_pass<T, P, N, false>(x, dt, A, bm, init, states, fin, S, H);
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(NTS)
ssd_bwd_state_kernel(const T* __restrict__ dy, const T* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ cm,
                     float* __restrict__ dstates, int S, int H) {
  state_pass<T, P, N, true>(dy, dt, A, cm, nullptr, dstates, nullptr, S, H);
}

constexpr size_t state_smem(int n) {
  return sizeof(float) * ((size_t)2 * L * (SLAB + 8) + 2 * L * n + L);
}

// ------------------------------------------------------------------------
// chunk passes: one block of 8 warps per (b, h, chunk). Warp w owns the
// rows 16 (w % 4) .. + 15 and, of every product, the 8-wide column tiles
// 2 i + w / 4: the even or the odd ones, which also halves the causal tiles
// evenly. Row sums over columns meet in shared memory, the two halves
// added in a fixed order.
// ------------------------------------------------------------------------
constexpr int NWC = 8;
constexpr int NTC = 32 * NWC;

struct Chunk {
  int bi, h, c, nc;
  size_t row0;  // first row of the chunk in the (B, S) rows
  __device__ __forceinline__ Chunk(int S, int H) {
    nc = S / L;
    h = blockIdx.x % H;
    c = (blockIdx.x / H) % nc;
    bi = blockIdx.x / (H * nc);
    row0 = (size_t)bi * S + (size_t)c * L;
  }
  __device__ __forceinline__ size_t state(int H, int P, int N) const {
    return (((size_t)bi * H + h) * nc + c) * P * N;
  }
};

struct Warp {
  int warp, lane, g, t, rg, ch, r0;
  __device__ __forceinline__ Warp() {
    warp = threadIdx.x / 32;
    lane = threadIdx.x % 32;
    g = lane / 4;
    t = lane % 4;
    rg = warp % 4;
    ch = warp / 4;
    r0 = 16 * rg;
  }
  __device__ __forceinline__ int tile(int i) const { return 2 * i + ch; }
};

// the chunk's dt and cumsum(A dt) into shared memory, by warp 0
template <typename T>
__device__ __forceinline__ void chunk_cum(const T* dt, float a, const Chunk& ck, int H,
                                          float* sDt, float* sCum) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const T* src = dt + (ck.row0 + 2 * lane) * H + ck.h;
    const float d0 = to_f(src[0]), d1 = to_f(src[H]);
    float c0, c1;
    warp_scan64(a * d0, a * d1, c0, c1);
    sDt[2 * lane] = d0;
    sDt[2 * lane + 1] = d1;
    sCum[2 * lane] = c0;
    sCum[2 * lane + 1] = c1;
  }
}

// exp(cum_i - cum_j), the exponent masked to i >= j before expf
__device__ __forceinline__ float decay(const float* sCum, int i, int j) {
  return expf(i >= j ? sCum[i] - sCum[j] : -INFINITY);
}

// G = C B^T over the warp's rows and its column tiles 2 i + ch, i <= rg
// (the tiles wholly above the diagonal are skipped)
template <int N>
__device__ __forceinline__ void scores(float (&acc)[L / 16][4], const float* sC,
                                       const float* sB, const Warp& W) {
  zero(acc);
#pragma unroll 2
  for (int k0 = 0; k0 < N; k0 += 8) {
    const FragA fa = frag_a([&](int r, int k) { return sC[Swz<N>::at(r, k)]; }, W.r0, k0);
#pragma unroll
    for (int i = 0; i < L / 16; ++i)
      if (i <= W.rg) {
        const FragB fb =
            frag_b([&](int k, int n) { return sB[Swz<N>::at(n, k)]; }, k0, 8 * W.tile(i));
        mma3(acc[i], fa, fb);
      }
  }
}

// ---- forward chunk pass --------------------------------------------------
template <typename T, int P, int N>
__global__ void __launch_bounds__(NTC, 2)
ssd_fwd_chunk_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ bm,
                     const T* __restrict__ cm, const float* __restrict__ states,
                     T* __restrict__ y, int S, int H) {
  extern __shared__ float sm[];
  float* sX = sm;              // [L][P]  x
  float* sB = sX + L * P;      // [L][N]  B
  float* sC = sB + L * N;      // [L][N]  C
  float* sS = sC + L * N;      // [P][N]  the chunk's input state
  float* sM = sS + P * N;      // [L][L]  (C B^T) * decay * dt_j
  float* sDt = sM + L * L;     // [L]
  float* sCum = sDt + L;       // [L]

  const Chunk ck(S, H);
  const Warp W;
  const int g = W.g, t = W.t, r0 = W.r0;
  load_tile<T, L, N, Swz<N>, NTC>(sB, bm + ck.row0 * N, N);
  load_tile<T, L, N, Swz<N>, NTC>(sC, cm + ck.row0 * N, N);
  cp_async_commit();
  load_tile<T, L, P, Swz<P>, NTC>(sX, x + (ck.row0 * H + ck.h) * P, (size_t)H * P);
  load_tile<float, P, N, Swz<N>, NTC>(sS, states + ck.state(H, P, N), N);
  cp_async_commit();
  chunk_cum(dt, A[ck.h], ck, H, sDt, sCum);
  cp_async_wait<1>();
  __syncthreads();

  {  // m = (C B^T) * exp(cum_i - cum_j) * dt_j, masked to i >= j
    float acc[L / 16][4];
    scores<N>(acc, sC, sB, W);
#pragma unroll
    for (int i = 0; i < L / 16; ++i)
      if (i <= W.rg) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = r0 + g + 8 * hf, j = 8 * W.tile(i) + 2 * t;
          store2(sM + Swz<L>::at(r, j), acc[i][2 * hf] * decay(sCum, r, j) * sDt[j],
                 acc[i][2 * hf + 1] * decay(sCum, r, j + 1) * sDt[j + 1]);
        }
      }
  }
  cp_async_wait<0>();
  __syncthreads();  // x and the state have landed; m is written

  // y = m x + (exp(cum) C) state^T, in column chunks of 64
  const float e_lo = expf(sCum[r0 + g]), e_hi = expf(sCum[r0 + g + 8]);
#pragma unroll 1
  for (int pc = 0; pc < P; pc += 64) {
    float acc[4][4];
    zero(acc);
#pragma unroll 2
    for (int kt = 0; kt <= 2 * W.rg + 1; ++kt) {  // j <= i
      const FragA fa = frag_a([&](int r, int k) { return sM[Swz<L>::at(r, k)]; }, r0, kt * 8);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const FragB fb = frag_b([&](int k, int n) { return sX[Swz<P>::at(k, n)]; }, kt * 8,
                                pc + 8 * W.tile(i));
        mma3(acc[i], fa, fb);
      }
    }
#pragma unroll 2
    for (int k0 = 0; k0 < N; k0 += 8) {
      const FragA fa = frag_a(
          [&](int r, int k) { return sC[Swz<N>::at(r, k)] * ((r & 8) ? e_hi : e_lo); }, r0, k0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const FragB fb = frag_b([&](int k, int n) { return sS[Swz<N>::at(n, k)]; }, k0,
                                pc + 8 * W.tile(i));
        mma3(acc[i], fa, fb);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        T* row = y + ((ck.row0 + r0 + g + 8 * hf) * H + ck.h) * P;
        store2(row + pc + 8 * W.tile(i) + 2 * t, acc[i][2 * hf], acc[i][2 * hf + 1]);
      }
  }
}

// ---- backward chunk pass -------------------------------------------------
// sum of a row's partial over the 4 lanes t of its quad; lane t == 0 keeps it
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(NTC, 2)
ssd_bwd_chunk_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ bm,
                     const T* __restrict__ cm, const float* __restrict__ states,
                     const float* __restrict__ dstates, const T* __restrict__ dy,
                     T* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ dda,
                     float* __restrict__ dbh, float* __restrict__ dch, int S, int H) {
  constexpr int PN4 = P * N / (4 * NTC);  // float4s of d(state) per thread
  constexpr int NTN = N / 16;             // the warp's column tiles of an N-wide product
  extern __shared__ float sm[];
  float* sX = sm;               // [L][P]  x
  float* sDy = sX + L * P;      // [L][P]  dy
  float* sB = sDy + L * P;      // [L][N]  B
  float* sC = sB + L * N;       // [L][N]  C
  float* sS = sC + L * N;       // [P][N]  the input state s0, then d(output state) ds1
  float* sM = sS + P * N;       // [L][L]  m = scores * decay, then dscores
  float* sDt = sM + L * L;      // [L]
  float* sCum = sDt + L;        // [L]  cumsum(dA)
  float* sE = sCum + L;         // [L]  exp(cum)
  float* sEtc = sE + L;         // [L]  exp(total - cum)
  float* sW = sEtc + L;         // [L]  exp(total - cum) dt
  float* sDw = sW + L;          // [2][L]  dw, by column half; then the sum
  float* sDd = sDw + 2 * L;     // [2][L]  ddt from the intra-chunk term
  float* sInt = sDd + 2 * L;    // [2][L]  sum_p dy y_inter
  float* sRs = sInt + 2 * L;    // [2][L]  row sums of ddiff
  float* sCol = sRs + 2 * L;    // [4][L]  column sums of ddiff over each row group
  float* sDcum = sCol + 4 * L;  // [L]  d(cum)
  float* sRed = sDcum + L;      // [NWC]  per-warp partials of sum(ds1 * s0)

  const Chunk ck(S, H);
  const Warp W;
  const int tid = threadIdx.x, lane = W.lane, g = W.g, t = W.t, r0 = W.r0;
  load_tile<T, L, N, Swz<N>, NTC>(sB, bm + ck.row0 * N, N);
  load_tile<T, L, N, Swz<N>, NTC>(sC, cm + ck.row0 * N, N);
  cp_async_commit();
  load_tile<T, L, P, Swz<P>, NTC>(sX, x + (ck.row0 * H + ck.h) * P, (size_t)H * P);
  load_tile<T, L, P, Swz<P>, NTC>(sDy, dy + (ck.row0 * H + ck.h) * P, (size_t)H * P);
  load_tile<float, P, N, Swz<N>, NTC>(sS, states + ck.state(H, P, N), N);
  cp_async_commit();
  chunk_cum(dt, A[ck.h], ck, H, sDt, sCum);
  cp_async_wait<1>();
  __syncthreads();
  const float total = sCum[L - 1], et = expf(total);

  // ---- phase 1: per-row factors; m = scores * decay ---------------------
  if (tid < L) {
    sE[tid] = expf(sCum[tid]);
    sEtc[tid] = expf(total - sCum[tid]);
    sW[tid] = sEtc[tid] * sDt[tid];
  }
  {
    float acc[L / 16][4];
    scores<N>(acc, sC, sB, W);
#pragma unroll
    for (int i = 0; i < L / 16; ++i)
      if (i <= W.rg) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = r0 + g + 8 * hf, j = 8 * W.tile(i) + 2 * t;
          store2(sM + Swz<L>::at(r, j), acc[i][2 * hf] * decay(sCum, r, j),
                 acc[i][2 * hf + 1] * decay(sCum, r, j + 1));
        }
      }
  }
  cp_async_wait<0>();
  __syncthreads();  // m, the row factors, x, dy and s0 are in place

  // ---- phase 2a: with s0 -------------------------------------------------
  // d(output state) comes in through registers while s0 is in use
  float4 ds1[PN4];
  {
    const float4* src = reinterpret_cast<const float4*>(dstates + ck.state(H, P, N));
#pragma unroll
    for (int i = 0; i < PN4; ++i) ds1[i] = src[i * NTC + tid];
  }
  const float e_lo = sE[r0 + g], e_hi = sE[r0 + g + 8];
  float dc[NTN][4];  // dC partial: (dy exp(cum)) s0, then + dscores B
  zero(dc);
#pragma unroll 2
  for (int k0 = 0; k0 < P; k0 += 8) {
    const FragA fa = frag_a(
        [&](int r, int k) { return sDy[Swz<P>::at(r, k)] * ((r & 8) ? e_hi : e_lo); }, r0, k0);
#pragma unroll
    for (int i = 0; i < NTN; ++i) {
      const FragB fb =
          frag_b([&](int k, int n) { return sS[Swz<N>::at(k, n)]; }, k0, 8 * W.tile(i));
      mma3(dc[i], fa, fb);
    }
  }
  {  // y_inter = (C s0^T) exp(cum): d(cum) += sum_p dy * y_inter
    float rs[2] = {0.f, 0.f};
#pragma unroll 1
    for (int pc = 0; pc < P; pc += 64) {
      float acc[4][4];
      zero(acc);
#pragma unroll 2
      for (int k0 = 0; k0 < N; k0 += 8) {
        const FragA fa = frag_a([&](int r, int k) { return sC[Swz<N>::at(r, k)]; }, r0, k0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const FragB fb = frag_b([&](int k, int n) { return sS[Swz<N>::at(n, k)]; }, k0,
                                  pc + 8 * W.tile(i));
          mma3(acc[i], fa, fb);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float e = hf ? e_hi : e_lo;
          const float2 d = *reinterpret_cast<const float2*>(
              sDy + Swz<P>::at(r0 + g + 8 * hf, pc + 8 * W.tile(i) + 2 * t));
          rs[hf] = fmaf(d.x, acc[i][2 * hf] * e, rs[hf]);
          rs[hf] = fmaf(d.y, acc[i][2 * hf + 1] * e, rs[hf]);
        }
    }
    rs[0] = quad_sum(rs[0]);
    rs[1] = quad_sum(rs[1]);
    if (t == 0) {
      sInt[W.ch * L + r0 + g] = rs[0];
      sInt[W.ch * L + r0 + g + 8] = rs[1];
    }
  }
  {  // sum(ds1 * s0)
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < PN4; ++i) {
      const int e = (i * NTC + tid) * 4;
      const float4 s = *reinterpret_cast<const float4*>(sS + Swz<N>::at(e / N, e % N));
      part = fmaf(ds1[i].x, s.x, part);
      part = fmaf(ds1[i].y, s.y, part);
      part = fmaf(ds1[i].z, s.z, part);
      part = fmaf(ds1[i].w, s.w, part);
    }
    part = warp_sum(part);
    if (lane == 0) sRed[W.warp] = part;
  }
  __syncthreads();  // every reader of s0 is done
#pragma unroll
  for (int i = 0; i < PN4; ++i) {
    const int e = (i * NTC + tid) * 4;
    *reinterpret_cast<float4*>(sS + Swz<N>::at(e / N, e % N)) = ds1[i];
  }
  __syncthreads();

  // ---- phase 2b: with ds1: dx, dw, ddt (intra part), dB's state part ----
  const float w_lo = sW[r0 + g], w_hi = sW[r0 + g + 8];
  {
    const float dt_lo = sDt[r0 + g], dt_hi = sDt[r0 + g + 8];
    float dw[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
#pragma unroll 1
    for (int pc = 0; pc < P; pc += 64) {
      float dxw[4][4], dxdt[4][4];
      zero(dxw);
      zero(dxdt);
#pragma unroll 2
      for (int k0 = 0; k0 < N; k0 += 8) {  // dxw = B ds1^T
        const FragA fa = frag_a([&](int r, int k) { return sB[Swz<N>::at(r, k)]; }, r0, k0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const FragB fb = frag_b([&](int k, int n) { return sS[Swz<N>::at(n, k)]; }, k0,
                                  pc + 8 * W.tile(i));
          mma3(dxw[i], fa, fb);
        }
      }
#pragma unroll 2
      for (int kt = 2 * W.rg; kt < L / 8; ++kt) {  // dxdt = m^T dy over i >= j
        const FragA fa = frag_a([&](int r, int k) { return sM[Swz<L>::at(k, r)]; }, r0, kt * 8);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const FragB fb = frag_b([&](int k, int n) { return sDy[Swz<P>::at(k, n)]; }, kt * 8,
                                  pc + 8 * W.tile(i));
          mma3(dxdt[i], fa, fb);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = r0 + g + 8 * hf, p = pc + 8 * W.tile(i) + 2 * t;
          const float w = hf ? w_hi : w_lo, d = hf ? dt_hi : dt_lo;
          const float2 xv = *reinterpret_cast<const float2*>(sX + Swz<P>::at(r, p));
          const float a0 = dxw[i][2 * hf], a1 = dxw[i][2 * hf + 1];
          const float b0 = dxdt[i][2 * hf], b1 = dxdt[i][2 * hf + 1];
          store2(dx + ((ck.row0 + r) * H + ck.h) * P + p, w * a0 + b0 * d, w * a1 + b1 * d);
          dw[hf] = fmaf(xv.y, a1, fmaf(xv.x, a0, dw[hf]));
          dd[hf] = fmaf(b1, xv.y, fmaf(b0, xv.x, dd[hf]));
        }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      dw[hf] = quad_sum(dw[hf]);
      dd[hf] = quad_sum(dd[hf]);
    }
    if (t == 0) {
      sDw[W.ch * L + r0 + g] = dw[0];
      sDw[W.ch * L + r0 + g + 8] = dw[1];
      sDd[W.ch * L + r0 + g] = dd[0];
      sDd[W.ch * L + r0 + g + 8] = dd[1];
    }
  }
  float db[NTN][4];  // dB partial: w (x ds1), then + dscores^T C
  zero(db);
#pragma unroll 2
  for (int k0 = 0; k0 < P; k0 += 8) {
    const FragA fa = frag_a([&](int r, int k) { return sX[Swz<P>::at(r, k)]; }, r0, k0);
#pragma unroll
    for (int i = 0; i < NTN; ++i) {
      const FragB fb =
          frag_b([&](int k, int n) { return sS[Swz<N>::at(k, n)]; }, k0, 8 * W.tile(i));
      mma3(db[i], fa, fb);
    }
  }
#pragma unroll
  for (int i = 0; i < NTN; ++i) {
    db[i][0] *= w_lo;
    db[i][1] *= w_lo;
    db[i][2] *= w_hi;
    db[i][3] *= w_hi;
  }
  __syncthreads();  // every reader of m^T is done

  // ---- phase 3: dm = (dy x^T) dt_j; ddiff = dm m; dscores = dm decay ----
  {
    float acc[L / 16][4];
    zero(acc);
#pragma unroll 2
    for (int k0 = 0; k0 < P; k0 += 8) {
      const FragA fa = frag_a([&](int r, int k) { return sDy[Swz<P>::at(r, k)]; }, r0, k0);
#pragma unroll
      for (int i = 0; i < L / 16; ++i)
        if (i <= W.rg) {
          const FragB fb =
              frag_b([&](int k, int n) { return sX[Swz<P>::at(n, k)]; }, k0, 8 * W.tile(i));
          mma3(acc[i], fa, fb);
        }
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < L / 16; ++i)
      if (i <= W.rg) {
        float cs[2] = {0.f, 0.f};
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = r0 + g + 8 * hf, j = 8 * W.tile(i) + 2 * t;
          float* at = sM + Swz<L>::at(r, j);
          const float2 m = *reinterpret_cast<const float2*>(at);
          const float dm0 = acc[i][2 * hf] * sDt[j], dm1 = acc[i][2 * hf + 1] * sDt[j + 1];
          const float dd0 = dm0 * m.x, dd1 = dm1 * m.y;
          rs[hf] += dd0 + dd1;
          cs[0] += dd0;
          cs[1] += dd1;
          store2(at, dm0 * decay(sCum, r, j), dm1 * decay(sCum, r, j + 1));
        }
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {  // over the warp's 16 rows
          cs[0] += __shfl_xor_sync(FULL, cs[0], o);
          cs[1] += __shfl_xor_sync(FULL, cs[1], o);
        }
        if (g == 0) {
          sCol[W.rg * L + 8 * W.tile(i) + 2 * t] = cs[0];
          sCol[W.rg * L + 8 * W.tile(i) + 2 * t + 1] = cs[1];
        }
      }
    rs[0] = quad_sum(rs[0]);
    rs[1] = quad_sum(rs[1]);
    if (t == 0) {
      sRs[W.ch * L + r0 + g] = rs[0];
      sRs[W.ch * L + r0 + g + 8] = rs[1];
    }
  }
  __syncthreads();  // dscores and the partial sums are complete

  // ---- phase 4: dB, dC partials ----------------------------------------
#pragma unroll 2
  for (int kt = 2 * W.rg; kt < L / 8; ++kt) {  // db += dscores^T C over i >= j
    const FragA fa = frag_a([&](int r, int k) { return sM[Swz<L>::at(k, r)]; }, r0, kt * 8);
#pragma unroll
    for (int i = 0; i < NTN; ++i) {
      const FragB fb =
          frag_b([&](int k, int n) { return sC[Swz<N>::at(k, n)]; }, kt * 8, 8 * W.tile(i));
      mma3(db[i], fa, fb);
    }
  }
#pragma unroll 2
  for (int kt = 0; kt <= 2 * W.rg + 1; ++kt) {  // dc += dscores B over j <= i
    const FragA fa = frag_a([&](int r, int k) { return sM[Swz<L>::at(r, k)]; }, r0, kt * 8);
#pragma unroll
    for (int i = 0; i < NTN; ++i) {
      const FragB fb =
          frag_b([&](int k, int n) { return sB[Swz<N>::at(k, n)]; }, kt * 8, 8 * W.tile(i));
      mma3(dc[i], fa, fb);
    }
  }
#pragma unroll
  for (int i = 0; i < NTN; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const size_t at = ((ck.row0 + r0 + g + 8 * hf) * H + ck.h) * N + 8 * W.tile(i) + 2 * t;
      store2(dbh + at, db[i][2 * hf], db[i][2 * hf + 1]);
      store2(dch + at, dc[i][2 * hf], dc[i][2 * hf + 1]);
    }

  // ---- phase 5: ddt; d(total) and d(dA) = inclusive suffix sum of d(cum)
  if (tid < L) {
    // d(cum) = ((-(dw w) + inter) + row sum) - column sum, as the reference
    const float dw = sDw[tid] + sDw[L + tid];
    float cs = 0.f;
    for (int rg = tid / 16; rg < 4; ++rg) cs += sCol[rg * L + tid];
    sDcum[tid] =
        ((-(dw * sW[tid]) + (sInt[tid] + sInt[L + tid])) + (sRs[tid] + sRs[L + tid])) - cs;
    ddt[(ck.row0 + tid) * H + ck.h] = dw * sEtc[tid] + (sDd[tid] + sDd[L + tid]);
    sDw[tid] = dw;
  }
  __syncthreads();
  if (W.warp == 0) {
    float red = 0.f;
    for (int w = 0; w < NWC; ++w) red += sRed[w];
    const float dww = warp_sum(sDw[2 * lane] * sW[2 * lane] + sDw[2 * lane + 1] * sW[2 * lane + 1]);
    const float dtotal = et * red + dww;
    const float d0 = sDcum[2 * lane];
    const float d1 = sDcum[2 * lane + 1] + (lane == 31 ? dtotal : 0.f);
    float c0, c1;
    warp_scan64(d0, d1, c0, c1);
    const float last = __shfl_sync(FULL, c1, 31);
    float* out = dda + ck.row0 * H + ck.h;
    out[(size_t)(2 * lane) * H] = (last - c0) + d0;
    out[(size_t)(2 * lane + 1) * H] = (last - c1) + d1;
  }
}

constexpr size_t fwd_chunk_smem(int p, int n) {
  return sizeof(float) * ((size_t)L * p + 2 * L * n + p * n + L * L + 2 * L);
}
constexpr size_t bwd_chunk_smem(int p, int n) {
  return sizeof(float) * ((size_t)2 * L * p + 2 * L * n + p * n + L * L + 18 * L + NWC);
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int P, int N>
int fwd_state(const void* x, const void* dt, const float* A, const void* bm, const float* init,
              float* states, float* fin, int b, int s, int h, cudaStream_t st) {
  const size_t smem = state_smem(N);
  cudaError_t e = allow_smem(ssd_fwd_state_kernel<T, P, N>, smem);
  if (e != cudaSuccess) return (int)e;
  ssd_fwd_state_kernel<T, P, N><<<b * h * (P / SLAB), NTS, smem, st>>>(
      (const T*)x, (const T*)dt, A, (const T*)bm, init, states, fin, s, h);
  return (int)cudaGetLastError();
}

template <typename T, int P, int N>
int fwd_chunk(const void* x, const void* dt, const float* A, const void* bm, const void* cm,
              const float* states, void* y, int b, int s, int h, cudaStream_t st) {
  const size_t smem = fwd_chunk_smem(P, N);
  cudaError_t e = allow_smem(ssd_fwd_chunk_kernel<T, P, N>, smem);
  if (e != cudaSuccess) return (int)e;
  ssd_fwd_chunk_kernel<T, P, N><<<b * h * (s / L), NTC, smem, st>>>(
      (const T*)x, (const T*)dt, A, (const T*)bm, (const T*)cm, states, (T*)y, s, h);
  return (int)cudaGetLastError();
}

template <typename T, int P, int N>
int bwd_state(const void* dt, const float* A, const void* cm, const void* dy, float* dstates,
              int b, int s, int h, cudaStream_t st) {
  const size_t smem = state_smem(N);
  cudaError_t e = allow_smem(ssd_bwd_state_kernel<T, P, N>, smem);
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_state_kernel<T, P, N><<<b * h * (P / SLAB), NTS, smem, st>>>(
      (const T*)dy, (const T*)dt, A, (const T*)cm, dstates, s, h);
  return (int)cudaGetLastError();
}

template <typename T, int P, int N>
int bwd_chunk(const void* x, const void* dt, const float* A, const void* bm, const void* cm,
              const float* states, const float* dstates, const void* dy, void* dx, float* ddt,
              float* dda, float* dbh, float* dch, int b, int s, int h, cudaStream_t st) {
  const size_t smem = bwd_chunk_smem(P, N);
  cudaError_t e = allow_smem(ssd_bwd_chunk_kernel<T, P, N>, smem);
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_chunk_kernel<T, P, N><<<b * h * (s / L), NTC, smem, st>>>(
      (const T*)x, (const T*)dt, A, (const T*)bm, (const T*)cm, states, dstates, (const T*)dy,
      (T*)dx, ddt, dda, dbh, dch, s, h);
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

// the forward state pass: each chunk's input state into states, starting
// from init (B, H, P, N) f32, or from 0 where init is null; the state
// leaving the last chunk into final_state (B, H, P, N) f32 unless it is null
int repro_ssd_fwd_state(const void* x, const void* dt, const void* A, const void* bm,
                        const void* init, void* states, void* final_state, int b, int s, int h,
                        int p, int n, int dtype, void* stream) {
  DISPATCH(fwd_state, x, dt, (const float*)A, bm, (const float*)init, (float*)states,
           (float*)final_state, b, s, h, (cudaStream_t)stream)
}

// the forward chunk pass: y from the inputs and each chunk's input state
int repro_ssd_fwd_chunk(const void* x, const void* dt, const void* A, const void* bm,
                        const void* cm, const void* states, void* y, int b, int s, int h, int p,
                        int n, int dtype, void* stream) {
  DISPATCH(fwd_chunk, x, dt, (const float*)A, bm, cm, (const float*)states, y, b, s, h,
           (cudaStream_t)stream)
}

// the backward state pass: each chunk's d(output state) into dstates
int repro_ssd_bwd_state(const void* dt, const void* A, const void* cm, const void* dy,
                        void* dstates, int b, int s, int h, int p, int n, int dtype,
                        void* stream) {
  DISPATCH(bwd_state, dt, (const float*)A, cm, dy, (float*)dstates, b, s, h, (cudaStream_t)stream)
}

// the backward chunk pass: dx, ddt, d(dA) and the dB, dC partials
int repro_ssd_bwd_chunk(const void* x, const void* dt, const void* A, const void* bm,
                        const void* cm, const void* states, const void* dstates, const void* dy,
                        void* dx, void* ddt, void* dda, void* dbh, void* dch, int b, int s, int h,
                        int p, int n, int dtype, void* stream) {
  DISPATCH(bwd_chunk, x, dt, (const float*)A, bm, cm, (const float*)states,
           (const float*)dstates, dy, dx, (float*)ddt, (float*)dda, (float*)dbh, (float*)dch, b,
           s, h, (cudaStream_t)stream)
}

}  // extern "C"
