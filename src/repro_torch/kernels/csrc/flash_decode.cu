// Flash decode for Hopper (sm_90a): one query row per (batch, head) against
// a KV cache, over a linear cache or through a paged block table.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_decode.py:
//   flash_decode_kernel<.., false> <- _flash_decode_kernel       (pallas_call in flash_decode)
//   flash_decode_kernel<.., true>  <- _flash_decode_paged_kernel (pallas_call in flash_decode_paged)
//
// What bounds them. Each (batch, head) reads its valid K and V rows once
// and does 4 D flops per row: about one flop per byte of bf16 cache, far
// below the H100's ~295 bf16 operations per byte. The bound is the bytes of
// the valid cache rows over the memory rate, so the design is about keeping
// enough loads in flight: every lane loads 16 contiguous bytes of a row, a
// group of D * sizeof(T) / 16 lanes (a "sub-warp") covers one row, and each
// sub-warp has four K rows and four V rows in flight per step.
//
// Layout. q and o are (B, 1, H, D) (the model's layout); the linear cache is
// (B, S, H_kv, D) and the paged pools are (N, page_size, H_kv, D) with a
// (B, P) int32 block table. Query head h reads kv head h / (H / H_kv): the
// kv heads are never repeated in memory.
//
// The TPU kernels walk the kv blocks as a sequential grid axis and carry
// m / l / acc in VMEM scratch. Here one block of 8 warps owns one
// (batch, head); its sub-warps take the keys in turn (sub-warp j takes keys
// j, j + NSUB, j + 2 NSUB, ...), each keeping its own running m / l / acc in
// registers, and the partial results merge in shared memory in a fixed
// order. The order of every sum depends only on the key positions, so the
// linear and the paged kernel give the same bits on the same cache rows.
// Split-K across blocks, cp.async and TMA pipelines are later work.
//
// Semantics follow the reference kernels: q is scaled by d**-0.5 in f32
// before the dot product; only keys kpos < lengths[b] count (lengths past
// the cache are clamped to it); a masked probability is exactly 0; the
// output is acc / max(l, 1e-30) in q's type, so a slot with length 0 gives
// 0. The ragged edge is masked in the kernel, not padded. The paged kernel
// walks the table only up to ceil(length / page_size) pages and never
// dereferences a -1 entry: its keys count as masked (the reference clamps
// -1 to page 0 and masks it by length, which gives the same result).
//
// Plain C interface for ctypes. Every entry returns cudaGetLastError()
// after its launch (0 on success). Launches go to the caller's stream.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;          // warps per block
constexpr int NT = NW * 32;    // threads per block
constexpr int U = 4;           // keys in flight per sub-warp and step

template <typename T, int D>
struct Geo {
  static constexpr int EPL = 16 / sizeof(T);   // elements per lane: 16 bytes
  static constexpr int LPK = D / EPL;          // lanes per key row
  static constexpr int KPW = 32 / LPK;         // key rows per warp and step
  static constexpr int NSUB = NW * KPW;        // sub-warps per block
  static_assert(LPK >= 1 && LPK <= 32 && 32 % LPK == 0, "unsupported head_dim");
};

// 16 bytes of a row -> EPL floats
__device__ __forceinline__ void unpack(const uint4& raw, float* out, const float*) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}

__device__ __forceinline__ void unpack(const uint4& raw, float* out, const __nv_bfloat16*) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) { *dst = __float2bfloat16_rn(x); }

// Where key row `pos` of (batch b, kv head kvh) lives, or nullptr when its
// page is unassigned. Linear: k + ((b * S + pos) * H_kv + kvh) * D. Paged:
// pool + ((page * page_size + pos % page_size) * H_kv + kvh) * D.
template <typename T, int D, bool PAGED>
struct Rows {
  const T* base;
  const int* table;   // this batch's row of the block table (paged only)
  int rows, h_kv, kvh;

  __device__ __forceinline__ const T* at(int pos) const {
    if (PAGED) {
      const int page = __ldg(table + pos / rows);
      if (page < 0) return nullptr;
      return base + (((size_t)page * rows + pos % rows) * h_kv + kvh) * D;
    }
    return base + ((size_t)pos * h_kv + kvh) * D;
  }
};

template <typename T, int D, bool PAGED>
__global__ void __launch_bounds__(NT)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ lengths, const int* __restrict__ pages,
                    T* __restrict__ o, int h, int h_kv, int rows, int p_tab, float scale) {
  using G = Geo<T, D>;
  constexpr int EPL = G::EPL, LPK = G::LPK, KPW = G::KPW, NSUB = G::NSUB;
  __shared__ float sm_acc[NSUB * D];
  __shared__ float sm_m[NSUB], sm_l[NSUB];

  const int b = blockIdx.x / h, hh = blockIdx.x % h;
  const int kvh = hh / (h / h_kv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / LPK, sl = lane % LPK;
  const int sw = warp * KPW + sub;     // this sub-warp's index in the block
  const int c0 = sl * EPL;             // first channel this lane holds

  // linear: `rows` is S and the cache holds S rows; paged: `rows` is the
  // page size and the table covers p_tab pages
  const int cap = PAGED ? p_tab * rows : rows;
  const int n = min(max(lengths[b], 0), cap);

  Rows<T, D, PAGED> kr{PAGED ? k : k + (size_t)b * rows * h_kv * D,
                       PAGED ? pages + (size_t)b * p_tab : nullptr, rows, h_kv, kvh};
  Rows<T, D, PAGED> vr{PAGED ? v : v + (size_t)b * rows * h_kv * D, kr.table, rows, h_kv, kvh};

  float qf[EPL];
  unpack(*reinterpret_cast<const uint4*>(q + ((size_t)b * h + hh) * D + c0), qf, q);
#pragma unroll
  for (int e = 0; e < EPL; ++e) qf[e] *= scale;

  float m = -INFINITY, l = 0.f, acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;

  // the loop bound is the same for every lane of a warp, so the shuffles
  // below always run converged; a sub-warp past the end masks its keys
  for (int it = warp * KPW; it < n; it += NSUB * U) {
    uint4 kraw[U], vraw[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pos = it + sub + u * NSUB;
      const T* kp = pos < n ? kr.at(pos) : nullptr;
      ok[u] = kp != nullptr;
      if (ok[u]) {
        kraw[u] = *reinterpret_cast<const uint4*>(kp + c0);
        vraw[u] = *reinterpret_cast<const uint4*>(vr.at(pos) + c0);
      } else {
        kraw[u] = make_uint4(0, 0, 0, 0);
        vraw[u] = make_uint4(0, 0, 0, 0);
      }
    }
    float s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[EPL];
      unpack(kraw[u], kf, q);
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) part = fmaf(qf[e], kf[e], part);
#pragma unroll
      for (int off = LPK / 2; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
      s[u] = ok[u] ? part : -INFINITY;
    }
    float mx = m;
#pragma unroll
    for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u]);
    if (mx == -INFINITY) continue;     // no valid key yet in this sub-warp
    const float corr = expf(m - mx);   // 0 while m is still -inf
    l *= corr;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] *= corr;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float p = ok[u] ? expf(s[u] - mx) : 0.f;
      float vf[EPL];
      unpack(vraw[u], vf, q);
      l += p;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[e] = fmaf(p, vf[e], acc[e]);
    }
    m = mx;
  }

  // merge the sub-warps' (m, l, acc) in a fixed order
#pragma unroll
  for (int e = 0; e < EPL; ++e) sm_acc[sw * D + c0 + e] = acc[e];
  if (sl == 0) {
    sm_m[sw] = m;
    sm_l[sw] = l;
  }
  __syncthreads();
  if (threadIdx.x < D) {
    const int c = threadIdx.x;
    float mg = -INFINITY;
    for (int j = 0; j < NSUB; ++j) mg = fmaxf(mg, sm_m[j]);
    float lg = 0.f, ag = 0.f;
    for (int j = 0; j < NSUB; ++j) {
      const float f = sm_m[j] == -INFINITY ? 0.f : expf(sm_m[j] - mg);
      lg = fmaf(f, sm_l[j], lg);
      ag = fmaf(f, sm_acc[j * D + c], ag);
    }
    store(o + ((size_t)b * h + hh) * D + c, ag / fmaxf(lg, 1e-30f));
  }
}

template <typename T, int D, bool PAGED>
int launch(const void* q, const void* k, const void* v, const int* lengths, const int* pages,
           void* o, int b, int h, int h_kv, int rows, int p_tab, float scale, cudaStream_t st) {
  if (b * h == 0) return 0;
  flash_decode_kernel<T, D, PAGED><<<b * h, NT, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)v, lengths, pages, (T*)o, h, h_kv, rows, p_tab, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. head_dim: 64 or 128. Anything else
// returns cudaErrorInvalidValue without launching.
#define DISPATCH(PAGED, ...)                                                         \
  if (dtype == 0 && d == 64) return launch<float, 64, PAGED>(__VA_ARGS__);           \
  if (dtype == 0 && d == 128) return launch<float, 128, PAGED>(__VA_ARGS__);         \
  if (dtype == 1 && d == 64) return launch<__nv_bfloat16, 64, PAGED>(__VA_ARGS__);   \
  if (dtype == 1 && d == 128) return launch<__nv_bfloat16, 128, PAGED>(__VA_ARGS__); \
  return (int)cudaErrorInvalidValue;

extern "C" {

// q, o: (B, 1, H, D); k, v: (B, S, H_kv, D); lengths: (B,) int32
int repro_flash_decode(const void* q, const void* k, const void* v, const void* lengths, void* o,
                       int b, int h, int h_kv, int s, int d, int dtype, float scale,
                       void* stream) {
  DISPATCH(false, q, k, v, (const int*)lengths, nullptr, o, b, h, h_kv, s, 0, scale,
           (cudaStream_t)stream)
}

// q, o: (B, 1, H, D); k_pool, v_pool: (N, page_size, H_kv, D); pages: (B, P)
// int32 with -1 = unassigned; lengths: (B,) int32
int repro_flash_decode_paged(const void* q, const void* k_pool, const void* v_pool,
                             const void* pages, const void* lengths, void* o, int b, int h,
                             int h_kv, int page_size, int p_tab, int d, int dtype, float scale,
                             void* stream) {
  DISPATCH(true, q, k_pool, v_pool, (const int*)lengths, (const int*)pages, o, b, h, h_kv,
           page_size, p_tab, scale, (cudaStream_t)stream)
}

}  // extern "C"
