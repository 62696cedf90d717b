// Flash decode for Hopper (sm_90a): one query row per (batch, head) against
// a KV cache, over a linear cache or through a paged block table.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_decode.py:
//   flash_decode_split_kernel<.., false> <- _flash_decode_kernel       (pallas_call in flash_decode)
//   flash_decode_split_kernel<.., true>  <- _flash_decode_paged_kernel (pallas_call in flash_decode_paged)
//   (flash_decode_merge_kernel combines the splits of either)
//
// What bounds them. Each (batch, kv head) reads its valid K and V rows once
// and does 4 D flops per row and query head: a few flops per byte of bf16
// cache, far below the H100's ~295 bf16 operations per byte. The bound is
// the bytes of the valid cache rows over the memory rate, so the design is
// about keeping enough loads in flight on enough SMs, and reading each row
// once: every lane loads 16 contiguous bytes of a row, a group of
// D * sizeof(T) / 16 lanes, rounded up to a power of two (a "sub-warp"),
// covers one row, and each sub-warp has four K rows and four V rows in
// flight per step. At D = 112 a sub-warp's last lanes (4 of 32 in f32,
// 2 of 16 in bf16) hold no channel and sit out the loads. A row wider than
// 32 such loads (f32 at D = 160: 40) takes two 16-byte loads a lane, 32
// contiguous bytes, and then two K and two V rows in flight per step, so
// a lane holds as many bytes as elsewhere; 20 of a warp's 32 lanes then
// hold channels, as in bf16 at D = 160.
//
// Layout. q and o are (B, 1, H, D) (the model's layout); the linear cache is
// (B, S, H_kv, D) and the paged pools are (N, page_size, H_kv, D) with a
// (B, P) int32 block table. Query head h reads kv head h / (H / H_kv): the
// kv heads are never repeated in memory.
//
// Split-K ("flash-decoding"). The TPU kernels walk the kv blocks as a
// sequential grid axis and carry m / l / acc in VMEM scratch. Here a block
// of 8 warps owns one (slot, kv head, split): the `split` key positions
// [i split, (i + 1) split) of the slot (split is an argument, 1 to
// SPLIT_MAX; the wrappers take 256 unless the autotuned table or the
// caller names another), and every query head of that kv
// head's group (up to 8 of them; a larger group takes several blocks), so
// each K and V row is read from memory once for the whole group. Its
// sub-warps take the split's keys in turn (sub-warp j takes keys k0 + j,
// k0 + j + NSUB, ...), each keeping a running m / l / acc per query head in
// registers; the sub-warps of a warp merge by xor shuffles, the warps in
// shared memory in warp order, and the block writes its split's (m, l,
// acc) per query head to a workspace. A second kernel merges each (slot,
// head)'s splits in split order. The paged kernel first stages the split's
// block-table entries in shared memory, so no row load waits on a table
// load from device memory.
//
// Which bits a row gets. Split boundaries and the merge order depend only
// on key positions, the slot's length and `split`: never on B, H, the
// table width, the cache's capacity or the card. A different split sums
// in another order and gives other bits, so every decode call of one
// (head_dim, dtype) must take the same split (kernels/autotune.py keeps
// one split per pair). So the linear and the paged kernel
// give the same bits on the same cache rows, and a slot gives the same
// bits alone and among other slots (engine == solo generation).
//
// Semantics follow the reference kernels: q is scaled by d**-0.5 in f32
// before the dot product; only keys kpos < lengths[b] count (lengths past
// the cache are clamped to it); a masked probability is exactly 0; the
// output is acc / max(l, 1e-30) in q's type, so a slot with length 0 gives
// 0. The ragged edge is masked in the kernel, not padded. The paged kernel
// reads the table only for the pages a slot's length covers and never
// dereferences a -1 entry: its keys count as masked (the reference clamps
// -1 to page 0 and masks it by length, which gives the same result).
//
// Sources. This header holds the kernels and their launchers. Their
// instances are compiled in several sources (see repro_decode::Kernels
// below), so that nvcc compiles them side by side; flash_decode.cu holds the
// plain C entries and dispatches to them.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;          // warps per block
constexpr int NT = NW * 32;    // threads per block
constexpr int SPLIT_MAX = 512; // key positions per split, at most (sm_tab)

constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2); }

// A row of D elements takes D / EPL lanes, each NV loads of 16 bytes (NV
// is 1 unless a row is wider than 32 loads); a sub-warp is that rounded up
// to a power of two, so it divides the warp. At D = 112 and 160 the last
// lanes of a sub-warp hold no channel (f32 D = 112: 28 of 32 lanes live,
// bf16 D = 112: 14 of 16, D = 160: 20 of 32): they load nothing and add 0
// to every sum.
template <typename T, int D>
struct Geo {
  static constexpr int EPV = 16 / sizeof(T);   // elements per 16-byte load
  static constexpr int NV = (D / EPV + 31) / 32;  // loads a lane takes of a row
  static constexpr int EPL = NV * EPV;         // elements per lane
  static constexpr int LPK = pow2_at_least(D / EPL);  // lanes per key row
  static constexpr int KPW = 32 / LPK;         // key rows per warp and step
  static constexpr int NSUB = NW * KPW;        // sub-warps per block
  static constexpr int U = 4 / NV;             // keys in flight per sub-warp and step
  static constexpr bool FULL_ROW = LPK * EPL == D;  // every lane holds channels
  static_assert(D % EPL == 0 && LPK <= 32 && U >= 1, "unsupported head_dim");
};

// 16 bytes of a row -> EPV floats
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

// a lane's NV loads of a row -> its NV * EPV floats
template <int NV, typename T>
__device__ __forceinline__ void unpack_all(const uint4 (&raw)[NV], float* out, const T* tag) {
#pragma unroll
  for (int i = 0; i < NV; ++i) unpack(raw[i], out + i * (16 / (int)sizeof(T)), tag);
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) { *dst = __float2bfloat16_rn(x); }

// (m, l) of two partial softmaxes merged, a before b in the fixed order:
// their weights exp(m_a - m) and exp(m_b - m), 0 for a part with no key
__device__ __forceinline__ void weights(float ma, float mb, float& m, float& fa, float& fb) {
  m = fmaxf(ma, mb);
  fa = ma == -INFINITY ? 0.f : expf(ma - m);
  fb = mb == -INFINITY ? 0.f : expf(mb - m);
}

// Where key row `pos` of (batch b, kv head kvh) lives, as an element
// offset that K and V share, or -1 when its page is unassigned. Linear,
// from the slot's first row: (pos * H_kv + kvh) * D. Paged, from the
// pool's: ((page * page_size + pos % page_size) * H_kv + kvh) * D, the
// page from the split's table entries staged in shared memory (entry 0 is
// page `first` of the slot's row of the table).
template <int D, bool PAGED>
struct Rows {
  const int* table;   // the staged entries (paged only)
  int first, rows, h_kv, kvh;

  __device__ __forceinline__ long long at(int pos) const {
    if (PAGED) {
      const int page = table[pos / rows - first];
      if (page < 0) return -1;
      return (((long long)page * rows + pos % rows) * h_kv + kvh) * D;
    }
    return ((long long)pos * h_kv + kvh) * D;
  }
};

// grid (B * H_kv * head chunks, splits). Writes, for each query head h of
// its chunk, the split's m and l to part_ml[((b H + h) n_split + i) 2 ..]
// and acc to part_acc[((b H + h) n_split + i) D ..]. A split that starts at
// or past the slot's length writes nothing.
template <typename T, int D, int GM, bool PAGED>
__global__ void __launch_bounds__(NT)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const int* __restrict__ lengths,
                          const int* __restrict__ pages, float* __restrict__ part_acc,
                          float* __restrict__ part_ml, int h, int h_kv, int rows, int p_tab,
                          int split, int n_split, float scale) {
  using G = Geo<T, D>;
  constexpr int NV = G::NV, EPL = G::EPL, LPK = G::LPK, KPW = G::KPW;
  constexpr int NSUB = G::NSUB, U = G::U;
  __shared__ float sm_acc[NW][GM][D];
  __shared__ float sm_m[NW][GM], sm_l[NW][GM];
  __shared__ int sm_tab[SPLIT_MAX];

  const int group = h / h_kv, n_hc = (group + GM - 1) / GM;
  const int hc = blockIdx.x % n_hc, kvh = blockIdx.x / n_hc % h_kv;
  const int b = blockIdx.x / (n_hc * h_kv), sp = blockIdx.y;
  const int h0 = kvh * group + hc * GM;          // the chunk's first query head
  const int gn = min(GM, group - hc * GM);       // its query heads
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / LPK, sl = lane % LPK;
  const int c0 = sl * EPL;                       // first channel this lane holds
  const bool live = G::FULL_ROW || c0 < D;       // this lane holds channels

  // linear: `rows` is S and the cache holds S rows; paged: `rows` is the
  // page size and the table covers p_tab pages
  const int cap = PAGED ? p_tab * rows : rows;
  const int n = min(max(lengths[b], 0), cap);
  const int k0 = sp * split, k1 = min(k0 + split, n);
  if (k0 >= n) return;  // the same for the whole block

  int first = 0;
  if (PAGED) {
    first = k0 / rows;
    const int* tab = pages + (size_t)b * p_tab;
    for (int i = threadIdx.x; i <= (k1 - 1) / rows - first; i += NT) sm_tab[i] = tab[first + i];
    __syncthreads();
  }
  const Rows<D, PAGED> cache{sm_tab, first, rows, h_kv, kvh};
  const size_t slot = PAGED ? 0 : (size_t)b * rows * h_kv * D;
  const T* kb = k + slot + c0;
  const T* vb = v + slot + c0;

  float qf[GM][EPL];
#pragma unroll
  for (int j = 0; j < GM; ++j) {
    if (j < gn && live) {
      uint4 raw[NV];
      const uint4* src = reinterpret_cast<const uint4*>(q + ((size_t)b * h + h0 + j) * D + c0);
#pragma unroll
      for (int i = 0; i < NV; ++i) raw[i] = src[i];
      unpack_all(raw, qf[j], q);
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qf[j][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) qf[j][e] *= scale;
  }

  float m[GM], l[GM], acc[GM][EPL];
#pragma unroll
  for (int j = 0; j < GM; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[j][e] = 0.f;
  }

  // the loop bound is the same for every lane of a warp, so the shuffles
  // below always run converged; a sub-warp past the end masks its keys
  for (int it = k0 + warp * KPW; it < k1; it += NSUB * U) {
    uint4 kraw[U][NV], vraw[U][NV];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pos = it + sub + u * NSUB;
      const long long off = pos < k1 ? cache.at(pos) : -1;
      ok[u] = off >= 0;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        if (ok[u] && live) {
          kraw[u][i] = reinterpret_cast<const uint4*>(kb + off)[i];
          vraw[u][i] = reinterpret_cast<const uint4*>(vb + off)[i];
        } else {
          kraw[u][i] = make_uint4(0, 0, 0, 0);
          vraw[u][i] = make_uint4(0, 0, 0, 0);
        }
      }
    }
    float s[U][GM];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[EPL];
      unpack_all(kraw[u], kf, q);
#pragma unroll
      for (int j = 0; j < GM; ++j) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) part = fmaf(qf[j][e], kf[e], part);
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        s[u][j] = ok[u] ? part : -INFINITY;
      }
    }
#pragma unroll
    for (int j = 0; j < GM; ++j) {
      float mx = m[j];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][j]);
      // no valid key yet: m stays -inf and every p below is 0
      const float corr = mx == -INFINITY ? 1.f : expf(m[j] - mx);  // 0 while m is -inf
      l[j] *= corr;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[j][e] *= corr;
      m[j] = mx;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[EPL];
      unpack_all(vraw[u], vf, q);
#pragma unroll
      for (int j = 0; j < GM; ++j) {
        const float p = ok[u] ? expf(s[u][j] - m[j]) : 0.f;
        l[j] += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[j][e] = fmaf(p, vf[e], acc[j][e]);
      }
    }
  }

  // the warp's sub-warps, lower sub-warp first: both partners of a
  // shuffle compute the same bits, and sub-warp 0 ends with the warp's
  // (m, l, acc)
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int j = 0; j < GM; ++j) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[j], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[j], off);
      const float ma = upper ? mo : m[j], mb = upper ? m[j] : mo;
      const float la = upper ? lo : l[j], lb = upper ? l[j] : lo;
      float mg, fa, fb;
      weights(ma, mb, mg, fa, fb);
      l[j] = fmaf(fb, lb, fa * la);
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[j][e], off);
        const float aa = upper ? ao : acc[j][e], ab = upper ? acc[j][e] : ao;
        acc[j][e] = fmaf(fb, ab, fa * aa);
      }
      m[j] = mg;
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int j = 0; j < GM; ++j) {
      if (live) {
#pragma unroll
        for (int e = 0; e < EPL; ++e) sm_acc[warp][j][c0 + e] = acc[j][e];
      }
      if (sl == 0) {
        sm_m[warp][j] = m[j];
        sm_l[warp][j] = l[j];
      }
    }
  }
  __syncthreads();

  // the warps in warp order; the split's (m, l, acc) to the workspace
  for (int i = threadIdx.x; i < gn * D; i += NT) {
    const int j = i / D, c = i % D;
    float mg = -INFINITY;
    for (int w = 0; w < NW; ++w) mg = fmaxf(mg, sm_m[w][j]);
    float lg = 0.f, ag = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float f = sm_m[w][j] == -INFINITY ? 0.f : expf(sm_m[w][j] - mg);
      lg = fmaf(f, sm_l[w][j], lg);
      ag = fmaf(f, sm_acc[w][j][c], ag);
    }
    const size_t at = ((size_t)b * h + h0 + j) * n_split + sp;
    part_acc[at * D + c] = ag;
    if (c == 0) {
      part_ml[2 * at] = mg;
      part_ml[2 * at + 1] = lg;
    }
  }
}

// grid B * H, D threads rounded up to whole warps (MT): each (slot,
// head)'s splits, the ceil(n / split) that its length n covers, summed in
// split order (0 for a slot of length 0). Each thread below D sums its
// channel; the splits' weights exp(m_i - m) are taken MT at a time into
// shared memory, so no thread walks the (m, l) list alone.
template <typename T, int D, int MT = (D + 31) / 32 * 32>
__global__ void __launch_bounds__(MT)
flash_decode_merge_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                          const int* __restrict__ lengths, T* __restrict__ o, int h, int cap,
                          int split, int n_split) {
  __shared__ float sm_f[MT], sm_l[MT], sm_m[MT / 32];
  const int bh = blockIdx.x, c = threadIdx.x;
  const int n = min(max(lengths[bh / h], 0), cap);
  const int ns = (n + split - 1) / split;
  const float* ml = part_ml + (size_t)bh * n_split * 2;
  const float* pa = part_acc + (size_t)bh * n_split * D + c;
  // the largest m: a max is exact in any order
  float mg = -INFINITY;
  for (int i = c; i < ns; i += MT) mg = fmaxf(mg, ml[2 * i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mg = fmaxf(mg, __shfl_xor_sync(0xffffffffu, mg, off));
  if (c % 32 == 0) sm_m[c / 32] = mg;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < MT / 32; ++w) mg = fmaxf(mg, sm_m[w]);
  float lg = 0.f, ag = 0.f;
  for (int i0 = 0; i0 < ns; i0 += MT) {
    __syncthreads();  // the previous chunk's readers are done
    if (i0 + c < ns) {
      const float m = ml[2 * (i0 + c)];
      sm_f[c] = m == -INFINITY ? 0.f : expf(m - mg);
      sm_l[c] = ml[2 * (i0 + c) + 1];
    }
    __syncthreads();
    const int cnt = min(MT, ns - i0);
    if (c < D) {
#pragma unroll 8
      for (int i = 0; i < cnt; ++i) {
        lg = fmaf(sm_f[i], sm_l[i], lg);
        ag = fmaf(sm_f[i], pa[(size_t)(i0 + i) * D], ag);
      }
    }
  }
  if (c < D) store(o + (size_t)bh * D + c, ag / fmaxf(lg, 1e-30f));
}

template <typename T, int D, int GM, bool PAGED>
int launch_gm(const void* q, const void* k, const void* v, const int* lengths, const int* pages,
              void* o, float* work, int b, int h, int h_kv, int rows, int p_tab, int split,
              float scale, cudaStream_t st) {
  const int cap = PAGED ? p_tab * rows : rows;
  const int n_split = (cap + split - 1) / split;
  float* part_acc = work;
  float* part_ml = work + (size_t)b * h * n_split * D;
  if (n_split > 0) {  // an empty cache has no split, and its merge writes 0
    const int n_hc = (h / h_kv + GM - 1) / GM;
    dim3 grid(b * h_kv * n_hc, n_split);
    flash_decode_split_kernel<T, D, GM, PAGED><<<grid, NT, 0, st>>>(
        (const T*)q, (const T*)k, (const T*)v, lengths, pages, part_acc, part_ml, h, h_kv,
        rows, p_tab, split, n_split, scale);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  flash_decode_merge_kernel<T, D><<<b * h, (D + 31) / 32 * 32, 0, st>>>(
      part_acc, part_ml, lengths, (T*)o, h, cap, split, n_split);
  return (int)cudaGetLastError();
}

// the query heads a block serves: the whole group, up to 8 heads; a larger
// group takes ceil(group / 8) blocks of 8
template <typename T, int D, bool PAGED, int GM = 8>
int launch(const void* q, const void* k, const void* v, const int* lengths, const int* pages,
           void* o, void* work, int b, int h, int h_kv, int rows, int p_tab, int split,
           float scale, cudaStream_t st) {
  if (split < 1 || split > SPLIT_MAX) return (int)cudaErrorInvalidValue;
  if (b * h == 0) return 0;
  if (h_kv <= 0 || h % h_kv) return (int)cudaErrorInvalidValue;
  if constexpr (GM > 1) {
    if (h / h_kv < GM)
      return launch<T, D, PAGED, GM - 1>(q, k, v, lengths, pages, o, work, b, h, h_kv, rows,
                                         p_tab, split, scale, st);
  }
  return launch_gm<T, D, GM, PAGED>(q, k, v, lengths, pages, o, (float*)work, b, h, h_kv, rows,
                                    p_tab, split, scale, st);
}

}  // namespace

namespace repro_decode {

// The launchers at one (T, D), as static members, so that one explicit
// instantiation compiles all of them: each flash_decode_<t>_<d>.cu
// instantiates one (T, D), its 16 split kernels (G 1 to 8, linear and
// paged) and its merge; flash_decode.cu declares them `extern template`
// and compiles none.
template <typename T, int D>
struct Kernels {
  static int run(bool paged, const void* q, const void* k, const void* v, const int* lengths,
                 const int* pages, void* o, void* work, int b, int h, int h_kv, int rows, int p_tab,
                 int split, float scale, cudaStream_t st);
};

template <typename T, int D>
int Kernels<T, D>::run(bool paged, const void* q, const void* k, const void* v, const int* lengths,
                       const int* pages, void* o, void* work, int b, int h, int h_kv, int rows,
                       int p_tab, int split, float scale, cudaStream_t st) {
  return paged ? launch<T, D, true>(q, k, v, lengths, pages, o, work, b, h, h_kv, rows, p_tab,
                                    split, scale, st)
               : launch<T, D, false>(q, k, v, lengths, pages, o, work, b, h, h_kv, rows, p_tab,
                                     split, scale, st);
}

}  // namespace repro_decode
