// Grouped matrix multiplication for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas kernels of the megablox grouped matmul that
// tensorflow_examples_tpu/parallel/moe.py:190 `_grouped_matmul` reaches on a
// TPU (jax/experimental/pallas/ops/tpu/megablox/gmm.py): `gmm`
// (`pl.pallas_call` at gmm.py:526) and `tgmm` (gmm.py:763), the latter and
// the `transpose_rhs` form of the former being what megablox's `_gmm_bwd`
// calls for the gradients. The MoE training step runs 24 gmm and 12 tgmm
// launches (6 MoE layers, two grouped products each, forward and backward).
//
// Contract (megablox's). `group_sizes` [g] int32 lives on the device; row
// segment i of the [m, ...] operand is rows [off_i, off_i + size_i), with
// off_i the exclusive cumsum, both clamped to m.
//   gmm:  out[m, n] = lhs[m, k] x rhs[g, k, n] (rhs[g, n, k] with transpose_rhs):
//         rows of segment i use rhs[i]; rows past the last segment are 0.
//   tgmm: out[g, k, n] = lhs_t[k, m] x rhs[m, n] per segment: out[i] sums
//         over segment i's rows only; an empty segment gives exact zeros.
// Inputs f32 or bf16 (both operands one type), products and sums in f32,
// the output rounded once to the input type. lhs_t may be given as a
// contiguous [k, m] or as the transposed view of a contiguous [m, k]
// (`lhs.T`, as the backward passes it): the tile loader reads either.
//
// What bounds them on an H100: operations. At the MoE step's shapes
// (m 16384, (k, n) = (768, 3072) or (3072, 768), g 8) a call is 77.3 GFLOP
// over 164 MB: 0.078 ms in bf16 on the tensor cores, 1.15 ms in f32 outside
// them, against 0.049 ms for the bytes. This first kernel stays off the
// tensor cores (no mma/wgmma, no TMA): it is a shared-memory-tiled SIMT
// GEMM with f32 accumulators, so in bf16 it runs far above its bound; the
// f32 bound is the one it can approach. Tensor cores are later work.
//
// Design. One CTA of 256 threads computes a 128 x 128 output tile, each
// thread an 8 x 8 block held in registers (rows ty*4 + {0..3} and
// 64 + ty*4 + {0..3}, columns likewise, so its float4 shared-memory reads
// are conflict-free), over 16-deep slices of the reduction staged in
// shared memory as f32; the next slice's global loads are issued into
// registers before the current slice's products (one slice in flight).
// The bf16 kernels are held to 128 registers so two CTAs share an SM
// (unbounded, ptxas gives them up to 179, which leaves one CTA of 8 warps
// per SM); the f32 ones keep one CTA, since at 128 registers the
// transposed-rhs gmm spills and ran slower on the H100 than unbounded.
// The TPU's sequential grid with scalar-prefetched group metadata becomes:
//   gmm:  a static grid of ceil(m/128) + g row-tile work items by the n
//         tiles (megablox's bound, gmm.py:79 `make_group_metadata`). Each
//         CTA walks the group sizes itself and takes the work item that
//         is its (group, row tile) pair: a row tile that spans two groups
//         is visited once for each, and each visit stores only its own
//         group's rows (megablox's `_get_store_mask`), so every output
//         element has exactly one writer. One extra pseudo-group covers
//         the rows past the last segment and writes their zeros. Items
//         past the real count exit at once. Nothing syncs with the host.
//   tgmm: one CTA per (group, k tile, n tile), looping over that group's
//         rows: deterministic, no atomics, and a group of no rows stores
//         the zeros of its untouched accumulators.
// Loads are scalar and masked (any m, k, n: 100 or 36 as well as 3072);
// offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;                    // tile rows (gmm: lhs rows; tgmm: k)
constexpr int BN = 128;                    // tile columns (n)
constexpr int BK = 16;                     // reduction slice
constexpr int THREADS = 256;               // 16 x 16 threads, 8 x 8 outputs each
constexpr int LDS = BM + 4;                // padded shared row: float4-aligned, 2-way stash
constexpr int PER_THREAD = BM * BK / THREADS;  // tile elements each thread fetches
static_assert(BM == BN, "one tile map serves both operands");

// CTAs each SM must hold at once (__launch_bounds__'s second argument).
template <typename T> struct Occupancy { static constexpr int ctas = 1; };
template <> struct Occupancy<__nv_bfloat16> { static constexpr int ctas = 2; };

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t lmax(int64_t a, int64_t b) { return a > b ? a : b; }
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Which tile element (i along the 128-wide side, r along the reduction)
// thread `tid` fetches in its step q. R_CONTIG: the operand is contiguous
// along r, so 16 neighbouring threads read 16 neighbouring r of one i;
// otherwise 128 neighbouring threads read 128 neighbouring i of one r.
template <bool R_CONTIG>
__device__ __forceinline__ int tile_i(int tid, int q) {
  return R_CONTIG ? tid / BK + q * (THREADS / BK) : tid % BM;
}
template <bool R_CONTIG>
__device__ __forceinline__ int tile_r(int tid, int q) {
  return R_CONTIG ? tid % BK : tid / BM + q * (THREADS / BM);
}

// Operand element (i, r) sits at p[i * ld + r] (R_CONTIG) or p[r * ld + i].
// Reads i0 + [0, BM) x r0 + [0, BK), with i outside [i_lo, i_hi) or r at
// or past r_hi read as 0.
template <typename T, bool R_CONTIG>
__device__ __forceinline__ void fetch(float (&v)[PER_THREAD], const T* __restrict__ p, int64_t ld,
                                      int64_t i0, int64_t i_lo, int64_t i_hi, int64_t r0,
                                      int64_t r_hi, int tid) {
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int64_t i = i0 + tile_i<R_CONTIG>(tid, q);
    const int64_t r = r0 + tile_r<R_CONTIG>(tid, q);
    const int64_t at = R_CONTIG ? i * ld + r : r * ld + i;
    v[q] = (i >= i_lo && i < i_hi && r < r_hi) ? to_f32(p[at]) : 0.f;
  }
}

template <bool R_CONTIG>
__device__ __forceinline__ void stash(float (*s)[LDS], const float (&v)[PER_THREAD], int tid) {
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) s[tile_r<R_CONTIG>(tid, q)][tile_i<R_CONTIG>(tid, q)] = v[q];
}

// The output row (or column) of a thread's register index e in 0..7.
__device__ __forceinline__ int sub(int t, int e) { return (e < 4 ? 0 : 64) + t * 4 + (e & 3); }

// acc += A(i0 + [0, BM), r) x B(r, j0 + [0, BN)) over r in [r_begin, r_end):
// A's rows outside [i_lo, i_hi) and B's columns at or past j_hi count as 0.
// Each operand is (pointer, leading dimension, contiguous along r or not).
template <typename T, bool A_RC, bool B_RC>
__device__ __forceinline__ void tile_product(
    float (&acc)[8][8], const T* __restrict__ a, int64_t lda, int64_t i0, int64_t i_lo,
    int64_t i_hi, const T* __restrict__ b, int64_t ldb, int64_t j0, int64_t j_hi,
    int64_t r_begin, int64_t r_end) {
  __shared__ __align__(16) float As[BK][LDS];
  __shared__ __align__(16) float Bs[BK][LDS];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float ra[PER_THREAD], rb[PER_THREAD];
  if (r_begin < r_end) {
    fetch<T, A_RC>(ra, a, lda, i0, i_lo, i_hi, r_begin, r_end, tid);
    fetch<T, B_RC>(rb, b, ldb, j0, j0, j_hi, r_begin, r_end, tid);
  }
  for (int64_t r0 = r_begin; r0 < r_end; r0 += BK) {
    stash<A_RC>(As, ra, tid);
    stash<B_RC>(Bs, rb, tid);
    __syncthreads();
    if (r0 + BK < r_end) {  // the next slice's loads fly during this slice's products
      fetch<T, A_RC>(ra, a, lda, i0, i_lo, i_hi, r0 + BK, r_end, tid);
      fetch<T, B_RC>(rb, b, ldb, j0, j0, j_hi, r0 + BK, r_end, tid);
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
#pragma unroll
        for (int f = 0; f < 8; ++f) acc[e][f] = fmaf(av[e], bv[f], acc[e][f]);
      }
    }
    __syncthreads();
  }
}

// Stores the rows of the tile at i0 that lie in [i_lo, i_hi), columns below
// j_hi, into out (row stride ldo).
template <typename T>
__device__ __forceinline__ void store_tile(T* __restrict__ out, int64_t ldo, const float (&acc)[8][8],
                                           int64_t i0, int64_t i_lo, int64_t i_hi, int64_t j0,
                                           int64_t j_hi) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int64_t i = i0 + sub(ty, e);
    if (i < i_lo || i >= i_hi) continue;
#pragma unroll
    for (int f = 0; f < 8; ++f) {
      const int64_t j = j0 + sub(tx, f);
      if (j < j_hi) store1(out + i * ldo + j, acc[e][f]);
    }
  }
}

// gmm: blockIdx.x is a (group, row tile) work item, blockIdx.y the n tile.
// Group g (one past the last) is the pseudo-group of rows past the segments.
template <typename T, bool TRANSPOSE_RHS>
__global__ void __launch_bounds__(THREADS, Occupancy<T>::ctas)
gmm_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs, const int* __restrict__ sizes,
           T* __restrict__ out, int64_t m, int64_t k, int64_t n, int g) {
  const int64_t w = blockIdx.x;
  int64_t start = 0, work = 0, gs = 0, ge = 0, tile = 0;
  int grp = -1;
  for (int i = 0; i <= g; ++i) {
    const int64_t end = i < g ? lmin(start + lmax(sizes[i], 0), m) : m;
    if (end > start) {
      const int64_t count = (end - 1) / BM - start / BM + 1;
      if (w < work + count) {
        grp = i;
        gs = start;
        ge = end;
        tile = start / BM + (w - work);
        break;
      }
      work += count;
    }
    start = end;
  }
  if (grp < 0) return;  // past the last work item: the grid is a static bound
  const int64_t i0 = tile * BM, j0 = (int64_t)blockIdx.y * BN;
  const int64_t i_lo = lmax(i0, gs), i_hi = lmin(i0 + BM, ge);
  float acc[8][8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
#pragma unroll
    for (int f = 0; f < 8; ++f) acc[e][f] = 0.f;
  }
  if (grp < g) {
    // rhs[grp] is [k, n] (B(r, j) at r * n + j) or, transposed, [n, k] (at j * k + r).
    tile_product<T, true, TRANSPOSE_RHS>(acc, lhs, k, i0, i_lo, i_hi,
                                         rhs + (int64_t)grp * k * n, TRANSPOSE_RHS ? k : n, j0,
                                         n, 0, k);
  }
  store_tile(out, n, acc, i0, i_lo, i_hi, j0, n);
}

// tgmm: blockIdx = (n tile, k tile, group). LHS_MK: lhs_t is the transposed
// view of a contiguous [m, k] (element (i, r) at r * k + i), else a
// contiguous [k, m] (at i * m + r).
template <typename T, bool LHS_MK>
__global__ void __launch_bounds__(THREADS, Occupancy<T>::ctas)
tgmm_kernel(const T* __restrict__ lhs_t, const T* __restrict__ rhs,
            const int* __restrict__ sizes, T* __restrict__ out, int64_t m, int64_t k, int64_t n) {
  const int grp = blockIdx.z;
  int64_t gs = 0;
  for (int i = 0; i < grp; ++i) gs += lmax(sizes[i], 0);
  gs = lmin(gs, m);
  const int64_t ge = lmin(gs + lmax(sizes[grp], 0), m);
  const int64_t i0 = (int64_t)blockIdx.y * BM, j0 = (int64_t)blockIdx.x * BN;
  float acc[8][8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
#pragma unroll
    for (int f = 0; f < 8; ++f) acc[e][f] = 0.f;
  }
  tile_product<T, !LHS_MK, false>(acc, lhs_t, LHS_MK ? k : m, i0, i0, k, rhs, n, j0, n, gs,
                                  ge);
  store_tile(out + (int64_t)grp * k * n, n, acc, i0, i0, k, j0, n);
}

template <typename T>
int launch_gmm(int transpose_rhs, const void* lhs, const void* rhs, const int* sizes, void* out,
               long long m, long long k, long long n, int g, cudaStream_t st) {
  const dim3 grid((unsigned)((m + BM - 1) / BM + g), (unsigned)((n + BN - 1) / BN));
  const T* a = static_cast<const T*>(lhs);
  const T* b = static_cast<const T*>(rhs);
  T* o = static_cast<T*>(out);
  if (transpose_rhs) {
    gmm_kernel<T, true><<<grid, THREADS, 0, st>>>(a, b, sizes, o, m, k, n, g);
  } else {
    gmm_kernel<T, false><<<grid, THREADS, 0, st>>>(a, b, sizes, o, m, k, n, g);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tgmm(int lhs_mk, const void* lhs_t, const void* rhs, const int* sizes, void* out,
                long long m, long long k, long long n, int g, cudaStream_t st) {
  const dim3 grid((unsigned)((n + BN - 1) / BN), (unsigned)((k + BM - 1) / BM), (unsigned)g);
  const T* a = static_cast<const T*>(lhs_t);
  const T* b = static_cast<const T*>(rhs);
  T* o = static_cast<T*>(out);
  if (lhs_mk) {
    tgmm_kernel<T, true><<<grid, THREADS, 0, st>>>(a, b, sizes, o, m, k, n);
  } else {
    tgmm_kernel<T, false><<<grid, THREADS, 0, st>>>(a, b, sizes, o, m, k, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each entry returns cudaGetLastError()
// after its launch (0 on success), launches on `stream` and does not
// synchronise.
extern "C" int gmm(int dtype, int transpose_rhs, const void* lhs, const void* rhs,
                   const int* group_sizes, void* out, long long m, long long k, long long n,
                   int g, void* stream) {
  if (m < 1 || k < 0 || n < 1 || g < 1 || (n + BN - 1) / BN > 65535 ||
      (m + BM - 1) / BM + g > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_gmm<float>(transpose_rhs, lhs, rhs, group_sizes, out, m, k, n, g, st);
  if (dtype == 1) {
    return launch_gmm<__nv_bfloat16>(transpose_rhs, lhs, rhs, group_sizes, out, m, k, n, g, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int tgmm(int dtype, int lhs_mk, const void* lhs_t, const void* rhs,
                    const int* group_sizes, void* out, long long m, long long k, long long n,
                    int g, void* stream) {
  if (m < 0 || k < 1 || n < 1 || g < 1 || g > 65535 || (n + BN - 1) / BN > 2147483647LL ||
      (k + BM - 1) / BM > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_tgmm<float>(lhs_mk, lhs_t, rhs, group_sizes, out, m, k, n, g, st);
  if (dtype == 1) {
    return launch_tgmm<__nv_bfloat16>(lhs_mk, lhs_t, rhs, group_sizes, out, m, k, n, g, st);
  }
  return (int)cudaErrorInvalidValue;
}
