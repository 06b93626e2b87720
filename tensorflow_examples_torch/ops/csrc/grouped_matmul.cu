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
// over 164 MB: 0.07817 ms in bf16 on the tensor cores, 1.15 ms in f32
// outside them, against 0.049 ms for the bytes.
//
// Two kernels each, picked by the wrapper from dtype, shape and alignment:
// bf16 with k % 8 == 0, n % 8 == 0 and 16-byte-aligned operands (every gmm
// and tgmm of the MoE step) runs on the tensor cores; anything else, f32
// included, runs the SIMT kernels.
//
// gmm_tc_kernel runs gmm on the tensor cores. One CTA of 8 warps computes
// a 128 x 128 output tile, each warp a 64 x 32 warp tile of
// mma.sync.m16n8k16 bf16 fragments with f32 accumulators, over 32-deep
// slices of the reduction (two k16 steps) kept as bf16 in shared memory. A
// ring of STAGES slices is filled by 16-byte cp.async: the load of slice
// t + STAGES - 1 is issued before the products of slice t. Rows at or past
// m and reduction columns at or past k are zero-filled by the copy
// (src-size 0); rows of a neighbouring group are loaded and masked at the
// store, as megablox does. lhs [m, k] fragments come from ldmatrix, rhs
// [k, n] from ldmatrix.trans, and rhs [n, k] (transpose_rhs, the backward's
// dlhs) from plain ldmatrix; each shared row is padded by 16 bytes, so
// neither conflicts. The epilogue rounds to bf16, stages the tile through
// shared memory and writes 16-byte stores, keeping the per-row group mask.
// The C interface is `gmm_tc`.
//
// tgmm_tc_kernel runs tgmm on the tensor cores with gmm_tc_kernel's tile,
// warps, ring and padding, the output's k side in place of gmm's rows and
// the group's rows as the reduction. Both operands run along the
// reduction: lhs.T (the backward's view of a contiguous [m, k]) and rhs
// [m, n] are staged as [32 rows][128] and give their fragments through
// ldmatrix.trans; a contiguous [k, m] lhs_t is staged as [128][32 rows]
// and gives them through plain ldmatrix. A row outside the chunk's rows is
// zero-filled by its copy (each 16-byte copy of lhs.T or rhs lies in one
// row, so a group may start on any row and no store mask is needed); the
// contiguous lhs_t's copies run along m, so it needs m % 8 == 0, loads
// whole 8-row chunks and zeroes the columns outside the rows after they
// land. Skewed routing puts most rows in one group, and one CTA per
// (group, tile) would leave that group's CTAs working alone while the
// rest of the grid exits (4.2 ms a launch of the SIMT kernel on the H100).
// So a group is cut into chunks of at most R rows (the wrapper's
// TGMM_CHUNK_ROWS, 4096: a balanced 8-way MoE step, 2048 rows a group, is
// never split, and all 16384 rows in one group make 4 chunks): the work items are (group, chunk) pairs on
// a static grid of ceil(m / R) + g items by the k and n tiles, walked on
// the device as gmm's are. A group of one chunk rounds and stores straight
// to out; a group of several writes one f32 [k, n] partial per chunk to a
// scratch buffer the wrapper allocates, and tgmm_reduce_kernel sums each
// such group's partials in chunk order and rounds once. Every output
// element has one writer, no atomics, so reruns are bit-identical. An
// empty group is one item of no rows and stores exact zeros. The C
// interface is `tgmm_tc`.
//
// The SIMT kernels stay off the tensor cores: a shared-memory-tiled SIMT
// GEMM with f32 accumulators, so in bf16 it runs far above its bound, and
// the f32 bound is the one it can approach (TF32 would change f32's
// numbers, which the MoE generate path, 384 f32 gmm launches a call, and
// the f32 step 0 of the MoE training check are held to).
//
// SIMT design. One CTA of 256 threads computes a 128 x 128 output tile, each
// thread an 8 x 8 block held in registers (rows ty*4 + {0..3} and
// 64 + ty*4 + {0..3}, columns likewise, so its float4 shared-memory reads
// are conflict-free), over 16-deep slices of the reduction staged in
// shared memory as f32; the next slice's global loads are issued into
// registers before the current slice's products (one slice in flight).
// The bf16 kernels are held to 128 registers so two CTAs share an SM
// (unbounded, ptxas gives them up to 179, which leaves one CTA of 8 warps
// per SM); the f32 ones keep one CTA, since at 128 registers the
// transposed-rhs gmm spills and ran slower on the H100 than unbounded.
// Loads are scalar and masked (any m, k, n); offsets are 64-bit.
//
// Both gmm kernels map the TPU's sequential grid with scalar-prefetched
// group metadata onto a static grid of ceil(m/128) + g row-tile work items
// by the n tiles (megablox's bound, gmm.py:79 `make_group_metadata`). Each
// CTA walks the group sizes itself and takes the work item that is its
// (group, row tile) pair: a row tile that spans two groups is visited once
// for each, and each visit stores only its own group's rows (megablox's
// `_get_store_mask`), so every output element has exactly one writer. One
// extra pseudo-group covers the rows past the last segment and writes their
// zeros. Items past the real count exit at once. Nothing syncs with the
// host, and nothing uses atomics.
//   SIMT tgmm: one CTA per (group, k tile, n tile), looping over that
//         group's rows: deterministic, no atomics, and a group of no rows
//         stores the zeros of its untouched accumulators.
//
// group_row_sum is not the port of a TPU kernel. It is the backward of the
// MoE dispatch's bias gathers b_in[srt_eid] and b_out[srt_eid]
// (tensorflow_examples_tpu/parallel/moe.py:374-377, `jnp.take`), whose
// rows are sorted by expert: db[e] = the f32 sum of the gradient's rows of
// segment e, rounded once ([16384, 3072] and [16384, 768] into 8 rows at
// the MoE step). It is bound by bytes: the gradient read once, 0.030 ms
// and 0.0075 ms in bf16. PyTorch's own backward of the gather accumulates
// with atomics in an order that changes from run to run. Here the work
// items are chunks of at most `chunk_rows` rows of each group by 256-column
// tiles, so 8 groups fill the card at n 768 too; each warp of a CTA sums
// its rows with 16-byte loads, four rows in flight, the eight warps' sums
// merge in shared memory in a fixed order into one f32 partial per chunk,
// and a second launch sums each group's partials, eight warps over the
// chunks and a fixed-order merge: no atomics, no host sync.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

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

// gmm's work item blockIdx.x: its group (g for the pseudo-group of rows
// past the last segment, -1 past the last item), the first row of its row
// tile, and the rows [i_lo, i_hi) of that tile the group owns.
__device__ __forceinline__ int work_item(const int* __restrict__ sizes, int64_t m, int g,
                                         int64_t& i0, int64_t& i_lo, int64_t& i_hi) {
  const int64_t w = blockIdx.x;
  int64_t start = 0, work = 0;
  for (int i = 0; i <= g; ++i) {
    const int64_t end = i < g ? lmin(start + lmax(sizes[i], 0), m) : m;
    if (end > start) {
      const int64_t count = (end - 1) / BM - start / BM + 1;
      if (w < work + count) {
        i0 = (start / BM + (w - work)) * BM;
        i_lo = lmax(i0, start);
        i_hi = lmin(i0 + BM, end);
        return i;
      }
      work += count;
    }
    start = end;
  }
  return -1;
}

// gmm: blockIdx.x is a (group, row tile) work item, blockIdx.y the n tile.
// Group g (one past the last) is the pseudo-group of rows past the segments.
template <typename T, bool TRANSPOSE_RHS>
__global__ void __launch_bounds__(THREADS, Occupancy<T>::ctas)
gmm_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs, const int* __restrict__ sizes,
           T* __restrict__ out, int64_t m, int64_t k, int64_t n, int g) {
  int64_t i0, i_lo, i_hi;
  const int grp = work_item(sizes, m, g, i0, i_lo, i_hi);
  if (grp < 0) return;  // past the last work item: the grid is a static bound
  const int64_t j0 = (int64_t)blockIdx.y * BN;
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

// ------------------------------------------------ gmm on the tensor cores

typedef __nv_bfloat16 bf16;

namespace tc {
constexpr int BK = 32;                     // reduction slice: two k16 steps
constexpr int STAGES = 4;                  // slices in flight
constexpr int LDK = BK + 8;                // a [rows][BK] tile's padded row (bf16)
constexpr int LDN = BN + 8;                // a [BK][BN] tile's padded row
constexpr int A_ELEMS = BM * LDK;          // lhs slice [BM][LDK]
constexpr int B_ELEMS = BN * LDK > BK * LDN ? BN * LDK : BK * LDN;  // rhs slice, either layout
constexpr int STAGE_ELEMS = A_ELEMS + B_ELEMS;
constexpr int LDC = BN + 8;                // the epilogue's staged output row
constexpr int SMEM_BYTES =
    (STAGES * STAGE_ELEMS > BM * LDC ? STAGES * STAGE_ELEMS : BM * LDC) * (int)sizeof(bf16);
}  // namespace tc

// One reduction slice [r0, r0 + BK) into ring stage `as` (lhs rows i0..,
// then the rhs slice of group matrix b: [BK][LDN] for rhs [k, n], or
// [BN][LDK] for rhs [n, k]). Two 16-byte chunks of each operand a thread.
template <bool TRANSPOSE_RHS>
__device__ __forceinline__ void tc_load_slice(bf16* as, const bf16* __restrict__ lhs,
                                              const bf16* __restrict__ b, int64_t m, int64_t k,
                                              int64_t n, int64_t i0, int64_t j0, int64_t r0) {
  bf16* bs = as + tc::A_ELEMS;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int c = threadIdx.x + t * THREADS;  // 512 chunks: 128 rows x 4
    const int row = c >> 2, kc = (c & 3) * 8;
    const int64_t i = i0 + row, r = r0 + kc;
    const bool ok = i < m && r < k;
    cp_async16(smem_u32(as + row * tc::LDK + kc), ok ? lhs + i * k + r : lhs, ok);
  }
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int c = threadIdx.x + t * THREADS;
    if (TRANSPOSE_RHS) {  // rhs [n, k]: 128 n rows x 4 chunks along k
      const int row = c >> 2, kc = (c & 3) * 8;
      const int64_t j = j0 + row, r = r0 + kc;
      const bool ok = j < n && r < k;
      cp_async16(smem_u32(bs + row * tc::LDK + kc), ok ? b + j * k + r : b, ok);
    } else {  // rhs [k, n]: 32 k rows x 16 chunks along n
      const int row = c >> 4, nc = (c & 15) * 8;
      const int64_t r = r0 + row, j = j0 + nc;
      const bool ok = r < k && j < n;
      cp_async16(smem_u32(bs + row * tc::LDN + nc), ok ? b + r * n + j : b, ok);
    }
  }
}

// gmm for bf16 on the tensor cores; the grid and work items are gmm_kernel's.
// Warp w owns rows (w & 1) * 64 + [0, 64) and columns (w >> 1) * 32 + [0, 32)
// of the 128 x 128 tile: 4 x 4 m16n8 fragments.
template <bool TRANSPOSE_RHS>
__global__ void __launch_bounds__(THREADS)
gmm_tc_kernel(const bf16* __restrict__ lhs, const bf16* __restrict__ rhs,
              const int* __restrict__ sizes, bf16* __restrict__ out, int64_t m, int64_t k,
              int64_t n, int g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  int64_t i0, i_lo, i_hi;
  const int grp = work_item(sizes, m, g, i0, i_lo, i_hi);
  if (grp < 0) return;  // past the last work item: the grid is a static bound
  const int64_t j0 = (int64_t)blockIdx.y * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: which matrix, which row of it

  float acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b][0] = acc[a][b][1] = acc[a][b][2] = acc[a][b][3] = 0.f;

  if (grp < g) {
    const bf16* b = rhs + (int64_t)grp * k * n;
    const int slices = (int)((k + tc::BK - 1) / tc::BK);
#pragma unroll
    for (int s = 0; s < tc::STAGES - 1; ++s) {
      if (s < slices)
        tc_load_slice<TRANSPOSE_RHS>(smem + s * tc::STAGE_ELEMS, lhs, b, m, k, n, i0, j0,
                                     (int64_t)s * tc::BK);
      cp_async_commit();
    }
    for (int t = 0; t < slices; ++t) {
      cp_async_wait<tc::STAGES - 2>();  // slice t has landed (this thread's copies)
      __syncthreads();                  // ... everyone's, and slice t - 1 is consumed
      const int next = t + tc::STAGES - 1;
      if (next < slices)
        tc_load_slice<TRANSPOSE_RHS>(smem + (next % tc::STAGES) * tc::STAGE_ELEMS, lhs, b, m,
                                     k, n, i0, j0, (int64_t)next * tc::BK);
      cp_async_commit();
      const bf16* as = smem + (t % tc::STAGES) * tc::STAGE_ELEMS;
      const bf16* bs = as + tc::A_ELEMS;
#pragma unroll
      for (int kk = 0; kk < tc::BK; kk += 16) {
        uint32_t af[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          ldmatrix_x4(af[mt], smem_u32(as + (wm + mt * 16 + (lane & 15)) * tc::LDK + kk +
                                       (lane >> 4) * 8));
#pragma unroll
        for (int np = 0; np < 2; ++np) {  // two n8 tiles per ldmatrix
          uint32_t bf[4];
          if (TRANSPOSE_RHS)
            ldmatrix_x4(bf, smem_u32(bs + (wn + np * 16 + mr + (mi >> 1) * 8) * tc::LDK + kk +
                                     (mi & 1) * 8));
          else
            ldmatrix_x4_trans(bf, smem_u32(bs + (kk + mr + (mi & 1) * 8) * tc::LDN + wn +
                                           np * 16 + (mi >> 1) * 8));
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            mma_bf16(acc[mt][2 * np], af[mt], bf[0], bf[1]);
            mma_bf16(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
          }
        }
      }
    }
    cp_async_wait<0>();
  }
  __syncthreads();  // the ring is consumed: reuse it to stage the output tile

  bf16* cs = smem;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int row = wm + mt * 16 + (lane >> 2), col = wn + nt * 8 + 2 * (lane & 3);
      *reinterpret_cast<uint32_t*>(cs + row * tc::LDC + col) =
          pack_bf16(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<uint32_t*>(cs + (row + 8) * tc::LDC + col) =
          pack_bf16(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < BM * BN / 8 / THREADS; ++t) {  // 2048 chunks of 8 columns
    const int c = tid + t * THREADS;
    const int row = c >> 4, col = (c & 15) * 8;
    const int64_t i = i0 + row, j = j0 + col;
    if (i >= i_lo && i < i_hi && j < n)
      *reinterpret_cast<uint4*>(out + i * n + j) =
          *reinterpret_cast<const uint4*>(cs + row * tc::LDC + col);
  }
}

// ----------------------------------------------- tgmm on the tensor cores

// Chunks of at most `rows` rows that group i contributes: ceil(size / rows),
// 0 for an empty group.
__device__ __forceinline__ int64_t chunk_count(int64_t start, int64_t end, int64_t rows) {
  return (end - start + rows - 1) / rows;
}

// tgmm's work item blockIdx.x: its group (-1 past the last item), the rows
// [lo, hi) of its chunk, and its partial-sum slot (-1 when the chunk is the
// group's only one and stores straight to out). A group of c > 1 chunks is
// c items and c consecutive slots; an empty group is one item of no rows,
// which stores its zeros.
__device__ __forceinline__ int tgmm_item(const int* __restrict__ sizes, int64_t m, int g,
                                         int64_t rows, int64_t& lo, int64_t& hi,
                                         int64_t& slot) {
  const int64_t w = blockIdx.x;
  int64_t start = 0, work = 0, slots = 0;
  for (int i = 0; i < g; ++i) {
    const int64_t end = lmin(start + lmax(sizes[i], 0), m);
    const int64_t chunks = chunk_count(start, end, rows);
    const int64_t count = chunks > 1 ? chunks : 1;
    if (w < work + count) {
      const int64_t c = w - work;
      lo = start + c * rows;
      hi = lmin(lo + rows, end);
      slot = chunks > 1 ? slots + c : -1;
      return i;
    }
    work += count;
    if (chunks > 1) slots += chunks;
    start = end;
  }
  return -1;
}

// One reduction slice, rows [r0, r0 + BK), into ring stage `as`: lhs_t as
// [BK][LDN] (LHS_MK: 32 reduction rows x 128 k, 16-byte chunks along k) or
// [BM][LDK] (contiguous [k, m]: 128 k rows x 32 reduction columns, chunks
// along m), then rhs [m, n] as [BK][LDN]. Reduction rows outside [lo, hi)
// of a row-chunked operand are zero-filled by the copy; the contiguous
// lhs_t's chunks of eight rows are loaded whole (m % 8 == 0) and its
// columns outside [lo, hi) zeroed after they land (tgmm_tc_kernel).
template <bool LHS_MK>
__device__ __forceinline__ void tgmm_load_slice(bf16* as, const bf16* __restrict__ lhs_t,
                                                const bf16* __restrict__ rhs, int64_t m,
                                                int64_t k, int64_t n, int64_t k0, int64_t j0,
                                                int64_t r0, int64_t lo, int64_t hi) {
  bf16* bs = as + tc::A_ELEMS;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int c = threadIdx.x + t * THREADS;  // 512 chunks of each operand
    if (LHS_MK) {  // element (kk, r) at r * k + kk
      const int row = c >> 4, kc = (c & 15) * 8;
      const int64_t r = r0 + row, kk = k0 + kc;
      const bool ok = r >= lo && r < hi && kk < k;
      cp_async16(smem_u32(as + row * tc::LDN + kc), ok ? lhs_t + r * k + kk : lhs_t, ok);
    } else {  // element (kk, r) at kk * m + r
      const int row = c >> 2, rc = (c & 3) * 8;
      const int64_t kk = k0 + row, r = r0 + rc;
      const bool ok = kk < k && r + 8 > lo && r < hi;
      cp_async16(smem_u32(as + row * tc::LDK + rc), ok ? lhs_t + kk * m + r : lhs_t, ok);
    }
  }
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int c = threadIdx.x + t * THREADS;
    const int row = c >> 4, nc = (c & 15) * 8;
    const int64_t r = r0 + row, j = j0 + nc;
    const bool ok = r >= lo && r < hi && j < n;
    cp_async16(smem_u32(bs + row * tc::LDN + nc), ok ? rhs + r * n + j : rhs, ok);
  }
}

// tgmm for bf16 on the tensor cores: blockIdx = (work item, k tile, n
// tile); the CTA sums its chunk's rows into the 128 x 128 tile
// out[grp][k0.., j0..] (or its f32 partial). Warps and fragments as
// gmm_tc_kernel, with the k side of the tile in place of gmm's rows.
template <bool LHS_MK>
__global__ void __launch_bounds__(THREADS)
tgmm_tc_kernel(const bf16* __restrict__ lhs_t, const bf16* __restrict__ rhs,
               const int* __restrict__ sizes, bf16* __restrict__ out,
               float* __restrict__ partial, int64_t m, int64_t k, int64_t n, int g,
               int64_t rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  int64_t lo, hi, slot;
  const int grp = tgmm_item(sizes, m, g, rows, lo, hi, slot);
  if (grp < 0) return;  // past the last work item: the grid is a static bound
  const int64_t k0 = (int64_t)blockIdx.y * BM, j0 = (int64_t)blockIdx.z * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;
  const int mi = lane >> 3, mr = lane & 7;

  float acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b][0] = acc[a][b][1] = acc[a][b][2] = acc[a][b][3] = 0.f;

  // Slices start at a multiple of 8 rows, which the contiguous lhs_t's
  // 16-byte copies need; the rows before lo are masked like any other.
  const int64_t r0 = lo & ~(int64_t)7;
  const int slices = hi > lo ? (int)((hi - r0 + tc::BK - 1) / tc::BK) : 0;
#pragma unroll
  for (int s = 0; s < tc::STAGES - 1; ++s) {
    if (s < slices)
      tgmm_load_slice<LHS_MK>(smem + s * tc::STAGE_ELEMS, lhs_t, rhs, m, k, n, k0, j0,
                              r0 + (int64_t)s * tc::BK, lo, hi);
    cp_async_commit();
  }
  for (int t = 0; t < slices; ++t) {
    cp_async_wait<tc::STAGES - 2>();
    __syncthreads();
    bf16* as = smem + (t % tc::STAGES) * tc::STAGE_ELEMS;
    const int64_t s0 = r0 + (int64_t)t * tc::BK;
    if (!LHS_MK && (s0 < lo || s0 + tc::BK > hi)) {
      // A boundary slice of the contiguous lhs_t: zero the columns of rows
      // outside [lo, hi) that whole 16-byte chunks brought in.
      const int row = tid >> 1, c0 = (tid & 1) * 16;
#pragma unroll
      for (int c = c0; c < c0 + 16; ++c) {
        if (s0 + c < lo || s0 + c >= hi) as[row * tc::LDK + c] = __float2bfloat16(0.f);
      }
      __syncthreads();
    }
    const int next = t + tc::STAGES - 1;
    if (next < slices)
      tgmm_load_slice<LHS_MK>(smem + (next % tc::STAGES) * tc::STAGE_ELEMS, lhs_t, rhs, m, k, n,
                              k0, j0, r0 + (int64_t)next * tc::BK, lo, hi);
    cp_async_commit();
    const bf16* bs = as + tc::A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < tc::BK; kk += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (LHS_MK)  // [r][k] tile: the A fragment (k rows, r columns) transposed
          ldmatrix_x4_trans(af[mt], smem_u32(as + (kk + mr + (mi >> 1) * 8) * tc::LDN + wm +
                                             mt * 16 + (mi & 1) * 8));
        else
          ldmatrix_x4(af[mt], smem_u32(as + (wm + mt * 16 + (lane & 15)) * tc::LDK + kk +
                                       (lane >> 4) * 8));
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, smem_u32(bs + (kk + mr + (mi & 1) * 8) * tc::LDN + wn + np * 16 +
                                       (mi >> 1) * 8));
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma_bf16(acc[mt][2 * np], af[mt], bf[0], bf[1]);
          mma_bf16(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is consumed

  if (slot >= 0) {  // one chunk of several: its f32 partial, summed by tgmm_reduce_kernel
    float* p = partial + slot * k * n;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int64_t row = k0 + wm + mt * 16 + (lane >> 2);
        const int64_t col = j0 + wn + nt * 8 + 2 * (lane & 3);
        if (col >= n) continue;
        if (row < k)
          *reinterpret_cast<float2*>(p + row * n + col) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
        if (row + 8 < k)
          *reinterpret_cast<float2*>(p + (row + 8) * n + col) =
              make_float2(acc[mt][nt][2], acc[mt][nt][3]);
      }
    }
    return;
  }
  // The group's only chunk: round once, stage the tile, 16-byte stores.
  bf16* cs = smem;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int row = wm + mt * 16 + (lane >> 2), col = wn + nt * 8 + 2 * (lane & 3);
      *reinterpret_cast<uint32_t*>(cs + row * tc::LDC + col) =
          pack_bf16(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<uint32_t*>(cs + (row + 8) * tc::LDC + col) =
          pack_bf16(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
  __syncthreads();
  bf16* o = out + (int64_t)grp * k * n;
#pragma unroll
  for (int t = 0; t < BM * BN / 8 / THREADS; ++t) {
    const int c = tid + t * THREADS;
    const int row = c >> 4, col = (c & 15) * 8;
    const int64_t i = k0 + row, j = j0 + col;
    if (i < k && j < n)
      *reinterpret_cast<uint4*>(o + i * n + j) =
          *reinterpret_cast<const uint4*>(cs + row * tc::LDC + col);
  }
}

// The second pass of a split tgmm: thread e sums elements [8e, 8e + 8) of
// [k, n] over each split group's partials in chunk order and rounds once.
// Groups of one chunk were stored by tgmm_tc_kernel and are skipped.
__global__ void __launch_bounds__(THREADS)
tgmm_reduce_kernel(const float* __restrict__ partial, const int* __restrict__ sizes,
                   bf16* __restrict__ out, int64_t m, int64_t k, int64_t n, int g, int64_t rows) {
  const int64_t kn = k * n;
  const int64_t e = ((int64_t)blockIdx.x * THREADS + threadIdx.x) * 8;
  if (e >= kn) return;
  int64_t start = 0, slot = 0;
  for (int i = 0; i < g; ++i) {
    const int64_t end = lmin(start + lmax(sizes[i], 0), m);
    const int64_t chunks = chunk_count(start, end, rows);
    if (chunks > 1) {
      float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int64_t c = 0; c < chunks; ++c) {
        const float4* p = reinterpret_cast<const float4*>(partial + (slot + c) * kn + e);
        const float4 a = p[0], b = p[1];
        s[0] += a.x; s[1] += a.y; s[2] += a.z; s[3] += a.w;
        s[4] += b.x; s[5] += b.y; s[6] += b.z; s[7] += b.w;
      }
      uint4 v;
      v.x = pack_bf16(s[0], s[1]);
      v.y = pack_bf16(s[2], s[3]);
      v.z = pack_bf16(s[4], s[5]);
      v.w = pack_bf16(s[6], s[7]);
      *reinterpret_cast<uint4*>(out + (int64_t)i * kn + e) = v;
      slot += chunks;
    }
    start = end;
  }
}

// ------------------------------------------------------ group_row_sum

constexpr int RS_COLS = 256;             // columns a CTA sums: 32 lanes x 8
constexpr int RS_LANES = THREADS / 32;   // row lanes: warp w takes rows lo + w, lo + w + 8, ...
static_assert(RS_COLS == THREADS, "the shared-memory merge gives each thread one column");

// v = x[r, j .. j + 8), columns at or past n read as 0.
template <typename T>
__device__ __forceinline__ void load8(float (&v)[8], const T* __restrict__ row, int64_t j,
                                      int64_t n, bool vec);
template <>
__device__ __forceinline__ void load8(float (&v)[8], const bf16* __restrict__ row, int64_t j,
                                      int64_t n, bool vec) {
  if (vec && j + 8 <= n) {
    const uint4 u = *reinterpret_cast<const uint4*>(row + j);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(h[q]);
      v[2 * q] = f.x;
      v[2 * q + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = j + q < n ? __bfloat162float(row[j + q]) : 0.f;
  }
}
template <>
__device__ __forceinline__ void load8(float (&v)[8], const float* __restrict__ row, int64_t j,
                                      int64_t n, bool vec) {
  if (vec && j + 8 <= n) {
    const float4 a = *reinterpret_cast<const float4*>(row + j);
    const float4 b = *reinterpret_cast<const float4*>(row + j + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = j + q < n ? row[j + q] : 0.f;
  }
}

// First pass: blockIdx = (chunk, column tile). The chunks are those of the
// nonempty groups in order, at most `rows` rows each, and chunk w's f32
// column sums go to partial[w]: each warp sums its rows in order, four
// rows' loads in flight at a time, then the eight warps' sums merge in
// shared memory in warp order.
template <typename T>
__global__ void __launch_bounds__(THREADS)
group_row_sum_kernel(const T* __restrict__ x, const int* __restrict__ sizes,
                     float* __restrict__ partial, int64_t m, int64_t n, int g, int64_t rows,
                     bool vec) {
  const int64_t w = blockIdx.x;
  int64_t start = 0, work = 0, lo = -1, hi = -1;
  for (int i = 0; i < g && lo < 0; ++i) {
    const int64_t end = lmin(start + lmax(sizes[i], 0), m);
    const int64_t chunks = chunk_count(start, end, rows);
    if (w < work + chunks) {
      lo = start + (w - work) * rows;
      hi = lmin(lo + rows, end);
    }
    work += chunks;
    start = end;
  }
  if (lo < 0) return;  // past the last chunk: the grid is a static bound
  __shared__ float red[RS_LANES][RS_COLS];
  const int lane = threadIdx.x & 31, wr = threadIdx.x >> 5;
  const int64_t c0 = (int64_t)blockIdx.y * RS_COLS, j = c0 + lane * 8;
  float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int64_t r = lo + wr; r < hi; r += 4 * RS_LANES) {
    float v[4][8];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int64_t ru = r + u * RS_LANES;
      if (ru < hi) {
        load8(v[u], x + ru * n, j, n, vec);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) v[u][q] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int q = 0; q < 8; ++q) s[q] += v[u][q];
    }
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) red[wr][lane * 8 + q] = s[q];
  __syncthreads();
  float sum = 0.f;
#pragma unroll
  for (int q = 0; q < RS_LANES; ++q) sum += red[q][threadIdx.x];
  if (c0 + threadIdx.x < n) partial[w * n + c0 + threadIdx.x] = sum;
}

// Second pass: blockIdx = (32-column tile, group). Warp w sums chunks w,
// w + 8, ... of the group for its lane's column, the eight warps' sums
// merge in warp order, and the column's total is rounded once (0 for an
// empty group).
template <typename T>
__global__ void __launch_bounds__(THREADS)
group_row_sum_reduce_kernel(const float* __restrict__ partial, const int* __restrict__ sizes,
                            T* __restrict__ out, int64_t m, int64_t n, int64_t rows) {
  __shared__ float red[RS_LANES][32];
  const int lane = threadIdx.x & 31, wr = threadIdx.x >> 5;
  const int64_t j = (int64_t)blockIdx.x * 32 + lane;
  const int grp = blockIdx.y;
  int64_t start = 0, slot = 0, chunks = 0;
  for (int i = 0; i <= grp; ++i) {
    const int64_t end = lmin(start + lmax(sizes[i], 0), m);
    chunks = chunk_count(start, end, rows);
    if (i < grp) slot += chunks;
    start = end;
  }
  float sum = 0.f;
  if (j < n) {
    for (int64_t c = wr; c < chunks; c += RS_LANES) sum += partial[(slot + c) * n + j];
  }
  red[wr][lane] = sum;
  __syncthreads();
  if (wr == 0 && j < n) {
    float total = 0.f;
#pragma unroll
    for (int q = 0; q < RS_LANES; ++q) total += red[q][lane];
    store1(out + (int64_t)grp * n + j, total);
  }
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

template <bool TRANSPOSE_RHS>
int launch_gmm_tc(const void* lhs, const void* rhs, const int* sizes, void* out, long long m,
                  long long k, long long n, int g, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      gmm_tc_kernel<TRANSPOSE_RHS>, cudaFuncAttributeMaxDynamicSharedMemorySize, tc::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((m + BM - 1) / BM + g), (unsigned)((n + BN - 1) / BN));
  gmm_tc_kernel<TRANSPOSE_RHS><<<grid, THREADS, tc::SMEM_BYTES, st>>>(
      static_cast<const bf16*>(lhs), static_cast<const bf16*>(rhs), sizes,
      static_cast<bf16*>(out), m, k, n, g);
  return (int)cudaGetLastError();
}

template <bool LHS_MK>
int launch_tgmm_tc(const void* lhs_t, const void* rhs, const int* sizes, void* out,
                   void* partial, long long m, long long k, long long n, int g, long long rows,
                   cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      tgmm_tc_kernel<LHS_MK>, cudaFuncAttributeMaxDynamicSharedMemorySize, tc::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((m + rows - 1) / rows + g), (unsigned)((k + BM - 1) / BM),
                  (unsigned)((n + BN - 1) / BN));
  tgmm_tc_kernel<LHS_MK><<<grid, THREADS, tc::SMEM_BYTES, st>>>(
      static_cast<const bf16*>(lhs_t), static_cast<const bf16*>(rhs), sizes,
      static_cast<bf16*>(out), static_cast<float*>(partial), m, k, n, g, rows);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return (int)launched;
  const long long chunks8 = (k * n / 8 + THREADS - 1) / THREADS;
  tgmm_reduce_kernel<<<(unsigned)chunks8, THREADS, 0, st>>>(
      static_cast<const float*>(partial), sizes, static_cast<bf16*>(out), m, k, n, g, rows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_group_row_sum(const void* x, const int* sizes, void* out, void* partial, long long m,
                         long long n, int g, long long rows, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const bool vec = n % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const dim3 grid1((unsigned)((m + rows - 1) / rows + g), (unsigned)((n + RS_COLS - 1) / RS_COLS));
  group_row_sum_kernel<T><<<grid1, THREADS, 0, st>>>(xt, sizes, static_cast<float*>(partial), m,
                                                      n, g, rows, vec);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return (int)launched;
  const dim3 grid2((unsigned)((n + 31) / 32), (unsigned)g);
  group_row_sum_reduce_kernel<T><<<grid2, THREADS, 0, st>>>(
      static_cast<const float*>(partial), sizes, static_cast<T*>(out), m, n, rows);
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

// gmm in bf16 on the tensor cores: the same contract as gmm, for k and n
// multiples of 8 and 16-byte-aligned lhs, rhs and out (what 16-byte
// cp.async and stores need); anything else returns cudaErrorInvalidValue.
extern "C" int gmm_tc(int transpose_rhs, const void* lhs, const void* rhs,
                      const int* group_sizes, void* out, long long m, long long k, long long n,
                      int g, void* stream) {
  if (m < 1 || k < 0 || n < 1 || g < 1 || k % 8 || n % 8 || (n + BN - 1) / BN > 65535 ||
      (m + BM - 1) / BM + g > 2147483647LL ||
      ((reinterpret_cast<uintptr_t>(lhs) | reinterpret_cast<uintptr_t>(rhs) |
        reinterpret_cast<uintptr_t>(out)) & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (transpose_rhs) return launch_gmm_tc<true>(lhs, rhs, group_sizes, out, m, k, n, g, st);
  return launch_gmm_tc<false>(lhs, rhs, group_sizes, out, m, k, n, g, st);
}

// tgmm in bf16 on the tensor cores: the same contract as tgmm, for k and n
// multiples of 8 (and m too for a contiguous [k, m] lhs_t, whose copies run
// along m) and 16-byte-aligned lhs_t, rhs, out and partial. A group is cut
// into chunks of at most `chunk_rows` rows; a group of several chunks
// writes f32 partials, one [k, n] slot per chunk, to `partial`, which must
// hold every such chunk the sizes can make (the wrapper's bound), and a
// second launch sums them. Both launches go on `stream`.
extern "C" int tgmm_tc(int lhs_mk, const void* lhs_t, const void* rhs, const int* group_sizes,
                       void* out, void* partial, long long m, long long k, long long n, int g,
                       long long chunk_rows, void* stream) {
  if (m < 0 || k < 1 || n < 1 || g < 1 || chunk_rows < 1 || k % 8 || n % 8 ||
      (!lhs_mk && m % 8) || (k + BM - 1) / BM > 65535 || (n + BN - 1) / BN > 65535 ||
      (m + chunk_rows - 1) / chunk_rows + g > 2147483647LL ||
      (k * n / 8 + THREADS - 1) / THREADS > 2147483647LL ||
      ((reinterpret_cast<uintptr_t>(lhs_t) | reinterpret_cast<uintptr_t>(rhs) |
        reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(partial)) & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (lhs_mk)
    return launch_tgmm_tc<true>(lhs_t, rhs, group_sizes, out, partial, m, k, n, g, chunk_rows, st);
  return launch_tgmm_tc<false>(lhs_t, rhs, group_sizes, out, partial, m, k, n, g, chunk_rows, st);
}

// out[i, :] = the f32 sum of x's rows in segment i, rounded once to x's
// type (0 for an empty segment): x [m, n] f32 or bf16, out [g, n]. The rows
// of each segment are cut into chunks of at most `chunk_rows`; `partial`
// holds (ceil(m / chunk_rows) + g) * n floats. Two launches on `stream`.
extern "C" int group_row_sum(int dtype, const void* x, const int* group_sizes, void* out,
                             void* partial, long long m, long long n, int g, long long chunk_rows,
                             void* stream) {
  if (m < 0 || n < 1 || g < 1 || g > 65535 || chunk_rows < 1 ||
      (n + RS_COLS - 1) / RS_COLS > 65535 ||
      (m + chunk_rows - 1) / chunk_rows + g > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_group_row_sum<float>(x, group_sizes, out, partial, m, n, g, chunk_rows, st);
  if (dtype == 1)
    return launch_group_row_sum<bf16>(x, group_sizes, out, partial, m, n, g, chunk_rows, st);
  return (int)cudaErrorInvalidValue;
}
