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
// them, against 0.049 ms for the bytes.
//
// Two gmm kernels, picked by the wrapper from dtype, shape and alignment:
//
// gmm_tc_kernel (bf16, k % 8 == 0, n % 8 == 0, 16-byte aligned operands:
// every gmm of the MoE step, forward and transpose_rhs) runs on the tensor
// cores. One CTA of 8 warps computes a 128 x 128 output tile, each warp a
// 64 x 32 warp tile of mma.sync.m16n8k16 bf16 fragments with f32
// accumulators, over 32-deep slices of the reduction (two k16 steps) kept
// as bf16 in shared memory. A ring of STAGES slices is filled by 16-byte
// cp.async: the load of slice t + STAGES - 1 is issued before the products
// of slice t. Rows at or past m and reduction columns at or past k are
// zero-filled by the copy (src-size 0); rows of a neighbouring group are
// loaded and masked at the store, as megablox does. lhs [m, k] fragments
// come from ldmatrix, rhs [k, n] from ldmatrix.trans, and rhs [n, k]
// (transpose_rhs, the backward's dlhs) from plain ldmatrix; each shared
// row is padded by 16 bytes, so neither conflicts. The epilogue rounds to
// bf16, stages the tile through shared memory and writes 16-byte stores,
// keeping the per-row group mask. The C interface is `gmm_tc`.
//
// The SIMT kernels (f32 gmm; bf16 gmm at other shapes, such as k or n of
// 100 and 36; tgmm in both types) stay off the tensor cores: a
// shared-memory-tiled SIMT GEMM with f32 accumulators, so in bf16 it runs
// far above its bound, and the f32 bound is the one it can approach (TF32
// would change f32's numbers, which the MoE generate path, 384 f32 gmm
// launches a call, is held to).
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
//   tgmm: one CTA per (group, k tile, n tile), looping over that group's
//         rows: deterministic, no atomics, and a group of no rows stores
//         the zeros of its untouched accumulators.

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; full = false zero-fills the destination.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  const int src_bytes = full ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16x16 bf16, row) x b (16x8 bf16, col), f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

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
