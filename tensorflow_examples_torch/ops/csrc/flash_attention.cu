// Flash attention forward and its two backward kernels for Hopper
// (sm_90a), plain C interface.
//
// Replaces the three TPU kernels of tensorflow_examples_tpu/ops/attention.py:
//   flash_fwd      <- _fwd_kernel      (driven by _flash_fwd)
//   flash_bwd_dkv  <- _bwd_dkv_kernel  (driven by _flash_bwd)
//   flash_bwd_dq   <- _bwd_dq_kernel   (driven by _flash_bwd)
// The GPT-2 training step runs them for every layer's causal
// self-attention under TransformerConfig.attention="flash": one forward,
// then dK/dV and dQ in the backward (a second forward per layer under
// remat).
//
// Contract (the JAX one): q [BH, seq_q, D], k/v [BH, seq_kv, D], row-major
// and contiguous, f32 or bf16, head_dim D in {8, 16, 32, 64, 128}. The
// causal diagonal is aligned bottom-right: row r sees key columns
// c <= r + (seq_kv - seq_q). An optional f32 key bias [B, seq_kv]
// (B = BH / heads) is added to every score of its batch row; it is data,
// not differentiated. The forward writes O (q's dtype) and the row
// logsumexp lse [BH, seq_q] (f32); the backward takes dO, lse,
// delta = rowsum(dO * O) and the lse cotangent dlse (all f32 but dO) and
// uses ds = p * (dp - delta + dlse) with p = exp(s - lse). Everything is
// accumulated in f32. A row that sees no key writes O = 0 and lse ~ -1e30
// (l is clamped at 1e-30), as in the JAX kernel. Any sequence length is
// taken: tiles past the end are masked, never tiled to a divisor.
//
// What bounds them on an H100: at the GPT-2 training shape (BH = 192,
// seq 1024, D = 64, causal) the forward does ~26 GFLOP on ~100 MB and the
// backward ~2.5x that, i.e. ~250 operations per byte: past the f32 ridge
// (67 TFLOP/s over 3.35 TB/s) and, counted against the bf16 tensor cores
// (989 TFLOP/s), near theirs. So in bf16 all three run on the tensor
// cores (head_dim 16 to 128); the f32 kernels, and bf16 at D = 8, are
// SIMT, bound by FMA throughput on the CUDA cores.
//
// The bf16 forward (flash_fwd_mma_kernel, D = 16..128), FlashAttention-2's
// design on mma.sync: one CTA of 4 warps takes 64 query rows of one
// (batch*head), 16 rows a warp, and launches the longest causal tiles
// first (the query-tile index runs backwards on the slow grid axis). Q is
// copied once to shared memory with cp.async and kept in registers as
// ldmatrix A fragments. K and V tiles of 64 rows stay bf16 in shared
// memory, each row padded by 16 bytes so that ldmatrix is free of bank
// conflicts, and are double-buffered: the cp.async of tile j+1 is issued
// before the tensor-core work on tile j (rows past the loop bound are
// zero-filled by the copy, never read). S = Q K^T by
// mma.sync.m16n8k16.bf16 with f32 accumulators; sm_scale is applied to S
// in f32 (1/sqrt(D) is no power of two at D = 8, 32, 128, so scaling bf16
// q would move the lse); the key bias and the causal / ragged-end mask go
// onto the f32 fragments, the mask only on tiles that reach the diagonal
// or the end. The online softmax runs on the fragments (row max and sum
// across each quad with two shuffles), with the reference's running max
// from -1e30 and rescale alpha = exp(m - m_new). P is rounded to bf16 in
// registers and fed straight back as the A operand of O += P V (two
// adjacent n8 C fragments are one k16 A fragment), with V fragments from
// ldmatrix.trans on the row-major [kv, D] tile; O stays in f32 registers.
// The epilogue divides by max(l, 1e-30), stages O as bf16 through shared
// memory and writes it with 16-byte coalesced stores; lse = m + log(l).
// The one difference from the reference: the JAX kernel multiplies f32 p
// by v, this kernel rounds p to bf16 once for the product (l sums the f32
// p, so the lse is unchanged). D = 8 is under the mma's k16 depth and
// takes the SIMT kernel in bf16 as well.
//
// The bf16 backward (flash_bwd_dkv_mma_kernel, flash_bwd_dq_mma_kernel,
// D = 16..128) recomputes p from the forward's lse on the same mma.sync
// machinery. Each output element has one writer, with no atomics and no
// second pass, so a rerun gives the same bits.
//   dK/dV is the forward transposed: one CTA of 4 warps takes 64 key rows
//     of one (batch*head), 16 a warp, keeps them as A fragments (K for
//     S^T = K Q^T, V for dP^T = V dO^T) and walks the query tiles (64
//     rows; 32 at D = 128) from the first that reaches the diagonal,
//     double-buffering Q, dO and the rows' lse, delta and dlse by
//     cp.async; causal key tile 0 walks them all, so the low key tiles
//     launch first. On each tile P^T = exp(S^T sm_scale + bias - lse) and
//     dS^T = P^T (dP^T - delta + dlse) are formed on the C fragments (the
//     bias by the thread's key rows, lse, delta and dlse by its columns),
//     packed to bf16 as A fragments, and dV += P^T dO, dK += dS^T Q take
//     dO and Q as B fragments by ldmatrix.trans. No warp reads another's
//     rows, so nothing is reduced across warps. dK is scaled by sm_scale
//     in the epilogue, and both leave as bf16 through shared memory with
//     16-byte stores.
//   dQ has the forward's shape: 64 query rows a CTA with Q and dO as A
//     fragments and each row's lse, delta and dlse in registers, walking
//     the key tiles to the diagonal with K and V double-buffered, longest
//     causal tiles first; S = Q K^T, dP = dO V^T, dS on the fragments,
//     dQ += dS K with K by ldmatrix.trans.
// At D = 128 the loop-invariant A operands are re-read from shared memory
// on each step and dK/dV takes 32-row query tiles, to stay within 255
// registers a thread without spills. As in the forward, the one
// difference from the reference: the JAX kernels multiply f32 p and ds by
// f32 operands, these kernels round p and ds to bf16 once for their
// products; scores, p, ds and every accumulator stay f32.
//
// The SIMT kernels (f32 at every D; bf16 at D = 8): TILE rows per CTA,
// PARTS threads per row (2 at D = 8, 8 at D = 128, else 4), each holding
// D / PARTS of the row's dims in float4 groups, interleaved so the PARTS
// threads of a row read contiguous bytes of a shared row and a warp's
// rows read the same address (a broadcast).
// Dot products reduce over the row's threads with shuffles. A loop inside
// the CTA walks the other operand's tiles (KT rows: 64, or 32 at D = 128
// to stay within 48 KB of static shared memory) staged as f32 (this loop
// replaces the TPU's sequential grid axis); under causal masking its
// bounds stop at the diagonal, so tiles wholly past it are never read.
// Masked scores are -inf inside the kernels, so their probability is
// exactly 0 and a fully masked tile cannot make a NaN: the running max
// starts at the finite -1e30 and -inf - m = -inf. Element offsets are
// computed in 64 bits.
//   flash_fwd (SIMT): one CTA per (batch*head, 64-row query tile); online
//     softmax with (m, l, acc) in registers; one tile's scores per thread.
//   flash_bwd_dkv (SIMT): one CTA per (batch*head, 64-row key tile);
//     walks query tiles from the first one that reaches the diagonal,
//     recomputes p = exp(s - lse), accumulates dV += p dO and dK += ds q.
//   flash_bwd_dq (SIMT): one CTA per (batch*head, 64-row query tile);
//     walks key tiles up to the diagonal, accumulates dQ += ds k.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TILE = 64;               // rows per CTA
constexpr float NEG_INF = -1e30f;      // ops/attention.py NEG_INF

// The SIMT kernels' layout for head_dim D.
template <int D>
struct Simt {
  static_assert(D == 8 || D == 16 || D == 32 || D == 64 || D == 128, "unsupported head_dim");
  static constexpr int PARTS = D == 8 ? 2 : (D == 128 ? 8 : 4);  // threads per row
  static constexpr int DPT = D / PARTS;                            // dims per thread
  static constexpr int GROUPS = DPT / 4;                           // float4 groups per thread
  static constexpr int THREADS = TILE * PARTS;
  static constexpr int KT = D == 128 ? 32 : 64;                    // rows of a staged tile
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(bf16* p, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// First of the four dims a thread owns in its i-th group of four.
template <int D>
__device__ __forceinline__ int dim_of(int part, int i) {
  return 4 * Simt<D>::PARTS * i + 4 * part;
}

// One row's owned dims from device memory into registers (zeros when the
// row does not exist), times `scale`.
template <int D, typename T>
__device__ __forceinline__ void load_row(float (&dst)[Simt<D>::DPT], const T* row, bool live,
                                         int part, float scale) {
#pragma unroll
  for (int i = 0; i < Simt<D>::GROUPS; ++i) {
    const float4 x = live ? load4(row + dim_of<D>(part, i)) : make_float4(0.f, 0.f, 0.f, 0.f);
    dst[4 * i + 0] = x.x * scale;
    dst[4 * i + 1] = x.y * scale;
    dst[4 * i + 2] = x.z * scale;
    dst[4 * i + 3] = x.w * scale;
  }
}

template <int D, typename T>
__device__ __forceinline__ void store_row(T* row, const float (&src)[Simt<D>::DPT], int part,
                                          float scale) {
#pragma unroll
  for (int i = 0; i < Simt<D>::GROUPS; ++i)
    store4(row + dim_of<D>(part, i), src[4 * i] * scale, src[4 * i + 1] * scale,
           src[4 * i + 2] * scale, src[4 * i + 3] * scale);
}

// Rows [row0, row0 + KT) of one head's [rows, D] matrix into shared memory
// as f32; rows at or past `end` are zero-filled.
template <int D, typename T>
__device__ __forceinline__ void stage_tile(float (*dst)[D], const T* src, int row0, int end) {
  for (int idx = threadIdx.x; idx < Simt<D>::KT * (D / 4); idx += Simt<D>::THREADS) {
    const int r = idx / (D / 4);
    const int c = (idx % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < end) x = load4(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<float4*>(&dst[r][c]) = x;
  }
}

// The dot product of a thread's dims with a shared row, summed over the
// threads of the row.
template <int D>
__device__ __forceinline__ float row_dot(const float (&a)[Simt<D>::DPT], const float* srow,
                                         int part) {
  float dot = 0.f;
#pragma unroll
  for (int i = 0; i < Simt<D>::GROUPS; ++i) {
    const float4 b = *reinterpret_cast<const float4*>(srow + dim_of<D>(part, i));
    dot += a[4 * i] * b.x + a[4 * i + 1] * b.y + a[4 * i + 2] * b.z + a[4 * i + 3] * b.w;
  }
#pragma unroll
  for (int o = 1; o < Simt<D>::PARTS; o <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
  return dot;
}

// acc += w * shared row (the thread's dims).
template <int D>
__device__ __forceinline__ void row_axpy(float (&acc)[Simt<D>::DPT], float w, const float* srow,
                                         int part) {
#pragma unroll
  for (int i = 0; i < Simt<D>::GROUPS; ++i) {
    const float4 b = *reinterpret_cast<const float4*>(srow + dim_of<D>(part, i));
    acc[4 * i + 0] += w * b.x;
    acc[4 * i + 1] += w * b.y;
    acc[4 * i + 2] += w * b.z;
    acc[4 * i + 3] += w * b.w;
  }
}

// Key columns [0, kv_end) that any of query rows [q0, q_last] may see.
__device__ __forceinline__ int kv_reach(int q_last, int offset, int seq_kv, int causal) {
  return causal ? max(0, min(seq_kv, q_last + offset + 1)) : seq_kv;
}

// ------------------------------------------------------------ SIMT forward

template <typename T, int D>
__global__ void __launch_bounds__(Simt<D>::THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ kb, T* __restrict__ o, float* __restrict__ lse,
                 int heads, int seq_q, int seq_kv, int causal, float sm_scale) {
  using L = Simt<D>;
  __shared__ __align__(16) float ks[L::KT][D];
  __shared__ __align__(16) float vs[L::KT][D];
  __shared__ float bias[L::KT];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * TILE;
  const int row = threadIdx.x / L::PARTS;
  const int part = threadIdx.x % L::PARTS;
  const int qi = q0 + row;
  const bool live = qi < seq_q;
  const int offset = seq_kv - seq_q;
  const int row_last = causal ? qi + offset : seq_kv - 1;  // last column this row sees

  float qr[L::DPT], acc[L::DPT];
  load_row<D>(qr, q + ((size_t)bh * seq_q + qi) * D, live, part, sm_scale);
#pragma unroll
  for (int i = 0; i < L::DPT; ++i) acc[i] = 0.f;
  float m = NEG_INF, l = 0.f;

  const int kv_end = kv_reach(min(q0 + TILE, seq_q) - 1, offset, seq_kv, causal);
  const T* kp = k + (size_t)bh * seq_kv * D;
  const T* vp = v + (size_t)bh * seq_kv * D;
  const float* bp = kb ? kb + (size_t)(bh / heads) * seq_kv : nullptr;

  for (int kv0 = 0; kv0 < kv_end; kv0 += L::KT) {
    __syncthreads();  // the previous tile is fully consumed
    stage_tile<D>(ks, kp, kv0, kv_end);
    stage_tile<D>(vs, vp, kv0, kv_end);
    if (threadIdx.x < L::KT)
      bias[threadIdx.x] = (bp && kv0 + threadIdx.x < kv_end) ? bp[kv0 + threadIdx.x] : 0.f;
    __syncthreads();

    float s[L::KT];
    float tile_max = NEG_INF;
#pragma unroll
    for (int j = 0; j < L::KT; ++j) {
      const float dot = row_dot<D>(qr, ks[j], part) + bias[j];
      const int col = kv0 + j;
      s[j] = (col < kv_end && col <= row_last) ? dot : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
#pragma unroll
    for (int i = 0; i < L::DPT; ++i) acc[i] *= alpha;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < L::KT; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
      row_axpy<D>(acc, p, vs[j], part);
    }
    l = l * alpha + psum;
    m = m_new;
  }

  if (live) {
    const float denom = fmaxf(l, 1e-30f);
    store_row<D>(o + ((size_t)bh * seq_q + qi) * D, acc, part, 1.f / denom);
    if (part == 0) lse[(size_t)bh * seq_q + qi] = m + logf(denom);
  }
}

// ------------------------------------------- bf16 forward on the tensor cores

constexpr int FA_ROWS = 64;     // query rows per CTA, 16 per warp
constexpr int FA_KV = 64;       // key rows per tile
constexpr int FA_THREADS = 128; // 4 warps

// Shared memory of the tensor-core forward: the Q tile, then two stages
// of K and two of V, each 64 rows of D bf16 padded by 8 (16 bytes).
template <int D>
struct FaSmem {
  static constexpr int LD = D + 8;
  static constexpr int TILE_ELEMS = 64 * LD;
  static constexpr int BYTES = 5 * TILE_ELEMS * (int)sizeof(bf16);
};

// Rows [row0, row0 + ROWS) of one head's [rows, D] bf16 matrix into a
// padded shared tile by cp.async; rows at or past `end` are zero-filled.
template <int D, int ROWS = 64>
__device__ __forceinline__ void stage_bf16(bf16* dst, const bf16* src, int row0, int end) {
  constexpr int PER_ROW = D / 8;  // 16-byte chunks in a row
  static_assert(ROWS * PER_ROW % FA_THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int t = 0; t < ROWS * PER_ROW / FA_THREADS; ++t) {
    const int c = threadIdx.x + t * FA_THREADS;
    const int r = c / PER_ROW, col = (c % PER_ROW) * 8;
    const bool in = row0 + r < end;
    cp_async16(smem_u32(dst + r * FaSmem<D>::LD + col),
               in ? src + (size_t)(row0 + r) * D + col : src, in);
  }
}

// Rows [row0, row0 + 64) of a padded shared tile to one head's [rows, D]
// bf16 matrix with 16-byte stores; rows at or past `end` are not written.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const bf16* tile, int row0, int end) {
  constexpr int PER_ROW = D / 8;
#pragma unroll
  for (int t = 0; t < 64 * PER_ROW / FA_THREADS; ++t) {
    const int c = threadIdx.x + t * FA_THREADS;
    const int r = c / PER_ROW, col = (c % PER_ROW) * 8;
    if (row0 + r < end)
      *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * D + col) =
          *reinterpret_cast<const uint4*>(tile + r * FaSmem<D>::LD + col);
  }
}

template <int D>
__global__ void __launch_bounds__(FA_THREADS)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ kb,
                     bf16* __restrict__ o, float* __restrict__ lse, int heads, int seq_q,
                     int seq_kv, int causal, float sm_scale) {
  static_assert(D % 16 == 0 && D >= 16 && D <= 128, "the mma forward takes D = 16..128");
  constexpr int LD = FaSmem<D>::LD;
  constexpr int TE = FaSmem<D>::TILE_ELEMS;
  constexpr int KSTEPS = D / 16;   // k16 steps of Q K^T
  constexpr int DTILES = D / 8;    // n8 tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* kst = qs + TE;      // two K stages
  bf16* vst = qs + 3 * TE;  // two V stages

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FA_ROWS;  // longest causal tiles first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int offset = seq_kv - seq_q;
  const int kv_end = kv_reach(min(q0 + FA_ROWS, seq_q) - 1, offset, seq_kv, causal);
  const int n_tiles = (kv_end + FA_KV - 1) / FA_KV;

  const bf16* qp = q + (size_t)bh * seq_q * D;
  const bf16* kp = k + (size_t)bh * seq_kv * D;
  const bf16* vp = v + (size_t)bh * seq_kv * D;
  const float* bp = kb ? kb + (size_t)(bh / heads) * seq_kv : nullptr;

  stage_bf16<D>(qs, qp, q0, seq_q);
  if (n_tiles > 0) {
    stage_bf16<D>(kst, kp, 0, kv_end);
    stage_bf16<D>(vst, vp, 0, kv_end);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // Q A fragments of this warp's 16 rows, kept for the whole loop.
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks)
    ldmatrix_x4(qf[ks], smem_u32(qs + (warp * 16 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8));

  float acc[DTILES][4];
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // rows g and g + 8 (thread-partial l)
  const int row_g = q0 + warp * 16 + g;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: which matrix, which row of it

  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * FA_KV;
    if (j + 1 < n_tiles) {  // the next tile flies during this tile's products
      stage_bf16<D>(kst + ((j + 1) & 1) * TE, kp, kv0 + FA_KV, kv_end);
      stage_bf16<D>(vst + ((j + 1) & 1) * TE, vp, kv0 + FA_KV, kv_end);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = kst + (j & 1) * TE;
    const bf16* vt = vst + (j & 1) * TE;

    // S = Q K^T: 16 x 64 per warp, eight n8 tiles.
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, smem_u32(kt + (np * 16 + mr + (mi >> 1) * 8) * LD + ks * 16 + (mi & 1) * 8));
        mma_bf16(s[2 * np], qf[ks], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[ks], b[2], b[3]);
      }
    }

    // Scale in f32, key bias, and the mask where the tile reaches the
    // diagonal or the end of the keys.
    const bool edge = kv0 + FA_KV > seq_kv || (causal && kv0 + FA_KV - 1 > q0 + offset);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = kv0 + nt * 8 + 2 * tig + e;
        const float b = (bp && col < seq_kv) ? __ldg(bp + col) : 0.f;
        float x0 = s[nt][e] * sm_scale + b;      // row g
        float x1 = s[nt][2 + e] * sm_scale + b;  // row g + 8
        if (edge) {
          if (col >= seq_kv || (causal && col > row_g + offset)) x0 = -INFINITY;
          if (col >= seq_kv || (causal && col > row_g + 8 + offset)) x1 = -INFINITY;
        }
        s[nt][e] = x0;
        s[nt][2 + e] = x1;
      }
    }

    // Online softmax on the fragments; a quad of threads shares two rows.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    const float alpha0 = expf(m[0] - mx[0]), alpha1 = expf(m[1] - mx[1]);
    m[0] = mx[0];
    m[1] = mx[1];
    float rs0 = 0.f, rs1 = 0.f;
    uint32_t pf[4][4];  // P as the A fragments of four k16 steps
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float p0 = expf(s[nt][0] - m[0]), p1 = expf(s[nt][1] - m[0]);
      const float p2 = expf(s[nt][2] - m[1]), p3 = expf(s[nt][3] - m[1]);
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      pf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p0, p1);  // a0 / a2: row g
      pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);  // a1 / a3: row g + 8
    }
    l[0] = l[0] * alpha0 + rs0;
    l[1] = l[1] * alpha1 + rs1;
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt) {
      acc[dt][0] *= alpha0;
      acc[dt][1] *= alpha0;
      acc[dt][2] *= alpha1;
      acc[dt][3] *= alpha1;
    }

    // O += P V, V fragments by ldmatrix.trans from the row-major tile.
#pragma unroll
    for (int kstep = 0; kstep < 4; ++kstep) {
#pragma unroll
      for (int dp = 0; dp < DTILES / 2; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, smem_u32(vt + (kstep * 16 + mr + (mi & 1) * 8) * LD + dp * 16 + (mi >> 1) * 8));
        mma_bf16(acc[2 * dp], pf[kstep], b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], pf[kstep], b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is consumed before the next prefetch overwrites it
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float den0 = fmaxf(l[0], 1e-30f), den1 = fmaxf(l[1], 1e-30f);
  const float inv0 = 1.f / den0, inv1 = 1.f / den1;
  if (tig == 0) {
    if (row_g < seq_q) lse[(size_t)bh * seq_q + row_g] = m[0] + logf(den0);
    if (row_g + 8 < seq_q) lse[(size_t)bh * seq_q + row_g + 8] = m[1] + logf(den1);
  }

  // O as bf16 through the (now free) Q tile, then 16-byte stores.
  __syncthreads();
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt) {
    const int col = dt * 8 + 2 * tig;
    *reinterpret_cast<uint32_t*>(qs + (warp * 16 + g) * LD + col) =
        pack_bf16(acc[dt][0] * inv0, acc[dt][1] * inv0);
    *reinterpret_cast<uint32_t*>(qs + (warp * 16 + g + 8) * LD + col) =
        pack_bf16(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
  __syncthreads();
  store_rows<D>(o + (size_t)bh * seq_q * D, qs, q0, seq_q);
}

// ------------------------------------ bf16 backward on the tensor cores

// Shapes of the two tensor-core backward kernels for head_dim D.
template <int D>
struct BwdMma {
  static constexpr int LD = D + 8;
  // Query rows of a dK/dV step: 32 at D = 128, where the two 16 x D f32
  // accumulators take 128 registers a thread and leave no room for
  // 64-column score tiles.
  static constexpr int QT = D == 128 ? 32 : 64;
  // Whether the loop-invariant A operands (K and V in dK/dV, Q and dO in
  // dQ) stay in registers; at D = 128 they are read from shared memory
  // on every step instead.
  static constexpr bool A_IN_REGS = D <= 64;
  // dK/dV: K, V, two stages of Q and of dO, two of (lse, delta, dlse).
  static constexpr int DKV_BYTES =
      (2 * 64 + 4 * QT) * LD * (int)sizeof(bf16) + 2 * 3 * QT * (int)sizeof(float);
  // dQ: Q, dO, two stages of K and of V.
  static constexpr int DQ_BYTES = 6 * 64 * LD * (int)sizeof(bf16);
};

// lse, delta and dlse of rows [row0, row0 + ROWS) into dst[3][ROWS]
// (rows at or past `end` zero-filled). The rows start at any float, so
// the copies are 4 bytes each.
template <int ROWS>
__device__ __forceinline__ void stage_rowvecs(float* dst, const float* lse, const float* delta,
                                              const float* dlse, int row0, int end) {
  for (int i = threadIdx.x; i < 3 * ROWS; i += FA_THREADS) {
    const int which = i / ROWS, r = i % ROWS;
    const float* src = which == 0 ? lse : (which == 1 ? delta : dlse);
    const bool in = row0 + r < end;
    cp_async4(smem_u32(dst + i), in ? src + row0 + r : src, in);
  }
}

// The A fragment (16 x 16, k16 step `ks`) of this warp's 16 rows of a
// padded shared tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const bf16* tile, int warp, int lane,
                                       int ks) {
  ldmatrix_x4(r, smem_u32(tile + (warp * 16 + (lane & 15)) * (D + 8) + ks * 16 + (lane >> 4) * 8));
}

// acc (16 x NT*8) += A x B^T over D, where B's rows are the first NT*8
// rows of a padded [rows][D] shared tile: B fragments by ldmatrix.
// A is `af` (registers) or, when A_IN_REGS is false, the warp's rows of
// the shared tile `a_tile`.
template <int D, int NT, bool A_IN_REGS, int FR>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const uint32_t (&af)[FR][4],
                                        const bf16* a_tile, const bf16* b_tile, int warp,
                                        int lane) {
  const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t a[4];
    if constexpr (A_IN_REGS) {
      a[0] = af[ks][0], a[1] = af[ks][1], a[2] = af[ks][2], a[3] = af[ks][3];
    } else {
      load_a<D>(a, a_tile, warp, lane, ks);
    }
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, smem_u32(b_tile + (np * 16 + mr + (mi >> 1) * 8) * (D + 8) + ks * 16 +
                              (mi & 1) * 8));
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x D) += A x B, A the bf16 fragments `af` of a 16 x KSTEPS*16
// matrix, B the first KSTEPS*16 rows of a padded row-major [rows][D]
// shared tile: B fragments by ldmatrix.trans.
template <int D, int KSTEPS>
__device__ __forceinline__ void mma_ab(float (&acc)[D / 8][4], const uint32_t (&af)[KSTEPS][4],
                                       const bf16* b_tile, int lane) {
  const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, smem_u32(b_tile + (ks * 16 + mr + (mi & 1) * 8) * (D + 8) + dp * 16 +
                                    (mi >> 1) * 8));
      mma_bf16(acc[2 * dp], af[ks], b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], af[ks], b[2], b[3]);
    }
  }
}

// A warp's 16 x D f32 accumulator, times `scale`, as bf16 into its rows
// of a padded shared tile.
template <int D>
__device__ __forceinline__ void stage_acc(bf16* tile, const float (&acc)[D / 8][4], float scale,
                                          int warp, int lane) {
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * tig;
    *reinterpret_cast<uint32_t*>(tile + (warp * 16 + g) * (D + 8) + col) =
        pack_bf16(acc[dt][0] * scale, acc[dt][1] * scale);
    *reinterpret_cast<uint32_t*>(tile + (warp * 16 + g + 8) * (D + 8) + col) =
        pack_bf16(acc[dt][2] * scale, acc[dt][3] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(FA_THREADS)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const float* __restrict__ dlse, const float* __restrict__ kb,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int heads, int seq_q,
                         int seq_kv, int causal, float sm_scale) {
  static_assert(D % 16 == 0 && D >= 16 && D <= 128, "the mma backward takes D = 16..128");
  using T = BwdMma<D>;
  constexpr int LD = T::LD, QT = T::QT;
  constexpr int NT = QT / 8;       // n8 tiles of a warp's S^T row block (queries)
  constexpr int QSTEPS = QT / 16;  // k16 steps of dV += P^T dO and dK += dS^T Q
  constexpr int DTILES = D / 8;
  constexpr int FR = T::A_IN_REGS ? D / 16 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks_ = reinterpret_cast<bf16*>(smem_raw);  // K rows of this CTA, then dK
  bf16* vs_ = ks_ + 64 * LD;                      // V rows, then dV
  bf16* qst = vs_ + 64 * LD;                      // two Q stages
  bf16* dost = qst + 2 * QT * LD;                 // two dO stages
  float* vec = reinterpret_cast<float*>(dost + 2 * QT * LD);  // two [lse | delta | dlse] stages

  const int bh = blockIdx.x;
  const int kv0 = blockIdx.y * 64;  // causal key tile 0 walks every query tile: it goes first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int offset = seq_kv - seq_q;
  // The first query row that sees key kv0 is kv0 - offset; start at its tile.
  const int q_begin = causal ? max(0, kv0 - offset) / QT * QT : 0;
  const int n_tiles = max(0, (seq_q - q_begin + QT - 1) / QT);

  const size_t qrow0 = (size_t)bh * seq_q;
  const bf16* qp = q + qrow0 * D;
  const bf16* dop = dout + qrow0 * D;
  const float* lp = lse + qrow0;
  const float* dlp = delta + qrow0;
  const float* dlsep = dlse + qrow0;

  stage_bf16<D>(ks_, k + (size_t)bh * seq_kv * D, kv0, seq_kv);
  stage_bf16<D>(vs_, v + (size_t)bh * seq_kv * D, kv0, seq_kv);
  if (n_tiles > 0) {
    stage_bf16<D, QT>(qst, qp, q_begin, seq_q);
    stage_bf16<D, QT>(dost, dop, q_begin, seq_q);
    stage_rowvecs<QT>(vec, lp, dlp, dlsep, q_begin, seq_q);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t kf[FR][4], vf[FR][4];  // K and V A fragments of the warp's 16 key rows
  if constexpr (T::A_IN_REGS) {
#pragma unroll
    for (int s = 0; s < D / 16; ++s) {
      load_a<D>(kf[s], ks_, warp, lane, s);
      load_a<D>(vf[s], vs_, warp, lane, s);
    }
  }
  const int key_g = kv0 + warp * 16 + g;  // this thread's key rows: key_g and key_g + 8
  const float* bp = kb ? kb + (size_t)(bh / heads) * seq_kv : nullptr;
  const float bias0 = (bp && key_g < seq_kv) ? bp[key_g] : 0.f;
  const float bias1 = (bp && key_g + 8 < seq_kv) ? bp[key_g + 8] : 0.f;

  float dka[DTILES][4], dva[DTILES][4];
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dt][e] = dva[dt][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int q0 = q_begin + j * QT;
    if (j + 1 < n_tiles) {  // the next query tile flies during this tile's products
      const int nb = (j + 1) & 1;
      stage_bf16<D, QT>(qst + nb * QT * LD, qp, q0 + QT, seq_q);
      stage_bf16<D, QT>(dost + nb * QT * LD, dop, q0 + QT, seq_q);
      stage_rowvecs<QT>(vec + nb * 3 * QT, lp, dlp, dlsep, q0 + QT, seq_q);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* qt = qst + (j & 1) * QT * LD;
    const bf16* dot = dost + (j & 1) * QT * LD;
    const float* lse_t = vec + (j & 1) * 3 * QT;
    const float* delta_t = lse_t + QT;
    const float* dlse_t = lse_t + 2 * QT;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x QT queries per warp.
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
    mma_abt<D, NT, T::A_IN_REGS>(st, kf, ks_, qt, warp, lane);
    mma_abt<D, NT, T::A_IN_REGS>(dpt, vf, vs_, dot, warp, lane);

    // P^T = exp(S^T sm_scale + bias - lse) and dS^T = P^T (dP^T - delta +
    // dlse) on the fragments, packed to bf16 as A operands; the mask only
    // where the tile reaches the diagonal or the end of the queries.
    const bool edge = q0 + QT > seq_q || (causal && kv0 + 63 > q0 + offset);
    uint32_t pf[QSTEPS][4], dsf[QSTEPS][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = nt * 8 + 2 * tig + e;  // query column in the tile
        const float l = lse_t[c], dd = delta_t[c], dl = dlse_t[c];
        float p0 = expf(st[nt][e] * sm_scale + bias0 - l);      // key row g
        float p1 = expf(st[nt][2 + e] * sm_scale + bias1 - l);  // key row g + 8
        if (edge) {
          const int qi = q0 + c;
          if (qi >= seq_q || (causal && key_g > qi + offset)) p0 = 0.f;
          if (qi >= seq_q || (causal && key_g + 8 > qi + offset)) p1 = 0.f;
        }
        p[e] = p0;
        p[2 + e] = p1;
        ds[e] = p0 * (dpt[nt][e] - dd + dl);
        ds[2 + e] = p1 * (dpt[nt][2 + e] - dd + dl);
      }
      pf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
      pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      dsf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      dsf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dV += P^T dO and dK += dS^T Q, B fragments by ldmatrix.trans.
    mma_ab<D, QSTEPS>(dva, pf, dot, lane);
    mma_ab<D, QSTEPS>(dka, dsf, qt, lane);
    __syncthreads();  // this stage is consumed before the next prefetch overwrites it
  }
  cp_async_wait<0>();

  // dK (times sm_scale) and dV as bf16 through the K and V tiles, then
  // 16-byte stores. Each warp wrote and read only its own rows so far.
  __syncthreads();
  stage_acc<D>(ks_, dka, sm_scale, warp, lane);
  stage_acc<D>(vs_, dva, 1.f, warp, lane);
  __syncthreads();
  store_rows<D>(dk + (size_t)bh * seq_kv * D, ks_, kv0, seq_kv);
  store_rows<D>(dv + (size_t)bh * seq_kv * D, vs_, kv0, seq_kv);
}

template <int D>
__global__ void __launch_bounds__(FA_THREADS)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const float* __restrict__ dlse, const float* __restrict__ kb,
                        bf16* __restrict__ dq, int heads, int seq_q, int seq_kv, int causal,
                        float sm_scale) {
  static_assert(D % 16 == 0 && D >= 16 && D <= 128, "the mma backward takes D = 16..128");
  using T = BwdMma<D>;
  constexpr int LD = T::LD;
  constexpr int TE = 64 * LD;
  constexpr int DTILES = D / 8;
  constexpr int FR = T::A_IN_REGS ? D / 16 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // Q rows of this CTA, then dQ
  bf16* dos = qs + TE;                           // dO rows
  bf16* kst = qs + 2 * TE;                       // two K stages
  bf16* vst = qs + 4 * TE;                       // two V stages

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FA_ROWS;  // longest causal tiles first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int offset = seq_kv - seq_q;
  const int kv_end = kv_reach(min(q0 + FA_ROWS, seq_q) - 1, offset, seq_kv, causal);
  const int n_tiles = (kv_end + FA_KV - 1) / FA_KV;

  const size_t qrow0 = (size_t)bh * seq_q;
  const bf16* kp = k + (size_t)bh * seq_kv * D;
  const bf16* vp = v + (size_t)bh * seq_kv * D;
  const float* bp = kb ? kb + (size_t)(bh / heads) * seq_kv : nullptr;

  stage_bf16<D>(qs, q + qrow0 * D, q0, seq_q);
  stage_bf16<D>(dos, dout + qrow0 * D, q0, seq_q);
  if (n_tiles > 0) {
    stage_bf16<D>(kst, kp, 0, kv_end);
    stage_bf16<D>(vst, vp, 0, kv_end);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qf[FR][4], dof[FR][4];  // Q and dO A fragments of the warp's 16 query rows
  if constexpr (T::A_IN_REGS) {
#pragma unroll
    for (int s = 0; s < D / 16; ++s) {
      load_a<D>(qf[s], qs, warp, lane, s);
      load_a<D>(dof[s], dos, warp, lane, s);
    }
  }
  const int row_g = q0 + warp * 16 + g;  // this thread's query rows: row_g and row_g + 8
  float row_lse[2], row_delta[2], row_dlse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool live = row_g + 8 * r < seq_q;
    row_lse[r] = live ? lse[qrow0 + row_g + 8 * r] : 0.f;
    row_delta[r] = live ? delta[qrow0 + row_g + 8 * r] : 0.f;
    row_dlse[r] = live ? dlse[qrow0 + row_g + 8 * r] : 0.f;
  }

  float acc[DTILES][4];
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * FA_KV;
    if (j + 1 < n_tiles) {  // the next key tile flies during this tile's products
      stage_bf16<D>(kst + ((j + 1) & 1) * TE, kp, kv0 + FA_KV, kv_end);
      stage_bf16<D>(vst + ((j + 1) & 1) * TE, vp, kv0 + FA_KV, kv_end);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = kst + (j & 1) * TE;
    const bf16* vt = vst + (j & 1) * TE;

    // S = Q K^T and dP = dO V^T: 16 queries x 64 keys per warp.
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    mma_abt<D, 8, T::A_IN_REGS>(s, qf, qs, kt, warp, lane);
    mma_abt<D, 8, T::A_IN_REGS>(dp, dof, dos, vt, warp, lane);

    // P and dS on the fragments, dS packed to bf16 as the A operand.
    const bool edge = kv0 + FA_KV > seq_kv || (causal && kv0 + FA_KV - 1 > q0 + offset);
    uint32_t dsf[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = kv0 + nt * 8 + 2 * tig + e;
        const float b = (bp && col < seq_kv) ? __ldg(bp + col) : 0.f;
        float p0 = expf(s[nt][e] * sm_scale + b - row_lse[0]);      // row g
        float p1 = expf(s[nt][2 + e] * sm_scale + b - row_lse[1]);  // row g + 8
        if (edge) {
          if (col >= seq_kv || (causal && col > row_g + offset)) p0 = 0.f;
          if (col >= seq_kv || (causal && col > row_g + 8 + offset)) p1 = 0.f;
        }
        ds[e] = p0 * (dp[nt][e] - row_delta[0] + row_dlse[0]);
        ds[2 + e] = p1 * (dp[nt][2 + e] - row_delta[1] + row_dlse[1]);
      }
      dsf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      dsf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dQ += dS K, K fragments by ldmatrix.trans from the row-major tile.
    mma_ab<D, 4>(acc, dsf, kt, lane);
    __syncthreads();  // this stage is consumed before the next prefetch overwrites it
  }
  cp_async_wait<0>();

  // dQ (times sm_scale) as bf16 through the Q tile, then 16-byte stores.
  __syncthreads();
  stage_acc<D>(qs, acc, sm_scale, warp, lane);
  __syncthreads();
  store_rows<D>(dq + qrow0 * D, qs, q0, seq_q);
}

// ------------------------------------------------------------- dK and dV

template <typename T, int D>
__global__ void __launch_bounds__(Simt<D>::THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, const float* __restrict__ dlse,
                     const float* __restrict__ kb, T* __restrict__ dk, T* __restrict__ dv,
                     int heads, int seq_q, int seq_kv, int causal, float sm_scale) {
  using L = Simt<D>;
  __shared__ __align__(16) float qs[L::KT][D];
  __shared__ __align__(16) float dos[L::KT][D];
  __shared__ float lse_s[L::KT], delta_s[L::KT], dlse_s[L::KT];

  const int bh = blockIdx.y;
  const int kv0 = blockIdx.x * TILE;
  const int row = threadIdx.x / L::PARTS;
  const int part = threadIdx.x % L::PARTS;
  const int kj = kv0 + row;  // this thread's key column
  const bool live = kj < seq_kv;
  const int offset = seq_kv - seq_q;

  float kr[L::DPT], vr[L::DPT], dkacc[L::DPT], dvacc[L::DPT];
  load_row<D>(kr, k + ((size_t)bh * seq_kv + kj) * D, live, part, 1.f);
  load_row<D>(vr, v + ((size_t)bh * seq_kv + kj) * D, live, part, 1.f);
#pragma unroll
  for (int i = 0; i < L::DPT; ++i) dkacc[i] = dvacc[i] = 0.f;
  const float b = (kb && live) ? kb[(size_t)(bh / heads) * seq_kv + kj] : 0.f;

  // First query row that sees column kv0 is kv0 - offset; start at its tile.
  const int q_begin = causal ? max(0, kv0 - offset) / L::KT * L::KT : 0;
  const size_t qrow0 = (size_t)bh * seq_q;
  for (int q0 = q_begin; q0 < seq_q; q0 += L::KT) {
    __syncthreads();
    stage_tile<D>(qs, q + qrow0 * D, q0, seq_q);
    stage_tile<D>(dos, dout + qrow0 * D, q0, seq_q);
    if (threadIdx.x < L::KT) {
      const int r = q0 + threadIdx.x;
      const bool ok = r < seq_q;
      lse_s[threadIdx.x] = ok ? lse[qrow0 + r] : 0.f;
      delta_s[threadIdx.x] = ok ? delta[qrow0 + r] : 0.f;
      dlse_s[threadIdx.x] = ok ? dlse[qrow0 + r] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int i = 0; i < L::KT; ++i) {
      const float qk = row_dot<D>(kr, qs[i], part);
      const float dp = row_dot<D>(vr, dos[i], part);
      const int qi = q0 + i;
      const bool visible = live && qi < seq_q && (!causal || kj <= qi + offset);
      const float s = qk * sm_scale + b;
      const float p = visible ? expf(s - lse_s[i]) : 0.f;
      const float ds = p * (dp - delta_s[i] + dlse_s[i]);
      row_axpy<D>(dvacc, p, dos[i], part);
      row_axpy<D>(dkacc, ds, qs[i], part);
    }
  }

  if (live) {
    store_row<D>(dk + ((size_t)bh * seq_kv + kj) * D, dkacc, part, sm_scale);
    store_row<D>(dv + ((size_t)bh * seq_kv + kj) * D, dvacc, part, 1.f);
  }
}

// -------------------------------------------------------------------- dQ

template <typename T, int D>
__global__ void __launch_bounds__(Simt<D>::THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, const float* __restrict__ dlse,
                    const float* __restrict__ kb, T* __restrict__ dq, int heads, int seq_q,
                    int seq_kv, int causal, float sm_scale) {
  using L = Simt<D>;
  __shared__ __align__(16) float ks[L::KT][D];
  __shared__ __align__(16) float vs[L::KT][D];
  __shared__ float bias[L::KT];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * TILE;
  const int row = threadIdx.x / L::PARTS;
  const int part = threadIdx.x % L::PARTS;
  const int qi = q0 + row;
  const bool live = qi < seq_q;
  const int offset = seq_kv - seq_q;
  const int row_last = causal ? qi + offset : seq_kv - 1;
  const size_t r = (size_t)bh * seq_q + qi;

  float qr[L::DPT], dor[L::DPT], acc[L::DPT];
  load_row<D>(qr, q + r * D, live, part, 1.f);
  load_row<D>(dor, dout + r * D, live, part, 1.f);
#pragma unroll
  for (int i = 0; i < L::DPT; ++i) acc[i] = 0.f;
  const float row_lse = live ? lse[r] : 0.f;
  const float row_delta = live ? delta[r] : 0.f;
  const float row_dlse = live ? dlse[r] : 0.f;

  const int kv_end = kv_reach(min(q0 + TILE, seq_q) - 1, offset, seq_kv, causal);
  const T* kp = k + (size_t)bh * seq_kv * D;
  const T* vp = v + (size_t)bh * seq_kv * D;
  const float* bp = kb ? kb + (size_t)(bh / heads) * seq_kv : nullptr;

  for (int kv0 = 0; kv0 < kv_end; kv0 += L::KT) {
    __syncthreads();
    stage_tile<D>(ks, kp, kv0, kv_end);
    stage_tile<D>(vs, vp, kv0, kv_end);
    if (threadIdx.x < L::KT)
      bias[threadIdx.x] = (bp && kv0 + threadIdx.x < kv_end) ? bp[kv0 + threadIdx.x] : 0.f;
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < L::KT; ++j) {
      const float qk = row_dot<D>(qr, ks[j], part);
      const float dp = row_dot<D>(dor, vs[j], part);
      const int col = kv0 + j;
      const bool visible = live && col < kv_end && col <= row_last;
      const float s = qk * sm_scale + bias[j];
      const float p = visible ? expf(s - row_lse) : 0.f;
      const float ds = p * (dp - row_delta + row_dlse);
      row_axpy<D>(acc, ds, ks[j], part);
    }
  }

  if (live) store_row<D>(dq + r * D, acc, part, sm_scale);
}

dim3 grid_for(int rows, int bh) { return dim3((rows + TILE - 1) / TILE, bh); }

// Opts a kernel into `bytes` of dynamic shared memory past the default
// 48 KB; returns the cudaError_t.
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

bool bad_shape(int bh, int heads, int seq_q, int seq_kv) {
  return bh < 1 || bh > 65535 || heads < 1 || bh % heads || seq_q < 1 || seq_kv < 1;
}

template <int D>
int launch_fwd(int dtype, const void* q, const void* k, const void* v, const float* kb, void* o,
               float* lse, int bh, int heads, int seq_q, int seq_kv, int causal, float sm_scale,
               cudaStream_t st) {
  if (dtype == 0) {
    flash_fwd_kernel<float, D><<<grid_for(seq_q, bh), Simt<D>::THREADS, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), kb, static_cast<float*>(o), lse, heads, seq_q, seq_kv,
        causal, sm_scale);
  } else if (dtype == 1) {
    if constexpr (D == 8) {  // under the mma's k16 depth: the SIMT kernel
      flash_fwd_kernel<bf16, D><<<grid_for(seq_q, bh), Simt<D>::THREADS, 0, st>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          kb, static_cast<bf16*>(o), lse, heads, seq_q, seq_kv, causal, sm_scale);
    } else {
      constexpr int bytes = FaSmem<D>::BYTES;
      const int err = allow_smem(flash_fwd_mma_kernel<D>, bytes);
      if (err) return err;
      const dim3 grid(bh, (seq_q + FA_ROWS - 1) / FA_ROWS);
      flash_fwd_mma_kernel<D><<<grid, FA_THREADS, bytes, st>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          kb, static_cast<bf16*>(o), lse, heads, seq_q, seq_kv, causal, sm_scale);
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(int dtype, const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, const float* dlse, const float* kb,
               void* dk, void* dv, int bh, int heads, int seq_q, int seq_kv, int causal,
               float sm_scale, cudaStream_t st) {
  const dim3 grid = grid_for(seq_kv, bh);
  if (dtype == 0) {
    flash_bwd_dkv_kernel<float, D><<<grid, Simt<D>::THREADS, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta, dlse, kb,
        static_cast<float*>(dk), static_cast<float*>(dv), heads, seq_q, seq_kv, causal,
        sm_scale);
  } else if (dtype == 1) {
    if constexpr (D == 8) {  // under the mma's k16 depth: the SIMT kernel
      flash_bwd_dkv_kernel<bf16, D><<<grid, Simt<D>::THREADS, 0, st>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          static_cast<const bf16*>(dout), lse, delta, dlse, kb, static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), heads, seq_q, seq_kv, causal, sm_scale);
    } else {
      constexpr int bytes = BwdMma<D>::DKV_BYTES;
      const int err = allow_smem(flash_bwd_dkv_mma_kernel<D>, bytes);
      if (err) return err;
      const dim3 mma_grid(bh, (seq_kv + 63) / 64);
      flash_bwd_dkv_mma_kernel<D><<<mma_grid, FA_THREADS, bytes, st>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          static_cast<const bf16*>(dout), lse, delta, dlse, kb, static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), heads, seq_q, seq_kv, causal, sm_scale);
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(int dtype, const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, const float* dlse, const float* kb, void* dq,
              int bh, int heads, int seq_q, int seq_kv, int causal, float sm_scale,
              cudaStream_t st) {
  const dim3 grid = grid_for(seq_q, bh);
  if (dtype == 0) {
    flash_bwd_dq_kernel<float, D><<<grid, Simt<D>::THREADS, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta, dlse, kb,
        static_cast<float*>(dq), heads, seq_q, seq_kv, causal, sm_scale);
  } else if (dtype == 1) {
    if constexpr (D == 8) {  // under the mma's k16 depth: the SIMT kernel
      flash_bwd_dq_kernel<bf16, D><<<grid, Simt<D>::THREADS, 0, st>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          static_cast<const bf16*>(dout), lse, delta, dlse, kb, static_cast<bf16*>(dq), heads,
          seq_q, seq_kv, causal, sm_scale);
    } else {
      constexpr int bytes = BwdMma<D>::DQ_BYTES;
      const int err = allow_smem(flash_bwd_dq_mma_kernel<D>, bytes);
      if (err) return err;
      const dim3 mma_grid(bh, (seq_q + FA_ROWS - 1) / FA_ROWS);
      flash_bwd_dq_mma_kernel<D><<<mma_grid, FA_THREADS, bytes, st>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          static_cast<const bf16*>(dout), lse, delta, dlse, kb, static_cast<bf16*>(dq), heads,
          seq_q, seq_kv, causal, sm_scale);
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One case per supported head_dim; any other returns cudaErrorInvalidValue.
#define FLASH_HEAD_DIMS(d, CALL)                  \
  switch (d) {                                    \
    case 8: { constexpr int D = 8; return CALL; } \
    case 16: { constexpr int D = 16; return CALL; } \
    case 32: { constexpr int D = 32; return CALL; } \
    case 64: { constexpr int D = 64; return CALL; } \
    case 128: { constexpr int D = 128; return CALL; } \
    default: return (int)cudaErrorInvalidValue;   \
  }

// dtype: 0 = float32, 1 = bfloat16; head_dim in {8, 16, 32, 64, 128}. kb
// may be NULL (no key bias). Each entry point returns cudaGetLastError()
// after its launch (0 on success), launches on `stream` and does not
// synchronise. The tile axis is the grid's slow one in the tensor-core
// kernels, so seq_q / 64 (forward, dQ) and seq_kv / 64 (dK/dV) are bounded
// by 65535, and bh by 65535 in the SIMT kernels.
extern "C" int flash_fwd(int dtype, const void* q, const void* k, const void* v,
                         const float* kb, void* o, float* lse, int bh, int heads, int seq_q,
                         int seq_kv, int head_dim, int causal, float sm_scale, void* stream) {
  if (bad_shape(bh, heads, seq_q, seq_kv) || (seq_q + TILE - 1) / TILE > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  FLASH_HEAD_DIMS(head_dim, launch_fwd<D>(dtype, q, k, v, kb, o, lse, bh, heads, seq_q, seq_kv,
                                          causal, sm_scale, st))
}

extern "C" int flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                             const void* dout, const float* lse, const float* delta,
                             const float* dlse, const float* kb, void* dk, void* dv, int bh,
                             int heads, int seq_q, int seq_kv, int head_dim, int causal,
                             float sm_scale, void* stream) {
  if (bad_shape(bh, heads, seq_q, seq_kv) || (seq_kv + TILE - 1) / TILE > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  FLASH_HEAD_DIMS(head_dim, launch_dkv<D>(dtype, q, k, v, dout, lse, delta, dlse, kb, dk, dv, bh,
                                          heads, seq_q, seq_kv, causal, sm_scale, st))
}

extern "C" int flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                            const void* dout, const float* lse, const float* delta,
                            const float* dlse, const float* kb, void* dq, int bh, int heads,
                            int seq_q, int seq_kv, int head_dim, int causal, float sm_scale,
                            void* stream) {
  if (bad_shape(bh, heads, seq_q, seq_kv) || (seq_q + TILE - 1) / TILE > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  FLASH_HEAD_DIMS(head_dim, launch_dq<D>(dtype, q, k, v, dout, lse, delta, dlse, kb, dq, bh,
                                         heads, seq_q, seq_kv, causal, sm_scale, st))
}
