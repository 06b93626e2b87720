// Flash-decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_decode_kernel` in
// tensorflow_examples_tpu/ops/decode.py (driven by `_make_decode` and the
// public `flash_decode_attention`). The serving engine runs it for the
// causal prefill attention under ServeConfig.attention="flash", with
// q_len == length == the prompt bucket; `generate` runs it for the prompt
// and then for each new token (q_len = 1 over the populated cache).
//
// Contract (the JAX one, unchanged): q [BH, q_len, D], k/v caches
// [BH, max_len, D], all row-major and contiguous, head_dim D in
// {8, 16, 32, 64, 128}; a scalar `length`.
// Query row r sits at global position length - q_len + r and attends cache
// columns c <= its position (and c < max_len). Output [BH, q_len, D] in
// q's dtype (f32 or bf16); scores, softmax and accumulators are f32.
//
// What bounds it on an H100: a prefill does q_len^2 / 2 * D * 4
// operations on 4 * q_len * D elements, about q_len / 8 operations a byte
// in f32: past the card's f32 ridge (67 TFLOP/s over 3.35 TB/s) above a
// ~160-token prompt, so long prompts are bound by FMA throughput and
// short ones by latency. In bf16 the tensor cores move the ridge past
// every length the engine runs, so bf16 is bound by bytes and latency.
// A q_len = 1 step reads the cache once: bytes and latency.
//
// The ops.decode wrapper picks the plan from shapes alone (route, query
// rows a CTA, splits; `decode_plan`) and passes it in; this file obeys it
// and refuses a plan it does not build.
//
// Two routes, one loop shape. A CTA takes block_q query rows of one
// (batch*head) and walks cache tiles of 64 rows; the walk stops at
// min(length, the tile's last row position + 1, max_len), so nothing past
// the populated length or the causal diagonal is read, and only tiles
// that reach the diagonal or that end are masked. The query-tile index
// runs backwards on the grid, so the longest causal walks launch first.
// The online softmax starts its running max at -1e30 and masks with -inf,
// so a masked probability is exactly 0.
//
// bf16, D = 16..128 (flash_decode_mma_kernel): FlashAttention-2 on
// mma.sync.m16n8k16 with f32 accumulators, the design of
// flash_attention.cu's flash_fwd_mma_kernel. 16 query rows a warp and 1,
// 2 or 4 warps (block_q 16, 32, 64: a short prompt does not pay for 64
// rows). Q is copied once and kept as ldmatrix A fragments (re-read from
// shared memory each step at D = 128, to stay within 255 registers); K
// and V tiles stay bf16 in shared memory, rows padded by 16 bytes
// (ldmatrix without bank conflicts), double-buffered by cp.async; V
// reaches P V through ldmatrix.trans. P is rounded to bf16 for P V, as the plain version
// casts the probabilities to the cache dtype (unnormalised here; l sums
// the f32 p). D = 8 is under the mma's k16 depth and takes the SIMT route.
//
// f32 (and bf16 at D = 8), register-tiled SIMT (flash_decode_simt_kernel):
// no TF32, which keeps ~3 decimal digits and would break token parity
// with the f32 reference. 256 threads; Q and double-buffered K and V
// tiles reach shared memory as f32 by cp.async (bf16 converts on the
// way in). Scores: a 16 x 16 thread grid, each thread a micro-tile of
// block_q / 16 query rows x 4 key columns (columns c, c + 16, c + 32,
// c + 48), read as float4 along D from padded rows, so one shared load
// feeds 4 (block_q 16) or 16 (block_q 64) FMAs. The row max and sum are
// reduced over the row's 16 threads with four shuffles once a tile; each
// thread keeps its own partial of l, summed once at the end. P goes to
// shared memory transposed, and P V is a second micro-tile: each thread
// owns RO rows x CO output dims (4 x 4 at D = 64), one float4 of P and
// one of V per key feeding 16 FMAs. block_q is 16 for q_len <= 16 at
// D >= 32, else 64.
//
// Split KV. When the grid of (query tiles x B*H) is below two waves of
// 132 SMs, the plan gives `splits` > 1 (on the tensor cores only for a
// single query tile a head, at least two KV tiles a split: there a tile
// costs little next to the merge): each CTA (grid z) takes a
// contiguous, near-equal share of its query tile's KV tiles and writes its
// unnormalised (acc, m, l) in f32 to scratch the wrapper allocates; a
// second kernel (common.cuh merge_splits) combines the splits in order. A
// split with no tile writes (0, -1e30, 0) and weighs exactly 0. No
// atomics: a rerun gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -1e30f;  // ops/attention.py NEG_INF
constexpr int KV_TILE = 64;        // cache rows a tile, both routes

// Where a CTA's rows go: the output (splits == 1) or its split's partial.
struct Partials {
  float* acc;  // [splits][rows][D], unnormalised
  float* m;    // [splits][rows]
  float* l;    // [splits][rows]
};

// Cache columns [0, kv_end) that rows [q0, last] may see, and the KV
// tiles [t0, t1) of split `split` of `splits` over them.
__device__ __forceinline__ void walk(int q_len, int max_len, int length, int last, int split,
                                     int splits, int& kv_end, int& t0, int& t1) {
  kv_end = max(0, min(length - q_len + last + 1, max_len));
  const int n = (kv_end + KV_TILE - 1) / KV_TILE;
  t0 = (int)((int64_t)n * split / splits);
  t1 = (int)((int64_t)n * (split + 1) / splits);
}

// ------------------------------------------------ bf16 on the tensor cores

template <int D>
struct MmaSmem {
  static constexpr int LD = D + 8;  // padded bf16 row: 16 bytes of slack
  static constexpr int TILE = KV_TILE * LD;
};

// Rows [row0, row0 + ROWS) of a [rows, D] bf16 matrix into a padded shared
// tile by cp.async; rows at or past `end` are zero-filled.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void stage_bf16(bf16* dst, const bf16* src, int row0, int end) {
  constexpr int PER_ROW = D / 8;  // 16-byte chunks in a row
  static_assert(ROWS * PER_ROW % THREADS == 0, "whole chunks per thread");
#pragma unroll 8
  for (int t = 0; t < ROWS * PER_ROW / THREADS; ++t) {
    const int c = threadIdx.x + t * THREADS;
    const int r = c / PER_ROW, col = (c % PER_ROW) * 8;
    const bool in = row0 + r < end;
    cp_async16(smem_u32(dst + r * MmaSmem<D>::LD + col),
               in ? src + (size_t)(row0 + r) * D + col : src, in);
  }
}

template <int D, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
flash_decode_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o, Partials part,
                        int q_len, int max_len, int length, float sm_scale) {
  static_assert(D % 16 == 0 && D >= 16 && D <= 128, "the mma route takes D = 16..128");
  constexpr int THREADS = 32 * WARPS;
  constexpr int BQ = 16 * WARPS;
  constexpr int LD = MmaSmem<D>::LD;
  constexpr int TE = MmaSmem<D>::TILE;
  constexpr int KSTEPS = D / 16;  // k16 steps of Q K^T
  constexpr int DTILES = D / 8;   // n8 tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* kst = qs + BQ * LD;                      // two K stages
  bf16* vst = kst + 2 * TE;                      // two V stages

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int split = blockIdx.z, splits = gridDim.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int shift = length - q_len;  // row r sits at position r + shift
  int kv_end, t0, t1;
  walk(q_len, max_len, length, min(q0 + BQ, q_len) - 1, split, splits, kv_end, t0, t1);

  const bf16* qp = q + (size_t)bh * q_len * D;
  const bf16* kp = k + (size_t)bh * max_len * D;
  const bf16* vp = v + (size_t)bh * max_len * D;

  stage_bf16<D, BQ, THREADS>(qs, qp, q0, q_len);
  if (t0 < t1) {
    stage_bf16<D, KV_TILE, THREADS>(kst, kp, t0 * KV_TILE, kv_end);
    stage_bf16<D, KV_TILE, THREADS>(vst, vp, t0 * KV_TILE, kv_end);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // Q A fragments, kept in registers up to D = 64; at D = 128 they are
  // re-read from the Q tile each step, to stay within 255 registers.
  constexpr bool Q_IN_REGS = D <= 64;
  const uint32_t q_addr = smem_u32(qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8);
  uint32_t qf[Q_IN_REGS ? KSTEPS : 1][4];
  if constexpr (Q_IN_REGS) {
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) ldmatrix_x4(qf[ks], q_addr + ks * 32);
  }

  float acc[DTILES][4];
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // rows g and g + 8 (thread-partial l)
  const int row_g = q0 + warp * 16 + g;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: which matrix, which row of it

  for (int t = t0; t < t1; ++t) {
    const int j = t - t0, kv0 = t * KV_TILE;
    if (t + 1 < t1) {  // the next tile flies during this tile's products
      stage_bf16<D, KV_TILE, THREADS>(kst + ((j + 1) & 1) * TE, kp, kv0 + KV_TILE, kv_end);
      stage_bf16<D, KV_TILE, THREADS>(vst + ((j + 1) & 1) * TE, vp, kv0 + KV_TILE, kv_end);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = kst + (j & 1) * TE;
    const bf16* vt = vst + (j & 1) * TE;

    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      uint32_t a[4];
      if constexpr (Q_IN_REGS) {
        a[0] = qf[ks][0], a[1] = qf[ks][1], a[2] = qf[ks][2], a[3] = qf[ks][3];
      } else {
        ldmatrix_x4(a, q_addr + ks * 32);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, smem_u32(kt + (np * 16 + mr + (mi >> 1) * 8) * LD + ks * 16 + (mi & 1) * 8));
        mma_bf16(s[2 * np], a, b[0], b[1]);
        mma_bf16(s[2 * np + 1], a, b[2], b[3]);
      }
    }

    // Scale in f32; mask where the tile passes the walk's end or the
    // first row's position.
    const bool edge = kv0 + KV_TILE > kv_end || kv0 + KV_TILE - 1 > q0 + shift;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = kv0 + nt * 8 + 2 * tig + e;
        float x0 = s[nt][e] * sm_scale;      // row g
        float x1 = s[nt][2 + e] * sm_scale;  // row g + 8
        if (edge) {
          if (col >= kv_end || col > row_g + shift) x0 = -INFINITY;
          if (col >= kv_end || col > row_g + 8 + shift) x1 = -INFINITY;
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

  if (part.acc != nullptr) {  // this split's unnormalised rows, f32
    const int64_t rows = (int64_t)gridDim.x * q_len;
    const int64_t base = (int64_t)split * rows + (int64_t)bh * q_len;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_g + 8 * r;
      if (row < q_len) {
        if (tig == 0) {
          part.m[base + row] = m[r];
          part.l[base + row] = l[r];
        }
        float* dst = part.acc + (base + row) * D + 2 * tig;
#pragma unroll
        for (int dt = 0; dt < DTILES; ++dt)
          *reinterpret_cast<float2*>(dst + dt * 8) =
              make_float2(acc[dt][2 * r], acc[dt][2 * r + 1]);
      }
    }
    return;
  }

  // O as bf16 through the (now free) Q tile, then 16-byte stores.
  const float inv0 = 1.f / fmaxf(l[0], 1e-30f), inv1 = 1.f / fmaxf(l[1], 1e-30f);
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
  constexpr int PER_ROW = D / 8;
  bf16* op = o + (size_t)bh * q_len * D;
#pragma unroll
  for (int t = 0; t < BQ * PER_ROW / THREADS; ++t) {
    const int c = tid + t * THREADS;
    const int r = c / PER_ROW, col = (c % PER_ROW) * 8;
    if (q0 + r < q_len)
      *reinterpret_cast<uint4*>(op + (size_t)(q0 + r) * D + col) =
          *reinterpret_cast<const uint4*>(qs + r * LD + col);
  }
}

// --------------------------------------------- register-tiled SIMT (f32)

// Layout of the SIMT route for head_dim D and BQ query rows a CTA.
template <int D, int BQ>
struct Simt {
  static_assert(D == 8 || D == 16 || D == 32 || D == 64 || D == 128, "unsupported head_dim");
  static_assert(BQ == 64 || (BQ == 16 && D >= 32), "block_q 64, or 16 at D >= 32");
  static constexpr int THREADS = 256;
  static constexpr int RS = BQ / 16;          // score rows a thread (16 x 16 thread grid)
  static constexpr int LD = D + 4;            // padded f32 row: float4-aligned, conflict-free
  static constexpr int LDP = BQ + 4;          // a row of P^T
  static constexpr int CO = D <= 32 ? 2 : D / 16;  // output dims a thread
  static constexpr int TCO = D / CO;          // threads along D
  static constexpr int RO = BQ * TCO / THREADS;    // output rows a thread
  static_assert(RO >= 1 && RO * (THREADS / TCO) == BQ, "whole output rows per thread");
  static constexpr int FLOATS = BQ * LD + 4 * KV_TILE * LD + KV_TILE * LDP + 3 * BQ;
  static constexpr int BYTES = FLOATS * 4;
  static constexpr int MIN_BLOCKS = BYTES <= 110 * 1024 ? 2 : 1;  // CTAs an SM holds
};

__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Rows [row0, row0 + ROWS) of a [rows, D] matrix into a padded f32 shared
// tile; rows at or past `end` are zero-filled. f32 goes by cp.async;
// bf16 is widened on the way (a plain load and store).
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void stage_f32(float* dst, const float* src, int row0, int end) {
  constexpr int PER_ROW = D / 4;
  for (int c = threadIdx.x; c < ROWS * PER_ROW; c += THREADS) {
    const int r = c / PER_ROW, col = (c % PER_ROW) * 4;
    const bool in = row0 + r < end;
    cp_async16(smem_u32(dst + r * (D + 4) + col), in ? src + (size_t)(row0 + r) * D + col : src,
               in);
  }
}

template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void stage_f32(float* dst, const bf16* src, int row0, int end) {
  constexpr int PER_ROW = D / 4;
  for (int c = threadIdx.x; c < ROWS * PER_ROW; c += THREADS) {
    const int r = c / PER_ROW, col = (c % PER_ROW) * 4;
    const float4 x = row0 + r < end ? load4(src + (size_t)(row0 + r) * D + col)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * (D + 4) + col) = x;
  }
}

// N consecutive floats of shared memory into registers (N = 1, 2, 4, 8).
template <int N>
__device__ __forceinline__ void lds(float (&r)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      r[i] = x.x, r[i + 1] = x.y, r[i + 2] = x.z, r[i + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    r[0] = x.x, r[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = p[i];
  }
}

template <int N>
__device__ __forceinline__ void store_row(float* p, const float (&x)[N], float scale) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(x[i] * scale, x[i + 1] * scale, x[i + 2] * scale, x[i + 3] * scale);
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 2)
      *reinterpret_cast<float2*>(p + i) = make_float2(x[i] * scale, x[i + 1] * scale);
  }
}

template <int N>
__device__ __forceinline__ void store_row(bf16* p, const float (&x)[N], float scale) {
#pragma unroll
  for (int i = 0; i < N; i += 2)
    *reinterpret_cast<__nv_bfloat162*>(p + i) = __floats2bfloat162_rn(x[i] * scale,
                                                                      x[i + 1] * scale);
}

template <typename T, int D, int BQ>
__global__ void __launch_bounds__(256, (Simt<D, BQ>::MIN_BLOCKS))
flash_decode_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o, Partials part, int q_len,
                         int max_len, int length, float sm_scale) {
  using L = Simt<D, BQ>;
  constexpr int LD = L::LD, LDP = L::LDP, RS = L::RS, RO = L::RO, CO = L::CO;
  constexpr int TE = KV_TILE * LD;
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                 // [BQ][LD]
  float* kst = qs + BQ * LD;       // two K stages [KV_TILE][LD]
  float* vst = kst + 2 * TE;       // two V stages
  float* pt = vst + 2 * TE;        // P^T [KV_TILE][LDP]
  float* alpha_s = pt + KV_TILE * LDP;  // [BQ]: this tile's rescale of each row
  float* m_s = alpha_s + BQ;       // [BQ]: final running max
  float* l_s = m_s + BQ;           // [BQ]: final sum

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int split = blockIdx.z, splits = gridDim.z;
  const int tid = threadIdx.x;
  const int shift = length - q_len;
  int kv_end, t0, t1;
  walk(q_len, max_len, length, min(q0 + BQ, q_len) - 1, split, splits, kv_end, t0, t1);

  const T* qp = q + (size_t)bh * q_len * D;
  const T* kp = k + (size_t)bh * max_len * D;
  const T* vp = v + (size_t)bh * max_len * D;
  stage_f32<D, BQ, L::THREADS>(qs, qp, q0, q_len);
  if (t0 < t1) {
    stage_f32<D, KV_TILE, L::THREADS>(kst, kp, t0 * KV_TILE, kv_end);
    stage_f32<D, KV_TILE, L::THREADS>(vst, vp, t0 * KV_TILE, kv_end);
  }
  cp_async_commit();

  // Scores: thread (tr, tc) holds rows tr * RS + r and keys tc + 16 c.
  const int tr = tid >> 4, tc = tid & 15;
  // P V: thread holds rows orow + r and dims ocol + c.
  const int orow = (tid / L::TCO) * RO, ocol = (tid % L::TCO) * CO;
  float m[RS], lp[RS];  // running max, this thread's part of the sum
#pragma unroll
  for (int r = 0; r < RS; ++r) m[r] = NEG_INF, lp[r] = 0.f;
  float acc[RO][CO];
#pragma unroll
  for (int r = 0; r < RO; ++r)
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[r][c] = 0.f;

  for (int t = t0; t < t1; ++t) {
    const int j = t - t0, kv0 = t * KV_TILE;
    if (t + 1 < t1) {
      stage_f32<D, KV_TILE, L::THREADS>(kst + ((j + 1) & 1) * TE, kp, kv0 + KV_TILE, kv_end);
      stage_f32<D, KV_TILE, L::THREADS>(vst + ((j + 1) & 1) * TE, vp, kv0 + KV_TILE, kv_end);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* kt = kst + (j & 1) * TE;
    const float* vt = vst + (j & 1) * TE;

    float s[RS][4];
#pragma unroll
    for (int r = 0; r < RS; ++r) s[r][0] = s[r][1] = s[r][2] = s[r][3] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 kk[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kk[c] = *reinterpret_cast<const float4*>(kt + (tc + 16 * c) * LD + d);
#pragma unroll
      for (int r = 0; r < RS; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(qs + (tr * RS + r) * LD + d);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(qq.x, kk[c].x, s[r][c]);
          s[r][c] = fmaf(qq.y, kk[c].y, s[r][c]);
          s[r][c] = fmaf(qq.z, kk[c].z, s[r][c]);
          s[r][c] = fmaf(qq.w, kk[c].w, s[r][c]);
        }
      }
    }

    const bool edge = kv0 + KV_TILE > kv_end || kv0 + KV_TILE - 1 > q0 + shift;
#pragma unroll
    for (int r = 0; r < RS; ++r) {
      const int pos = q0 + tr * RS + r + shift;
      float mx = m[r];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = kv0 + tc + 16 * c;
        float x = s[r][c] * sm_scale;
        if (edge && (col >= kv_end || col > pos)) x = -INFINITY;
        s[r][c] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = expf(m[r] - mx);
      m[r] = mx;
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(s[r][c] - mx);
        ps += s[r][c];
      }
      lp[r] = lp[r] * alpha + ps;
      if (tc == 0) alpha_s[tr * RS + r] = alpha;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float* dst = pt + (tc + 16 * c) * LDP + tr * RS;
      if constexpr (RS == 4) {
        *reinterpret_cast<float4*>(dst) = make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
      } else {
#pragma unroll
        for (int r = 0; r < RS; ++r) dst[r] = s[r][c];
      }
    }
    __syncthreads();

    float a[RO];
    lds(a, alpha_s + orow);
#pragma unroll
    for (int r = 0; r < RO; ++r)
#pragma unroll
      for (int c = 0; c < CO; ++c) acc[r][c] *= a[r];
#pragma unroll 8
    for (int key = 0; key < KV_TILE; ++key) {
      float p[RO], vv[CO];
      lds(p, pt + key * LDP + orow);
      lds(vv, vt + key * LD + ocol);
#pragma unroll
      for (int r = 0; r < RO; ++r)
#pragma unroll
        for (int c = 0; c < CO; ++c) acc[r][c] = fmaf(p[r], vv[c], acc[r][c]);
    }
    __syncthreads();  // P^T and this stage are consumed before they are overwritten
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < RS; ++r) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) lp[r] += __shfl_xor_sync(0xffffffffu, lp[r], off);
    if (tc == 0) {
      m_s[tr * RS + r] = m[r];
      l_s[tr * RS + r] = lp[r];
    }
  }
  __syncthreads();

  if (part.acc != nullptr) {  // this split's unnormalised rows, f32
    const int64_t rows = (int64_t)gridDim.x * q_len;
    const int64_t base = (int64_t)split * rows + (int64_t)bh * q_len;
    if (tid < BQ && q0 + tid < q_len) {
      part.m[base + q0 + tid] = m_s[tid];
      part.l[base + q0 + tid] = l_s[tid];
    }
#pragma unroll
    for (int r = 0; r < RO; ++r)
      if (q0 + orow + r < q_len)
        store_row(part.acc + (base + q0 + orow + r) * D + ocol, acc[r], 1.f);
    return;
  }
#pragma unroll
  for (int r = 0; r < RO; ++r)
    if (q0 + orow + r < q_len)
      store_row(o + ((size_t)bh * q_len + q0 + orow + r) * D + ocol, acc[r],
                1.f / fmaxf(l_s[orow + r], 1e-30f));
}

// ------------------------------------------------------------- launches

// Opts a kernel into `bytes` of dynamic shared memory past the default
// 48 KB; returns the cudaError_t.
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int D, int BQ>
int launch_simt(const void* q, const void* k, const void* v, void* o, Partials part, int bh,
                int q_len, int max_len, int length, int splits, float sm_scale, cudaStream_t st) {
  constexpr int bytes = Simt<D, BQ>::BYTES;
  auto kernel = flash_decode_simt_kernel<T, D, BQ>;
  const int err = allow_smem(kernel, bytes);
  if (err) return err;
  const dim3 grid(bh, (q_len + BQ - 1) / BQ, splits);
  kernel<<<grid, Simt<D, BQ>::THREADS, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), part, q_len, max_len, length, sm_scale);
  return (int)cudaGetLastError();
}

template <int D, int WARPS>
int launch_mma(const void* q, const void* k, const void* v, void* o, Partials part, int bh,
               int q_len, int max_len, int length, int splits, float sm_scale, cudaStream_t st) {
  constexpr int bytes = (16 * WARPS + 4 * KV_TILE) * MmaSmem<D>::LD * (int)sizeof(bf16);
  auto kernel = flash_decode_mma_kernel<D, WARPS>;
  const int err = allow_smem(kernel, bytes);
  if (err) return err;
  const dim3 grid(bh, (q_len + 16 * WARPS - 1) / (16 * WARPS), splits);
  kernel<<<grid, 32 * WARPS, bytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), part, q_len, max_len, length, sm_scale);
  return (int)cudaGetLastError();
}

// The attention kernel the plan names; cudaErrorInvalidValue for a plan
// this file does not build.
template <int D>
int attend(int dtype, const void* q, const void* k, const void* v, void* o, Partials part,
           int bh, int q_len, int max_len, int length, int block_q, int splits, float sm_scale,
           cudaStream_t st) {
#define TET_ARGS q, k, v, o, part, bh, q_len, max_len, length, splits, sm_scale, st
  if constexpr (D >= 16) {
    if (dtype == 1) {
      switch (block_q) {
        case 16: return launch_mma<D, 1>(TET_ARGS);
        case 32: return launch_mma<D, 2>(TET_ARGS);
        case 64: return launch_mma<D, 4>(TET_ARGS);
        default: return (int)cudaErrorInvalidValue;
      }
    }
  }
  if (dtype == 0) {
    if (block_q == 64) return launch_simt<float, D, 64>(TET_ARGS);
    if constexpr (D >= 32) {
      if (block_q == 16) return launch_simt<float, D, 16>(TET_ARGS);
    }
    return (int)cudaErrorInvalidValue;
  }
  if constexpr (D == 8) {
    if (dtype == 1 && block_q == 64) return launch_simt<bf16, D, 64>(TET_ARGS);
  }
#undef TET_ARGS
  return (int)cudaErrorInvalidValue;
}

// The attention launch, then the merge when the plan splits.
template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o, Partials part,
           int bh, int q_len, int max_len, int length, int block_q, int splits, float sm_scale,
           cudaStream_t st) {
  const int err = attend<D>(dtype, q, k, v, o, part, bh, q_len, max_len, length, block_q,
                            splits, sm_scale, st);
  if (err || splits == 1) return err;
  const int rows = bh * q_len;
  if (dtype == 0)
    return merge_splits<float, D>(part.acc, part.m, part.l, static_cast<float*>(o), rows,
                                  splits, st);
  return merge_splits<bf16, D>(part.acc, part.m, part.l, static_cast<bf16*>(o), rows, splits,
                               st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim in {8, 16, 32, 64, 128}.
// block_q and splits are the plan of ops/decode.py `decode_plan`: bf16 at
// D >= 16 takes the tensor cores with block_q 16, 32 or 64; otherwise
// SIMT with block_q 64, or 16 at D >= 32. splits > 1 needs the partial
// buffers (acc [splits][bh * q_len][D], m and l [splits][bh * q_len],
// f32) and launches the merge after the attention kernel; splits == 1
// takes null buffers. Returns cudaGetLastError() after the launches (0 on
// success), or cudaErrorInvalidValue for what it does not take. Launches
// on `stream`; does not synchronise.
extern "C" int flash_decode(int dtype, const void* q, const void* k, const void* v, void* o,
                            float* part_acc, float* part_m, float* part_l, int bh, int q_len,
                            int max_len, int length, int head_dim, int block_q, int splits,
                            float sm_scale, void* stream) {
  if (bh < 1 || q_len < 1 || max_len < 1 || block_q < 1 || splits < 1 || splits > 65535 ||
      (q_len + block_q - 1) / block_q > 65535 || (int64_t)bh * q_len > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if ((splits > 1) != (part_acc != nullptr && part_m != nullptr && part_l != nullptr))
    return (int)cudaErrorInvalidValue;
  const Partials part{splits > 1 ? part_acc : nullptr, part_m, part_l};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define TET_HEAD_DIM(D)                                                                        \
  case D:                                                                                      \
    return launch<D>(dtype, q, k, v, o, part, bh, q_len, max_len, length, block_q, splits,     \
                     sm_scale, st)
  switch (head_dim) {
    TET_HEAD_DIM(8);
    TET_HEAD_DIM(16);
    TET_HEAD_DIM(32);
    TET_HEAD_DIM(64);
    TET_HEAD_DIM(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TET_HEAD_DIM
}
