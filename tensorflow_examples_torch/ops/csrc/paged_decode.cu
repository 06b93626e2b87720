// Fused paged-decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_paged_decode_kernel` in
// tensorflow_examples_tpu/ops/paged_decode.py (driven by
// `_make_paged_decode` and the public `paged_decode_attention`). The
// serving engine runs it for every layer of every decode step under
// ServeConfig.attention="paged_flash", including the int8 KV pool, whose
// rows it dequantizes in the kernel.
//
// Contract: q [S, H, D] (f32 or bf16), one query per slot, head_dim D in
// {8, 16, 32, 64, 128}; K/V block pools [NB, H, BS, D] (f32, bf16 or
// int8), with per-row f32 scales [NB, H, BS] for int8; lengths [S] int32
// (populated length including the new token); block_tables [S, nb] int32
// (logical -> physical block). Slot s attends columns
// < min(lengths[s], nb * BS) and reads nothing past them. A slot of
// length 0 writes zeros. A table entry outside [0, NB) that the slot
// reads traps. Output [S, H, D] in q's dtype.
//
// What bounds it on an H100: bytes. Each K/V element is used for two
// multiply-adds, so a decode step is far below the card's ridge; the least
// time is the populated K/V bytes over 3.35 TB/s. With one query per slot
// there is no reuse, so the design moves every populated byte once,
// straight from the pool through the block table, with enough of it in
// flight to approach the memory rate; int8 pools are read at one byte an
// element and widened in registers.
//
// Design. Grid (head, slot, split): split z takes the slot's logical
// blocks [z * bps, (z + 1) * bps), bps = blocks_per_split (128 rows'
// worth; ops/paged_decode.py `paged_plan` picks bps and the split count
// from the block size and the table width nb, never from the lengths,
// which live on the device). A split that starts past the slot's length
// writes an empty partial and stops. A CTA of 4 warps first reads its
// split's table entries into shared memory. Each lane then holds 16 bytes
// of a row (4 f32, 8 bf16 or 16 int8 elements; 8 int8 at D = 8), so LPR =
// D / that many lanes hold a row and a warp reads 32 / LPR rows with one
// load instruction each for K and V; neighbouring lane groups take
// neighbouring rows, so a warp's loads are contiguous within a block.
// Each lane group keeps its own online softmax (m, l, acc in registers)
// over rows g, g + G, g + 2G, ... (G groups in the CTA), and loads UNROLL
// rows' K and V before it scores them, so 2 * UNROLL 16-byte loads a
// lane are in flight at once; they are kept as raw bits and widened to
// f32 only when used, so an int8 row costs the registers of an f32 one.
// A score is the lane slice's dot with the query slice, reduced over the
// LPR lanes by shuffles; int8 scales the dot by the row's scale, read
// once per row, and folds the V scale into the probability. There is no
// block barrier in the loop. At the end the groups of a warp merge by a
// shuffle butterfly, the four warps through shared memory in a fixed
// order, and the CTA writes the output (one split) or its split's
// unnormalised (acc, m, l) for the merge kernel (common.cuh
// merge_splits), which combines the splits in order. A length-0 slot
// comes out as exact zeros either way. No atomics: a rerun gives the
// same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 128;        // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;           // rows a lane group loads before it scores them
constexpr int MAX_BS = 64;          // largest block size taken
constexpr int MAX_SPLIT_BLOCKS = 128;  // largest blocks_per_split (128 rows at BS = 1)
constexpr float NEG_INF = -1e30f;   // ops/attention.py NEG_INF

// How the lanes of a warp hold rows of type KVT at head_dim D.
template <typename KVT, int D>
struct Lanes {
  static_assert(D == 8 || D == 16 || D == 32 || D == 64 || D == 128, "unsupported head_dim");
  static constexpr int VEC = (int)(16 / sizeof(KVT)) < D ? (int)(16 / sizeof(KVT)) : D;
  static constexpr int LPR = D / VEC;        // lanes a row
  static constexpr int RPW = 32 / LPR;       // rows a warp reads at once
  static constexpr int GROUPS = WARPS * RPW; // lane groups in the CTA
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// A lane's slice of a row, VEC elements, as raw bits (16 bytes; 8 for
// int8 at D = 8): loads keep the raw bits, so UNROLL rows in flight cost
// 4 registers each whatever the element type, and widen when used.
template <typename KVT, int VEC>
__device__ __forceinline__ uint4 load_raw(const KVT* p) {
  if constexpr (VEC * sizeof(KVT) == 16) return *reinterpret_cast<const uint4*>(p);
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_uint4(u.x, u.y, 0u, 0u);
}

template <int VEC>
__device__ __forceinline__ void widen(float (&x)[VEC], uint4 u, float) {
  static_assert(VEC == 4, "f32 rows go as 16 bytes");
  x[0] = __uint_as_float(u.x), x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z), x[3] = __uint_as_float(u.w);
}

// bf16 to f32 is exact: the bf16 bits are the f32's top half.
template <int VEC>
__device__ __forceinline__ void widen(float (&x)[VEC], uint4 u, bf16) {
  static_assert(VEC == 8, "bf16 rows go as 16 bytes");
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Each byte sign-extended by shifting it to the top and back.
template <int VEC>
__device__ __forceinline__ void widen(float (&x)[VEC], uint4 u, int8_t) {
  static_assert(VEC == 8 || VEC == 16, "int8 rows go as 8 or 16 bytes");
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < VEC; ++i) x[i] = (float)((int32_t)(w[i / 4] << (24 - 8 * (i % 4))) >> 24);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(bf16* p, float x) { *p = __float2bfloat16(x); }

template <typename QT, typename KVT, int D>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const QT* __restrict__ q, const KVT* __restrict__ kb,
                    const KVT* __restrict__ vb, const float* __restrict__ ksc,
                    const float* __restrict__ vsc, const int* __restrict__ lengths,
                    const int* __restrict__ tables, QT* __restrict__ o,
                    float* __restrict__ part_acc, float* __restrict__ part_m,
                    float* __restrict__ part_l, int num_heads, int num_blocks, int block_size,
                    int nb, int blocks_per_split, float sm_scale) {
  using L = Lanes<KVT, D>;
  constexpr int VEC = L::VEC, LPR = L::LPR, G = L::GROUPS;
  constexpr bool QUANT = sizeof(KVT) == 1;
  __shared__ int tbl[MAX_SPLIT_BLOCKS];
  __shared__ float wm[WARPS], wl[WARPS];
  __shared__ __align__(16) float wacc[WARPS][D];

  const int h = blockIdx.x, s = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sub = lane % LPR;             // which slice of the row
  const int grp = warp * L::RPW + lane / LPR;  // which lane group
  const int64_t out_row = (int64_t)s * num_heads + h;

  // Rows [row0, row0 + n) of the slot, in this split's blocks.
  const int length = min(lengths[s], nb * block_size);
  const int row0 = split * blocks_per_split * block_size;
  const int n = min(length - row0, blocks_per_split * block_size);
  const int nblk = n > 0 ? (n + block_size - 1) / block_size : 0;
  const int* table = tables + (int64_t)s * nb + split * blocks_per_split;
  for (int i = tid; i < nblk; i += THREADS) {
    const int b = table[i];
    if (b < 0 || b >= num_blocks) __trap();  // a corrupt table is a fault
    tbl[i] = b;
  }

  float qv[VEC];
  {
    const QT* qp = q + out_row * D + sub * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e) qv[e] = to_f32(qp[e]);
  }
  __syncthreads();

  float m = NEG_INF, l = 0.f, acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;

  // The same trip count on every lane: the shuffles below take the whole warp.
  for (int base = grp; base - grp < n; base += G * UNROLL) {
    uint4 kr[UNROLL], vr[UNROLL];
    float ks[UNROLL], vs[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {  // every load of the batch first
      const int r = base + u * G;
      if (r < n) {
        const int64_t at = ((int64_t)tbl[r / block_size] * num_heads + h) * block_size +
                           r % block_size;
        kr[u] = load_raw<KVT, VEC>(kb + at * D + sub * VEC);
        vr[u] = load_raw<KVT, VEC>(vb + at * D + sub * VEC);
        if constexpr (QUANT) {
          ks[u] = ksc[at];
          vs[u] = vsc[at];
        }
      }
    }
    float sc[UNROLL];
    float mx = m;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float kx[VEC];
      widen<VEC>(kx, kr[u], KVT());
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) dot = fmaf(qv[e], kx[e], dot);
#pragma unroll
      for (int off = 1; off < LPR; off <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if constexpr (QUANT) dot *= ks[u];
      sc[u] = base + u * G < n ? dot * sm_scale : -INFINITY;
      mx = fmaxf(mx, sc[u]);
    }
    const float alpha = expf(m - mx);
    m = mx;
    l *= alpha;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] *= alpha;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const float p = expf(sc[u] - mx);
      l += p;
      if (base + u * G < n) {
        const float pv = QUANT ? p * vs[u] : p;
        float vx[VEC];
        widen<VEC>(vx, vr[u], KVT());
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = fmaf(pv, vx[e], acc[e]);
      }
    }
  }

  // The warp's lane groups, by a butterfly over the lane bits above LPR.
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float lo = __shfl_xor_sync(0xffffffffu, l, off);
    const float mn = fmaxf(m, mo);
    const float a = expf(m - mn), b = expf(mo - mn);
    l = l * a + lo * b;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      acc[e] = acc[e] * a + __shfl_xor_sync(0xffffffffu, acc[e], off) * b;
    m = mn;
  }
  if (lane < LPR) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) wacc[warp][sub * VEC + e] = acc[e];
    if (lane == 0) wm[warp] = m, wl[warp] = l;
  }
  __syncthreads();

  // The four warps in order; thread d < D writes dim d.
  for (int d = tid; d < D; d += THREADS) {
    float mx = wm[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, wm[w]);
    float sum = 0.f, out = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float a = expf(wm[w] - mx);
      sum += wl[w] * a;
      out += wacc[w][d] * a;
    }
    if (part_acc != nullptr) {
      const int64_t at = (int64_t)split * gridDim.y * num_heads + out_row;
      part_acc[at * D + d] = out;
      if (d == 0) part_m[at] = mx, part_l[at] = sum;
    } else {
      store1(o + out_row * D + d, out / fmaxf(sum, 1e-30f));
    }
  }
}

template <typename QT, typename KVT, int D>
int launch(const void* q, const void* kb, const void* vb, const void* ksc, const void* vsc,
           const void* lengths, const void* tables, void* o, float* part_acc, float* part_m,
           float* part_l, int num_slots, int num_heads, int num_blocks, int block_size, int nb,
           int blocks_per_split, int splits, float sm_scale, cudaStream_t st) {
  const dim3 grid(num_heads, num_slots, splits);
  paged_decode_kernel<QT, KVT, D><<<grid, THREADS, 0, st>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(kb), static_cast<const KVT*>(vb),
      static_cast<const float*>(ksc), static_cast<const float*>(vsc),
      static_cast<const int*>(lengths), static_cast<const int*>(tables), static_cast<QT*>(o),
      part_acc, part_m, part_l, num_heads, num_blocks, block_size, nb, blocks_per_split,
      sm_scale);
  int err = (int)cudaGetLastError();
  if (err || splits == 1) return err;
  return merge_splits<QT, D>(part_acc, part_m, part_l, static_cast<QT*>(o),
                             num_slots * num_heads, splits, st);
}

template <int D>
int launch_dtypes(int q_dtype, int kv_dtype, const void* q, const void* kb, const void* vb,
                  const void* k_scale, const void* v_scale, const void* lengths,
                  const void* tables, void* o, float* part_acc, float* part_m, float* part_l,
                  int num_slots, int num_heads, int num_blocks, int block_size, int nb,
                  int blocks_per_split, int splits, float sm_scale, cudaStream_t st) {
#define TET_LAUNCH(QT, KVT)                                                                  \
  return launch<QT, KVT, D>(q, kb, vb, k_scale, v_scale, lengths, tables, o, part_acc,       \
                            part_m, part_l, num_slots, num_heads, num_blocks, block_size, nb, \
                            blocks_per_split, splits, sm_scale, st)
  if (q_dtype == 0 && kv_dtype == 0) TET_LAUNCH(float, float);
  if (q_dtype == 1 && kv_dtype == 1) TET_LAUNCH(bf16, bf16);
  if (q_dtype == 0 && kv_dtype == 2) TET_LAUNCH(float, int8_t);
  if (q_dtype == 1 && kv_dtype == 2) TET_LAUNCH(bf16, int8_t);
#undef TET_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16. kv_dtype: 0 = float32, 1 = bfloat16,
// 2 = int8 (k_scale / v_scale then required, else null). head_dim in
// {8, 16, 32, 64, 128}. blocks_per_split and splits are the plan of
// ops/paged_decode.py `paged_plan` (splits * blocks_per_split >= nb);
// splits > 1 needs the partial buffers (acc [splits][S * H][D], m and l
// [splits][S * H], f32) and launches the merge after the attention kernel;
// splits == 1 takes null buffers. Returns cudaGetLastError() after the
// launches (0 on success), or cudaErrorInvalidValue for what it does not
// take. Launches on `stream`; does not synchronise.
extern "C" int paged_decode(int q_dtype, int kv_dtype, const void* q, const void* kb,
                            const void* vb, const void* k_scale, const void* v_scale,
                            const void* lengths, const void* tables, void* o, float* part_acc,
                            float* part_m, float* part_l, int num_slots, int num_heads,
                            int num_blocks, int block_size, int nb, int head_dim,
                            int blocks_per_split, int splits, float sm_scale, void* stream) {
  if (num_slots < 1 || num_slots > 65535 || num_heads < 1 || num_blocks < 1 ||
      block_size < 1 || block_size > MAX_BS || nb < 1 || blocks_per_split < 1 ||
      blocks_per_split > MAX_SPLIT_BLOCKS || splits < 1 || splits > 65535 ||
      (int64_t)splits * blocks_per_split < nb)
    return (int)cudaErrorInvalidValue;
  if ((kv_dtype == 2) != (k_scale != nullptr && v_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  if ((splits > 1) != (part_acc != nullptr && part_m != nullptr && part_l != nullptr))
    return (int)cudaErrorInvalidValue;
  if (splits == 1) part_acc = nullptr;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define TET_HEAD_DIM(D)                                                                         \
  case D:                                                                                       \
    return launch_dtypes<D>(q_dtype, kv_dtype, q, kb, vb, k_scale, v_scale, lengths, tables, o, \
                            part_acc, part_m, part_l, num_slots, num_heads, num_blocks,         \
                            block_size, nb, blocks_per_split, splits, sm_scale, st)
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
