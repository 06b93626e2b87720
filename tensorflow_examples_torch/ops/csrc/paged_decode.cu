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
// int8), with per-row f32 scales
// [NB, H, BS] for int8; lengths [S] int32 (populated length including the
// new token); block_tables [S, nb] int32 (logical -> physical block).
// Slot s attends columns < lengths[s] and reads nothing past them. A slot
// of length 0 writes zeros. Output [S, H, D] in q's dtype.
//
// What bounds it on an H100: bytes. Each K/V element is used for two
// multiply-adds, so a decode step is far below the card's ridge; the least
// time is the populated K/V bytes over 3.35 TB/s. With one query per slot
// there is no reuse to exploit, so the design reads every needed byte
// exactly once, straight from the pool through the block table (no
// gathered per-slot copy in device memory, which is what the plain
// version pays for), and int8 pools are read at one byte per element and
// widened only in shared memory.
//
// Design: one CTA per (head, slot); 128 threads. The CTA reads its own
// block-table entries (no scalar prefetch on this card) and loops over
// logical blocks j < ceil(length / BS); for each it stages that physical
// block's populated K and V rows in shared memory as f32 (dequantized
// with their row scales when the pool is int8), CHUNK rows at a time (64,
// or 32 at D = 128 to stay within 48 KB of static shared memory), computes
// their scores with one warp per row (lane d, d + 32, ... of the dims),
// and folds them into an online softmax whose accumulator (one dim per
// thread, threads d < D) stays in registers. With few slots the
// card holds few CTAs, so a step is bound by per-block latency rather than
// bandwidth; splitting the KV range across CTAs with an lse merge and
// pipelining the block loads are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;      // 4 warps; thread d < D owns dim d
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BS = 64;        // largest block size taken
constexpr float NEG_INF = -1e30f; // ops/attention.py NEG_INF

// Rows of a block staged in shared memory at a time.
template <int D>
struct Chunk {
  static_assert(D == 8 || D == 16 || D == 32 || D == 64 || D == 128, "unsupported head_dim");
  static constexpr int ROWS = D == 128 ? 32 : 64;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename QT, typename KVT, int D>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const QT* __restrict__ q, const KVT* __restrict__ kb,
                    const KVT* __restrict__ vb, const float* __restrict__ ksc,
                    const float* __restrict__ vsc, const int* __restrict__ lengths,
                    const int* __restrict__ tables, QT* __restrict__ o, int num_heads,
                    int num_blocks, int block_size, int nb, float sm_scale) {
  constexpr int CH = Chunk<D>::ROWS;
  __shared__ __align__(16) float ks[CH][D];
  __shared__ __align__(16) float vs[CH][D];
  __shared__ float qs[D];
  __shared__ float sc[CH];

  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int length = lengths[s];
  const int* table = tables + (size_t)s * nb;
  const size_t qoff = ((size_t)s * num_heads + h) * D;
  if (tid < D) qs[tid] = to_f32(q[qoff + tid]) * sm_scale;

  const int nblocks = length > 0 ? min((length + block_size - 1) / block_size, nb) : 0;
  float m = NEG_INF, l = 0.f, acc = 0.f;  // thread tid < D owns dim tid

  for (int j = 0; j < nblocks; ++j) {
    const int rows = min(block_size, length - j * block_size);  // populated rows
    const int blk = table[j];
    if (blk < 0 || blk >= num_blocks) __trap();  // a corrupt table is a fault
    const size_t row0 = ((size_t)blk * num_heads + h) * block_size;
    // One chunk when a chunk holds the largest block: a constant trip
    // count the compiler removes (a runtime-bounded loop here made the
    // fp32 kernel measurably slower on the H100).
    const int chunks = CH >= MAX_BS ? 1 : (rows + CH - 1) / CH;
    for (int ci = 0; ci < chunks; ++ci) {
      const int c0 = ci * CH;
      const int n = min(CH, rows - c0);  // populated rows of this chunk
      __syncthreads();  // previous chunk consumed; qs visible on the first pass
      for (int idx = tid; idx < n * (D / 4); idx += THREADS) {
        const int r = idx / (D / 4);
        const int c = (idx % (D / 4)) * 4;
        const size_t at = row0 + c0 + r;
        float4 kk = load4(kb + at * D + c);
        float4 vv = load4(vb + at * D + c);
        if (ksc != nullptr) {
          const float a = ksc[at], b = vsc[at];
          kk.x *= a; kk.y *= a; kk.z *= a; kk.w *= a;
          vv.x *= b; vv.y *= b; vv.z *= b; vv.w *= b;
        }
        *reinterpret_cast<float4*>(&ks[r][c]) = kk;
        *reinterpret_cast<float4*>(&vs[r][c]) = vv;
      }
      __syncthreads();
      for (int r = warp; r < n; r += WARPS) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < (D + 31) / 32; ++i) {
          const int d = lane + 32 * i;
          if (d < D) dot += qs[d] * ks[r][d];
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (lane == 0) sc[r] = dot;
      }
      __syncthreads();
      float bmax = NEG_INF;
      for (int r = 0; r < n; ++r) bmax = fmaxf(bmax, sc[r]);
      const float m_new = fmaxf(m, bmax);
      const float alpha = expf(m - m_new);
      float psum = 0.f, a = acc * alpha;
      for (int r = 0; r < n; ++r) {
        const float p = expf(sc[r] - m_new);
        psum += p;
        if (tid < D) a += p * vs[r][tid];
      }
      acc = a;
      l = l * alpha + psum;
      m = m_new;
    }
  }
  if (tid < D) store1(o + qoff + tid, acc / fmaxf(l, 1e-30f));
}

template <typename QT, typename KVT, int D>
void launch(const void* q, const void* kb, const void* vb, const void* ksc,
            const void* vsc, const void* lengths, const void* tables, void* o,
            int num_slots, int num_heads, int num_blocks, int block_size, int nb,
            float sm_scale, cudaStream_t st) {
  const dim3 grid(num_heads, num_slots);
  paged_decode_kernel<QT, KVT, D><<<grid, THREADS, 0, st>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(kb), static_cast<const KVT*>(vb),
      static_cast<const float*>(ksc), static_cast<const float*>(vsc),
      static_cast<const int*>(lengths), static_cast<const int*>(tables),
      static_cast<QT*>(o), num_heads, num_blocks, block_size, nb, sm_scale);
}

template <int D>
int launch_dtypes(int q_dtype, int kv_dtype, const void* q, const void* kb, const void* vb,
                  const void* k_scale, const void* v_scale, const void* lengths,
                  const void* tables, void* o, int num_slots, int num_heads, int num_blocks,
                  int block_size, int nb, float sm_scale, cudaStream_t st) {
#define TET_LAUNCH(QT, KVT)                                                          \
  launch<QT, KVT, D>(q, kb, vb, k_scale, v_scale, lengths, tables, o, num_slots,     \
                     num_heads, num_blocks, block_size, nb, sm_scale, st)
  if (q_dtype == 0 && kv_dtype == 0) TET_LAUNCH(float, float);
  else if (q_dtype == 1 && kv_dtype == 1) TET_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  else if (q_dtype == 0 && kv_dtype == 2) TET_LAUNCH(float, int8_t);
  else if (q_dtype == 1 && kv_dtype == 2) TET_LAUNCH(__nv_bfloat16, int8_t);
  else return (int)cudaErrorInvalidValue;
#undef TET_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16. kv_dtype: 0 = float32, 1 = bfloat16,
// 2 = int8 (k_scale / v_scale then required, else null). head_dim in
// {8, 16, 32, 64, 128}. Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for what it does not take. Launches
// on `stream`; does not synchronise.
extern "C" int paged_decode(int q_dtype, int kv_dtype, const void* q, const void* kb,
                            const void* vb, const void* k_scale, const void* v_scale,
                            const void* lengths, const void* tables, void* o,
                            int num_slots, int num_heads, int num_blocks, int block_size,
                            int nb, int head_dim, float sm_scale, void* stream) {
  if (num_slots < 1 || num_slots > 65535 || num_heads < 1 || num_blocks < 1 ||
      block_size < 1 || block_size > MAX_BS || nb < 1)
    return (int)cudaErrorInvalidValue;
  if ((kv_dtype == 2) != (k_scale != nullptr && v_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define TET_HEAD_DIM(D)                                                                   \
  case D:                                                                                 \
    return launch_dtypes<D>(q_dtype, kv_dtype, q, kb, vb, k_scale, v_scale, lengths, tables, \
                            o, num_slots, num_heads, num_blocks, block_size, nb, sm_scale, st)
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
