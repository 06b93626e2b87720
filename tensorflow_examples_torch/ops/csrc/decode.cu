// Flash-decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_decode_kernel` in
// tensorflow_examples_tpu/ops/decode.py (driven by `_make_decode` and the
// public `flash_decode_attention`). The serving engine runs it for the
// causal prefill attention under ServeConfig.attention="flash", with
// q_len == length == the prompt bucket.
//
// Contract (the JAX one, unchanged): q [BH, q_len, D], k/v caches
// [BH, max_len, D], all row-major and contiguous, head_dim D in
// {8, 16, 32, 64, 128}; a scalar `length`.
// Query row r sits at global position length - q_len + r and attends cache
// columns c <= its position (and c < max_len). Output [BH, q_len, D] in
// q's dtype (f32 or bf16); sums, softmax and accumulator are f32.
//
// What bounds it on an H100: at the engine's prefill shapes the work is
// q_len^2 / 2 * D * 4 f32 operations against 4 * q_len * D elements of
// traffic, i.e. about q_len / 8 operations per byte in f32. Above a
// ~160-token prompt that is past the card's f32 ridge (67 TFLOP/s over
// 3.35 TB/s), so long prompts are bound by f32 FMA throughput and short
// ones by bytes and launch latency. TF32 tensor cores are not used: they
// keep ~3 decimal digits and would break token parity with the f32
// reference.
//
// Design: one CTA per (batch*head, 64-row query tile); PARTS threads per
// query row (2 at D = 8, 8 at D = 128, else 4), each holding D / PARTS of
// the dims of its q row and of its f32 accumulator in registers. A loop
// inside the CTA walks K/V tiles of KV_ROWS rows (64, or 32 at D = 128 to
// stay within 48 KB of static shared memory) staged in shared memory as
// f32 (this loop replaces the TPU's sequential KV grid axis and its
// power-of-two lax.switch ladder); its bound is
// min(length, last row's position + 1, max_len), so tiles past the causal
// diagonal or the populated length are never read. Each K and V tile is
// read from device memory once per query tile and reused by all 64 rows.
// The online softmax keeps (m, l, acc) in registers. Rows of a tile past
// the loop bound are zero-filled in shared memory, never loaded.
// Splitting KV across CTAs, cp.async/TMA pipelining and tensor cores are
// left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_Q = 64;              // query rows per CTA
constexpr float NEG_INF = -1e30f;        // ops/attention.py NEG_INF

// The kernel's layout for head_dim D.
template <int D>
struct Rows {
  static_assert(D == 8 || D == 16 || D == 32 || D == 64 || D == 128, "unsupported head_dim");
  static constexpr int PARTS = D == 8 ? 2 : (D == 128 ? 8 : 4);  // threads per query row
  static constexpr int DPT = D / PARTS;                            // dims per thread
  static constexpr int GROUPS = DPT / 4;                           // float4 groups per thread
  static constexpr int THREADS = BLOCK_Q * PARTS;
  static constexpr int KV_ROWS = D == 128 ? 32 : 64;               // cache rows per shared tile
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// First of the four dims a thread owns in its i-th group: interleaved so
// the PARTS threads of one row read consecutive floats of a shared row.
template <int D>
__device__ __forceinline__ int dim_of(int part, int i) { return 4 * Rows<D>::PARTS * i + 4 * part; }

// Rows [row0, row0 + KV_ROWS) of one head's [max_len, D] cache into
// shared memory as f32; rows at or past `end` are zero-filled.
template <int D, typename T>
__device__ __forceinline__ void stage_tile(float (*dst)[D], const T* src, int row0, int end) {
  for (int idx = threadIdx.x; idx < Rows<D>::KV_ROWS * (D / 4); idx += Rows<D>::THREADS) {
    const int r = idx / (D / 4);
    const int c = (idx % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < end) x = load4(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<float4*>(&dst[r][c]) = x;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Rows<D>::THREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o, int q_len,
                    int max_len, int length, float sm_scale) {
  using L = Rows<D>;
  __shared__ __align__(16) float ks[L::KV_ROWS][D];
  __shared__ __align__(16) float vs[L::KV_ROWS][D];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BLOCK_Q;
  const int row = threadIdx.x / L::PARTS;
  const int part = threadIdx.x % L::PARTS;
  const int qi = q0 + row;
  const bool live = qi < q_len;
  const int pos = length - q_len + qi;  // global position of this row

  float qr[L::DPT], acc[L::DPT];
  const T* qp = q + ((size_t)bh * q_len + (live ? qi : 0)) * D;
#pragma unroll
  for (int i = 0; i < L::GROUPS; ++i) {
    float4 x = live ? load4(qp + dim_of<D>(part, i)) : make_float4(0.f, 0.f, 0.f, 0.f);
    qr[4 * i + 0] = x.x * sm_scale;
    qr[4 * i + 1] = x.y * sm_scale;
    qr[4 * i + 2] = x.z * sm_scale;
    qr[4 * i + 3] = x.w * sm_scale;
    acc[4 * i + 0] = acc[4 * i + 1] = acc[4 * i + 2] = acc[4 * i + 3] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  // Last column any row of this tile may see: the populated length, the
  // tile's last row position, and the cache extent.
  const int last_q = min(q0 + BLOCK_Q, q_len) - 1;
  const int kv_end = min(min(length, length - q_len + last_q + 1), max_len);
  const T* kp = k + (size_t)bh * max_len * D;
  const T* vp = v + (size_t)bh * max_len * D;

  for (int kv0 = 0; kv0 < kv_end; kv0 += L::KV_ROWS) {
    __syncthreads();  // the previous tile is fully consumed
    stage_tile<D>(ks, kp, kv0, kv_end);
    stage_tile<D>(vs, vp, kv0, kv_end);
    __syncthreads();

    float s[L::KV_ROWS];
    float tile_max = NEG_INF;
#pragma unroll
    for (int j = 0; j < L::KV_ROWS; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < L::GROUPS; ++i) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[j][dim_of<D>(part, i)]);
        dot += qr[4 * i] * kk.x + qr[4 * i + 1] * kk.y + qr[4 * i + 2] * kk.z +
               qr[4 * i + 3] * kk.w;
      }
#pragma unroll
      for (int off = 1; off < L::PARTS; off <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const int col = kv0 + j;
      s[j] = (col <= pos && col < kv_end) ? dot : NEG_INF;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
#pragma unroll
    for (int i = 0; i < L::DPT; ++i) acc[i] *= alpha;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < L::KV_ROWS; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
#pragma unroll
      for (int i = 0; i < L::GROUPS; ++i) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j][dim_of<D>(part, i)]);
        acc[4 * i + 0] += p * vv.x;
        acc[4 * i + 1] += p * vv.y;
        acc[4 * i + 2] += p * vv.z;
        acc[4 * i + 3] += p * vv.w;
      }
    }
    l = l * alpha + psum;
    m = m_new;
  }

  if (live) {
    const float denom = fmaxf(l, 1e-30f);
    T* op = o + ((size_t)bh * q_len + qi) * D;
#pragma unroll
    for (int i = 0; i < L::GROUPS; ++i) {
      const int d = dim_of<D>(part, i);
      store1(op + d + 0, acc[4 * i + 0] / denom);
      store1(op + d + 1, acc[4 * i + 1] / denom);
      store1(op + d + 2, acc[4 * i + 2] / denom);
      store1(op + d + 3, acc[4 * i + 3] / denom);
    }
  }
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o, int bh, int q_len,
           int max_len, int length, float sm_scale, cudaStream_t st) {
  const dim3 grid((q_len + BLOCK_Q - 1) / BLOCK_Q, bh);
  if (dtype == 0) {
    flash_decode_kernel<float, D><<<grid, Rows<D>::THREADS, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), q_len, max_len, length,
        sm_scale);
  } else if (dtype == 1) {
    flash_decode_kernel<__nv_bfloat16, D><<<grid, Rows<D>::THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), q_len,
        max_len, length, sm_scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim in {8, 16, 32, 64, 128}.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a shape or head_dim it does not take.
// Launches on `stream`; does not synchronise.
extern "C" int flash_decode(int dtype, const void* q, const void* k, const void* v,
                            void* o, int bh, int q_len, int max_len, int length,
                            int head_dim, float sm_scale, void* stream) {
  if (bh < 1 || bh > 65535 || q_len < 1 || max_len < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 8: return launch<8>(dtype, q, k, v, o, bh, q_len, max_len, length, sm_scale, st);
    case 16: return launch<16>(dtype, q, k, v, o, bh, q_len, max_len, length, sm_scale, st);
    case 32: return launch<32>(dtype, q, k, v, o, bh, q_len, max_len, length, sm_scale, st);
    case 64: return launch<64>(dtype, q, k, v, o, bh, q_len, max_len, length, sm_scale, st);
    case 128: return launch<128>(dtype, q, k, v, o, bh, q_len, max_len, length, sm_scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
