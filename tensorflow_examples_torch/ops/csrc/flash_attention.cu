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
// Contract (the JAX one): q [BH, seq_q, 64], k/v [BH, seq_kv, 64], row-major
// and contiguous, f32 or bf16. The causal diagonal is aligned bottom-right:
// row r sees key columns c <= r + (seq_kv - seq_q). An optional f32 key bias
// [B, seq_kv] (B = BH / heads) is added to every score of its batch row; it
// is data, not differentiated. The forward writes O (q's dtype) and the row
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
// (989 TFLOP/s), near theirs. These kernels are bound by FMA throughput on
// the CUDA cores: they use no tensor cores yet (mma/wgmma, TMA and
// split-KV are later work), which is what keeps them simple and exact.
//
// Design, shared by the three: 256 threads per CTA, four per tile row, each
// holding 16 of the row's 64 dims (interleaved, so the four threads of a
// row read 64 contiguous bytes of a shared row and a warp's eight rows read
// the same address: a broadcast). Dot products reduce with two shuffles.
// A loop inside the CTA walks the other operand's 64-row tiles staged in
// shared memory as f32 (this loop replaces the TPU's sequential grid axis);
// under causal masking its bounds stop at the diagonal, so tiles wholly
// past it are never read. Masked scores are -inf inside the kernel, so
// their probability is exactly 0 and a fully masked tile cannot make a
// NaN: the running max starts at the finite -1e30 and -inf - m = -inf.
// Element offsets are computed in 64 bits.
//   flash_fwd: one CTA per (batch*head, 64-row query tile); online softmax
//     with (m, l, acc) in registers; one tile's 64 scores per thread.
//   flash_bwd_dkv: one CTA per (batch*head, 64-row key tile); walks query
//     tiles from the first one that reaches the diagonal, recomputes
//     p = exp(s - lse), accumulates dV += p dO and dK += ds q.
//   flash_bwd_dq: one CTA per (batch*head, 64-row query tile); walks key
//     tiles up to the diagonal, accumulates dQ += ds k.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;                  // head_dim
constexpr int TILE = 64;               // rows per CTA and per staged tile
constexpr int PARTS = 4;               // threads per row
constexpr int THREADS = TILE * PARTS;  // 256
constexpr float NEG_INF = -1e30f;      // ops/attention.py NEG_INF

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// First of the four dims a thread owns in its i-th group of four.
__device__ __forceinline__ int dim_of(int part, int i) { return 16 * i + 4 * part; }

// One row's 16 owned dims from device memory into registers (zeros when
// the row does not exist), times `scale`.
template <typename T>
__device__ __forceinline__ void load_row(float (&dst)[16], const T* row, bool live, int part,
                                         float scale) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 x = live ? load4(row + dim_of(part, i)) : make_float4(0.f, 0.f, 0.f, 0.f);
    dst[4 * i + 0] = x.x * scale;
    dst[4 * i + 1] = x.y * scale;
    dst[4 * i + 2] = x.z * scale;
    dst[4 * i + 3] = x.w * scale;
  }
}

template <typename T>
__device__ __forceinline__ void store_row(T* row, const float (&src)[16], int part, float scale) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    store4(row + dim_of(part, i), src[4 * i] * scale, src[4 * i + 1] * scale,
           src[4 * i + 2] * scale, src[4 * i + 3] * scale);
}

// Rows [row0, row0 + TILE) of one head's [rows, D] matrix into shared
// memory as f32; rows at or past `end` are zero-filled.
template <typename T>
__device__ __forceinline__ void stage_tile(float (*dst)[D], const T* src, int row0, int end) {
  for (int idx = threadIdx.x; idx < TILE * (D / 4); idx += THREADS) {
    const int r = idx / (D / 4);
    const int c = (idx % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < end) x = load4(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<float4*>(&dst[r][c]) = x;
  }
}

// The dot product of a thread's 16 dims with a shared row, summed over the
// four threads of the row.
__device__ __forceinline__ float row_dot(const float (&a)[16], const float* srow, int part) {
  float dot = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 b = *reinterpret_cast<const float4*>(srow + dim_of(part, i));
    dot += a[4 * i] * b.x + a[4 * i + 1] * b.y + a[4 * i + 2] * b.z + a[4 * i + 3] * b.w;
  }
  dot += __shfl_xor_sync(0xffffffffu, dot, 1);
  dot += __shfl_xor_sync(0xffffffffu, dot, 2);
  return dot;
}

// acc += w * shared row (the thread's 16 dims).
__device__ __forceinline__ void row_axpy(float (&acc)[16], float w, const float* srow, int part) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 b = *reinterpret_cast<const float4*>(srow + dim_of(part, i));
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

// ------------------------------------------------------------------ forward

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ kb, T* __restrict__ o, float* __restrict__ lse,
                 int heads, int seq_q, int seq_kv, int causal, float sm_scale) {
  __shared__ __align__(16) float ks[TILE][D];
  __shared__ __align__(16) float vs[TILE][D];
  __shared__ float bias[TILE];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * TILE;
  const int row = threadIdx.x / PARTS;
  const int part = threadIdx.x % PARTS;
  const int qi = q0 + row;
  const bool live = qi < seq_q;
  const int offset = seq_kv - seq_q;
  const int row_last = causal ? qi + offset : seq_kv - 1;  // last column this row sees

  float qr[16], acc[16];
  load_row(qr, q + ((size_t)bh * seq_q + qi) * D, live, part, sm_scale);
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  float m = NEG_INF, l = 0.f;

  const int kv_end = kv_reach(min(q0 + TILE, seq_q) - 1, offset, seq_kv, causal);
  const T* kp = k + (size_t)bh * seq_kv * D;
  const T* vp = v + (size_t)bh * seq_kv * D;
  const float* bp = kb ? kb + (size_t)(bh / heads) * seq_kv : nullptr;

  for (int kv0 = 0; kv0 < kv_end; kv0 += TILE) {
    __syncthreads();  // the previous tile is fully consumed
    stage_tile(ks, kp, kv0, kv_end);
    stage_tile(vs, vp, kv0, kv_end);
    if (threadIdx.x < TILE)
      bias[threadIdx.x] = (bp && kv0 + threadIdx.x < kv_end) ? bp[kv0 + threadIdx.x] : 0.f;
    __syncthreads();

    float s[TILE];
    float tile_max = NEG_INF;
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      const float dot = row_dot(qr, ks[j], part) + bias[j];
      const int col = kv0 + j;
      s[j] = (col < kv_end && col <= row_last) ? dot : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] *= alpha;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
      row_axpy(acc, p, vs[j], part);
    }
    l = l * alpha + psum;
    m = m_new;
  }

  if (live) {
    const float denom = fmaxf(l, 1e-30f);
    store_row(o + ((size_t)bh * seq_q + qi) * D, acc, part, 1.f / denom);
    if (part == 0) lse[(size_t)bh * seq_q + qi] = m + logf(denom);
  }
}

// ------------------------------------------------------------- dK and dV

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, const float* __restrict__ dlse,
                     const float* __restrict__ kb, T* __restrict__ dk, T* __restrict__ dv,
                     int heads, int seq_q, int seq_kv, int causal, float sm_scale) {
  __shared__ __align__(16) float qs[TILE][D];
  __shared__ __align__(16) float dos[TILE][D];
  __shared__ float lse_s[TILE], delta_s[TILE], dlse_s[TILE];

  const int bh = blockIdx.y;
  const int kv0 = blockIdx.x * TILE;
  const int row = threadIdx.x / PARTS;
  const int part = threadIdx.x % PARTS;
  const int kj = kv0 + row;  // this thread's key column
  const bool live = kj < seq_kv;
  const int offset = seq_kv - seq_q;

  float kr[16], vr[16], dkacc[16], dvacc[16];
  load_row(kr, k + ((size_t)bh * seq_kv + kj) * D, live, part, 1.f);
  load_row(vr, v + ((size_t)bh * seq_kv + kj) * D, live, part, 1.f);
#pragma unroll
  for (int i = 0; i < 16; ++i) dkacc[i] = dvacc[i] = 0.f;
  const float b = (kb && live) ? kb[(size_t)(bh / heads) * seq_kv + kj] : 0.f;

  // First query row that sees column kv0 is kv0 - offset; start at its tile.
  const int q_begin = causal ? max(0, kv0 - offset) / TILE * TILE : 0;
  const size_t qrow0 = (size_t)bh * seq_q;
  for (int q0 = q_begin; q0 < seq_q; q0 += TILE) {
    __syncthreads();
    stage_tile(qs, q + qrow0 * D, q0, seq_q);
    stage_tile(dos, dout + qrow0 * D, q0, seq_q);
    if (threadIdx.x < TILE) {
      const int r = q0 + threadIdx.x;
      const bool ok = r < seq_q;
      lse_s[threadIdx.x] = ok ? lse[qrow0 + r] : 0.f;
      delta_s[threadIdx.x] = ok ? delta[qrow0 + r] : 0.f;
      dlse_s[threadIdx.x] = ok ? dlse[qrow0 + r] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int i = 0; i < TILE; ++i) {
      const float qk = row_dot(kr, qs[i], part);
      const float dp = row_dot(vr, dos[i], part);
      const int qi = q0 + i;
      const bool visible = live && qi < seq_q && (!causal || kj <= qi + offset);
      const float s = qk * sm_scale + b;
      const float p = visible ? expf(s - lse_s[i]) : 0.f;
      const float ds = p * (dp - delta_s[i] + dlse_s[i]);
      row_axpy(dvacc, p, dos[i], part);
      row_axpy(dkacc, ds, qs[i], part);
    }
  }

  if (live) {
    store_row(dk + ((size_t)bh * seq_kv + kj) * D, dkacc, part, sm_scale);
    store_row(dv + ((size_t)bh * seq_kv + kj) * D, dvacc, part, 1.f);
  }
}

// -------------------------------------------------------------------- dQ

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, const float* __restrict__ dlse,
                    const float* __restrict__ kb, T* __restrict__ dq, int heads, int seq_q,
                    int seq_kv, int causal, float sm_scale) {
  __shared__ __align__(16) float ks[TILE][D];
  __shared__ __align__(16) float vs[TILE][D];
  __shared__ float bias[TILE];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * TILE;
  const int row = threadIdx.x / PARTS;
  const int part = threadIdx.x % PARTS;
  const int qi = q0 + row;
  const bool live = qi < seq_q;
  const int offset = seq_kv - seq_q;
  const int row_last = causal ? qi + offset : seq_kv - 1;
  const size_t r = (size_t)bh * seq_q + qi;

  float qr[16], dor[16], acc[16];
  load_row(qr, q + r * D, live, part, 1.f);
  load_row(dor, dout + r * D, live, part, 1.f);
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  const float row_lse = live ? lse[r] : 0.f;
  const float row_delta = live ? delta[r] : 0.f;
  const float row_dlse = live ? dlse[r] : 0.f;

  const int kv_end = kv_reach(min(q0 + TILE, seq_q) - 1, offset, seq_kv, causal);
  const T* kp = k + (size_t)bh * seq_kv * D;
  const T* vp = v + (size_t)bh * seq_kv * D;
  const float* bp = kb ? kb + (size_t)(bh / heads) * seq_kv : nullptr;

  for (int kv0 = 0; kv0 < kv_end; kv0 += TILE) {
    __syncthreads();
    stage_tile(ks, kp, kv0, kv_end);
    stage_tile(vs, vp, kv0, kv_end);
    if (threadIdx.x < TILE)
      bias[threadIdx.x] = (bp && kv0 + threadIdx.x < kv_end) ? bp[kv0 + threadIdx.x] : 0.f;
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < TILE; ++j) {
      const float qk = row_dot(qr, ks[j], part);
      const float dp = row_dot(dor, vs[j], part);
      const int col = kv0 + j;
      const bool visible = live && col < kv_end && col <= row_last;
      const float s = qk * sm_scale + bias[j];
      const float p = visible ? expf(s - row_lse) : 0.f;
      const float ds = p * (dp - row_delta + row_dlse);
      row_axpy(acc, ds, ks[j], part);
    }
  }

  if (live) store_row(dq + r * D, acc, part, sm_scale);
}

dim3 grid_for(int rows, int bh) { return dim3((rows + TILE - 1) / TILE, bh); }

bool bad_shape(int bh, int heads, int seq_q, int seq_kv) {
  return bh < 1 || bh > 65535 || heads < 1 || bh % heads || seq_q < 1 || seq_kv < 1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. kb may be NULL (no key bias). Each entry
// point returns cudaGetLastError() after its launch (0 on success), launches
// on `stream` and does not synchronise.
extern "C" int flash_fwd(int dtype, const void* q, const void* k, const void* v,
                         const float* kb, void* o, float* lse, int bh, int heads, int seq_q,
                         int seq_kv, int causal, float sm_scale, void* stream) {
  if (bad_shape(bh, heads, seq_q, seq_kv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(seq_q, bh);
  if (dtype == 0) {
    flash_fwd_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), kb, static_cast<float*>(o), lse, heads, seq_q, seq_kv,
        causal, sm_scale);
  } else if (dtype == 1) {
    flash_fwd_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), kb, static_cast<__nv_bfloat16*>(o), lse, heads,
        seq_q, seq_kv, causal, sm_scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                             const void* dout, const float* lse, const float* delta,
                             const float* dlse, const float* kb, void* dk, void* dv, int bh,
                             int heads, int seq_q, int seq_kv, int causal, float sm_scale,
                             void* stream) {
  if (bad_shape(bh, heads, seq_q, seq_kv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(seq_kv, bh);
  if (dtype == 0) {
    flash_bwd_dkv_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta, dlse, kb,
        static_cast<float*>(dk), static_cast<float*>(dv), heads, seq_q, seq_kv, causal,
        sm_scale);
  } else if (dtype == 1) {
    flash_bwd_dkv_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse,
        delta, dlse, kb, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
        heads, seq_q, seq_kv, causal, sm_scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                            const void* dout, const float* lse, const float* delta,
                            const float* dlse, const float* kb, void* dq, int bh, int heads,
                            int seq_q, int seq_kv, int causal, float sm_scale, void* stream) {
  if (bad_shape(bh, heads, seq_q, seq_kv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(seq_q, bh);
  if (dtype == 0) {
    flash_bwd_dq_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta, dlse, kb,
        static_cast<float*>(dq), heads, seq_q, seq_kv, causal, sm_scale);
  } else if (dtype == 1) {
    flash_bwd_dq_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse,
        delta, dlse, kb, static_cast<__nv_bfloat16*>(dq), heads, seq_q, seq_kv, causal,
        sm_scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
