// Fused softmax cross-entropy for Hopper (sm_90a), plain C interface.
//
// Replaces the two TPU kernels of tensorflow_examples_tpu/ops/cross_entropy.py:
// `_ce_fwd_kernel` (driven by `_fwd_call`) and `_ce_bwd_kernel` (driven by
// the backward of `_make_fused`). The GPT-2 training step runs one of each
// per step on its [batch*seq, vocab] logits; eval runs the forward alone.
//
// Contract (the JAX one): logits [N, V] row-major, f32 or bf16; int32
// labels [N]. A label outside [0, V) selects 0, so its row's NLL is its
// lse and its gradient a plain softmax (the JAX mask-sum picks nothing).
//   ce_fwd: lse[r] = m + log(max(l, 1e-30)) of an online (m, l) over the
//           row, in f32; nll[r] = lse[r] - logits[r, label[r]].
//   ce_bwd: dlogits[r, c] = g[r] * (exp(x[r, c] - lse[r]) - [c == label[r]]),
//           in f32, rounded once to the logits' dtype.
//
// What bounds them on an H100: bytes. The forward reads N*V logits once
// and writes 8 bytes a row; the backward reads them once more and writes
// N*V gradients. At the step's [16384, 50257] in bf16 that is 1.65 GB
// (0.49 ms at 3.35 TB/s) and 3.29 GB (0.98 ms); a handful of operations
// per element is far below the card's ridge. Neither kernel makes an f32
// [N, V] copy: that copy is what the plain path pays for.
//
// Design. Forward: one CTA of 256 threads per row (the TPU's sequential
// vocab grid axis becomes a strided loop inside the CTA). Each thread
// walks the columns tid, tid + 256, ... eight at a time (eight loads in
// flight, then one rescale of its running (m, l) by the chunk's max and
// eight exps), starting from m = -1e30 as the TPU kernel does. Warps
// merge their (m, l) pairs with shuffles, rescaling by exp(m_a - m), and
// warp 0 merges the eight warp results from shared memory. The label's
// logit is read once by thread 0. Backward: a 2-D grid of rows x
// 2048-column chunks, each thread computing eight elements. Loads and
// stores are scalar, so the odd V (every other bf16 row starts on a
// 2-byte boundary) needs no alignment peel; a warp still touches one
// contiguous 64- or 128-byte span per access. Offsets are 64-bit: at
// batch 48 x 1024, N*V passes 2^31. Vector loads, several rows per CTA
// and TMA are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 8;
constexpr int BWD_CHUNK = THREADS * UNROLL;  // columns per backward CTA
constexpr float NEG_INF = -1e30f;            // ops/cross_entropy.py NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Merge the online-softmax pair (m_b, l_b) into (m, l).
__device__ __forceinline__ void merge(float& m, float& l, float m_b, float l_b) {
  const float m_new = fmaxf(m, m_b);
  l = l * __expf(m - m_new) + l_b * __expf(m_b - m_new);
  m = m_new;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ce_fwd_kernel(const T* __restrict__ logits, const int* __restrict__ labels,
              float* __restrict__ nll, float* __restrict__ lse_out, int64_t vocab) {
  const int64_t row = blockIdx.x;
  const T* x = logits + row * vocab;
  const int tid = threadIdx.x;

  float m = NEG_INF, l = 0.f;
  for (int64_t base = tid; base < vocab; base += (int64_t)THREADS * UNROLL) {
    float v[UNROLL];
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      const int64_t c = base + (int64_t)i * THREADS;
      v[i] = c < vocab ? to_f32(x[c]) : NEG_INF;
    }
    float cm = v[0];
#pragma unroll
    for (int i = 1; i < UNROLL; ++i) cm = fmaxf(cm, v[i]);
    const float m_new = fmaxf(m, cm);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      const int64_t c = base + (int64_t)i * THREADS;
      s += c < vocab ? __expf(v[i] - m_new) : 0.f;
    }
    l = l * __expf(m - m_new) + s;
    m = m_new;
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m_b = __shfl_xor_sync(0xffffffffu, m, off);
    const float l_b = __shfl_xor_sync(0xffffffffu, l, off);
    merge(m, l, m_b, l_b);
  }
  __shared__ float sm_m[WARPS], sm_l[WARPS];
  const int warp = tid / 32, lane = tid % 32;
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < WARPS ? sm_m[lane] : NEG_INF;
    l = lane < WARPS ? sm_l[lane] : 0.f;
#pragma unroll
    for (int off = WARPS / 2; off > 0; off >>= 1) {
      const float m_b = __shfl_xor_sync(0xffffffffu, m, off);
      const float l_b = __shfl_xor_sync(0xffffffffu, l, off);
      merge(m, l, m_b, l_b);
    }
    if (lane == 0) {
      const float lse = m + logf(fmaxf(l, 1e-30f));
      const int label = labels[row];
      const float target = (label >= 0 && (int64_t)label < vocab) ? to_f32(x[label]) : 0.f;
      lse_out[row] = lse;
      nll[row] = lse - target;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ce_bwd_kernel(const T* __restrict__ logits, const int* __restrict__ labels,
              const float* __restrict__ lse, const float* __restrict__ g,
              T* __restrict__ dlogits, int64_t vocab) {
  const int64_t row = blockIdx.x;
  const int64_t start = (int64_t)blockIdx.y * BWD_CHUNK + threadIdx.x;
  const float row_lse = lse[row], row_g = g[row];
  const int64_t label = labels[row];
  const T* x = logits + row * vocab;
  T* dx = dlogits + row * vocab;
  float v[UNROLL];
#pragma unroll
  for (int i = 0; i < UNROLL; ++i) {
    const int64_t c = start + (int64_t)i * THREADS;
    v[i] = c < vocab ? to_f32(x[c]) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < UNROLL; ++i) {
    const int64_t c = start + (int64_t)i * THREADS;
    if (c < vocab) {
      const float p = __expf(v[i] - row_lse);
      store1(dx + c, row_g * (p - (c == label ? 1.f : 0.f)));
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each entry returns cudaGetLastError()
// after its launch (0 on success), launches on `stream` and does not
// synchronise.
extern "C" int ce_fwd(int dtype, const void* logits, const int* labels, float* nll,
                      float* lse, long long n, long long vocab, void* stream) {
  if (n < 1 || n > 2147483647LL || vocab < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)n);
  if (dtype == 0) {
    ce_fwd_kernel<float><<<grid, THREADS, 0, st>>>(static_cast<const float*>(logits), labels,
                                                   nll, lse, vocab);
  } else if (dtype == 1) {
    ce_fwd_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits), labels, nll, lse, vocab);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int ce_bwd(int dtype, const void* logits, const int* labels, const float* lse,
                      const float* g, void* dlogits, long long n, long long vocab,
                      void* stream) {
  const long long chunks = (vocab + BWD_CHUNK - 1) / BWD_CHUNK;
  if (n < 1 || n > 2147483647LL || vocab < 1 || chunks > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)n, (unsigned)chunks);
  if (dtype == 0) {
    ce_bwd_kernel<float><<<grid, THREADS, 0, st>>>(static_cast<const float*>(logits), labels,
                                                   lse, g, static_cast<float*>(dlogits), vocab);
  } else if (dtype == 1) {
    ce_bwd_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits), labels, lse, g,
        static_cast<__nv_bfloat16*>(dlogits), vocab);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
