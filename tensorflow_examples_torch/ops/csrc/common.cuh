// Device helpers shared by the port's kernels (sm_90a).
//
// cp.async copies, ldmatrix loads and the bf16 mma.sync step used by the
// tensor-core kernels (flash_attention.cu, grouped_matmul.cu, decode.cu),
// and the merge of split-KV attention partials used by both decode
// kernels (decode.cu, paged_decode.cu). A library that includes this file
// is rebuilt when it changes: ops/_build.py hashes each included header
// with the source.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; full = false zero-fills the destination.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  const int src_bytes = full ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

// 4 bytes from global to shared; full = false zero-fills the destination.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool full) {
  const int src_bytes = full ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
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

// ------------------------------------------------- split-KV partials

// A split that saw no key: running max, sum and accumulator as the
// online softmax starts them, so the merge weighs it by exactly 0.
constexpr float SPLIT_EMPTY_M = -1e30f;

__device__ __forceinline__ void store_f4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }
__device__ __forceinline__ void store_f4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// Merges `splits` partials of `rows` attention rows in split order:
// acc [splits][rows][D] (unnormalised, f32), m and l [splits][rows] (the
// split's running max and sum). m = max m_i, l = sum l_i e^(m_i - m),
// O = sum acc_i e^(m_i - m) / max(l, 1e-30), in q's dtype. One thread
// per four dims of a row; every thread of a row recomputes m and l, so
// no two threads share a sum and a rerun gives the same bits.
template <typename T, int D>
__global__ void __launch_bounds__(256)
merge_splits_kernel(const float* __restrict__ acc, const float* __restrict__ m,
                    const float* __restrict__ l, T* __restrict__ o, int rows, int splits) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)rows * (D / 4)) return;
  const int64_t row = idx / (D / 4);
  const int col = (int)(idx % (D / 4)) * 4;
  float mx = SPLIT_EMPTY_M;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, m[(int64_t)s * rows + row]);
  float sum = 0.f;
  float4 out = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const int64_t at = (int64_t)s * rows + row;
    const float w = expf(m[at] - mx);
    sum += l[at] * w;
    const float4 a = *reinterpret_cast<const float4*>(acc + at * D + col);
    out.x += a.x * w;
    out.y += a.y * w;
    out.z += a.z * w;
    out.w += a.w * w;
  }
  const float inv = 1.f / fmaxf(sum, 1e-30f);
  store_f4(o + row * D + col, make_float4(out.x * inv, out.y * inv, out.z * inv, out.w * inv));
}

template <typename T, int D>
int merge_splits(const float* acc, const float* m, const float* l, T* o, int rows, int splits,
                 cudaStream_t st) {
  const int64_t threads = (int64_t)rows * (D / 4);
  merge_splits_kernel<T, D><<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
      acc, m, l, o, rows, splits);
  return (int)cudaGetLastError();
}

}  // namespace
