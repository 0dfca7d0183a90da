// Helpers shared by the port's CUDA kernels.
//
// Every kernel is reached through an extern "C" launcher that takes raw
// device pointers and the caller's stream, launches without synchronising,
// allocates nothing, and returns cudaGetLastError() so that the Python
// wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace repro {

// dtype codes passed from Python (kernels/library.py)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch casts
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// reductions over the 16 lanes of a half warp (lanes 0-15 or 16-31)
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// TF32 bits of x, rounded to nearest with ties away from zero (the SSD
// scan's split; flash attention splits on the FMA pipe instead, since
// cvt.rna issues at a quarter rate: split_a / split_b there)
__device__ __forceinline__ unsigned tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d += a b, a 16 x 8 (row), b 8 x 8 (col), TF32 in, fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16-byte asynchronous copy global -> shared, and its group fences
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// mma.sync, ldmatrix and the operand splits of the tensor-core kernels
// (flash_attention.cu, flash_attention_bwd.cu)
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 16-byte matrices: thread t gives the address of row t % 8 of
// matrix t / 8 and receives 32 bits of each: (row t / 4, bytes 4 (t % 4) ..
// +4), i.e. one fp32 value or a pair of bf16 values; with trans (bf16 only)
// (rows 2 (t % 4), +1; bf16 column t / 4)
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// TF32 high part and remainder of N fragment values: lo = x - hi exactly,
// handed over as it is (the tensor core reads the top 19 bits of a TF32
// operand, so lo enters truncated to TF32). split_a: hi is x rounded to 11
// significant bits by Veltkamp's split on the FMA pipe (c = x (2^13 + 1),
// hi = c - (c - x), each step rounded, never fused), exact in TF32; |x| must
// stay below 4e34 (c overflows), far beyond what attention's inputs, P and
// dS reach. split_b: hi is x truncated to TF32 (one logic operation), which
// leaves a remainder twice as large; flash attention takes it for the B
// fragments of Q K^T, the most splits of S, and its errors stay within the
// limit's budget (PERF.md). The forward's V split that way too spills
// registers at width 256.
template <int N>
__device__ __forceinline__ void split_a(const unsigned (&x)[N],
                                        unsigned (&hi)[N], unsigned (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float xf = __uint_as_float(x[i]);
    const float c = __fmul_rn(xf, 8193.f);
    const float h = __fsub_rn(c, __fsub_rn(c, xf));
    hi[i] = __float_as_uint(h);
    lo[i] = __float_as_uint(__fsub_rn(xf, h));
  }
}
template <int N>
__device__ __forceinline__ void split_b(const unsigned (&x)[N],
                                        unsigned (&hi)[N], unsigned (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = x[i] & 0xffffe000u;
    lo[i] = __float_as_uint(
        __fsub_rn(__uint_as_float(x[i]), __uint_as_float(hi[i])));
  }
}

// 2^x on the special-function unit (~2 ulp; results below 2^-126, far
// under what a row sum of at least 1 can notice, flush to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the bf16x2 high parts of (a, b) (rounded), and their remainders in lo
__device__ __forceinline__ unsigned split_bf16x2(float a, float b,
                                                 unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  lo = *reinterpret_cast<const unsigned*>(&l);
  return *reinterpret_cast<const unsigned*>(&h);
}

}  // namespace repro
