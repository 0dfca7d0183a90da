// Decode attention on Hopper: one query token per (batch, head) against a
// KV cache filled up to kv_len, split across the cache (flash-decoding).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py
// (_dec_kernel / decode_attention_fwd). Same function: q [B,1,Hq,dh]
// against k/v [B,Smax,Hkv,dh], positions >= kv_len masked, query head h
// reading KV head h / (Hq/Hkv), scale = true dh^-0.5. kv_len is one int32
// read from device memory, so the caller needs no host sync.
//
// What differs from the TPU design: the TPU kernel gives each (batch, query
// head) a sequential walk over the cache's blocks. At batch 1 that is
// B*Hq = 14 programs, which on a GPU would fill 14 of 132 SMs, and each of
// the 7 query heads sharing a KV head would read it again. Here
//   (1) dec_split: grid (nsplit, B*Hkv), 4 warps. A block serves every query
//       head of one KV head (K/V read once) over one chunk of ceil(kv_len /
//       nsplit) positions; warps take positions round-robin, each lane holds
//       dh/32 columns of q, K, V and the accumulators, a score is a warp
//       all-reduce, and the online softmax (m, l, acc) stays in registers.
//       The 4 warps merge through shared memory and the block writes one
//       partial (m, l, acc) per query head. Chunks past kv_len write empty
//       partials and read nothing.
//   (2) dec_merge: one block per (batch, query head) rescales and sums the
//       nsplit partials and writes the output in q's dtype.
// Query heads are taken 8 at a time (kGMax) to bound registers.
//
// Bound on an H100 (3.35 TB/s) at the serve path's decode (kv_len ~ 1000,
// bf16, Hkv = 2, dh = 64): K and V below kv_len are 0.5 MB, about 0.15 us;
// the FLOPs are negligible. Two launches cost more: launch-bound.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kGMax = 8;

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
dec_split(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const int* __restrict__ kv_len_ptr,
          float* __restrict__ part_m, float* __restrict__ part_l,
          float* __restrict__ part_acc, int smax, int hq, int hkv, int dh,
          int nsplit, float scale) {
  constexpr int EL = HD / 32;   // columns per lane: d = lane * EL + e
  __shared__ float sm_m[kWarps][kGMax];
  __shared__ float sm_l[kWarps][kGMax];
  __shared__ float sm_acc[kWarps][kGMax][HD];

  const int split = blockIdx.x;
  const int b = blockIdx.y / hkv;
  const int kvh = blockIdx.y - b * hkv;
  const int G = hq / hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int kv_len = max(0, min(*kv_len_ptr, smax));
  const int chunk = (kv_len + nsplit - 1) / nsplit;
  const int start = split * chunk;
  const int end = min(start + chunk, kv_len);

  const size_t kv_row = (size_t)hkv * dh;   // stride between positions
  const T* kb = k + ((size_t)b * smax * hkv + kvh) * dh;
  const T* vb = v + ((size_t)b * smax * hkv + kvh) * dh;

  for (int g0 = 0; g0 < G; g0 += kGMax) {
    const int ng = min(kGMax, G - g0);
    float qr[kGMax][EL], acc[kGMax][EL], m[kGMax], l[kGMax];
#pragma unroll
    for (int g = 0; g < kGMax; ++g) {
      const int h = kvh * G + g0 + g;
#pragma unroll
      for (int e = 0; e < EL; ++e) {
        const int d = lane * EL + e;
        qr[g][e] = (g < ng && d < dh)
                       ? repro::to_float(q[((size_t)b * hq + h) * dh + d])
                       : 0.f;
        acc[g][e] = 0.f;
      }
      m[g] = -INFINITY;
      l[g] = 0.f;
    }

    for (int p = start + warp; p < end; p += kWarps) {
      float kr[EL], vr[EL];
#pragma unroll
      for (int e = 0; e < EL; ++e) {
        const int d = lane * EL + e;
        kr[e] = d < dh ? repro::to_float(kb[(size_t)p * kv_row + d]) : 0.f;
        vr[e] = d < dh ? repro::to_float(vb[(size_t)p * kv_row + d]) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < kGMax; ++g) {
        if (g >= ng) break;
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < EL; ++e) s = fmaf(qr[g][e], kr[e], s);
        s = repro::warp_sum(s) * scale;
        const float mn = fmaxf(m[g], s);
        const float alpha = expf(m[g] - mn);   // 0 on the first position
        const float pw = expf(s - mn);
        l[g] = l[g] * alpha + pw;
#pragma unroll
        for (int e = 0; e < EL; ++e) acc[g][e] = fmaf(acc[g][e], alpha, pw * vr[e]);
        m[g] = mn;
      }
    }

    // merge the warps' states, one partial per query head
#pragma unroll
    for (int g = 0; g < kGMax; ++g) {
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < EL; ++e) sm_acc[warp][g][lane * EL + e] = acc[g][e];
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < ng * HD; idx += kWarps * 32) {
      const int g = idx / HD;
      const int d = idx - g * HD;
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
      float lsum = 0.f, asum = 0.f;
      if (mx != -INFINITY) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const float c = expf(sm_m[w][g] - mx);
          lsum = fmaf(c, sm_l[w][g], lsum);
          asum = fmaf(c, sm_acc[w][g][d], asum);
        }
      }
      const size_t part = ((size_t)b * hq + kvh * G + g0 + g) * nsplit + split;
      part_acc[part * HD + d] = asum;
      if (d == 0) {
        part_m[part] = mx;
        part_l[part] = lsum;
      }
    }
    __syncthreads();
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
dec_merge(const float* __restrict__ part_m, const float* __restrict__ part_l,
          const float* __restrict__ part_acc, T* __restrict__ o, int dh,
          int nsplit) {
  const int row = blockIdx.x;   // b * hq + h
  const int d = threadIdx.x;
  const float* pm = part_m + (size_t)row * nsplit;
  const float* pl = part_l + (size_t)row * nsplit;
  const float* pa = part_acc + (size_t)row * nsplit * HD;
  float mx = -INFINITY;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, pm[s]);
  float lsum = 0.f, asum = 0.f;
  if (mx != -INFINITY) {
    for (int s = 0; s < nsplit; ++s) {
      const float c = expf(pm[s] - mx);
      lsum = fmaf(c, pl[s], lsum);
      asum = fmaf(c, pa[(size_t)s * HD + d], asum);
    }
  }
  if (d < dh)
    o[(size_t)row * dh + d] = repro::from_float<T>(asum / fmaxf(lsum, 1e-30f));
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           void* o, float* scratch, int b, int smax, int hq, int hkv, int dh,
           int nsplit, float scale, cudaStream_t s) {
  float* pm = scratch;
  float* pl = pm + (size_t)b * hq * nsplit;
  float* pa = pl + (size_t)b * hq * nsplit;
  dim3 grid(nsplit, b * hkv);
  dec_split<T, HD><<<grid, kWarps * 32, 0, s>>>(
      (const T*)q, (const T*)k, (const T*)v, kv_len, pm, pl, pa, smax, hq,
      hkv, dh, nsplit, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dec_merge<T, HD><<<b * hq, HD, 0, s>>>(pm, pl, pa, (T*)o, dh, nsplit);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, const int* kv_len,
              void* o, float* scratch, int b, int smax, int hq, int hkv,
              int dh, int nsplit, float scale, cudaStream_t s) {
  if (dh <= 64)
    return launch<T, 64>(q, k, v, kv_len, o, scratch, b, smax, hq, hkv, dh,
                         nsplit, scale, s);
  if (dh <= 128)
    return launch<T, 128>(q, k, v, kv_len, o, scratch, b, smax, hq, hkv, dh,
                          nsplit, scale, s);
  if (dh <= 256)
    return launch<T, 256>(q, k, v, kv_len, o, scratch, b, smax, hq, hkv, dh,
                          nsplit, scale, s);
  return (int)cudaErrorInvalidValue;
}

int width(int dh) { return dh <= 64 ? 64 : dh <= 128 ? 128 : 256; }

}  // namespace

extern "C" long long decode_attention_scratch_floats(int b, int hq, int dh,
                                                     int nsplit) {
  return (long long)b * hq * nsplit * (2 + width(dh));
}

extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const int* kv_len,
                                       void* o, float* scratch, int b,
                                       int smax, int hq, int hkv, int dh,
                                       int nsplit, float scale, int dtype,
                                       void* stream) {
  if (b <= 0 || hq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || dh <= 0 || nsplit <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == repro::kFloat32)
    return launch_dh<float>(q, k, v, kv_len, o, scratch, b, smax, hq, hkv,
                            dh, nsplit, scale, s);
  if (dtype == repro::kBFloat16)
    return launch_dh<__nv_bfloat16>(q, k, v, kv_len, o, scratch, b, smax, hq,
                                    hkv, dh, nsplit, scale, s);
  return (int)cudaErrorInvalidValue;
}
