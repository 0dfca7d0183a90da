// RG-LRU linear recurrence (the RecurrentGemma / Griffin mixer) on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan/kernel.py
// (_rglru_kernel / rglru_scan_fwd). Same function: per batch row and
// channel, h_t = a_t * h_{t-1} + u_t with h_0 = 0, over a and u [B, S, C]
// (fp32 or bf16, computed in fp32), h written in a's dtype.
//
// What differs from the TPU design, and why: the TPU kernel gives each
// (batch, 512-channel block) a sequential walk over 128-step time blocks,
// carrying h in VMEM; its lanes are channels. On the card one thread per
// channel walking all of S would give B*C/256 = 16 blocks at the serve
// shape (B 1, C 4096) for 132 SMs, each thread a serial chain of S
// dependent FMAs. Here the time axis is cut as well, with the recurrence's
// associativity ((A1, H1) then (A2, H2) is (A1 A2, A2 H1 + H2)):
//   - a block owns 32 consecutive channels (one per lane, so every load and
//     store of a warp is 32 neighbouring values) and kWarps chunks of
//     ceil(S / kWarps) steps, one chunk per warp;
//   - walk 1: each lane runs its chunk from h = 0 and keeps the chunk's
//     local h and the product of its a's, in fp32;
//   - the kWarps (product, h) pairs meet in shared memory, and each warp
//     folds those of the chunks before its own into its carry-in, in order;
//   - walk 2: each lane runs its chunk again from its carry-in and writes h.
// So at the serve shape 128 blocks of 512 threads fill the card, a lane's
// serial chain is S / 16 steps, and a ragged S only moves the chunk bounds
// (no padding). Loads are issued kUnroll steps ahead of the FMAs that use
// them, so a lane keeps that many loads in flight. Walk 2 reads a and u a
// second time, mostly from L2.
//
// Bound on an H100 (3.35 TB/s) at the serve path's prefill (recurrentgemma-
// 9b, B 1, S 1000, C 4096, fp32): a and u read once, h written once, 49.2 MB,
// 0.0147 ms; one FMA and one multiply per element are negligible: bytes
// bind. This kernel moves 1.67x those bytes (a and u read twice).
#include "common.cuh"

namespace {

constexpr int kLanes = 32;     // channels per block, one per lane
constexpr int kWarps = 16;     // time chunks per block, one per warp
constexpr int kUnroll = 8;     // steps whose loads are issued together

// Run h <- a_t h + u_t over steps [t0, t1) of one channel (element stride
// c), from h; with WRITE, store each h_t. Returns the last h and multiplies
// the chunk's a's into *prod.
template <typename T, bool WRITE>
__device__ __forceinline__ float walk(const T* __restrict__ a,
                                      const T* __restrict__ u,
                                      T* __restrict__ h_out, int t0, int t1,
                                      size_t c, float h, float* prod) {
  float p = 1.f;
  int t = t0;
  for (; t + kUnroll <= t1; t += kUnroll) {
    float av[kUnroll], uv[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      av[i] = repro::to_float(a[(size_t)(t + i) * c]);
      uv[i] = repro::to_float(u[(size_t)(t + i) * c]);
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      h = fmaf(av[i], h, uv[i]);
      p *= av[i];
      if (WRITE) h_out[(size_t)(t + i) * c] = repro::from_float<T>(h);
    }
  }
  for (; t < t1; ++t) {
    const float av = repro::to_float(a[(size_t)t * c]);
    h = fmaf(av, h, repro::to_float(u[(size_t)t * c]));
    p *= av;
    if (WRITE) h_out[(size_t)t * c] = repro::from_float<T>(h);
  }
  *prod = p;
  return h;
}

template <typename T>
__global__ void __launch_bounds__(kLanes * kWarps)
rglru_fwd(const T* __restrict__ a, const T* __restrict__ u,
          T* __restrict__ h, int s, int c) {
  __shared__ float sm_prod[kWarps][kLanes];   // product of a over a chunk
  __shared__ float sm_h[kWarps][kLanes];      // the chunk's h from h = 0

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ch = blockIdx.x * kLanes + lane;
  const bool live = ch < c;
  const int len = (s + kWarps - 1) / kWarps;
  const int t0 = min(s, warp * len);
  const int t1 = min(s, t0 + len);
  const size_t off = (size_t)blockIdx.y * s * c + (live ? ch : 0);
  const T* ab = a + off;
  const T* ub = u + off;
  T* hb = h + off;

  float prod = 1.f, hl = 0.f;
  if (live) hl = walk<T, false>(ab, ub, hb, t0, t1, (size_t)c, 0.f, &prod);
  sm_prod[warp][lane] = prod;
  sm_h[warp][lane] = hl;
  __syncthreads();

  float carry = 0.f;   // h just before t0
  for (int w = 0; w < warp; ++w)
    carry = fmaf(sm_prod[w][lane], carry, sm_h[w][lane]);
  if (live) walk<T, true>(ab, ub, hb, t0, t1, (size_t)c, carry, &prod);
}

template <typename T>
int launch(const void* a, const void* u, void* h, int b, int s, int c,
           cudaStream_t stream) {
  dim3 grid((c + kLanes - 1) / kLanes, b);
  rglru_fwd<T><<<grid, kLanes * kWarps, 0, stream>>>(
      (const T*)a, (const T*)u, (T*)h, s, c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rglru_scan_launch(const void* a, const void* u, void* h,
                                 int b, int s, int c, int dtype,
                                 void* stream) {
  if (b <= 0 || s <= 0 || c <= 0) return 0;
  if (b > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t strm = (cudaStream_t)stream;
  if (dtype == repro::kFloat32) return launch<float>(a, u, h, b, s, c, strm);
  if (dtype == repro::kBFloat16)
    return launch<__nv_bfloat16>(a, u, h, b, s, c, strm);
  return (int)cudaErrorInvalidValue;
}
