// Flash-attention forward (prefill) on Hopper: causal / sliding-window GQA
// attention with an fp32 online softmax.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_fa_kernel / flash_attention_fwd). Same function: q [B,S,Hq,dh] against
// k/v [B,Skv,Hkv,dh]; query head h reads KV head h / (Hq/Hkv); key j is
// visible to query i iff (!causal || j <= i) && (!window || j > i - window);
// the scale is the true dh^-0.5, whatever width the kernel is instantiated
// at (head dims below the width read as zeros, which is exact).
//
// What differs from the TPU design: the TPU kernel runs a sequential kv grid
// axis and keeps (m, l, acc) in VMEM scratch, with a grid that floor-divides
// S (ragged tails are never written). Here one block of 256 threads owns a
// 64-row query tile of one (batch, head) and loops over 64-row K/V tiles
// itself, holding m, l and its share of acc in registers; tiles above the
// diagonal or left of the window are never visited, and ragged query and
// key tails are masked. The 16x16 thread grid gives each thread 4 query
// rows x 4 key columns of the score tile (and 4 rows x HD/16 output
// columns); row reductions are half-warp shuffles. Q, the current K or V
// tile and the probability tile sit in shared memory as fp32 with one pad
// column, so the strided reads are free of bank conflicts. Products are
// fp32 FMAs for both fp32 and bf16 inputs (bf16 is widened on load): no
// TF32, so fp32 inputs keep full precision.
//
// Bound on an H100 at the serve path's prefill (S = 1000, Hq = 14, dh = 64,
// fp32, causal): 4 * S(S+1)/2 * dh * Hq = 1.79 GFLOP per layer, 27 us at the
// 67 TFLOP/s fp32 (non-tensor) peak, against 8.2 MB of q/k/v/o (2.4 us):
// operations bind. This simple kernel is bound by its shared-memory reads
// (two loads per FMA); tensor-core (mma/wgmma) tiles are later work.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key rows per K/V tile
constexpr int kThreads = 256;  // 16 x 16

template <int HD>
constexpr size_t fa_smem_bytes() {
  return (size_t)(2 * kBQ * (HD + 1) + kBQ * (kBK + 1)) * sizeof(float);
}

template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int row0, int nrows, int rows_total,
                                          int row_stride, int dh) {
  // dst [nrows][HD+1] <- src rows row0.. (row r at src + r * row_stride);
  // rows past rows_total and columns past dh read as zero
  for (int idx = threadIdx.x; idx < nrows * HD; idx += kThreads) {
    const int r = idx / HD;
    const int d = idx - r * HD;
    const int gr = row0 + r;
    float x = 0.f;
    if (gr < rows_total && d < dh)
      x = repro::to_float(src[(size_t)gr * row_stride + d]);
    dst[r * (HD + 1) + d] = x;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
fa_fwd(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, T* __restrict__ o, int sq, int skv, int hq,
       int hkv, int dh, int causal, int window, float scale) {
  using repro::half_warp_max;
  using repro::half_warp_sum;
  constexpr int NC = HD / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                       // [kBQ][HD+1]
  float* KVs = Qs + kBQ * (HD + 1);       // [kBK][HD+1], K then V
  float* Ps = KVs + kBK * (HD + 1);       // [kBQ][kBK+1]

  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int h = bh - b * hq;
  const int kvh = h / (hq / hkv);
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;      // rows ty + 16 i
  const int tx = tid & 15;      // columns tx + 16 j

  // [B,S,H,dh] rows of one head are H*dh apart
  const T* qb = q + ((size_t)b * sq * hq + h) * dh;
  const T* kb = k + ((size_t)b * skv * hkv + kvh) * dh;
  const T* vb = v + ((size_t)b * skv * hkv + kvh) * dh;
  load_tile<T, HD>(Qs, qb, q0, kBQ, sq, hq * dh, dh);

  // visible key range of this query tile
  int kv_end = skv;
  if (causal) kv_end = min(kv_end, q0 + kBQ);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q0 - window + 1);
  kv_begin = (kv_begin / kBK) * kBK;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    __syncthreads();   // Qs ready / previous V and P reads done
    load_tile<T, HD>(KVs, kb, k0, kBK, skv, hkv * dh, dh);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = KVs[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        bool ok = kj < skv;
        if (causal) ok = ok && kj <= qi;
        if (window > 0) ok = ok && kj > qi - window;
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
      mt = half_warp_max(mt);
      const float mn = fmaxf(m[i], mt);
      const bool none = mn == -INFINITY;   // nothing visible to this row yet
      const float alpha = none ? 1.f : expf(m[i] - mn);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = none ? 0.f : expf(s[i][j] - mn);
        Ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = p;
        ps += p;
      }
      ps = half_warp_sum(ps);
      l[i] = l[i] * alpha + ps;
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();   // P written, K reads done
    load_tile<T, HD>(KVs, vb, k0, kBK, skv, hkv * dh, dh);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float vv = KVs[kk * (HD + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

  T* ob = o + ((size_t)b * sq * hq + h) * dh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int d = tx + 16 * j;
      if (d < dh)
        ob[(size_t)qi * hq * dh + d] = repro::from_float<T>(acc[i][j] / li);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int sq, int skv, int hq, int hkv, int dh, int causal, int window,
           float scale, cudaStream_t stream) {
  const size_t smem = fa_smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      fa_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((sq + kBQ - 1) / kBQ, b * hq);
  fa_fwd<T, HD><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, sq, skv, hq, hkv, dh,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* o, int b,
              int sq, int skv, int hq, int hkv, int dh, int causal,
              int window, float scale, cudaStream_t s) {
  if (dh <= 64)
    return launch<T, 64>(q, k, v, o, b, sq, skv, hq, hkv, dh, causal, window,
                         scale, s);
  if (dh <= 128)
    return launch<T, 128>(q, k, v, o, b, sq, skv, hq, hkv, dh, causal,
                          window, scale, s);
  if (dh <= 256)
    return launch<T, 256>(q, k, v, o, b, sq, skv, hq, hkv, dh, causal,
                          window, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int sq,
                                      int skv, int hq, int hkv, int dh,
                                      int causal, int window, float scale,
                                      int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || hq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || dh <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == repro::kFloat32)
    return launch_dh<float>(q, k, v, o, b, sq, skv, hq, hkv, dh, causal,
                            window, scale, s);
  if (dtype == repro::kBFloat16)
    return launch_dh<__nv_bfloat16>(q, k, v, o, b, sq, skv, hq, hkv, dh,
                                    causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
