// Flash-attention backward on Hopper: dq, dk and dv of causal / sliding-
// window GQA attention from the forward's row log-sum-exp, the softmax
// recomputed tile by tile (FlashAttention-2's split).
//
// The TPU package has no counterpart: its Pallas forward
// (src/repro/kernels/flash_attention/kernel.py, _fa_kernel) has no VJP, and
// the reference trains through sdpa_ref, differentiated by XLA. The port
// trains through its forward kernel (flash_attention.cu), so the gradient
// has to come from a kernel too. Same function as autograd through the
// plain version: q [B,S,Hq,dh], k/v [B,Skv,Hkv,dh], o and dO like q, lse
// [B,Hq,S] fp32 (natural log of sum_j exp(scale q_i.k_j) over the visible
// keys); query head h reads KV head h / (Hq/Hkv); key j is visible to
// query i iff (!causal || j <= i) && (!window || j > i - window); scale is
// the true dh^-0.5. With s = scale q.k, P = exp(s - lse), dP = dO V^T and
// D = rowsum(dO o O):
//   dV = P^T dO,  dS = P o (dP - D),  dK = scale dS^T Q,  dQ = scale dS K.
// dk and dv of a KV head sum over its g query heads (g = 7 at qwen2-0.5b).
//
// Bound on an H100. The function's work is 10 dh Hq flop per visible
// (query, key) pair and batch: the four products above and S = Q K^T once.
// At qwen2-0.5b's train shape (B 8, S 2048, 14/2 heads of 64, causal, bf16)
// that is 150 GFLOP: 0.15 ms at 989 TFLOP/s, against 117 MB of q, k, v, o,
// dO, dq, dk, dv (0.035 ms at 3.35 TB/s): operations bind.
//
// Design: simple and right first (a later PR may move the products to the
// tensor cores). Three kernels, no atomics, so repeats are bit-identical:
// - fa_bwd_delta: D per row in fp32, one warp a row.
// - fa_bwd_dkdv: one block per (64-key tile, batch, KV head). It holds K and
//   V, and the dK / dV accumulators in registers, and loops over the group's
//   query heads and the query tiles that see the key tile, recomputing S and
//   dP there. Key tile 0 is seen by every query tile under a causal mask, so
//   the grid's slow axis runs over key tiles, heaviest first.
// - fa_bwd_dq: one block per (64-row query tile, batch, query head), looping
//   over the key tiles its rows see, heaviest tiles first.
// Every product is fp32 FMA on fp32 copies of the tiles in shared memory
// (bf16 inputs are widened as they are staged), so the fp32 route is fp32-
// accurate and bf16 adds no rounding inside the kernel. A thread computes a
// 4 x 4 block of each 64 x 64 score tile (rows ty + 16 i, keys tx + 16 j) and
// a 4 x (dh / 16) block of each output; tile rows are padded to an odd pitch
// (Q, dO, K, V) or to 80 (P, dS), so that the 16 rows a warp reads at once
// lie on different banks. Rows past S or Skv and head dims past dh are
// staged as zeros and masked; tiles are loaded synchronously.
#include "common.cuh"

namespace {

constexpr int kB = 64;          // rows of a query tile and keys of a key tile
constexpr int kThreads = 256;   // 16 x 16: tx = tid % 16, ty = tid / 16
constexpr int kLDS = kB + 16;   // pitch of the P and dS tiles

template <int HD>
struct BwdCfg {
  static constexpr int LD = HD + 1;     // pitch of the Q, dO, K and V tiles
  static constexpr int ND = HD / 16;    // head dims of an output a thread owns
  static constexpr size_t tile = sizeof(float) * kB * LD;
  static constexpr size_t stile = sizeof(float) * kB * kLDS;
  // dkdv: K, V, Q, dO, P, dS, lse, D; dq: Q, dO, K, V, dS, lse, D
  static constexpr size_t smem_dkdv = 4 * tile + 2 * stile + 2 * sizeof(float) * kB;
  static constexpr size_t smem_dq = 4 * tile + stile + 2 * sizeof(float) * kB;
  static_assert(smem_dkdv <= 232448, "shared memory of one block");
};

__device__ __forceinline__ bool visible(int i, int j, int sq, int skv,
                                        int causal, int window) {
  return i < sq && j < skv && (!causal || j <= i) &&
         (window <= 0 || j > i - window);
}

// rows [row0, row0 + kB) of a [rows_total, row_stride] source, dims [0, dh),
// as fp32 into a [kB][HD + 1] tile; zeros past either edge
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, const T* src, int row0,
                                      int rows_total, int row_stride, int dh) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kB; r += kThreads / 32) {
    const bool in = row0 + r < rows_total;
    const T* s = src + (size_t)(in ? row0 + r : 0) * row_stride;
#pragma unroll
    for (int d = lane; d < HD; d += 32)
      dst[r * BwdCfg<HD>::LD + d] =
          (in && d < dh) ? repro::to_float<T>(s[d]) : 0.f;
  }
}

// acc[i][j] = sum_d A[ty + 16 i][d] B[tx + 16 j][d] over two staged tiles
template <int HD>
__device__ __forceinline__ void rows_dot(const float* A, const float* B,
                                         float (&acc)[4][4]) {
  constexpr int LD = BwdCfg<HD>::LD;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const float* a0 = A + ty * LD;
  const float* b0 = B + tx * LD;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = a0[16 * i * LD + d];
      b[i] = b0[16 * i * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[j][i] += sum_r S[r][ty + 16 j] M[r][tx + 16 i]: (P^T dO or dS^T Q) for
// the thread's keys ty + 16 j and head dims tx + 16 i
template <int HD>
__device__ __forceinline__ void cols_dot(const float* S, const float* M,
                                         float (&acc)[4][BwdCfg<HD>::ND]) {
  constexpr int LD = BwdCfg<HD>::LD, ND = BwdCfg<HD>::ND;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int r = 0; r < kB; ++r) {
    float a[4], m[ND];
#pragma unroll
    for (int j = 0; j < 4; ++j) a[j] = S[r * kLDS + ty + 16 * j];
#pragma unroll
    for (int i = 0; i < ND; ++i) m[i] = M[r * LD + tx + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < ND; ++i) acc[j][i] = fmaf(a[j], m[i], acc[j][i]);
  }
}

// acc[i][j] += sum_c S[ty + 16 i][c] K[c][tx + 16 j]: dS K for the thread's
// rows ty + 16 i and head dims tx + 16 j
template <int HD>
__device__ __forceinline__ void rows_mat(const float* S, const float* K,
                                         float (&acc)[4][BwdCfg<HD>::ND]) {
  constexpr int LD = BwdCfg<HD>::LD, ND = BwdCfg<HD>::ND;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int c = 0; c < kB; ++c) {
    float a[4], m[ND];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = S[(ty + 16 * i) * kLDS + c];
#pragma unroll
    for (int j = 0; j < ND; ++j) m[j] = K[c * LD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[i][j] = fmaf(a[i], m[j], acc[i][j]);
  }
}

// P and dS of one (query tile, key tile) pair from the staged Q, dO, K, V,
// lse and D: P into Ps (when given) and dS into dSs, each [kB][kLDS]
template <int HD>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs,
                                       const float* Ks, const float* Vs,
                                       const float* Ls, const float* Ds,
                                       float* Ps, float* dSs, int q0, int k0,
                                       int sq, int skv, int causal,
                                       int window, float scale) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][4], dp[4][4];
  rows_dot<HD>(Qs, Ks, s);
  rows_dot<HD>(dOs, Vs, dp);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const float p = visible(q0 + r, k0 + c, sq, skv, causal, window)
                          ? expf(s[i][j] * scale - Ls[r])
                          : 0.f;
      if (Ps != nullptr) Ps[r * kLDS + c] = p;
      dSs[r * kLDS + c] = p * (dp[i][j] - Ds[r]);
    }
  }
}

// lse and D of rows [q0, q0 + kB) of one (batch, head) row block
__device__ __forceinline__ void stage_rows_stats(float* Ls, float* Ds,
                                                 const float* lse,
                                                 const float* delta, int q0,
                                                 int sq) {
  for (int r = threadIdx.x; r < kB; r += kThreads) {
    const bool in = q0 + r < sq;
    Ls[r] = in ? lse[q0 + r] : INFINITY;
    Ds[r] = in ? delta[q0 + r] : 0.f;
  }
}

// D[b, h, i] = sum_d dO[b, i, h, d] O[b, i, h, d]: one warp a row
template <typename T>
__global__ void __launch_bounds__(kThreads)
fa_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, int rows, int sq, int hq, int dh) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* orow = o + (size_t)row * dh;
  const T* drow = dout + (size_t)row * dh;
  float acc = 0.f;
  for (int d = lane; d < dh; d += 32)
    acc = fmaf(repro::to_float<T>(drow[d]), repro::to_float<T>(orow[d]), acc);
  acc = repro::warp_sum(acc);
  if (lane == 0) {
    const int h = row % hq;
    const int bi = row / hq;       // b * sq + i
    const int b = bi / sq, i = bi - b * sq;
    delta[((size_t)b * hq + h) * sq + i] = acc;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int sq, int skv, int hq,
            int hkv, int dh, int causal, int window, float scale) {
  using C = BwdCfg<HD>;
  constexpr int ND = C::ND;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + kB * C::LD;
  float* Qs = Vs + kB * C::LD;
  float* dOs = Qs + kB * C::LD;
  float* Ps = dOs + kB * C::LD;
  float* dSs = Ps + kB * kLDS;
  float* Ls = dSs + kB * kLDS;
  float* Ds = Ls + kB;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const int b = blockIdx.x / hkv, kvh = blockIdx.x - b * hkv;
  const int k0 = blockIdx.y * kB;
  const int g = hq / hkv;
  const size_t kv_off = ((size_t)b * skv * hkv + kvh) * dh;
  stage<T, HD>(Ks, k + kv_off, k0, skv, hkv * dh, dh);
  stage<T, HD>(Vs, v + kv_off, k0, skv, hkv * dh, dh);

  // query rows that see a key of this tile: i >= k0 (causal) and i <
  // (last key) + window (windowed)
  int q_begin = causal ? k0 : 0;
  q_begin = (q_begin / kB) * kB;
  int q_end = sq;
  if (window > 0) q_end = min(sq, min(k0 + kB, skv) - 1 + window);

  float dk_acc[4][ND], dv_acc[4][ND];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < ND; ++i) dk_acc[j][i] = dv_acc[j][i] = 0.f;

  for (int hh = 0; hh < g; ++hh) {
    const int h = kvh * g + hh;
    const size_t q_off = ((size_t)b * sq * hq + h) * dh;
    const size_t r_off = ((size_t)b * hq + h) * sq;
    for (int q0 = q_begin; q0 < q_end; q0 += kB) {
      __syncthreads();   // the previous tile's readers are done (and K, V in)
      stage<T, HD>(Qs, q + q_off, q0, sq, hq * dh, dh);
      stage<T, HD>(dOs, dout + q_off, q0, sq, hq * dh, dh);
      stage_rows_stats(Ls, Ds, lse + r_off, delta + r_off, q0, sq);
      __syncthreads();
      scores<HD>(Qs, dOs, Ks, Vs, Ls, Ds, Ps, dSs, q0, k0, sq, skv, causal,
                 window, scale);
      __syncthreads();
      cols_dot<HD>(Ps, dOs, dv_acc);
      cols_dot<HD>(dSs, Qs, dk_acc);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int kj = k0 + ty + 16 * j;
    if (kj >= skv) continue;
    const size_t row = kv_off + (size_t)kj * hkv * dh;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      const int d = tx + 16 * i;
      if (d < dh) {
        dk[row + d] = repro::from_float<T>(dk_acc[j][i] * scale);
        dv[row + d] = repro::from_float<T>(dv_acc[j][i]);
      }
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int sq, int skv, int hq, int hkv, int dh,
          int causal, int window, float scale) {
  using C = BwdCfg<HD>;
  constexpr int ND = C::ND;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + kB * C::LD;
  float* Ks = dOs + kB * C::LD;
  float* Vs = Ks + kB * C::LD;
  float* dSs = Vs + kB * C::LD;
  float* Ls = dSs + kB * kLDS;
  float* Ds = Ls + kB;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const int b = blockIdx.x / hq, h = blockIdx.x - b * hq;
  const int kvh = h / (hq / hkv);
  const int nq = (sq + kB - 1) / kB;
  // the last query tiles see the most keys under a causal mask: first
  const int q0 = (causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y) * kB;
  const size_t q_off = ((size_t)b * sq * hq + h) * dh;
  const size_t r_off = ((size_t)b * hq + h) * sq;
  const size_t kv_off = ((size_t)b * skv * hkv + kvh) * dh;
  stage<T, HD>(Qs, q + q_off, q0, sq, hq * dh, dh);
  stage<T, HD>(dOs, dout + q_off, q0, sq, hq * dh, dh);
  stage_rows_stats(Ls, Ds, lse + r_off, delta + r_off, q0, sq);

  // keys that a row of this tile sees: j <= last row (causal) and j > q0 -
  // window (windowed)
  int kv_end = skv;
  if (causal) kv_end = min(kv_end, min(q0 + kB, sq));
  int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  kv_begin = (kv_begin / kB) * kB;

  float dq_acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < ND; ++j) dq_acc[i][j] = 0.f;

  for (int k0 = kv_begin; k0 < kv_end; k0 += kB) {
    __syncthreads();   // the previous tile's readers are done (and Q, dO in)
    stage<T, HD>(Ks, k + kv_off, k0, skv, hkv * dh, dh);
    stage<T, HD>(Vs, v + kv_off, k0, skv, hkv * dh, dh);
    __syncthreads();
    scores<HD>(Qs, dOs, Ks, Vs, Ls, Ds, nullptr, dSs, q0, k0, sq, skv,
               causal, window, scale);
    __syncthreads();
    rows_mat<HD>(dSs, Ks, dq_acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= sq) continue;
    T* row = dq + q_off + (size_t)qi * hq * dh;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = tx + 16 * j;
      if (d < dh) row[d] = repro::from_float<T>(dq_acc[i][j] * scale);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int b, int sq, int skv, int hq, int hkv,
           int dh, int causal, int window, float scale, cudaStream_t stream) {
  using C = BwdCfg<HD>;
  cudaError_t e = cudaFuncSetAttribute(
      fa_bwd_dkdv<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::smem_dkdv);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(fa_bwd_dq<T, HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)C::smem_dq);
  if (e != cudaSuccess) return (int)e;
  const int rows = b * sq * hq;
  const int rows_per_block = kThreads / 32;
  fa_bwd_delta<T><<<(rows + rows_per_block - 1) / rows_per_block, kThreads, 0,
                    stream>>>((const T*)o, (const T*)dout, delta, rows, sq, hq,
                              dh);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (skv > 0) {
    const dim3 grid_kv(b * hkv, (skv + kB - 1) / kB);
    fa_bwd_dkdv<T, HD><<<grid_kv, kThreads, C::smem_dkdv, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
        (T*)dk, (T*)dv, sq, skv, hq, hkv, dh, causal, window, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid_q(b * hq, (sq + kB - 1) / kB);
  fa_bwd_dq<T, HD><<<grid_q, kThreads, C::smem_dq, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, sq, skv, hq, hkv, dh, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, float* delta, void* dq,
              void* dk, void* dv, int b, int sq, int skv, int hq, int hkv,
              int dh, int causal, int window, float scale, cudaStream_t s) {
  if (dh <= 64)
    return launch<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, skv,
                         hq, hkv, dh, causal, window, scale, s);
  if (dh <= 128)
    return launch<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq,
                          skv, hq, hkv, dh, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dq, dk, dv (like q, k, v) of the attention the forward computed, from q,
// k, v, its output o, the output's gradient dout and the forward's lse
// [B,Hq,S]; delta is [B,Hq,S] fp32 scratch (D, written here). dh <= 128.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int b, int sq, int skv, int hq, int hkv, int dh, int causal,
    int window, float scale, int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || hq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || dh <= 0 || skv < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == repro::kFloat32)
    return launch_dh<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq,
                            skv, hq, hkv, dh, causal, window, scale, s);
  if (dtype == repro::kBFloat16)
    return launch_dh<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                    b, sq, skv, hq, hkv, dh, causal, window,
                                    scale, s);
  return (int)cudaErrorInvalidValue;
}
