// Mamba2 SSD chunked scan (state-space duality, dual form) on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (_ssd_kernel / ssd_scan_fwd) and the per-chunk cumsum its dispatcher
// (ops.py) computes before it. Same function: per (batch, head) row bh and
// chunk of Q steps, with dacum the inclusive cumsum of da within the chunk,
//   y_i = sum_{j<=i} (C_i . B_j) exp(dacum_i - dacum_j) dt_j x_j
//         + exp(dacum_i) C_i S^T
//   S  <- exp(dacum_end) S + sum_j dt_j exp(dacum_end - dacum_j) x_j^T B_j
// with the state S [P, N] carried in fp32 from chunk to chunk (h_0 = 0). It
// returns y [BH, S, P] and, unlike the TPU kernel, the final S [BH, P, N],
// which the serve path keeps for decode. Row bh reads B/C row bh / g (g = 1
// for the reference's layout, g = H when the model passes B/C once per batch
// row: mamba2 has one B/C group, so the 64 heads share one copy).
//
// What differs from the TPU design, and why:
// - The TPU kernel holds a whole chunk in VMEM (B and C [256, 128] fp32,
//   128 KB each, the [256, 256] score matrix, the state). A block here has
//   at most 227 KB of shared memory, so the chunk is tiled: 64-row query
//   tiles of C against streamed 64-row key tiles of B and x, with only the
//   64 x 64 masked score tile and the state slice in shared memory. Key
//   tiles above the diagonal are never visited.
// - Grid (BH, P / 32): the 32-column slices of the head dim are
//   independent (row p of S and column p of y depend only on column p of x
//   and row p of S), so at batch 1 the 64 heads of mamba2 give 128 blocks
//   for the 132 SMs, at the cost of computing C.B^T once per slice. Each
//   block walks the chunks in order itself (the TPU's sequential grid axis).
// - The ragged last chunk (S = 1000 with Q = 256 leaves 232) is masked,
//   which equals the reference model's zero-dt padding; the Pallas grid
//   floor-divides and never writes such a tail.
// - dacum is summed in fp64 (one warp, per chunk) and each decay exponent
//   dacum_i - dacum_j is taken in fp64 before the fp32 exp. With random
//   weights da is -0.3 to -30 per step, so the cumsum reaches thousands,
//   where an fp32 difference of two cumsums carries an absolute error of
//   an ulp of thousands into every near-diagonal decay exponent; the fp64
//   difference keeps each decay at fp32 accuracy, as the sequential
//   recurrence (the plain version) computes it step by step. The
//   mask is applied before the exp (above the diagonal the exponent is
//   large and positive: exp(li) * 0 would be inf * 0 = NaN).
// - Products are fp32 FMAs from shared memory for fp32 and bf16 inputs
//   alike (bf16 is widened on load): no TF32, so the serve path's fp32
//   prefill keeps full precision, as the reference's does.
//
// Bound on an H100 at the serve path's prefill (mamba2-1.3b, S = 1000,
// BH = 64, P = 64, N = 128, Q = 256, fp32, B/C shared by the 64 heads):
// the lower-triangle products need 2 (Q(Q+1)/2 (N/64 + P) + 2 Q N P) flop
// per (bh, chunk) (no C.S^T in the first chunk), 2.9 GFLOP in all,
// 0.043 ms at the 67 TFLOP/s fp32 (non-tensor) peak, against 36 MB of
// inputs and outputs (0.011 ms at 3.35 TB/s): operations bind. This
// simple kernel recomputes C.B^T in every block (64 heads x 2 slices) and
// reads two shared floats per FMA, so it is bound by its shared-memory
// reads; sharing the scores across heads and tensor-core (mma/wgmma) tiles
// are later work.
#include "common.cuh"

namespace {

constexpr int kT = 64;         // rows of a query or key tile
constexpr int kPT = 32;        // head-dim columns per block
constexpr int kThreads = 256;  // 16 x 16
constexpr size_t kMaxSmem = 232448;

template <int NW>
size_t ssd_smem_bytes(int q) {
  return (size_t)q * (sizeof(double) + 2 * sizeof(float)) +
         (size_t)(2 * kT * (NW + 1) + kT * (kPT + 1) + kT * (kT + 1) +
                  kPT * (NW + 1)) * sizeof(float);
}

// dac[i] = da[0] + ... + da[i] in fp64 (one warp: each lane sums a
// contiguous segment, then a shuffle scan of the segment sums), dts = dt
template <typename T>
__device__ void chunk_scan(const T* __restrict__ da, const T* __restrict__ dt,
                           int qc, double* dac, float* dts) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = (qc + 31) / 32;
    const int lo = min(lane * per, qc);
    const int hi = min(lo + per, qc);
    double run = 0.0;
    for (int i = lo; i < hi; ++i) run += (double)repro::to_float(da[i]);
    double incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    double acc = incl - run;
    for (int i = lo; i < hi; ++i) {
      acc += (double)repro::to_float(da[i]);
      dac[i] = acc;
    }
  }
  for (int i = threadIdx.x; i < qc; i += kThreads)
    dts[i] = repro::to_float(dt[i]);
}

// dst [kT][NW+1] <- rows row0.. of src [*, n]; rows past nrows and columns
// past n read as zero
template <typename T, int NW>
__device__ void load_bc(float* dst, const T* __restrict__ src, int row0,
                        int nrows, int n) {
  for (int idx = threadIdx.x; idx < kT * NW; idx += kThreads) {
    const int r = idx / NW;
    const int k = idx - r * NW;
    float v = 0.f;
    if (r < nrows && k < n) v = repro::to_float(src[(size_t)(row0 + r) * n + k]);
    dst[r * (NW + 1) + k] = v;
  }
}

// dst [kT][kPT+1] <- x[row0 + r][p0 + c] (times w[r] when w is given); rows
// past nrows and columns past p read as zero
template <typename T>
__device__ void load_x(float* dst, const T* __restrict__ xb, int row0,
                       int nrows, int p0, int p, const float* w) {
  for (int idx = threadIdx.x; idx < kT * kPT; idx += kThreads) {
    const int r = idx / kPT;
    const int c = idx - r * kPT;
    float v = 0.f;
    if (r < nrows && p0 + c < p) {
      v = repro::to_float(xb[(size_t)(row0 + r) * p + p0 + c]);
      if (w != nullptr) v *= w[r];
    }
    dst[r * (kPT + 1) + c] = v;
  }
}

template <typename T, int NW>
__global__ void __launch_bounds__(kThreads)
ssd_fwd(const T* __restrict__ x, const T* __restrict__ bm,
        const T* __restrict__ cm, const T* __restrict__ dt,
        const T* __restrict__ da, T* __restrict__ y, float* __restrict__ st,
        int s, int p, int n, int q, int g) {
  constexpr int NB = NW / 16;   // state columns per thread
  extern __shared__ double smem_d[];
  double* dac = smem_d;                       // [q]   chunk cumsum of da
  float* dts = (float*)(dac + q);             // [q]   dt
  float* wts = dts + q;                       // [q]   dt * decay to chunk end
  float* Cs = wts + q;                        // [kT][NW+1]
  float* Bs = Cs + kT * (NW + 1);             // [kT][NW+1]
  float* Xs = Bs + kT * (NW + 1);             // [kT][kPT+1]
  float* Ps = Xs + kT * (kPT + 1);            // [kT][kT+1]   masked scores
  float* Ss = Ps + kT * (kT + 1);             // [kPT][NW+1]  state slice

  const int bh = blockIdx.x;
  const int p0 = blockIdx.y * kPT;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;      // rows ty + 16 a
  const int tx = tid & 15;      // columns tx + 16 b
  const T* xb = x + (size_t)bh * s * p;
  const T* bb = bm + (size_t)(bh / g) * s * n;
  const T* cb = cm + (size_t)(bh / g) * s * n;
  T* yb = y + (size_t)bh * s * p;

  for (int i = tid; i < kPT * (NW + 1); i += kThreads) Ss[i] = 0.f;

  for (int c0 = 0; c0 < s; c0 += q) {
    const int qc = min(q, s - c0);
    __syncthreads();   // the previous chunk's reads and state writes done
    chunk_scan<T>(da + (size_t)bh * s + c0, dt + (size_t)bh * s + c0, qc,
                  dac, dts);
    __syncthreads();
    const double dend = dac[qc - 1];
    for (int i = tid; i < qc; i += kThreads)
      wts[i] = dts[i] * expf((float)(dend - dac[i]));

    // ---- y, one 64-row query tile at a time
    for (int i0 = 0; i0 < qc; i0 += kT) {
      __syncthreads();   // Cs / Bs / Xs / Ps free, wts written
      load_bc<T, NW>(Cs, cb, c0 + i0, min(kT, qc - i0), n);
      __syncthreads();

      // the state entering the chunk: exp(dacum_i) C_i . S_p
      float acc[4][2];
      {
        float t[4][2];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 2; ++b) t[a][b] = 0.f;
#pragma unroll 8
        for (int k = 0; k < NW; ++k) {
          float cv[4], sv[2];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = Cs[(ty + 16 * a) * (NW + 1) + k];
#pragma unroll
          for (int b = 0; b < 2; ++b) sv[b] = Ss[(tx + 16 * b) * (NW + 1) + k];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 2; ++b) t[a][b] = fmaf(cv[a], sv[b], t[a][b]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + ty + 16 * a;
          const float e = i < qc ? expf((float)dac[i]) : 0.f;
#pragma unroll
          for (int b = 0; b < 2; ++b) acc[a][b] = t[a][b] * e;
        }
      }

      // within the chunk: key tiles up to the diagonal one
      for (int j0 = 0; j0 <= i0; j0 += kT) {
        __syncthreads();   // previous Bs / Xs / Ps reads done
        load_bc<T, NW>(Bs, bb, c0 + j0, min(kT, qc - j0), n);
        load_x<T>(Xs, xb, c0 + j0, min(kT, qc - j0), p0, p, nullptr);
        __syncthreads();
        float sc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) sc[a][b] = 0.f;
#pragma unroll 8
        for (int k = 0; k < NW; ++k) {
          float cv[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = Cs[(ty + 16 * a) * (NW + 1) + k];
#pragma unroll
          for (int b = 0; b < 4; ++b) bv[b] = Bs[(tx + 16 * b) * (NW + 1) + k];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) sc[a][b] = fmaf(cv[a], bv[b], sc[a][b]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + ty + 16 * a;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int j = j0 + tx + 16 * b;
            float v = 0.f;   // mask before the exp: above the diagonal
            if (j <= i && i < qc)   // the exponent is large and positive
              v = sc[a][b] * expf((float)(dac[i] - dac[j])) * dts[j];
            Ps[(ty + 16 * a) * (kT + 1) + tx + 16 * b] = v;
          }
        }
        __syncthreads();
#pragma unroll 8
        for (int jj = 0; jj < kT; ++jj) {
          float pv[4], xv[2];
#pragma unroll
          for (int a = 0; a < 4; ++a) pv[a] = Ps[(ty + 16 * a) * (kT + 1) + jj];
#pragma unroll
          for (int b = 0; b < 2; ++b) xv[b] = Xs[jj * (kPT + 1) + tx + 16 * b];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 2; ++b) acc[a][b] = fmaf(pv[a], xv[b], acc[a][b]);
        }
      }

#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
        if (i >= qc) continue;
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int col = p0 + tx + 16 * b;
          if (col < p)
            yb[(size_t)(c0 + i) * p + col] = repro::from_float<T>(acc[a][b]);
        }
      }
    }

    // ---- state: S <- exp(dacum_end) S + sum_j w_j x_j^T B_j
    float sacc[2][NB];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < NB; ++b) sacc[a][b] = 0.f;
    for (int j0 = 0; j0 < qc; j0 += kT) {
      __syncthreads();   // previous Bs / Xs reads done
      load_bc<T, NW>(Bs, bb, c0 + j0, min(kT, qc - j0), n);
      load_x<T>(Xs, xb, c0 + j0, min(kT, qc - j0), p0, p, wts + j0);
      __syncthreads();
#pragma unroll 4
      for (int jj = 0; jj < kT; ++jj) {
        float xv[2], bv[NB];
#pragma unroll
        for (int a = 0; a < 2; ++a) xv[a] = Xs[jj * (kPT + 1) + ty + 16 * a];
#pragma unroll
        for (int b = 0; b < NB; ++b) bv[b] = Bs[jj * (NW + 1) + tx + 16 * b];
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < NB; ++b) sacc[a][b] = fmaf(xv[a], bv[b], sacc[a][b]);
      }
    }
    const float gdec = expf((float)dend);
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        float* sv = &Ss[(ty + 16 * a) * (NW + 1) + tx + 16 * b];
        *sv = gdec * *sv + sacc[a][b];
      }
  }

  __syncthreads();
  float* sb = st + (size_t)bh * p * n;
  for (int idx = tid; idx < kPT * NW; idx += kThreads) {
    const int r = idx / NW;
    const int k = idx - r * NW;
    if (p0 + r < p && k < n) sb[(size_t)(p0 + r) * n + k] = Ss[r * (NW + 1) + k];
  }
}

template <typename T, int NW>
int launch(const void* x, const void* b, const void* c, const void* dt,
           const void* da, void* y, void* st, int bh, int s, int p, int n,
           int chunk, int g, cudaStream_t stream) {
  const int q = min(chunk, s);
  const size_t smem = ssd_smem_bytes<NW>(q);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_fwd<T, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(bh, (p + kPT - 1) / kPT);
  ssd_fwd<T, NW><<<grid, kThreads, smem, stream>>>(
      (const T*)x, (const T*)b, (const T*)c, (const T*)dt, (const T*)da,
      (T*)y, (float*)st, s, p, n, q, g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_n(const void* x, const void* b, const void* c, const void* dt,
             const void* da, void* y, void* st, int bh, int s, int p, int n,
             int chunk, int g, cudaStream_t stream) {
  if (n <= 64)
    return launch<T, 64>(x, b, c, dt, da, y, st, bh, s, p, n, chunk, g,
                         stream);
  if (n <= 128)
    return launch<T, 128>(x, b, c, dt, da, y, st, bh, s, p, n, chunk, g,
                          stream);
  if (n <= 256)
    return launch<T, 256>(x, b, c, dt, da, y, st, bh, s, p, n, chunk, g,
                          stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int ssd_scan_launch(const void* x, const void* b, const void* c,
                               const void* dt, const void* da, void* y,
                               void* st, int bh, int s, int p, int n,
                               int chunk, int g, int dtype, void* stream) {
  if (bh <= 0 || p <= 0) return 0;
  if (s < 0 || n <= 0 || chunk <= 0 || g <= 0 || bh % g != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t strm = (cudaStream_t)stream;
  if (dtype == repro::kFloat32)
    return launch_n<float>(x, b, c, dt, da, y, st, bh, s, p, n, chunk, g,
                           strm);
  if (dtype == repro::kBFloat16)
    return launch_n<__nv_bfloat16>(x, b, c, dt, da, y, st, bh, s, p, n,
                                   chunk, g, strm);
  return (int)cudaErrorInvalidValue;
}
