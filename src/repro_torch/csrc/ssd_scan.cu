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
// Bound on an H100 at the serve path's prefill (mamba2-1.3b, S = 1000,
// BH = 64, P = 64, N = 128, Q = 256, fp32, B/C shared by the 64 heads):
// the lower-triangle products need 2 (Q(Q+1)/2 (N/64 + P) + 2 Q N P) flop
// per (bh, chunk) (no C.S^T in the first chunk), 2.9 GFLOP in all. On this
// route (3xTF32 on the tensor cores, below) that is 8.7 GFLOP at 495 TFLOP/s,
// 0.0175 ms, against 36 MB of inputs and outputs (0.011 ms at 3.35 TB/s);
// on fp32 FMAs it would be 0.043 ms at 67 TFLOP/s.
//
// Design: the SSD algorithm's own decomposition (arXiv:2405.21060, sec. 6),
// in three launches that run over (row or head, chunk, tile) at once; only
// the passing of the [P, N] state from chunk to chunk is sequential.
//   1. ssd_chunk: (a) the scores C_c B_c^T of each chunk, once per B/C row
//      (shared by the g heads that read it), the 64 x 64 tiles on or below
//      the diagonal only, into a [rows, chunks, Q, Q] buffer (1 MB at the
//      serve shape); (b) each chunk's own state contribution
//      sum_j w_j x_j^T B_j, w_j = dt_j exp(dacum_end - dacum_j), per (head,
//      chunk, 64 x 64 tile of [P, N]), and exp(dacum_end).
//   2. ssd_pass: per (head, p, n), the scan over chunks: the state entering
//      chunk c replaces chunk c's contribution in place, and the last state
//      is the output state.
//   3. ssd_out: per (head, chunk, 64-row tile, 64-column tile of P),
//      exp(dacum_i) C_i S_c^T from the entering state, then the masked,
//      decayed scores times x, up to the diagonal.
// Every product is a 64 x 64 block tile, 8 warps of 16 x 32, over slabs of
// 32 along the reduction, staged in shared memory and fed to
// mma.sync.m16n8k8 TF32; the next slab's global loads are in flight while
// this slab's products run, and two blocks share an SM (128 registers). The reference's prefill is fp32 without TF32, and
// plain TF32 keeps ~11 bits, too few for the 1e-4 limit once the state sums
// 16 chunks; so each operand is split once, when staged, into a TF32 high
// part and a TF32 remainder, and each product is the sum of three TF32
// products (lo.hi + hi.lo + hi.hi, fp32 accumulation; lo.lo, ~2^-22 of the
// product, is dropped): 3xTF32, near fp32 accuracy at 3x the tensor work.
// Kept from the first design: dacum is summed in fp64 (one warp per chunk),
// and every decay exponent dacum_i - dacum_j is taken in fp64 before the
// fp32 exp (with random weights da is -0.3 to -30 a step and the cumsum
// reaches thousands, where an fp32 difference would carry an ulp of
// thousands into every near-diagonal decay); the mask is applied before the
// exp (above the diagonal exp would overflow and inf * 0 is NaN); the
// ragged last chunk is masked, which equals the reference model's zero-dt
// padding (the Pallas grid floor-divides and never writes such a tail).
#include "ssd_common.cuh"

namespace {

// shared memory: four planes (A and B, high and remainder), then the
// chunk's dacum (fp64), dt and w
size_t smem_bytes(int q) {
  return (size_t)4 * kPlane * sizeof(unsigned) +
         (size_t)q * (sizeof(double) + 2 * sizeof(float));
}

struct Smem {
  Planes a, b;
  double* dac;
  float* dts;
  float* w;
};

__device__ __forceinline__ Smem carve(unsigned char* smem, int q) {
  unsigned* u = reinterpret_cast<unsigned*>(smem);
  Smem s;
  s.a = {u, u + kPlane};
  s.b = {u + 2 * kPlane, u + 3 * kPlane};
  s.dac = reinterpret_cast<double*>(u + 4 * kPlane);
  s.dts = reinterpret_cast<float*>(s.dac + q);
  s.w = s.dts + q;
  return s;
}

// 1. (a) scores of a (B/C row, chunk, 64 x 64 tile on or below the
// diagonal); (b) a chunk's own state contribution, one 64 x 64 tile of
// [P, N] per block, and exp(dacum_end)
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk(const T* __restrict__ x, const T* __restrict__ bm,
          const T* __restrict__ cm, const T* __restrict__ dt,
          const T* __restrict__ da, float* __restrict__ scores,
          float* __restrict__ states, float* __restrict__ gdec, Shape sh,
          int ntri) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem sm = carve(smem, sh.q);
  const T zero = repro::from_float<T>(0.f);
  float acc[4][4];
  zero_acc(acc);
  int lin = blockIdx.x;
  const int rows = sh.bh / sh.g;
  if (lin < rows * sh.nch * ntri) {
    int tri = lin % ntri;
    const int rc = lin / ntri;   // row * nch + c
    const int c0 = (rc % sh.nch) * sh.q;
    const int qc = min(sh.q, sh.s - c0);
    int ti = 0;
    while (tri > ti) tri -= ++ti;
    const int tj = tri;
    if (ti * kB >= qc) return;
    const T* cb = cm + ((size_t)(rc / sh.nch) * sh.s + c0) * sh.n;
    const T* bb = bm + ((size_t)(rc / sh.nch) * sh.s + c0) * sh.n;
    gemm<false, false>(
        (sh.n + kK - 1) / kK, sm.a, sm.b,
        [&](int sl, int r, int k) {   // A[i][n] = C_i[n]
          const int i = ti * kB + r, kk = sl * kK + k;
          return i < qc && kk < sh.n ? cb[(size_t)i * sh.n + kk] : zero;
        },
        Widen{},
        [&](int sl, int r, int k) {   // B[n][j] = B_j[n]
          const int j = tj * kB + r, kk = sl * kK + k;
          return j < qc && kk < sh.n ? bb[(size_t)j * sh.n + kk] : zero;
        },
        Widen{}, acc);
    float* out = scores + (size_t)rc * sh.q * sh.q;
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = ti * kB + acc_row(e), j = tj * kB + acc_col(t, e);
        if (i < qc && j < qc) out[(size_t)i * sh.q + j] = acc[t][e];
      }
    return;
  }
  lin -= rows * sh.nch * ntri;
  const int npt = (sh.p + kB - 1) / kB, nnt = (sh.n + kB - 1) / kB;
  const int ntile = lin % (npt * nnt);
  const int hc = lin / (npt * nnt);   // bh * nch + c
  const int bh = hc / sh.nch;
  const int c0 = (hc % sh.nch) * sh.q;
  const int qc = min(sh.q, sh.s - c0);
  const int p0 = (ntile / nnt) * kB, n0 = (ntile % nnt) * kB;
  chunk_scan<T>(da + (size_t)bh * sh.s + c0, dt + (size_t)bh * sh.s + c0, qc,
                sm.dac, sm.dts);
  __syncthreads();
  const double dend = sm.dac[qc - 1];
  for (int i = threadIdx.x; i < qc; i += kThreads)
    sm.w[i] = sm.dts[i] * expf((float)(dend - sm.dac[i]));
  if (ntile == 0 && threadIdx.x == 0) gdec[hc] = expf((float)dend);
  const T* xb = x + ((size_t)bh * sh.s + c0) * sh.p;
  const T* bb = bm + ((size_t)(bh / sh.g) * sh.s + c0) * sh.n;
  gemm<true, true>(
      (qc + kK - 1) / kK, sm.a, sm.b,
      [&](int sl, int r, int k) {   // A[p][j] = w_j x_j[p]
        const int j = sl * kK + k, pp = p0 + r;
        return j < qc && pp < sh.p ? xb[(size_t)j * sh.p + pp] : zero;
      },
      [&](int sl, int, int k, T v) {   // w only below qc: no read past it
        const int j = sl * kK + k;
        return j < qc ? sm.w[j] * repro::to_float(v) : 0.f;
      },
      [&](int sl, int r, int k) {   // B[j][n] = B_j[n]
        const int j = sl * kK + k, nn = n0 + r;
        return j < qc && nn < sh.n ? bb[(size_t)j * sh.n + nn] : zero;
      },
      Widen{}, acc);
  float* out = states + (size_t)hc * sh.p * sh.n;
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pp = p0 + acc_row(e), nn = n0 + acc_col(t, e);
      if (pp < sh.p && nn < sh.n) out[(size_t)pp * sh.n + nn] = acc[t][e];
    }
}

// 2. the scan over chunks, per (head, p, n): states[c] becomes the state
// entering chunk c; the state after the last chunk is the output
__global__ void __launch_bounds__(kThreads)
ssd_pass(float* __restrict__ states, const float* __restrict__ gdec,
         float* __restrict__ st, Shape sh) {
  const size_t pn = (size_t)sh.p * sh.n;
  const size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (size_t)sh.bh * pn) return;
  const size_t bh = idx / pn, e = idx - bh * pn;
  float* cells = states + bh * sh.nch * pn + e;
  const float* gd = gdec + bh * sh.nch;
  float s = 0.f;
  for (int c0 = 0; c0 < sh.nch; c0 += 8) {   // 8 chunks' loads in flight
    float own[8], dec[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      own[u] = c0 + u < sh.nch ? cells[(c0 + u) * pn] : 0.f;
      dec[u] = c0 + u < sh.nch ? gd[c0 + u] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (c0 + u < sh.nch) {
        cells[(c0 + u) * pn] = s;
        s = fmaf(dec[u], s, own[u]);
      }
  }
  st[idx] = s;
}

// 3. y of a (head, chunk, 64-row tile, 64-column tile of P)
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssd_out(const T* __restrict__ x, const T* __restrict__ cm,
        const T* __restrict__ dt, const T* __restrict__ da,
        const float* __restrict__ scores, const float* __restrict__ states,
        T* __restrict__ y, Shape sh) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem sm = carve(smem, sh.q);
  const int hc = blockIdx.x;   // bh * nch + c
  const int bh = hc / sh.nch, c = hc % sh.nch;
  const int c0 = c * sh.q;
  const int qc = min(sh.q, sh.s - c0);
  const int i0 = blockIdx.z * kB, p0 = blockIdx.y * kB;
  if (i0 >= qc) return;
  chunk_scan<T>(da + (size_t)bh * sh.s + c0, dt + (size_t)bh * sh.s + c0, qc,
                sm.dac, sm.dts);
  const T* cb = cm + ((size_t)(bh / sh.g) * sh.s + c0) * sh.n;
  const T* xb = x + ((size_t)bh * sh.s + c0) * sh.p;
  const T zero = repro::from_float<T>(0.f);
  float acc[4][4];
  zero_acc(acc);
  if (c > 0) {   // exp(dacum_i) C_i S^T from the entering state
    const float* sb = states + (size_t)hc * sh.p * sh.n;
    gemm<false, false>(
        (sh.n + kK - 1) / kK, sm.a, sm.b,
        [&](int sl, int r, int k) {   // A[i][n] = C_i[n]
          const int i = i0 + r, kk = sl * kK + k;
          return i < qc && kk < sh.n ? cb[(size_t)i * sh.n + kk] : zero;
        },
        Widen{},
        [&](int sl, int r, int k) {   // B[n][p] = S[p][n]
          const int pp = p0 + r, kk = sl * kK + k;
          return pp < sh.p && kk < sh.n ? sb[(size_t)pp * sh.n + kk] : 0.f;
        },
        Widen{}, acc);
  }
  __syncthreads();   // dac written (and the last slab's reads done)
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + acc_row(e);
      acc[t][e] *= i < qc ? expf((float)sm.dac[i]) : 0.f;
    }
  const float* sc = scores + ((size_t)(bh / sh.g) * sh.nch + c) * sh.q * sh.q;
  // within the chunk, key slabs up to the diagonal; the mask is applied
  // before the exp (above the diagonal the exponent is large and positive)
  gemm<false, true>(
      (min(i0 + kB, qc) + kK - 1) / kK, sm.a, sm.b,
      [&](int sl, int r, int k) {   // A[i][j] = scores, raw
        const int i = i0 + r, j = sl * kK + k;
        return j <= i && i < qc ? sc[(size_t)i * sh.q + j] : 0.f;
      },
      [&](int sl, int r, int k, float v) {   // decayed, times dt_j
        const int i = i0 + r, j = sl * kK + k;
        if (j > i || i >= qc) return 0.f;
        return v * expf((float)(sm.dac[i] - sm.dac[j])) * sm.dts[j];
      },
      [&](int sl, int r, int k) {   // B[j][p] = x_j[p]
        const int j = sl * kK + k, pp = p0 + r;
        return j < qc && pp < sh.p ? xb[(size_t)j * sh.p + pp] : zero;
      },
      Widen{}, acc);
  T* yb = y + ((size_t)bh * sh.s + c0) * sh.p;
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + acc_row(e), pp = p0 + acc_col(t, e);
      if (i < qc && pp < sh.p)
        yb[(size_t)i * sh.p + pp] = repro::from_float<T>(acc[t][e]);
    }
}

template <typename T>
int launch(const void* x, const void* b, const void* c, const void* dt,
           const void* da, void* y, void* st, float* scratch, Shape sh,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(sh.q);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        ssd_out<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int rows = sh.bh / sh.g;
  float* scores = scratch;
  float* states = scores + (size_t)rows * sh.nch * sh.q * sh.q;
  float* gdec = states + (size_t)sh.bh * sh.nch * sh.p * sh.n;
  const int ntri = tri_tiles(sh.q);
  const int nsc = rows * sh.nch * ntri;
  const int nst = sh.bh * sh.nch * ((sh.p + kB - 1) / kB) *
                  ((sh.n + kB - 1) / kB);
  ssd_chunk<T><<<nsc + nst, kThreads, smem, stream>>>(
      (const T*)x, (const T*)b, (const T*)c, (const T*)dt, (const T*)da,
      scores, states, gdec, sh, ntri);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const size_t elems = (size_t)sh.bh * sh.p * sh.n;
  ssd_pass<<<(unsigned)((elems + kThreads - 1) / kThreads), kThreads, 0,
             stream>>>(states, gdec, (float*)st, sh);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  dim3 grid(sh.bh * sh.nch, (sh.p + kB - 1) / kB, (sh.q + kB - 1) / kB);
  ssd_out<T><<<grid, kThreads, smem, stream>>>(
      (const T*)x, (const T*)c, (const T*)dt, (const T*)da, scores, states,
      (T*)y, sh);
  return (int)cudaGetLastError();
}

}  // namespace

// floats of the work buffer: the scores [rows, chunks, Q, Q], the chunk
// states [BH, chunks, P, N] and exp(dacum_end) [BH, chunks]
extern "C" long long ssd_scan_scratch_floats(int bh, int s, int p, int n,
                                             int chunk, int g) {
  if (bh <= 0 || s <= 0 || chunk <= 0 || g <= 0) return 0;
  const Shape sh = shape_of(bh, s, p, n, chunk, g);
  return (long long)(bh / g) * sh.nch * sh.q * sh.q +
         (long long)bh * sh.nch * ((long long)p * n + 1);
}

extern "C" int ssd_scan_launch(const void* x, const void* b, const void* c,
                               const void* dt, const void* da, void* y,
                               void* st, float* scratch, int bh, int s, int p,
                               int n, int chunk, int g, int dtype,
                               void* stream) {
  if (bh <= 0 || p <= 0) return 0;
  if (s < 0 || n <= 0 || chunk <= 0 || g <= 0 || bh % g != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t strm = (cudaStream_t)stream;
  if (s == 0)   // no step: the state stays h_0 = 0
    return (int)cudaMemsetAsync(st, 0, (size_t)bh * p * n * sizeof(float),
                                strm);
  const Shape sh = shape_of(bh, s, p, n, chunk, g);
  if (dtype == repro::kFloat32)
    return launch<float>(x, b, c, dt, da, y, st, scratch, sh, strm);
  if (dtype == repro::kBFloat16)
    return launch<__nv_bfloat16>(x, b, c, dt, da, y, st, scratch, sh, strm);
  return (int)cudaErrorInvalidValue;
}
