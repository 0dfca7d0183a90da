// Backward of the Mamba2 SSD chunked scan (ssd_scan.cu) on Hopper.
//
// The TPU package has no counterpart: the reference trains mamba2 through
// its ssd_chunked (src/repro/models/ssm.py), differentiated by XLA, and its
// Pallas kernel (src/repro/kernels/ssd_scan/kernel.py, _ssd_kernel) has no
// VJP. The port trains through its forward kernel, so the gradient has to
// come from a kernel too. Same function as the plain reverse recurrence
// (kernels/ssd_scan/ref.py, ssd_scan_bwd_ref): with G_t the gradient of the
// state h_t [P, N],
//   G_t = dy_t C_t^T + exp(da_{t+1}) G_{t+1},  G_{S-1} = dy C^T + dstate,
//   dx_t = dt_t G_t B_t, dB_t = dt_t G_t^T x_t, ddt_t = x_t^T G_t B_t,
//   dda_t = exp(da_t) <G_t, h_{t-1}>, dC_t = h_t^T dy_t,
// dB and dC summed over the g heads that share a B/C row.
//
// Chunked form (arXiv:2405.21060, sec. 6; the structure of the public
// mamba_ssm backward: chunk_state_bwd, state_passing_bwd, chunk_scan_bwd_dx
// / dC / dcb and the ddA cumsum). Per (head, chunk c) of Q steps, cum_i the
// inclusive in-chunk cumsum of da, H_c the state entering the chunk (the
// forward's ssd_pass leaves it in the work buffer, with the scores C B^T
// and exp(cum_end)), dH_{c+1} the gradient of the state leaving it,
// M_ij = (C_i . B_j) exp(cum_i - cum_j) and
// W_ij = (dy_i . x_j) exp(cum_i - cum_j) dt_j for j <= i:
//   dH_c     = exp(cum_end) dH_{c+1} + sum_i exp(cum_i) dy_i^T C_i
//   dx_j     = dt_j (sum_{i>=j} M_ij dy_i + exp(cum_end - cum_j) dH_{c+1} B_j)
//   ddt_j    = x_j . (the same bracket)
//   dC_i     = sum_{j<=i} W_ij B_j + exp(cum_i) dy_i^T H_c
//   dB_j     = sum_{i>=j} W_ij C_i + dt_j exp(cum_end - cum_j) dH_{c+1}^T x_j
//   dda_k    = sum_{i>=k} (dy_i . y_i - Cs_i) + E + sum_{j<k} U_j
// with y the forward's output, Cs_j = sum_{i>=j} W_ij (C_i . B_j) (the
// column sums of the decayed scores times dy . x), U_j = x_j . (the state
// part of dx_j), and E = exp(cum_end) <dH_{c+1}, H_c>. The last line is
// the reverse cumsum of d(cum): the state term of y and the diagonal
// blocks' row sums add up to dy . y, which the forward already wrote.
//
// Launches, in order (no atomics: every sum runs in a fixed order, so
// repeats are bit-identical):
//   0. ssd_bwd_cum: per (head, chunk), cum in fp64 (the forward's
//      chunk_scan) into scratch;
//   1. ssd_bwd_dchunk: per (head, chunk, 64 x 64 tile of [P, N]), the
//      chunk's own dH term sum_i exp(cum_i) dy_i^T C_i;
//   2. ssd_bwd_pass: per (head, p, n), the reverse scan over chunks; slot
//      c then holds dH_{c+1}, dstate (or 0) entering the last chunk;
//   3. ssd_bwd_w: per (B/C row, chunk, 64 x 64 tile on or below the
//      diagonal), the g heads in order: dy x^T, decayed, times dt, summed
//      over the heads into W (before the N-wide products, as the forward
//      shares its scores), and each head's column sums of W o (C B^T);
//   4. ssd_bwd_dx: per (head, chunk, 64-row tile), dx, ddt and U;
//   5. ssd_bwd_dbc: per (B/C row, chunk, 64-row tile, 64-column tile of
//      N), dC or dB: the W products, then the state terms as one product
//      whose reduction runs over the g heads' P dims (4096 at mamba2);
//   6. ssd_bwd_dda: per (head, chunk), the reverse cumsum above in fp64.
// Every product is the forward's 64 x 64 block tile on 3xTF32 mma.sync
// (ssd_common.cuh). The forward's numerics hold: cum is summed in fp64 and
// every decay exponent cum_i - cum_j (and cum_end - cum_j) is taken in fp64
// before the fp32 exp, masked before the exp; the ragged last chunk is
// masked, which equals zero-dt padding.
//
// Bound on an H100 at mamba2-1.3b's train shape (x [BH 512, S 2048, P 64],
// B/C [8, 2048, 128] shared by 64 heads, chunk 256, fp32): see
// chip_smoke.py::ssd_bwd_ops_bytes, which counts these products' useful
// flop (3xTF32 triples them) against the inputs read and the gradients
// written once; operations bind.
#include "ssd_common.cuh"

namespace {

// -- shared memory of each launch: the four planes, then its own arrays --
constexpr size_t kPlanes = (size_t)4 * kPlane * sizeof(unsigned);

__device__ __forceinline__ Planes plane(unsigned char* smem, int i) {
  unsigned* u = reinterpret_cast<unsigned*>(smem);
  return {u + 2 * i * kPlane, u + (2 * i + 1) * kPlane};
}

struct Bufs {   // the backward's scratch (ssd_scan_bwd_scratch_floats)
  double* cum;           // [BH, S] in-chunk inclusive cumsum of da
  float* dh;             // [BH, chunks, P, N] dH_{c+1} of chunk c
  float* w;              // [rows, chunks, Q, Q] W summed over the g heads
  float* cs;             // [BH, chunks, Q / 64 tiles, Q] column-sum partials
  float* u;              // [BH, S] U
};

// the forward's work buffer: scores [rows, chunks, Q, Q], entering states
// [BH, chunks, P, N], exp(cum_end) [BH, chunks]
struct Fwd {
  const float* scores;
  const float* states;
  const float* gdec;
};

// row sums over the block tile's columns of a per-element value, for the
// tile's 64 rows: v[e] for acc_row(e) (two rows a thread), summed over a
// thread's columns, the four lanes of a row (tig) and the two column warps,
// in a fixed order. red: 128 floats of shared memory; returns the sum for
// row threadIdx.x (< 64) after a block barrier.
__device__ __forceinline__ float tile_row_sum(const float (&v)[2],
                                              float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float r[2] = {v[0], v[1]};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    r[i] += __shfl_xor_sync(0xffffffffu, r[i], 1);
    r[i] += __shfl_xor_sync(0xffffffffu, r[i], 2);
  }
  if ((lane & 3) == 0) {
    const int row = (warp >> 1) * 16 + (lane >> 2);
    red[2 * row + (warp & 1)] = r[0];
    red[2 * (row + 8) + (warp & 1)] = r[1];
  }
  __syncthreads();
  return threadIdx.x < kB ? red[2 * threadIdx.x] + red[2 * threadIdx.x + 1]
                          : 0.f;
}

// 0. cum per (head, chunk)
__global__ void __launch_bounds__(kThreads)
ssd_bwd_cum(const float* __restrict__ dt, const float* __restrict__ da,
            Bufs bf, Shape sh) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* dac = reinterpret_cast<double*>(smem);
  float* dts = reinterpret_cast<float*>(dac + sh.q);
  const int bh = blockIdx.x / sh.nch;
  const int c0 = (blockIdx.x % sh.nch) * sh.q;
  const int qc = min(sh.q, sh.s - c0);
  const size_t off = (size_t)bh * sh.s + c0;
  chunk_scan<float>(da + off, dt + off, qc, dac, dts);
  __syncthreads();
  for (int i = threadIdx.x; i < qc; i += kThreads) bf.cum[off + i] = dac[i];
}

// 1. per (head, chunk, tile of [P, N]): sum_i exp(cum_i) dy_i^T C_i
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_dchunk(const float* __restrict__ dy, const float* __restrict__ cm,
               Bufs bf, Shape sh) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ecum = reinterpret_cast<float*>(smem + kPlanes);
  const int npt = (sh.p + kB - 1) / kB, nnt = (sh.n + kB - 1) / kB;
  const int tile = blockIdx.x % (npt * nnt);
  const int hc = blockIdx.x / (npt * nnt);   // bh * nch + c
  const int bh = hc / sh.nch;
  const int c0 = (hc % sh.nch) * sh.q;
  const int qc = min(sh.q, sh.s - c0);
  const int p0 = (tile / nnt) * kB, n0 = (tile % nnt) * kB;
  const size_t off = (size_t)bh * sh.s + c0;
  for (int i = threadIdx.x; i < qc; i += kThreads)
    ecum[i] = expf((float)bf.cum[off + i]);
  const float* dyb = dy + off * sh.p;
  const float* cb = cm + ((size_t)(bh / sh.g) * sh.s + c0) * sh.n;
  float acc[4][4];
  zero_acc(acc);
  gemm<true, true>(
      (qc + kK - 1) / kK, plane(smem, 0), plane(smem, 1),
      [&](int sl, int r, int k) {   // A[p][i] = exp(cum_i) dy_i[p]
        const int i = sl * kK + k, pp = p0 + r;
        return i < qc && pp < sh.p ? dyb[(size_t)i * sh.p + pp] : 0.f;
      },
      [&](int sl, int, int k, float v) {   // ecum only below qc
        const int i = sl * kK + k;
        return i < qc ? ecum[i] * v : 0.f;
      },
      [&](int sl, int r, int k) {   // B[i][n] = C_i[n]
        const int i = sl * kK + k, nn = n0 + r;
        return i < qc && nn < sh.n ? cb[(size_t)i * sh.n + nn] : 0.f;
      },
      Widen{}, acc);
  float* out = bf.dh + (size_t)hc * sh.p * sh.n;
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pp = p0 + acc_row(e), nn = n0 + acc_col(t, e);
      if (pp < sh.p && nn < sh.n) out[(size_t)pp * sh.n + nn] = acc[t][e];
    }
}

// 2. per (head, p, n): the reverse scan over chunks; slot c becomes the
// gradient of the state leaving chunk c
__global__ void __launch_bounds__(kThreads)
ssd_bwd_pass(Bufs bf, const float* __restrict__ gdec,
             const float* __restrict__ dstate, Shape sh) {
  const size_t pn = (size_t)sh.p * sh.n;
  const size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (size_t)sh.bh * pn) return;
  const size_t bh = idx / pn, e = idx - bh * pn;
  float* cells = bf.dh + bh * sh.nch * pn + e;
  const float* gd = gdec + bh * sh.nch;
  float s = dstate != nullptr ? dstate[idx] : 0.f;
  for (int c = sh.nch - 1; c >= 0; --c) {
    const float own = cells[c * pn];
    cells[c * pn] = s;
    s = fmaf(gd[c], s, own);
  }
}

// 3. per (B/C row, chunk, tile (ti, tj) on or below the diagonal): W over
// the row's g heads, in order, and each head's column sums of W o (C B^T)
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_w(const float* __restrict__ x, const float* __restrict__ dy,
          const float* __restrict__ dt, Fwd fw, Bufs bf, Shape sh, int ntri) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* ci = reinterpret_cast<double*>(smem + kPlanes);   // cum of rows i
  double* cj = ci + kB;                                      // of rows j
  float* dtj = reinterpret_cast<float*>(cj + kB);
  float* colred = dtj + kB;                                  // [4][64]
  const int lin = blockIdx.x;
  int tri = lin % ntri;
  const int rc = lin / ntri;   // row * nch + c
  const int row = rc / sh.nch, c = rc % sh.nch;
  const int c0 = c * sh.q;
  const int qc = min(sh.q, sh.s - c0);
  int ti = 0;
  while (tri > ti) tri -= ++ti;
  const int tj = tri;
  if (ti * kB >= qc) return;
  const int ntq = (sh.q + kB - 1) / kB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* sc = fw.scores + (size_t)rc * sh.q * sh.q;
  float wacc[4][4];
  zero_acc(wacc);
  for (int hh = 0; hh < sh.g; ++hh) {
    const int bh = row * sh.g + hh;
    const size_t off = (size_t)bh * sh.s + c0;
    __syncthreads();   // the previous head is done with ci, cj, dtj, colred
    for (int r = threadIdx.x; r < kB; r += kThreads) {
      const int i = ti * kB + r, j = tj * kB + r;
      ci[r] = i < qc ? bf.cum[off + i] : 0.0;
      cj[r] = j < qc ? bf.cum[off + j] : 0.0;
      dtj[r] = j < qc ? dt[off + j] : 0.f;
    }
    const float* dyb = dy + off * sh.p;
    const float* xb = x + off * sh.p;
    float acc[4][4];
    zero_acc(acc);
    gemm<false, false>(
        (sh.p + kK - 1) / kK, plane(smem, 0), plane(smem, 1),
        [&](int sl, int r, int k) {   // A[i][p] = dy_i[p]
          const int i = ti * kB + r, pp = sl * kK + k;
          return i < qc && pp < sh.p ? dyb[(size_t)i * sh.p + pp] : 0.f;
        },
        Widen{},
        [&](int sl, int r, int k) {   // B[p][j] = x_j[p]
          const int j = tj * kB + r, pp = sl * kK + k;
          return j < qc && pp < sh.p ? xb[(size_t)j * sh.p + pp] : 0.f;
        },
        Widen{}, acc);
    float col[4][2];
#pragma unroll
    for (int t = 0; t < 4; ++t) col[t][0] = col[t][1] = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = acc_row(e), rj = acc_col(t, e);
        const int i = ti * kB + ri, j = tj * kB + rj;
        float w = 0.f;
        if (j <= i && i < qc)   // the mask before the exp
          w = acc[t][e] * expf((float)(ci[ri] - cj[rj])) * dtj[rj];
        wacc[t][e] += w;
        if (w != 0.f) col[t][e & 1] += w * sc[(size_t)i * sh.q + j];
      }
    // column sums: the two rows of a thread, the 8 lanes of a column
    // (gid), then the four row warps, in order
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float v = col[t][k];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (lane < 4) colred[(warp >> 1) * kB + acc_col(t, k)] = v;
      }
    __syncthreads();
    if (threadIdx.x < kB) {
      const int j = tj * kB + threadIdx.x;
      if (j < qc)
        bf.cs[(((size_t)bh * sh.nch + c) * ntq + ti) * sh.q + j] =
            colred[threadIdx.x] + colred[kB + threadIdx.x] +
            colred[2 * kB + threadIdx.x] + colred[3 * kB + threadIdx.x];
    }
  }
  float* wo = bf.w + (size_t)rc * sh.q * sh.q;
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = ti * kB + acc_row(e), j = tj * kB + acc_col(t, e);
      if (i < qc && j < qc) wo[(size_t)i * sh.q + j] = wacc[t][e];
    }
}

// 4. per (head, chunk, 64-row tile j): dx, ddt and U over the P tiles (one
// block an SM: its two accumulators spill at two)
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_dx(const float* __restrict__ x, const float* __restrict__ bm,
           const float* __restrict__ dt, const float* __restrict__ dy,
           Fwd fw, Bufs bf, float* __restrict__ dx, float* __restrict__ ddt,
           Shape sh) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* dac = reinterpret_cast<double*>(smem + kPlanes);
  float* dts = reinterpret_cast<float*>(dac + sh.q);
  float* red = dts + sh.q;   // [2][128]
  const int hc = blockIdx.x;   // bh * nch + c
  const int bh = hc / sh.nch, c = hc % sh.nch;
  const int c0 = c * sh.q;
  const int qc = min(sh.q, sh.s - c0);
  const int j0 = blockIdx.y * kB;
  if (j0 >= qc) return;
  const size_t off = (size_t)bh * sh.s + c0;
  for (int i = threadIdx.x; i < qc; i += kThreads) {
    dac[i] = bf.cum[off + i];
    dts[i] = dt[off + i];
  }
  const int row = bh / sh.g;
  const float* sc = fw.scores + ((size_t)row * sh.nch + c) * sh.q * sh.q;
  const float* dyb = dy + off * sh.p;
  const float* xb = x + off * sh.p;
  const float* bb = bm + ((size_t)row * sh.s + c0) * sh.n;
  const float* dhb = bf.dh + (size_t)hc * sh.p * sh.n;
  float tot_ddt = 0.f, tot_u = 0.f;   // of row j0 + threadIdx.x
  for (int p0 = 0; p0 < sh.p; p0 += kB) {
    float a1[4][4], a2[4][4];
    zero_acc(a1);
    zero_acc(a2);
    // sum_{i >= j} M_ij dy_i: A[j][i] = scores[i][j], decayed
    gemm<true, true>(
        (qc - j0 + kK - 1) / kK, plane(smem, 0), plane(smem, 1),
        [&](int sl, int r, int k) {
          const int i = j0 + sl * kK + k, j = j0 + r;
          return j <= i && i < qc ? sc[(size_t)i * sh.q + j] : 0.f;
        },
        [&](int sl, int r, int k, float v) {
          const int i = j0 + sl * kK + k, j = j0 + r;
          if (j > i || i >= qc) return 0.f;
          return v * expf((float)(dac[i] - dac[j]));
        },
        [&](int sl, int r, int k) {   // B[i][p] = dy_i[p]
          const int i = j0 + sl * kK + k, pp = p0 + r;
          return i < qc && pp < sh.p ? dyb[(size_t)i * sh.p + pp] : 0.f;
        },
        Widen{}, a1);
    // dH_{c+1} B_j: A[j][n] = B_j[n], B[n][p] = dH[p][n]
    gemm<false, false>(
        (sh.n + kK - 1) / kK, plane(smem, 0), plane(smem, 1),
        [&](int sl, int r, int k) {
          const int j = j0 + r, nn = sl * kK + k;
          return j < qc && nn < sh.n ? bb[(size_t)j * sh.n + nn] : 0.f;
        },
        Widen{},
        [&](int sl, int r, int k) {
          const int pp = p0 + r, nn = sl * kK + k;
          return pp < sh.p && nn < sh.n ? dhb[(size_t)pp * sh.n + nn] : 0.f;
        },
        Widen{}, a2);
    float vd[2] = {0.f, 0.f}, vu[2] = {0.f, 0.f};
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + acc_row(e), pp = p0 + acc_col(t, e);
        if (j >= qc || pp >= sh.p) continue;
        const float f = expf((float)(dac[qc - 1] - dac[j]));
        const float st = f * a2[t][e];
        const float inner = a1[t][e] + st;
        const float xv = xb[(size_t)j * sh.p + pp];
        dx[(off + j) * sh.p + pp] = (dts[j] * inner);
        vd[e >> 1] += xv * inner;
        vu[e >> 1] += xv * st;
      }
    tot_ddt += tile_row_sum(vd, red);
    tot_u += tile_row_sum(vu, red + 2 * kB);
  }
  const int j = j0 + threadIdx.x;
  if (threadIdx.x < kB && j < qc) {
    ddt[off + j] = (tot_ddt);
    bf.u[off + j] = dts[j] * tot_u;
  }
}

// 5. per (B/C row, chunk, 64-row tile, 64-column tile of N); blockIdx.y 0:
// dC of rows i, 1: dB of rows j
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_dbc(const float* __restrict__ x, const float* __restrict__ bm,
            const float* __restrict__ cm, const float* __restrict__ dt,
            const float* __restrict__ dy, Fwd fw, Bufs bf,
            float* __restrict__ db, float* __restrict__ dc, Shape sh) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* fac = reinterpret_cast<float*>(smem + kPlanes);   // [g][64]
  const bool is_b = blockIdx.y == 1;
  const int nqt = (sh.q + kB - 1) / kB, nnt = (sh.n + kB - 1) / kB;
  int lin = blockIdx.x;
  const int n0 = (lin % nnt) * kB;
  lin /= nnt;
  const int r0 = (lin % nqt) * kB;   // the tile's first row (i or j)
  const int rc = lin / nqt;          // row * nch + c
  const int row = rc / sh.nch, c = rc % sh.nch;
  const int c0 = c * sh.q;
  const int qc = min(sh.q, sh.s - c0);
  if (r0 >= qc) return;
  // per head and tile row: exp(cum_i) for dC; dt_j exp(cum_end - cum_j)
  // for dB (0 past the chunk)
  for (int idx = threadIdx.x; idx < sh.g * kB; idx += kThreads) {
    const int hh = idx / kB, r = idx % kB;
    const size_t off = (size_t)(row * sh.g + hh) * sh.s + c0;
    float f = 0.f;
    if (r0 + r < qc)
      f = is_b ? dt[off + r0 + r] *
                     expf((float)(bf.cum[off + qc - 1] - bf.cum[off + r0 + r]))
               : expf((float)bf.cum[off + r0 + r]);
    fac[idx] = f;
  }
  const float* wb = bf.w + (size_t)rc * sh.q * sh.q;
  const float* other = (is_b ? cm : bm) + ((size_t)row * sh.s + c0) * sh.n;
  float acc[4][4];
  zero_acc(acc);
  if (is_b) {   // sum_{i >= j} W_ij C_i: A[j][i] = W[i][j]
    gemm<true, true>(
        (qc - r0 + kK - 1) / kK, plane(smem, 0), plane(smem, 1),
        [&](int sl, int r, int k) {
          const int i = r0 + sl * kK + k, j = r0 + r;
          return j <= i && i < qc ? wb[(size_t)i * sh.q + j] : 0.f;
        },
        Widen{},
        [&](int sl, int r, int k) {
          const int i = r0 + sl * kK + k, nn = n0 + r;
          return i < qc && nn < sh.n ? other[(size_t)i * sh.n + nn] : 0.f;
        },
        Widen{}, acc);
  } else {      // sum_{j <= i} W_ij B_j: A[i][j] = W[i][j]
    gemm<false, true>(
        (min(r0 + kB, qc) + kK - 1) / kK, plane(smem, 0), plane(smem, 1),
        [&](int sl, int r, int k) {
          const int i = r0 + r, j = sl * kK + k;
          return j <= i && i < qc ? wb[(size_t)i * sh.q + j] : 0.f;
        },
        Widen{},
        [&](int sl, int r, int k) {
          const int j = sl * kK + k, nn = n0 + r;
          return j < qc && nn < sh.n ? other[(size_t)j * sh.n + nn] : 0.f;
        },
        Widen{}, acc);
  }
  // the state terms, over (head, p) of the row's heads: dC: A[i][(h, p)] =
  // exp(cum_i) dy_i[p], B = H_c[p][n]; dB: A[j][(h, p)] = dt_j
  // exp(cum_end - cum_j) x_j[p], B = dH_{c+1}[p][n]
  const float* a_src = is_b ? x : dy;
  const float* st = is_b ? bf.dh : fw.states;
  const int kdim = sh.g * sh.p;
  gemm<false, true>(
      (kdim + kK - 1) / kK, plane(smem, 0), plane(smem, 1),
      [&](int sl, int r, int k) {
        const int kk = sl * kK + k;
        if (kk >= kdim || r0 + r >= qc) return 0.f;
        const int hh = kk / sh.p, pp = kk - hh * sh.p;
        return a_src[((size_t)(row * sh.g + hh) * sh.s + c0 + r0 + r) * sh.p +
                     pp];
      },
      [&](int sl, int r, int k, float v) {
        const int kk = sl * kK + k;
        return kk < kdim ? fac[(kk / sh.p) * kB + r] * v
                         : 0.f;
      },
      [&](int sl, int r, int k) {
        const int kk = sl * kK + k, nn = n0 + r;
        if (kk >= kdim || nn >= sh.n) return 0.f;
        const int hh = kk / sh.p, pp = kk - hh * sh.p;
        return st[(((size_t)(row * sh.g + hh) * sh.nch + c) * sh.p + pp) *
                      sh.n + nn];
      },
      Widen{}, acc);
  float* out = (is_b ? db : dc) + ((size_t)row * sh.s + c0) * sh.n;
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r0 + acc_row(e), nn = n0 + acc_col(t, e);
      if (i < qc && nn < sh.n)
        out[(size_t)i * sh.n + nn] = (acc[t][e]);
    }
}

// 6. per (head, chunk): dda_k = sum_{i>=k} (dy_i . y_i - Cs_i) + E +
// sum_{j<k} U_j, the sums in fp64
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dda(const float* __restrict__ dy, const float* __restrict__ y, Fwd fw,
            Bufs bf, float* __restrict__ dda, Shape sh) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* v = reinterpret_cast<double*>(smem);   // [q]
  double* u = v + sh.q;                           // [q]
  float* red = reinterpret_cast<float*>(u + sh.q);   // [kThreads]
  const int hc = blockIdx.x;
  const int bh = hc / sh.nch, c = hc % sh.nch;
  const int c0 = c * sh.q;
  const int qc = min(sh.q, sh.s - c0);
  const size_t off = (size_t)bh * sh.s + c0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ntq = (sh.q + kB - 1) / kB;
  // E = exp(cum_end) <dH_{c+1}, H_c>; H_0 = 0
  float e = 0.f;
  if (c > 0) {
    const size_t pn = (size_t)sh.p * sh.n;
    const float* a = bf.dh + (size_t)hc * pn;
    const float* b = fw.states + (size_t)hc * pn;
    for (size_t k = threadIdx.x; k < pn; k += kThreads) e += a[k] * b[k];
  }
  red[threadIdx.x] = e;
  __syncthreads();
  for (int o = kThreads / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) red[threadIdx.x] += red[threadIdx.x + o];
    __syncthreads();
  }
  const double big_e =
      (double)red[0] * (double)expf((float)bf.cum[off + qc - 1]);
  // v_i = dy_i . y_i - Cs_i, u_i = U_i
  for (int i = warp; i < qc; i += kThreads / 32) {
    const float* a = dy + (off + i) * sh.p;
    const float* b = y + (off + i) * sh.p;
    float d = 0.f;
    for (int k = lane; k < sh.p; k += 32)
      d = fmaf(a[k], b[k], d);
    d = repro::warp_sum(d);
    if (lane == 0) {
      double cs = 0.0;
      for (int ti = i / kB; ti * kB < qc; ++ti)
        cs += bf.cs[(((size_t)bh * sh.nch + c) * ntq + ti) * sh.q + i];
      v[i] = (double)d - cs;
      u[i] = bf.u[off + i];
    }
  }
  __syncthreads();
  if (warp == 0) {   // v: suffix sums; u: exclusive prefix sums
    const int per = (qc + 31) / 32;
    const int lo = min(lane * per, qc), hi = min(lo + per, qc);
    double rv = 0.0, ru = 0.0;
    for (int i = lo; i < hi; ++i) {
      rv += v[i];
      ru += u[i];
    }
    double iv = rv, iu = ru;   // inclusive scans over lanes
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double a = __shfl_down_sync(0xffffffffu, iv, o);
      const double b = __shfl_up_sync(0xffffffffu, iu, o);
      if (lane + o < 32) iv += a;
      if (lane >= o) iu += b;
    }
    double sv = iv - rv;   // the lanes after this one
    double pu = iu - ru;   // the lanes before
    for (int i = hi - 1; i >= lo; --i) {
      sv += v[i];
      v[i] = sv;
    }
    for (int i = lo; i < hi; ++i) {
      const double x = u[i];
      u[i] = pu;
      pu += x;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < qc; i += kThreads)
    dda[off + i] = ((float)(v[i] + big_e + u[i]));
}

size_t smem_dx(int q) {
  return kPlanes + (size_t)q * (sizeof(double) + sizeof(float)) +
         4 * kB * sizeof(float);
}

int launch(const float* x, const float* bm, const float* cm,
           const float* dt, const float* da, const float* y, const float* dy,
           const float* dstate, const float* work, float* scratch, float* dx,
           float* db, float* dc, float* ddt, float* dda, Shape sh,
           cudaStream_t stream) {
  const int rows = sh.bh / sh.g;
  const int ntq = (sh.q + kB - 1) / kB;
  Fwd fw;
  fw.scores = work;
  fw.states = fw.scores + (size_t)rows * sh.nch * sh.q * sh.q;
  fw.gdec = fw.states + (size_t)sh.bh * sh.nch * sh.p * sh.n;
  Bufs bf;
  bf.cum = reinterpret_cast<double*>(scratch);
  bf.dh = scratch + (size_t)2 * sh.bh * sh.s;
  bf.w = bf.dh + (size_t)sh.bh * sh.nch * sh.p * sh.n;
  bf.cs = bf.w + (size_t)rows * sh.nch * sh.q * sh.q;
  bf.u = bf.cs + (size_t)sh.bh * sh.nch * ntq * sh.q;

  const size_t s_cum = (size_t)sh.q * (sizeof(double) + sizeof(float));
  const size_t s_chunk = kPlanes + (size_t)sh.q * sizeof(float);
  const size_t s_w = kPlanes + 2 * kB * sizeof(double) +
                     5 * kB * sizeof(float);
  const size_t s_dx = smem_dx(sh.q);
  const size_t s_dbc = kPlanes + (size_t)sh.g * kB * sizeof(float);
  const size_t s_dda =
      (size_t)2 * sh.q * sizeof(double) + kThreads * sizeof(float);
  const size_t most = s_dbc > s_dx ? s_dbc : s_dx;
  if (most > kMaxSmem || s_dda > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
  const void* fns[] = {(const void*)ssd_bwd_dchunk,
                       (const void*)ssd_bwd_w, (const void*)ssd_bwd_dx,
                       (const void*)ssd_bwd_dbc};
  const size_t sizes[] = {s_chunk, s_w, s_dx, s_dbc};
  for (int i = 0; i < 4 && e == cudaSuccess; ++i)
    e = cudaFuncSetAttribute(fns[i],
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sizes[i]);
  if (e != cudaSuccess) return (int)e;
  const int hcs = sh.bh * sh.nch;
  ssd_bwd_cum<<<hcs, kThreads, s_cum, stream>>>(dt, da, bf, sh);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int npn = ((sh.p + kB - 1) / kB) * ((sh.n + kB - 1) / kB);
  ssd_bwd_dchunk<<<hcs * npn, kThreads, s_chunk, stream>>>(dy, cm, bf, sh);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const size_t elems = (size_t)sh.bh * sh.p * sh.n;
  ssd_bwd_pass<<<(unsigned)((elems + kThreads - 1) / kThreads), kThreads, 0,
                 stream>>>(bf, fw.gdec, dstate, sh);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int ntri = tri_tiles(sh.q);
  ssd_bwd_w<<<rows * sh.nch * ntri, kThreads, s_w, stream>>>(
      x, dy, dt, fw, bf, sh, ntri);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_bwd_dx<<<dim3(hcs, ntq), kThreads, s_dx, stream>>>(
      x, bm, dt, dy, fw, bf, dx, ddt, sh);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int nnt = (sh.n + kB - 1) / kB;
  ssd_bwd_dbc<<<dim3(rows * sh.nch * ntq * nnt, 2), kThreads, s_dbc,
                stream>>>(x, bm, cm, dt, dy, fw, bf, db, dc, sh);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_bwd_dda<<<hcs, kThreads, s_dda, stream>>>(dy, y, fw, bf, dda, sh);
  return (int)cudaGetLastError();
}

}  // namespace

// floats of the backward's scratch: cum [BH, S] (fp64, two floats each),
// dH [BH, chunks, P, N], W [rows, chunks, Q, Q], the column-sum partials
// [BH, chunks, Q / 64 tiles, Q] and U [BH, S]
extern "C" long long ssd_scan_bwd_scratch_floats(int bh, int s, int p, int n,
                                                 int chunk, int g) {
  if (bh <= 0 || s <= 0 || chunk <= 0 || g <= 0) return 0;
  const Shape sh = shape_of(bh, s, p, n, chunk, g);
  const long long ntq = (sh.q + kB - 1) / kB;
  return 3LL * bh * s + (long long)bh * sh.nch * p * n +
         (long long)(bh / g) * sh.nch * sh.q * sh.q +
         (long long)bh * sh.nch * ntq * sh.q;
}

// dx, dB, dC, ddt, dda (like x, B, C, dt, da) of the scan whose forward
// (ssd_scan_launch) left y and its work buffer, for the output gradient dy
// and the final state's gradient dstate ([BH, P, N], or null for 0); fp32
// only: the mixer scans in fp32, and dda's sums read y, which a bf16
// forward has rounded
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* b, const void* c, const void* dt,
    const void* da, const void* y, const void* dy, const float* dstate,
    const float* work, float* scratch, void* dx, void* db, void* dc,
    void* ddt, void* dda, int bh, int s, int p, int n, int chunk, int g,
    int dtype, void* stream) {
  if (bh <= 0 || p <= 0 || s <= 0) return 0;
  if (n <= 0 || chunk <= 0 || g <= 0 || bh % g != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype != repro::kFloat32) return (int)cudaErrorInvalidValue;
  using F = const float*;
  return launch((F)x, (F)b, (F)c, (F)dt, (F)da, (F)y, (F)dy, dstate, work,
                scratch, (float*)dx, (float*)db, (float*)dc, (float*)ddt,
                (float*)dda, shape_of(bh, s, p, n, chunk, g),
                (cudaStream_t)stream);
}
