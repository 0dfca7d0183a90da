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
// Bound on an H100 at mamba2-1.3b's train shape (x [BH 512, S 2048, P 64],
// B/C [8, 2048, 128] shared by 64 heads, chunk 256, fp32): see
// chip_smoke.py::ssd_bwd_ops_bytes, which counts these products' useful
// flop (3xTF32 triples them) against the inputs read and the gradients
// written once; operations bind (0.74 ms). The first design (seven launches
// through the forward's 64 x 64 tile helper) took 8.7 ms: every staged
// value split by two cvt.rna (a quarter-rate instruction), one slab in
// flight through registers, 64 x 64 tiles whose state-term reduction over
// the g heads' P dims (4096) read each staged value for 2 or 4 output
// tiles, a second pass reading and writing all of dH, and W's 64 heads one
// after the other in a block. The redesign, launch by launch (no atomics:
// every sum runs in a fixed order, so repeats are bit-identical):
//   0. ssd_bwd_cum: per (head, chunk), cum in fp64 (the forward's
//      chunk_scan) and, once, the fp32 factors the products scale by:
//      exp(cum_i), exp(cum_end - cum_j) and dt_j exp(cum_end - cum_j).
//   1. ssd_bwd_dstate: per (head, 64 x 128 tile of [P, N]), the chunks in
//      reverse: dH_{c+1} is held in the accumulator and written once to
//      slot c, dstate (or 0) seeds it; each chunk scales it by exp(cum_end)
//      and adds its own sum_i exp(cum_i) dy_i^T C_i (exp(cum_i) applied to
//      dy as its fragments load). The first design's separate pass over
//      chunks, a second read and write of dH, is gone.
//   2. ssd_bwd_w: per (B/C row, chunk, 64 x 64 tile on or below the
//      diagonal, group of g / 4 heads), launched in clusters of the 4 head
//      groups of a tile: each block runs its heads' dy x^T products (the
//      ring streams across heads), decays them, times dt, sums them and
//      writes each head's column sums of W o (C B^T) per 32-row group; the
//      4 partial W meet in distributed shared memory and are added in rank
//      order (W summed over the heads before the N-wide products, as the
//      forward shares its scores).
//   3. ssd_bwd_dx: per (head, chunk, 64-row tile j), over P in tiles of 64:
//      the state part exp(cum_end - cum_j) dH_{c+1} B_j first, in the
//      accumulator that the masked, decayed scores times dy then add to
//      (one accumulator, not two: three blocks of 4 warps an SM, not one
//      of 8); each score is decayed once, by the thread that copied it,
//      before the slab's barrier (16-byte shared accesses); dx, ddt, U. A
//      (head, chunk)'s row tiles are neighbours in the grid, so its dy and
//      dH_{c+1} come from L2.
//   4. ssd_bwd_dbc: per (B/C row, chunk, 64-row tile, 128-column tile of
//      N), dC or dB: the W product, then the state terms as one product
//      whose reduction runs over the g heads' P dims (4096 at mamba2), A
//      scaled per row and head by exp(cum_i) or dt_j exp(cum_end - cum_j)
//      as its fragments load. The tile covers all of N at mamba2's 128, so
//      each staged A value serves every column; 512 blocks fill the card's
//      132 SMs twice at the train shape, so the reduction is not split.
//   5. ssd_bwd_dda: per (head, chunk), the reverse cumsum above in fp64.
// Every product (1-4) runs on the ring (ssd_common.cuh): raw fp32 slabs of
// 32 arrive by cp.async (16-byte copies, zero-filled past the edges) in a
// ring of 3 stages, one block barrier a slab, and each value is split into
// TF32 parts only when its fragment is loaded, on the FMA pipe (3xTF32
// mma.sync, 32 x 32 warp tiles). The forward's numerics hold: cum is summed
// in fp64 and every decay exponent cum_i - cum_j (and cum_end - cum_j) is
// taken in fp64 before the fp32 exp, masked before the exp; the ragged last
// chunk is masked, which equals zero-dt padding. The decay is never
// factored into exp(cum_i) exp(-cum_j), which overflows on slow decay.
// Where a warp's 32 x 32 of W (w) or a slab of scores (dx) lies wholly
// below the diagonal, the decay is taken through a pivot row p between the
// two, exp(cum_i - cum_p) exp(cum_p - cum_j): with da <= 0 both exponents
// are <= 0, so neither factor overflows, and the exps fall from one an
// element to one a row and one a column.
//
// What bounds each launch at the train shape (NVIDIA H100 80GB HBM3,
// 700 W; scripts/ssd_bwd_stages.py builds each with a part taken out):
// dx (1.2 ms) its decay of the scores near the diagonal and its short
// blocks (about 9 slabs each); w (0.73) its per-head epilogue, the decays
// and the column sums (0.28 of it); dbc (0.78) and dstate (0.37) the
// products and the split at fragment load, about half of each, then the
// copies; dda (0.35) its reads of dy, y, dH and H (bytes).
#include <cooperative_groups.h>

#include "ssd_common.cuh"

namespace cg = cooperative_groups;

namespace {

// slabs in each launch's ring, and the blocks an SM its registers allow
constexpr int kStagesWide = 3;   // dstate, dbc: 2 blocks of 8 warps an SM
constexpr int kStagesW = 3;
constexpr int kStagesDx = 3;
constexpr int kBlocksW = 3;      // w, dx: 4 warps a block
constexpr int kBlocksDx = 3;
constexpr int kHG = 4;       // head groups of ssd_bwd_w: a cluster's blocks
constexpr int kLdW = kB + 4;   // rows of a block's W partial in ssd_bwd_w

using Wide = Ring<128, 64>;    // dstate, dbc: 64 x 128 tiles, 8 warps
using Narrow = Ring<64, 0>;    // dx: 64 x 64, 4 warps
using WRing = Ring<64, 320>;   // w: 64 x 64, 4 warps, a head's cum and dt

struct Bufs {   // the backward's scratch (layout_of)
  double* cum;   // [BH, S] in-chunk inclusive cumsum of da
  float* dh;     // [BH, chunks, P, N] dH_{c+1} of chunk c
  float* w;      // [rows, chunks, Q, wld] W summed over the g heads
  float* cs;     // [BH, chunks, 2 Q / 64, Q] column sums by 32-row group
  float* ecum;   // [BH, S] exp(cum_i)
  float* fj;     // [BH, S] exp(cum_end - cum_j)
  float* wj;     // [BH, S] dt_j exp(cum_end - cum_j)
  float* u;      // [BH, S] U
  int wld;       // W's row pitch: Q rounded up to 16 bytes
};

// the forward's work buffer: scores [rows, chunks, Q, Q], entering states
// [BH, chunks, P, N], exp(cum_end) [BH, chunks]
struct Fwd {
  const float* scores;
  const float* states;
  const float* gdec;
};

// offsets (floats) of the scratch's arrays, each on 16 bytes
struct Layout {
  long long cum, dh, w, cs, ecum, fj, wj, u, total;
  int wld;
};

Layout layout_of(const Shape& sh) {
  auto pad = [](long long v) { return (v + 3) & ~3LL; };
  const long long bhs = (long long)sh.bh * sh.s;
  const long long ntq = (sh.q + kB - 1) / kB;
  Layout l;
  l.wld = (int)pad(sh.q);
  l.cum = 0;
  l.dh = pad(2 * bhs);
  l.w = l.dh + pad((long long)sh.bh * sh.nch * sh.p * sh.n);
  l.cs = l.w + pad((long long)(sh.bh / sh.g) * sh.nch * sh.q * l.wld);
  l.ecum = l.cs + pad((long long)sh.bh * sh.nch * 2 * ntq * sh.q);
  l.fj = l.ecum + pad(bhs);
  l.wj = l.fj + pad(bhs);
  l.u = l.wj + pad(bhs);
  l.total = l.u + pad(bhs);
  return l;
}

// 0. cum per (head, chunk), and the factors the products scale by
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
  const double dend = dac[qc - 1];
  for (int i = threadIdx.x; i < qc; i += kThreads) {
    const float f = expf((float)(dend - dac[i]));
    bf.cum[off + i] = dac[i];
    bf.ecum[off + i] = expf((float)dac[i]);
    bf.fj[off + i] = f;
    bf.wj[off + i] = dts[i] * f;
  }
}

// 1. per (head, 64 x 128 tile of [P, N]): the chunks in reverse; slot c of
// dh gets dH_{c+1}, the gradient of the state leaving chunk c
__global__ void __launch_bounds__(Wide::kThreads, 2)
ssd_bwd_dstate(const float* __restrict__ dy, const float* __restrict__ cm,
               const float* __restrict__ gdec,
               const float* __restrict__ dstate, Bufs bf, Shape sh) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  constexpr int NT = Wide::kThreads;
  const int npt = (sh.p + kB - 1) / kB, nnt = (sh.n + 127) / 128;
  const int bh = blockIdx.x / (npt * nnt);
  const int tile = blockIdx.x % (npt * nnt);
  const int p0 = (tile / nnt) * kB, n0 = (tile % nnt) * 128;
  const size_t pn = (size_t)sh.p * sh.n;
  float* slots = bf.dh + (size_t)bh * sh.nch * pn;
  const float* gd = gdec + (size_t)bh * sh.nch;
  const float* dyb = dy + (size_t)bh * sh.s * sh.p;
  const float* cb = cm + (size_t)(bh / sh.g) * sh.s * sh.n;
  const float* eb = bf.ecum + (size_t)bh * sh.s;
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pp = p0 + ring_row(mt, e), nn = n0 + ring_col(nt, e);
        const bool ok = pp < sh.p && nn < sh.n;
        const float v = dstate != nullptr && ok
                            ? dstate[bh * pn + (size_t)pp * sh.n + nn]
                            : 0.f;
        acc[mt][nt][e] = v;
        if (ok) slots[(sh.nch - 1) * pn + (size_t)pp * sh.n + nn] = v;
      }
  // slabs: the last chunk's, then chunk nch - 2, ..., 1 (chunk 0's own
  // term only reaches the gradient of the initial state, which is 0)
  const int qlast = sh.s - (sh.nch - 1) * sh.q;
  const int nsl = (qlast + kRS - 1) / kRS, nsf = (sh.q + kRS - 1) / kRS;
  const int nslab = sh.nch > 1 ? nsl + (sh.nch - 2) * nsf : 0;
  // each callback's place: chunk c, slab start k0 (slabs in order)
  struct At {
    int c, k0;
  } ai{sh.nch - 1, 0}, as{sh.nch - 1, 0};
  auto next = [&](At& a) {
    a.k0 += kRS;
    if (a.k0 >= min(sh.q, sh.s - a.c * sh.q)) {
      --a.c;
      a.k0 = 0;
    }
  };
  ring_loop<kStagesWide>(
      nslab,
      [&](int, int st) {
        const int c = ai.c, k0 = ai.k0;
        next(ai);
        const int qc = min(sh.q, sh.s - c * sh.q);
        const size_t i0 = (size_t)c * sh.q + k0;
        box<kRS, kB, NT>(Wide::a(ring, st), kLdA, dyb + i0 * sh.p + p0,
                         sh.p, qc - k0, sh.p - p0, dy);
        box<kRS, 128, NT>(Wide::b(ring, st), Wide::kLdB,
                          cb + i0 * sh.n + n0, sh.n, qc - k0, sh.n - n0, cm);
        side_copy<float>(Wide::side(ring, st), eb + i0, kRS, qc - k0,
                         bf.ecum);
      },
      [](int, int) {},
      [&](int, int st) {
        const int c = as.c, k0 = as.k0;
        next(as);
        if (k0 == 0) {   // the chunk's first slab: the carry decays
          const float g = gd[c];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[mt][nt][e] *= g;
        }
        // A[p][i] = exp(cum_i) dy_i[p], B[i][n] = C_i[n]
        mma_ring<128, true, true, kKScale>(Wide::a(ring, st),
                                           Wide::b(ring, st),
                                           Wide::side(ring, st), acc);
        const int qc = min(sh.q, sh.s - c * sh.q);
        if (k0 + kRS >= qc) {   // the chunk's last slab: dH_c into slot c - 1
          float* out = slots + (size_t)(c - 1) * pn;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int pp = p0 + ring_row(mt, e), nn = n0 + ring_col(nt, e);
                if (pp < sh.p && nn < sh.n)
                  out[(size_t)pp * sh.n + nn] = acc[mt][nt][e];
              }
        }
      });
}

// 2. per (B/C row, chunk, tile (ti, tj) on or below the diagonal, head
// group): W over the group's heads, each head's column sums of W o (C B^T)
// by 32-row group; the cluster's 4 partial W added in rank order
__global__ void __cluster_dims__(kHG, 1, 1)
    __launch_bounds__(WRing::kThreads, kBlocksW)
ssd_bwd_w(const float* __restrict__ x, const float* __restrict__ dy,
          const float* __restrict__ dt, Fwd fw, Bufs bf, Shape sh,
          int ntri) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  constexpr int NT = WRing::kThreads;
  cg::cluster_group cluster = cg::this_cluster();
  const int hg = (int)cluster.block_rank();
  const int lin = blockIdx.x / kHG;
  int tri = lin % ntri;
  const int rc = lin / ntri;   // row * nch + c
  const int row = rc / sh.nch, c = rc % sh.nch;
  const int c0 = c * sh.q;
  const int qc = min(sh.q, sh.s - c0);
  int ti = 0;
  while (tri > ti) tri -= ++ti;
  const int tj = tri;
  if (ti * kB >= qc) return;   // the whole cluster
  const int i0 = ti * kB, j0 = tj * kB;
  const int h0 = hg * sh.g / kHG, h1 = (hg + 1) * sh.g / kHG;
  const int nps = (sh.p + kRS - 1) / kRS;
  const int nrg = 2 * ((sh.q + kB - 1) / kB);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the tile's scores at the accumulator's places, 0 off the mask
  const float* sc = fw.scores + (size_t)rc * sh.q * sh.q;
  float scv[2][4][4], acc[2][4][4], wacc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + ring_row(mt, e), j = j0 + ring_col(nt, e);
        scv[mt][nt][e] = j <= i && i < qc ? sc[(size_t)i * sh.q + j] : 0.f;
        acc[mt][nt][e] = wacc[mt][nt][e] = 0.f;
      }
  Walk wi(nps), ws(nps);   // (head of the group, slab of the head)
  ring_loop<kStagesW>(
      (h1 - h0) * nps,
      [&](int, int st) {
        const int k0 = kRS * wi.inner;
        const bool last = wi.inner == nps - 1;
        const size_t off = (size_t)(row * sh.g + h0 + wi.outer) * sh.s + c0;
        wi.next();
        // A[i][p] = dy_i[p], B[j][p] = x_j[p]
        box<kB, kRS, NT>(WRing::a(ring, st), kLdR,
                         dy + (off + i0) * sh.p + k0, sh.p, qc - i0,
                         sh.p - k0, dy);
        box<kB, kRS, NT>(WRing::b(ring, st), kLdR,
                         x + (off + j0) * sh.p + k0, sh.p, qc - j0,
                         sh.p - k0, x);
        if (last) {   // the head's cum and dt, for its epilogue
          double* cd = reinterpret_cast<double*>(WRing::side(ring, st));
          side_copy<double>(cd, bf.cum + off + i0, kB, qc - i0, bf.cum);
          side_copy<double>(cd + kB, bf.cum + off + j0, kB, qc - j0, bf.cum);
          side_copy<float>(reinterpret_cast<float*>(cd + 2 * kB),
                           dt + off + j0, kB, qc - j0, dt);
        }
      },
      [](int, int) {},
      [&](int, int st) {
        mma_ring<64, false, false, kNoScale>(WRing::a(ring, st),
                                             WRing::b(ring, st), nullptr,
                                             acc);
        const bool last = ws.inner == nps - 1;
        const int bh = row * sh.g + h0 + ws.outer;
        ws.next();
        if (!last) return;
        const double* ci =
            reinterpret_cast<const double*>(WRing::side(ring, st));
        const double* cj = ci + kB;
        const float* dtj = reinterpret_cast<const float*>(cj + kB);
        // where this warp's 32 x 32 lies wholly below the diagonal (the
        // tile does, or it is the diagonal tile's lower left quadrant) the
        // decay is taken through a pivot row pv: exp(cum_i - cum_pv)
        // exp(cum_pv - cum_j), both exponents in fp64 and <= 0 (da <= 0,
        // j < pv <= i), so neither factor overflows: 12 exps, not 32
        const bool below = ti > tj || ((warp & 1) == 1 && (warp >> 1) == 0);
        const int pv = ti > tj ? 0 : 32;   // the pivot's row in the tile
        float fr[2][2], fc[4][2];
        if (below) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int ri = ring_row(mt, 2 * h);
              fr[mt][h] =
                  i0 + ri < qc ? expf((float)(ci[ri] - ci[pv])) : 0.f;
            }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              const int rj = ring_col(nt, k);
              fc[nt][k] = i0 + pv < qc ? expf((float)(ci[pv] - cj[rj])) : 0.f;
            }
        }
        float col[4][2] = {};
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int ri = ring_row(mt, e), rj = ring_col(nt, e);
              const int i = i0 + ri, j = j0 + rj;
              float w = 0.f;
              if (below)
                w = acc[mt][nt][e] * (fr[mt][e >> 1] * fc[nt][e & 1]) *
                    dtj[rj];
              else if (j <= i && i < qc)   // the mask before the exp
                w = acc[mt][nt][e] * expf((float)(ci[ri] - cj[rj])) *
                    dtj[rj];
              wacc[mt][nt][e] += w;
              col[nt][e & 1] += w * scv[mt][nt][e];
              acc[mt][nt][e] = 0.f;
            }
        // column sums over the warp's 32 rows: its 4 rows a thread, then
        // the 8 lanes of a column (gid), in order
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            float v = col[nt][k];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            const int j = j0 + ring_col(nt, k);
            if (lane < 4 && j < qc)
              bf.cs[(((size_t)bh * sh.nch + c) * nrg + 2 * ti + (warp & 1)) *
                        sh.q + j] = v;
          }
      });
  __syncthreads();   // every warp is done with the ring
  float* part = ring;   // [64][kLdW]: this block's partial W
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[ring_row(mt, e) * kLdW + ring_col(nt, e)] = wacc[mt][nt][e];
  cluster.sync();   // the 4 partials written
  // rows [16 hg, +16) of the tile: the partials in rank order
  constexpr int kRows = kB / kHG;
  for (int idx = threadIdx.x; idx < kRows * kB; idx += NT) {
    const int r = hg * kRows + idx / kB, cc = idx % kB;
    float v = 0.f;
#pragma unroll
    for (int rk = 0; rk < kHG; ++rk)
      v += cluster.map_shared_rank(part, rk)[r * kLdW + cc];
    const int i = i0 + r, j = j0 + cc;
    if (i < qc && j < qc) bf.w[((size_t)rc * sh.q + i) * bf.wld + j] = v;
  }
  cluster.sync();   // no block leaves while another reads its partial
}

// 4. per (head, chunk, 64-row tile j): dx, ddt and U over the P tiles
__global__ void __launch_bounds__(Narrow::kThreads, kBlocksDx)
ssd_bwd_dx(const float* __restrict__ x, const float* __restrict__ bm,
           const float* __restrict__ dt, const float* __restrict__ dy,
           Fwd fw, Bufs bf, float* __restrict__ dx, float* __restrict__ ddt,
           Shape sh) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NT = Narrow::kThreads;
  double* cums = reinterpret_cast<double*>(smem);   // the chunk's cum
  float* ring = reinterpret_cast<float*>(smem + ((sh.q * 8 + 15) & ~15));
  // the row tiles of one (head, chunk) are neighbours in the grid, so they
  // run together and read that chunk's dy and dH_{c+1} from L2
  const int ntq = (sh.q + kB - 1) / kB;
  const int hc = blockIdx.x / ntq;   // bh * nch + c
  const int bh = hc / sh.nch, c = hc % sh.nch;
  const int c0 = c * sh.q;
  const int qc = min(sh.q, sh.s - c0);
  const int j0 = (blockIdx.x % ntq) * kB;
  if (j0 >= qc) return;
  const size_t off = (size_t)bh * sh.s + c0;
  for (int i = threadIdx.x; i < qc; i += NT) cums[i] = bf.cum[off + i];
  __syncthreads();
  // past the tile's diagonal (i >= pv = j0 + 64 > j) the decay is taken
  // through pv: exp(cum_i - cum_pv) exp(cum_pv - cum_j), both exponents in
  // fp64 and <= 0 (da <= 0), so neither factor overflows; the column
  // factors of this thread's 4 columns (its chunks' columns, box_chunk) once
  const int pv = j0 + kB;
  float fcol[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = j0 + (threadIdx.x % (kB / 4)) * 4 + q;
    fcol[q] = pv < qc ? expf((float)(cums[pv] - cums[j])) : 0.f;
  }
  const int row = bh / sh.g;
  const float* sc = fw.scores + ((size_t)row * sh.nch + c) * sh.q * sh.q;
  const float* dyb = dy + off * sh.p;
  const float* xb = x + off * sh.p;
  const float* bb = bm + ((size_t)row * sh.s + c0) * sh.n;
  const float* dhb = bf.dh + (size_t)hc * sh.p * sh.n;
  const int na2 = (sh.n + kRS - 1) / kRS;
  const int nper = na2 + (qc - j0 + kRS - 1) / kRS;   // slabs a P tile
  const int npt = (sh.p + kB - 1) / kB;
  float fr[2][2], dtr[2][2];   // exp(cum_end - cum_j), dt_j of its rows
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + ring_row(mt, 2 * h);
      fr[mt][h] = j < qc ? bf.fj[off + j] : 0.f;
      dtr[mt][h] = j < qc ? dt[off + j] : 0.f;
    }
  // the tile's x, which the epilogues read, on its way to L1 (one 128-byte
  // line a thread at P 64)
  for (int l = threadIdx.x; l < min(kB, qc - j0) * sh.p / 32; l += NT)
    asm volatile("prefetch.global.L1 [%0];" ::"l"(xb + (size_t)j0 * sh.p +
                                                   32 * l));
  float vd[2][2] = {}, vu[2][2] = {}, acc[2][4][4];
  zero_ring(acc);
  Walk wi(nper), wp(nper), ws(nper);   // (P tile, slab of the tile)
  ring_loop<kStagesDx>(
      npt * nper,
      [&](int, int st) {
        const int r = wi.inner, p0 = kB * wi.outer;
        wi.next();
        if (r < na2) {   // A[j][n] = B_j[n], B[p][n] = dH_{c+1}[p][n]
          const int k0 = kRS * r;
          box<kB, kRS, NT>(Narrow::a(ring, st), kLdR,
                           bb + (size_t)j0 * sh.n + k0, sh.n, qc - j0,
                           sh.n - k0, bm);
          box<kB, kRS, NT>(Narrow::b(ring, st), kLdR,
                           dhb + (size_t)p0 * sh.n + k0, sh.n, sh.p - p0,
                           sh.n - k0, bf.dh);
        } else {   // A[j][i] = scores[i][j] (decayed in prep), B = dy_i[p]
          const int k0 = j0 + kRS * (r - na2);
          box<kRS, kB, NT>(Narrow::a(ring, st), kLdA,
                           sc + (size_t)k0 * sh.q + j0, sh.q, qc - k0,
                           qc - j0, fw.scores);
          box<kRS, kB, NT>(Narrow::b(ring, st), Narrow::kLdB,
                           dyb + (size_t)k0 * sh.p + p0, sh.p, qc - k0,
                           sh.p - p0, dy);
        }
      },
      [&](int, int st) {   // M_ij = scores_ij exp(cum_i - cum_j), j <= i
        const int r = wp.inner;
        wp.next();
        if (r < na2) return;
        const int k0 = j0 + kRS * (r - na2);
        float* a = Narrow::a(ring, st);
#pragma unroll
        for (int e = 0; e < kRS * kB / 4 / NT; ++e) {
          int rr, cc;
          box_chunk<kB, NT>(e, rr, cc);
          const int i = k0 + rr;
          // the 4 values a 16-byte access: a quarter warp's 8 chunks lie
          // on 32 different banks (one value at a time: 4 ways at most)
          float4* p4 = reinterpret_cast<float4*>(a + rr * kLdA + cc);
          const float4 v = *p4;
          float vq[4] = {v.x, v.y, v.z, v.w};
          if (k0 >= pv) {   // below the tile: every j < pv <= i
            const float fr =
                i < qc ? expf((float)(cums[i] - cums[pv])) : 0.f;
#pragma unroll
            for (int q = 0; q < 4; ++q) vq[q] = vq[q] * (fr * fcol[q]);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int j = j0 + cc + q;
              vq[q] = j <= i && i < qc
                          ? vq[q] * expf((float)(cums[i] - cums[j]))
                          : 0.f;
            }
          }
          *p4 = make_float4(vq[0], vq[1], vq[2], vq[3]);
        }
      },
      [&](int, int st) {
        const int r = ws.inner, p0 = kB * ws.outer;
        ws.next();
        if (r < na2)
          mma_ring<64, false, false, kNoScale>(
              Narrow::a(ring, st), Narrow::b(ring, st), nullptr, acc);
        else
          mma_ring<64, true, true, kNoScale>(
              Narrow::a(ring, st), Narrow::b(ring, st), nullptr, acc);
        if (r == na2 - 1) {   // the state part, and U's share of it
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int j = j0 + ring_row(mt, e), pp = p0 + ring_col(nt, e);
                const float st_ = fr[mt][e >> 1] * acc[mt][nt][e];
                acc[mt][nt][e] = st_;
                if (j < qc && pp < sh.p)
                  vu[mt][e >> 1] += xb[(size_t)j * sh.p + pp] * st_;
              }
        }
        if (r == nper - 1) {   // the bracket: dx and ddt's share
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int j = j0 + ring_row(mt, e), pp = p0 + ring_col(nt, e);
                const float inner = acc[mt][nt][e];
                acc[mt][nt][e] = 0.f;
                if (j >= qc || pp >= sh.p) continue;
                dx[(off + j) * sh.p + pp] = dtr[mt][e >> 1] * inner;
                vd[mt][e >> 1] += xb[(size_t)j * sh.p + pp] * inner;
              }
        }
      });
  // row sums: the 4 lanes of a row (tig), then the two column warps
  __syncthreads();   // every warp is done with the ring
  float* red = ring;   // [column warp][ddt, U][64]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float a = vd[mt][h], b = vu[mt][h];
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      b += __shfl_xor_sync(0xffffffffu, b, 1);
      b += __shfl_xor_sync(0xffffffffu, b, 2);
      if ((lane & 3) == 0) {
        const int rr = ring_row(mt, 2 * h);
        red[((warp >> 1) * 2) * kB + rr] = a;
        red[((warp >> 1) * 2 + 1) * kB + rr] = b;
      }
    }
  __syncthreads();
  const int j = j0 + threadIdx.x;
  if (threadIdx.x < kB && j < qc) {
    ddt[off + j] = red[threadIdx.x] + red[2 * kB + threadIdx.x];
    bf.u[off + j] =
        dt[off + j] * (red[kB + threadIdx.x] + red[3 * kB + threadIdx.x]);
  }
}

// 5. per (B/C row, chunk, 64-row tile, 128-column tile of N); blockIdx.y
// 0: dC of rows i, 1: dB of rows j
__global__ void __launch_bounds__(Wide::kThreads, 2)
ssd_bwd_dbc(const float* __restrict__ x, const float* __restrict__ bm,
            const float* __restrict__ cm, const float* __restrict__ dy,
            Fwd fw, Bufs bf, float* __restrict__ db, float* __restrict__ dc,
            Shape sh) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  constexpr int NT = Wide::kThreads;
  const bool is_b = blockIdx.y == 1;
  const int nqt = (sh.q + kB - 1) / kB, nnt = (sh.n + 127) / 128;
  int lin = blockIdx.x;
  const int n0 = (lin % nnt) * 128;
  lin /= nnt;
  const int r0 = (lin % nqt) * kB;   // the tile's first row (i or j)
  const int rc = lin / nqt;          // row * nch + c
  const int row = rc / sh.nch, c = rc % sh.nch;
  const int c0 = c * sh.q;
  const int qc = min(sh.q, sh.s - c0);
  if (r0 >= qc) return;
  const float* wb = bf.w + (size_t)rc * sh.q * bf.wld;
  const float* other = (is_b ? cm : bm) + ((size_t)row * sh.s + c0) * sh.n;
  // the W product's slabs: dB over i from r0, dC over j up to the tile
  const int nw = is_b ? (qc - r0 + kRS - 1) / kRS
                      : (min(r0 + kB, qc) + kRS - 1) / kRS;
  const int nps = (sh.p + kRS - 1) / kRS;
  // the state terms, over (head, p): dC: A[i][(h, p)] = exp(cum_i) dy_i[p]
  // (H_0 = 0: none in chunk 0), B = H_c[p][n]; dB: A[j][(h, p)] = dt_j
  // exp(cum_end - cum_j) x_j[p], B = dH_{c+1}[p][n]
  const int ns = !is_b && c == 0 ? 0 : sh.g * nps;
  const float* a_src = is_b ? x : dy;
  const float* st_src = is_b ? bf.dh : fw.states;
  const float* fac = is_b ? bf.wj : bf.ecum;
  float acc[2][4][4];
  zero_ring(acc);
  Walk wi(nps);   // (head, slab of the head) of the state terms
  ring_loop<kStagesWide>(
      nw + ns,
      [&](int s, int st) {
        if (s < nw) {
          int k0;
          if (is_b) {   // A[j][i] = W[i][j]
            k0 = r0 + kRS * s;
            box<kRS, kB, NT>(Wide::a(ring, st), kLdA,
                             wb + (size_t)k0 * bf.wld + r0, bf.wld, qc - k0,
                             qc - r0, bf.w);
          } else {      // A[i][j] = W[i][j]
            k0 = kRS * s;
            box<kB, kRS, NT>(Wide::a(ring, st), kLdR,
                             wb + (size_t)r0 * bf.wld + k0, bf.wld, qc - r0,
                             min(r0 + kB, qc) - k0, bf.w);
          }
          box<kRS, 128, NT>(Wide::b(ring, st), Wide::kLdB,
                            other + (size_t)k0 * sh.n + n0, sh.n, qc - k0,
                            sh.n - n0, bm);
        } else {
          const int k0 = kRS * wi.inner;
          const int bh = row * sh.g + wi.outer;
          wi.next();
          const size_t off = (size_t)bh * sh.s + c0;
          box<kB, kRS, NT>(Wide::a(ring, st), kLdR,
                           a_src + (off + r0) * sh.p + k0, sh.p, qc - r0,
                           sh.p - k0, x);
          box<kRS, 128, NT>(
              Wide::b(ring, st), Wide::kLdB,
              st_src + (((size_t)bh * sh.nch + c) * sh.p + k0) * sh.n + n0,
              sh.n, sh.p - k0, sh.n - n0, bf.dh);
          side_copy<float>(Wide::side(ring, st), fac + off + r0, kB, qc - r0,
                           fac);
        }
      },
      [](int, int) {},
      [&](int s, int st) {
        if (s >= nw)
          mma_ring<128, false, true, kRowScale>(
              Wide::a(ring, st), Wide::b(ring, st), Wide::side(ring, st),
              acc);
        else if (is_b)
          mma_ring<128, true, true, kNoScale>(
              Wide::a(ring, st), Wide::b(ring, st), nullptr, acc);
        else
          mma_ring<128, false, true, kNoScale>(
              Wide::a(ring, st), Wide::b(ring, st), nullptr, acc);
      });
  float* out = (is_b ? db : dc) + ((size_t)row * sh.s + c0) * sh.n;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = r0 + ring_row(mt, e), nn = n0 + ring_col(nt, e);
        if (i < qc && nn < sh.n) out[(size_t)i * sh.n + nn] = acc[mt][nt][e];
      }
}

// 5. per (head, chunk): dda_k = sum_{i>=k} (dy_i . y_i - Cs_i) + E +
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
  const int nrg = 2 * ((sh.q + kB - 1) / kB);   // 32-row groups
  const int qrg = 2 * ((qc + kB - 1) / kB);      // those W's tiles reach
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
      for (int rg = 2 * (i / kB); rg < qrg; ++rg)
        cs += bf.cs[(((size_t)bh * sh.nch + c) * nrg + rg) * sh.q + i];
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
  const Layout l = layout_of(sh);
  Bufs bf;
  bf.cum = reinterpret_cast<double*>(scratch + l.cum);
  bf.dh = scratch + l.dh;
  bf.w = scratch + l.w;
  bf.cs = scratch + l.cs;
  bf.ecum = scratch + l.ecum;
  bf.fj = scratch + l.fj;
  bf.wj = scratch + l.wj;
  bf.u = scratch + l.u;
  bf.wld = l.wld;

  const size_t s_cum = (size_t)sh.q * (sizeof(double) + sizeof(float));
  const size_t s_wide = (size_t)kStagesWide * Wide::kStage * sizeof(float);
  const size_t s_w = (size_t)kStagesW * WRing::kStage * sizeof(float);
  const size_t s_dx = (((size_t)sh.q * sizeof(double) + 15) & ~(size_t)15) +
                      (size_t)kStagesDx * Narrow::kStage * sizeof(float);
  const size_t s_dda =
      (size_t)2 * sh.q * sizeof(double) + kThreads * sizeof(float);
  static_assert((size_t)kB * kLdW <= (size_t)kStagesW * WRing::kStage &&
                    4 * kB <= kStagesDx * Narrow::kStage,
                "the partial W and dx's row sums fit in their rings");
  if (s_dx > kMaxSmem || s_dda > kMaxSmem || s_cum > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
  const void* fns[] = {(const void*)ssd_bwd_dstate, (const void*)ssd_bwd_w,
                       (const void*)ssd_bwd_dx, (const void*)ssd_bwd_dbc};
  const size_t sizes[] = {s_wide, s_w, s_dx, s_wide};
  for (int i = 0; i < 4 && e == cudaSuccess; ++i)
    e = cudaFuncSetAttribute(fns[i],
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sizes[i]);
  if (e != cudaSuccess) return (int)e;
  const int hcs = sh.bh * sh.nch;
  const int npt = (sh.p + kB - 1) / kB, nnt = (sh.n + 127) / 128;
  ssd_bwd_cum<<<hcs, kThreads, s_cum, stream>>>(dt, da, bf, sh);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_bwd_dstate<<<sh.bh * npt * nnt, Wide::kThreads, s_wide, stream>>>(
      dy, cm, fw.gdec, dstate, bf, sh);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int ntri = tri_tiles(sh.q);
  ssd_bwd_w<<<rows * sh.nch * ntri * kHG, WRing::kThreads, s_w, stream>>>(
      x, dy, dt, fw, bf, sh, ntri);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_bwd_dx<<<hcs * ntq, Narrow::kThreads, s_dx, stream>>>(
      x, bm, dt, dy, fw, bf, dx, ddt, sh);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_bwd_dbc<<<dim3(rows * sh.nch * ntq * nnt, 2), Wide::kThreads, s_wide,
                stream>>>(x, bm, cm, dy, fw, bf, db, dc, sh);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_bwd_dda<<<hcs, kThreads, s_dda, stream>>>(dy, y, fw, bf, dda, sh);
  return (int)cudaGetLastError();
}

}  // namespace

// floats of the backward's scratch: cum [BH, S] (fp64, two floats each),
// dH [BH, chunks, P, N], W [rows, chunks, Q, Q rounded up to 4], the column
// sums [BH, chunks, 2 Q / 64, Q], and exp(cum), exp(cum_end - cum),
// dt exp(cum_end - cum) and U [BH, S] (layout_of)
extern "C" long long ssd_scan_bwd_scratch_floats(int bh, int s, int p, int n,
                                                 int chunk, int g) {
  if (bh <= 0 || s <= 0 || chunk <= 0 || g <= 0) return 0;
  return layout_of(shape_of(bh, s, p, n, chunk, g)).total;
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
