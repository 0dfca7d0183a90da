// The block-tile products and chunk helpers shared by the SSD scan's
// forward (ssd_scan.cu) and backward (ssd_scan_bwd.cu): 64 x 64 output
// tiles of 8 warps, operands staged in shared memory as TF32 high parts and
// remainders (3xTF32 mma.sync), the next slab's loads in flight while this
// slab's products run; the fp64 in-chunk cumsum of da; the shapes.
#pragma once

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps: 4 (rows) x 2 (columns) of 16 x 32
constexpr int kB = 64;         // rows and columns of a block tile
constexpr int kK = 32;         // reduction slab
constexpr int kLdM = kK + 4;   // [64][36]: rows m (or n), inner k
constexpr int kLdK = kB + 8;   // [32][72]: rows k, inner m (or n)
constexpr int kPlane = kB * kLdM;   // == kK * kLdK floats
constexpr size_t kMaxSmem = 232448;

static_assert(kB * kLdM == kK * kLdK, "planes of one size");

using repro::mma_tf32;
using repro::tf32;

// A slab operand in shared memory: the TF32 high parts and remainders of a
// 64 x 32 tile. K-major: [k][72] (global rows along k, contiguous along m or
// n); else [m][36] (contiguous along k). The paddings keep both the staging
// stores and the fragment loads on 32 different banks.
struct Planes {
  unsigned* hi;
  unsigned* lo;
};

template <bool KMAJ>
__device__ __forceinline__ int at(int r, int k) {
  return KMAJ ? k * kLdK + r : r * kLdM + k;
}

// element e (of 8) of a thread's share of a 64 x 32 slab operand: row r
// (m or n) and reduction index k; consecutive threads walk the dimension
// that is contiguous in global memory
template <bool KMAJ>
__device__ __forceinline__ void coords(int e, int& r, int& k) {
  const int idx = threadIdx.x + e * kThreads;
  r = KMAJ ? idx % kB : idx / kK;
  k = KMAJ ? idx / kB : idx % kK;
}

// acc += A B over one slab: A [64 rows m][32 k], B [32 k][64 columns n];
// warp w holds rows 16 (w / 2) .. +16 and columns 32 (w % 2) .. +32, as
// four m16n8 accumulators: acc[t] = (row gid, col 2 tig + {0, 1}) and
// (row gid + 8, ...) of the 8 columns from 8 t
template <bool AK, bool BK>
__device__ __forceinline__ void mma_slab(Planes A, Planes B,
                                         float (&acc)[4][4]) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = (warp >> 1) * 16, n0 = (warp & 1) * 32;
#pragma unroll
  for (int k0 = 0; k0 < kK; k0 += 8) {
    unsigned ah[4], al[4];
    const int ia[4] = {at<AK>(m0 + gid, k0 + tig), at<AK>(m0 + gid + 8, k0 + tig),
                       at<AK>(m0 + gid, k0 + tig + 4),
                       at<AK>(m0 + gid + 8, k0 + tig + 4)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ah[i] = A.hi[ia[i]];
      al[i] = A.lo[ia[i]];
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int n = n0 + 8 * t + gid;
      const int i0 = at<BK>(n, k0 + tig), i1 = at<BK>(n, k0 + tig + 4);
      const unsigned bh[2] = {B.hi[i0], B.hi[i1]};
      const unsigned bl[2] = {B.lo[i0], B.lo[i1]};
      mma_tf32(acc[t], al, bh);
      mma_tf32(acc[t], ah, bl);
      mma_tf32(acc[t], ah, bh);
    }
  }
}

constexpr int kPer = kB * kK / kThreads;   // operand elements per thread

// acc += sum over nslab slabs s of A_s B_s. fa(s, r, k) reads the raw value
// of A's element (row r, reduction k) of slab s from global memory, in its
// stored type (0 where masked); ga(s, r, k, raw) turns it into the fp32
// operand when it is staged (then split into TF32 parts); fb, gb likewise
// for B. Slab s + 1's loads are in flight while slab s's products run:
// nothing uses a loaded value, not even to widen it, before the products
// are issued.
template <bool AK, bool BK, typename FA, typename GA, typename FB, typename GB>
__device__ __forceinline__ void gemm(int nslab, Planes A, Planes B, FA fa,
                                     GA ga, FB fb, GB gb,
                                     float (&acc)[4][4]) {
  decltype(fa(0, 0, 0)) ra[kPer];
  decltype(fb(0, 0, 0)) rb[kPer];
  auto fetch = [&](int sl) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      int r, k;
      coords<AK>(e, r, k);
      ra[e] = fa(sl, r, k);
      coords<BK>(e, r, k);
      rb[e] = fb(sl, r, k);
    }
  };
  auto put = [](Planes p, int at_, float v) {
    const unsigned h = tf32(v);
    p.hi[at_] = h;
    p.lo[at_] = tf32(v - __uint_as_float(h));
  };
  if (nslab > 0) fetch(0);
  for (int sl = 0; sl < nslab; ++sl) {
    __syncthreads();   // the previous products are done with the planes
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      int r, k;
      coords<AK>(e, r, k);
      put(A, at<AK>(r, k), ga(sl, r, k, ra[e]));
      coords<BK>(e, r, k);
      put(B, at<BK>(r, k), gb(sl, r, k, rb[e]));
    }
    __syncthreads();
    if (sl + 1 < nslab) fetch(sl + 1);
    mma_slab<AK, BK>(A, B, acc);
  }
}

struct Widen {   // an operand staged as it was read, widened to fp32
  template <typename U>
  __device__ float operator()(int, int, int, U v) const {
    return repro::to_float(v);
  }
};

// row (0..63) and column (0..63) of accumulator element e of acc[t]
__device__ __forceinline__ int acc_row(int e) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp >> 1) * 16 + (lane >> 2) + (e >> 1) * 8;
}
__device__ __forceinline__ int acc_col(int t, int e) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp & 1) * 32 + 8 * t + 2 * (lane & 3) + (e & 1);
}

__device__ __forceinline__ void zero_acc(float (&acc)[4][4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
}

// dac[i] = da[0] + ... + da[i] in fp64, dts = dt. Every thread loads a
// share of da (one round trip), then one warp scans it in place: each lane
// sums a contiguous segment, then a shuffle scan of the segment sums.
template <typename T>
__device__ void chunk_scan(const T* __restrict__ da, const T* __restrict__ dt,
                           int qc, double* dac, float* dts) {
  for (int i = threadIdx.x; i < qc; i += kThreads) {
    dac[i] = (double)repro::to_float(da[i]);
    dts[i] = repro::to_float(dt[i]);
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = (qc + 31) / 32;
    const int lo = min(lane * per, qc);
    const int hi = min(lo + per, qc);
    double run = 0.0;
    for (int i = lo; i < hi; ++i) run += dac[i];
    double incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    double acc = incl - run;
    for (int i = lo; i < hi; ++i) {
      acc += dac[i];
      dac[i] = acc;
    }
  }
}

struct Shape {
  int bh, s, p, n, q, g, nch;   // q: chunk length, nch: chunks
};

Shape shape_of(int bh, int s, int p, int n, int chunk, int g) {
  const int q = min(chunk, s);
  return {bh, s, p, n, q, g, (s + q - 1) / q};
}

int tri_tiles(int q) {
  const int nt = (q + kB - 1) / kB;
  return nt * (nt + 1) / 2;
}

}  // namespace
