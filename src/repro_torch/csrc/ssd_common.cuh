// The block-tile products and chunk helpers of the SSD scan's forward
// (ssd_scan.cu) and backward (ssd_scan_bwd.cu). The forward's products
// (gemm): 64 x 64 output tiles of 8 warps, operands staged in shared memory
// as TF32 high parts and remainders (3xTF32 mma.sync), the next slab's
// loads in flight while this slab's products run. The backward's (the
// ring): raw fp32 slabs copied by cp.async into a ring of stages, one block
// barrier a slab, and each value split into its TF32 parts when a fragment
// is loaded, on the FMA pipe; 64 x 64 or 64 x 128 output tiles of 32 x 32
// warp tiles. Both: the fp64 in-chunk cumsum of da; the shapes.
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

// ---- the backward's ring ----
//
// A block tile is 64 rows by BN (64 or 128) columns; warp w holds rows
// 32 (w % 2) .. +32 and columns 32 (w / 2) .. +32 as acc[mt][nt], the m16n8
// tile of rows 16 mt and columns 8 nt: (row gid, cols 2 tig + {0, 1}) and
// (row gid + 8, ...). A slab is 32 of the reduction. Its operands lie in a
// stage as they were read: A [64][36] (rows m, k contiguous) or, K-major,
// [32][72] (rows k, m contiguous); B [BN][36] (rows n) or, K-major,
// [32][BN + 8]. The paddings put the fragment loads (and the 16-byte copies)
// on 32 different banks. Then a side vector of up to SIDE floats that a
// launch stages with the slab (a per-row or per-k scale, or the decays of
// an epilogue).
constexpr int kRS = 32;        // reduction slab
constexpr int kLdR = kRS + 4;  // [rows][36]
constexpr int kLdA = kB + 8;   // [32][72]: A, K-major
constexpr int kRingA = kB * kLdR;

static_assert(kB * kLdR == kRS * kLdA, "A stages of one size");

template <int BN, int SIDE>
struct Ring {
  static constexpr int kWarps = 2 * (BN / 32);
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kLdB = BN + 8;   // [32][BN + 8]: B, K-major
  static constexpr int kBsz = BN * kLdR > kRS * kLdB ? BN * kLdR : kRS * kLdB;
  static constexpr int kStage = kRingA + kBsz + SIDE;   // floats
  static_assert(SIDE % 4 == 0, "16-byte stages");
  __device__ static float* a(float* ring, int st) {
    return ring + st * kStage;
  }
  __device__ static float* b(float* ring, int st) {
    return ring + st * kStage + kRingA;
  }
  __device__ static float* side(float* ring, int st) {
    return ring + st * kStage + kRingA + kBsz;
  }
};

// cp.async of `bytes` (0 .. the copy's size) from src, the rest of the copy
// zero-filled; with 0 bytes nothing is read
__device__ __forceinline__ void cp_zfill16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   repro::smem_u32(dst)), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_zfill4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   repro::smem_u32(dst)), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_zfill8(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   repro::smem_u32(dst)), "l"(src), "r"(bytes));
}

// copy a box of R rows x C columns (columns contiguous in global memory,
// row stride ld floats) from src into dst (row pitch lds floats): rows from
// nr on and columns from nc on are zeros. Thread t takes the 4-column
// chunks t, t + NT, ...: chunk idx is row idx / (C / 4), columns
// 4 (idx % (C / 4)) .. +4 (box_chunk). 16-byte copies where every row
// start is 16-byte aligned, else one 4-byte copy a value. safe: any
// readable address (given to the copies that read nothing).
template <int R, int C, int NT>
__device__ __forceinline__ void box(float* dst, int lds, const float* src,
                                    size_t ld, int nr, int nc,
                                    const float* safe) {
  constexpr int kChunks = R * C / 4;
  const bool vec = (ld & 3) == 0 &&
                   (reinterpret_cast<unsigned long long>(src) & 15) == 0;
  if (vec && nr >= R && nc >= C) {   // the whole box: no bounds a chunk
#pragma unroll
    for (int e = 0; e < (kChunks + NT - 1) / NT; ++e) {
      const int idx = threadIdx.x + e * NT;
      if (kChunks % NT != 0 && idx >= kChunks) break;
      const int r = idx / (C / 4), c = (idx % (C / 4)) * 4;
      cp_zfill16(dst + r * lds + c, src + (size_t)r * ld + c, 16);
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < (kChunks + NT - 1) / NT; ++e) {
    const int idx = threadIdx.x + e * NT;
    if (kChunks % NT != 0 && idx >= kChunks) break;
    const int r = idx / (C / 4), c = (idx % (C / 4)) * 4;
    float* d = dst + r * lds + c;
    const float* s = src + (size_t)r * ld + c;
    const int left = r < nr ? min(max(nc - c, 0), 4) : 0;   // values to read
    if (vec) {
      cp_zfill16(d, left ? s : safe, 4 * left);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        cp_zfill4(d + q, q < left ? s + q : safe, q < left ? 4 : 0);
    }
  }
}

// the first row and column of chunk e (of a thread's share) of a box
template <int C, int NT>
__device__ __forceinline__ void box_chunk(int e, int& r, int& c) {
  const int idx = threadIdx.x + e * NT;
  r = idx / (C / 4);
  c = (idx % (C / 4)) * 4;
}

// n values of a side vector (4 or 8 bytes each, T float or double), those
// from nv on zeros: one copy a value, by threads 0 .. n - 1 (n <= threads)
template <typename T>
__device__ __forceinline__ void side_copy(T* dst, const T* src, int n, int nv,
                                          const T* safe) {
  const int t = threadIdx.x;
  if (t < n) {
    if (sizeof(T) == 8)
      cp_zfill8(dst + t, t < nv ? src + t : safe, t < nv ? 8 : 0);
    else
      cp_zfill4(dst + t, t < nv ? src + t : safe, t < nv ? 4 : 0);
  }
}

// TF32 high parts and remainders of a fragment's values on the FMA pipe
// (common.cuh's split_a: the high part rounded to 11 significant bits, the
// remainder exact and truncated to TF32 by the tensor core)
template <int N>
__device__ __forceinline__ void split_frag(const float (&x)[N],
                                           unsigned (&hi)[N],
                                           unsigned (&lo)[N]) {
  unsigned bits[N];
#pragma unroll
  for (int i = 0; i < N; ++i) bits[i] = __float_as_uint(x[i]);
  repro::split_a(bits, hi, lo);
}

enum Scale { kNoScale, kRowScale, kKScale };

// acc += A B over the slab in one stage (3xTF32: lo.hi + hi.lo + hi.hi);
// SC: A's values times scale[row of the tile] (kRowScale) or scale[k]
// (kKScale) as they are loaded
template <int BN, bool AK, bool BK, int SC>
__device__ __forceinline__ void mma_ring(const float* A, const float* B,
                                         const float* scale,
                                         float (&acc)[2][4][4]) {
  constexpr int kLdB = BN + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = (warp & 1) * 32, n0 = (warp >> 1) * 32;
  auto ia = [](int m, int k) { return AK ? k * kLdA + m : m * kLdR + k; };
  auto ib = [](int n, int k) { return BK ? k * kLdB + n : n * kLdR + k; };
  float rs[2][2];
  if (SC == kRowScale) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      rs[mt][0] = scale[m0 + 16 * mt + gid];
      rs[mt][1] = scale[m0 + 16 * mt + gid + 8];
    }
  }
#pragma unroll
  for (int k0 = 0; k0 < kRS; k0 += 8) {
    unsigned ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int m = m0 + 16 * mt + gid;
      float a[4] = {A[ia(m, k0 + tig)], A[ia(m + 8, k0 + tig)],
                    A[ia(m, k0 + tig + 4)], A[ia(m + 8, k0 + tig + 4)]};
      if (SC == kRowScale) {
        a[0] *= rs[mt][0];
        a[1] *= rs[mt][1];
        a[2] *= rs[mt][0];
        a[3] *= rs[mt][1];
      } else if (SC == kKScale) {
        const float s0 = scale[k0 + tig], s1 = scale[k0 + tig + 4];
        a[0] *= s0;
        a[1] *= s0;
        a[2] *= s1;
        a[3] *= s1;
      }
      split_frag(a, ah[mt], al[mt]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n0 + 8 * nt + gid;
      const float b[2] = {B[ib(n, k0 + tig)], B[ib(n, k0 + tig + 4)]};
      split_frag(b, bh[nt], bl[nt]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        mma_tf32(acc[mt][nt], al[mt], bh[nt]);
        mma_tf32(acc[mt][nt], ah[mt], bl[nt]);
        mma_tf32(acc[mt][nt], ah[mt], bh[nt]);
      }
  }
}

// the place (outer, inner) of a slab in a loop of n inner slabs an outer
// step, advanced one slab at a time, with no division a slab: a launch
// keeps one for each of the ring's callbacks, which see the slabs in order
struct Walk {
  int outer, inner, n;
  __device__ explicit Walk(int n_) : outer(0), inner(0), n(n_) {}
  __device__ void next() {
    if (++inner == n) {
      inner = 0;
      ++outer;
    }
  }
};

// the ring's loop over nslab slabs: issue(s, stage) starts slab s's copies
// (each thread its share), prep(s, stage) may rewrite the values this thread
// copied once they have landed, step(s, stage) runs the slab's products.
// STAGES - 1 slabs are in flight while one is multiplied; one block barrier
// a slab. Nothing is in flight when it returns.
template <int STAGES, typename Issue, typename Prep, typename Step>
__device__ __forceinline__ void ring_loop(int nslab, Issue issue, Prep prep,
                                          Step step) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nslab) issue(s, s);
    repro::cp_async_commit();
  }
  for (int s = 0; s < nslab; ++s) {
    repro::cp_async_wait<STAGES - 2>();
    const int st = s % STAGES;
    prep(s, st);
    __syncthreads();   // slab s visible; stage s - 1 free
    const int nx = s + STAGES - 1;
    if (nx < nslab) issue(nx, nx % STAGES);
    repro::cp_async_commit();
    step(s, st);
  }
  repro::cp_async_wait<0>();
}

// row (0..63) and column (0..BN-1) of element e of acc[mt][nt]
__device__ __forceinline__ int ring_row(int mt, int e) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp & 1) * 32 + 16 * mt + (lane >> 2) + (e >> 1) * 8;
}
__device__ __forceinline__ int ring_col(int nt, int e) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp >> 1) * 32 + 8 * nt + 2 * (lane & 3) + (e & 1);
}

__device__ __forceinline__ void zero_ring(float (&acc)[2][4][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
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
