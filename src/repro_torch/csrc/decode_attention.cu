// Decode attention on Hopper: one query token per (batch, head) against a
// KV cache filled up to kv_len, split across the cache (flash-decoding),
// in one launch that also merges the splits.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py
// (_dec_kernel / decode_attention_fwd). Same function: q [B,1,Hq,dh]
// against k/v [B,Smax,Hkv,dh], positions >= kv_len masked, query head h
// reading KV head h / (Hq/Hkv), scale = true dh^-0.5. kv_len is one int32
// read from device memory, so the caller needs no host sync. With a window
// W > 0, positions below kv_len - W are masked too (the model's sliding-
// window attention: the query at position kv_len - 1 sees the last W keys),
// and the splits cover only [max(0, kv_len - W), kv_len). The TPU kernel
// takes no window (its dispatcher drops it); this follows the reference's
// oracle, sdpa_ref.
//
// Bound on an H100 (3.35 TB/s): the live K and V, read once (recurrentgemma-
// 9b's ring at kv_len 1001, bf16, 1 KV head of 256: 1.0 MB, 0.31 us; qwen2-
// 0.5b at kv_len 1000: 0.5 MB, 0.15 us); the FLOPs are negligible. So the
// kernel is bound by latency: how many K/V bytes each SM has in flight, and
// how many dependent steps stand between the launch and the last store.
//
// Design. The TPU kernel walks the cache sequentially per (batch, query
// head): 14-16 programs at batch 1, 14-16 of 132 SMs. Here:
// - Grid (nsplit, B * Hkv * ceil(G / 16)), G = Hq / Hkv; nsplit is chosen
//   from shapes only (kernel.py::num_splits: about one block per SM, a
//   multiple of the cluster size), and each block takes ceil(live / nsplit)
//   of the live positions, computed from the device-side kv_len. A block
//   serves up to 16 query heads of one KV head, so recurrentgemma-9b's 16
//   heads read each K/V row once.
// - A block walks its positions in tiles of 16, double-buffered in shared
//   memory with 16-byte cp.async copies (the next tile in flight while this
//   one is used). Per tile: the 16 x 16 (head, position) scores from shared
//   memory, one thread each; one max and one exp per score and one rescale
//   of the accumulator per tile (a half warp per head, shuffles); P.V with
//   the [G, dh] accumulator spread over the 256 threads (4 columns and up
//   to 4 heads each). SIMT FMAs: at 16 heads the block does ~1 FMA per K/V
//   byte, far below what would make arithmetic the limit.
// - The merge happens in the same launch, in two levels. Blocks are
//   launched in clusters of 8: each block leaves its (m, l, acc) in shared
//   memory and the 8 blocks of a cluster merge them through distributed
//   shared memory, each block one eighth of the (head, column) pairs, into
//   one partial per cluster in global memory. Then one arrival counter per
//   (batch, KV head, head group) finds the last cluster to finish; its 8
//   blocks merge the nsplit / 8 cluster partials, again each one eighth of
//   the pairs, and write the output. Both levels are parallel over columns
//   and short (the serve shapes give 9-17 partials), instead of one serial
//   loop over 32-64 partials per column in a second launch. The merging
//   block resets the counter to 0, so the next call finds it zeroed.
// - The counters live in a buffer that the wrapper allocates zeroed, once
//   per (device, stream): calls on one stream run one after another and
//   share it; calls on different streams get different buffers, so
//   concurrent calls never share a counter.
// - Semantics pinned by the tests: the window masks positions below
//   kv_len - W; a split with no live position merges as m = -inf, l = 0;
//   a query row with no live key at all writes 0.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 16;      // cache positions per tile
constexpr int kGMax = 16;      // query heads per block: one half warp each
constexpr int kCluster = 8;    // blocks merged through distributed smem
constexpr int kMaxCl = 32;     // clusters per row at most (nsplit <= 256)
// (head, column) pairs a block merges per level: gb * dh / kCluster <= 512,
// two per thread at most
constexpr int kItems = kGMax * 256 / kCluster / 256;

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;

// release (after the partials are written) or acquire (before they are
// read) at device scope; lighter than __threadfence's sequential fence
__device__ __forceinline__ void fence_acq_rel() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

// 8 consecutive values of a row in shared memory (16-byte aligned), as fp32
__device__ __forceinline__ void load8(const float* p, float (&out)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&out)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// 4 consecutive values (8- or 16-byte aligned), as fp32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__host__ __device__ inline int round8(int x) { return (x + 7) & ~7; }

// bytes of one tile row in shared memory: 16 bytes of padding keep the
// score threads' 16-byte reads of 8 different rows on different banks
template <typename T>
__host__ __device__ inline int row_bytes(int dh) {
  return round8(dh) * (int)sizeof(T) + 16;
}

template <typename T>
__host__ __device__ inline size_t smem_bytes(int gs, int dh, int ncl) {
  const int dhp = round8(dh);
  return (size_t)4 * kTile * row_bytes<T>(dh) +          // K, V x 2 buffers
         sizeof(float) * ((size_t)2 * gs * dhp +           // q, acc
                          kGMax * kTile + 5 * kGMax +      // p, alpha, m, l,
                          kGMax * kCluster +               // M, L, factors
                          (size_t)2 * ncl * kGMax) +       // cluster m, l
         16;                                               // flag
}

template <typename T, int HD>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
dec_fwd(const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const int* __restrict__ kv_len_ptr,
        float* __restrict__ part, int* __restrict__ counters,
        T* __restrict__ o, int smax, int hq, int hkv, int dh, int nsplit,
        int ngroups, int window, float scale, int vec) {
  constexpr int NQ = HD / 4;              // column quads
  constexpr int GG = kThreads / NQ;       // head slots over the threads
  constexpr int GPT = (kGMax + GG - 1) / GG;   // heads per thread in P.V

  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x;
  const int split = blockIdx.x;
  const int rank = (int)cluster.block_rank();
  const int cl = split / kCluster;
  const int ncl = nsplit / kCluster;
  const int row = blockIdx.y;             // (b * hkv + kvh) * ngroups + hg
  const int hg = row % ngroups;
  const int b = row / ngroups / hkv;
  const int kvh = row / ngroups - b * hkv;
  const int G = hq / hkv;
  const int g0 = hg * kGMax;
  const int gb = min(kGMax, G - g0);      // heads of this block
  const int gs = min(kGMax, G);           // stride of the per-head arrays
  const int dhp = round8(dh);
  const int rb = row_bytes<T>(dh);

  unsigned char* tiles = smem;            // [2 buffers][K, V][kTile] rows
  float* qs = reinterpret_cast<float*>(smem + 4 * kTile * rb);   // [gs][dhp]
  float* pacc = qs + gs * dhp;            // [gs][dhp] this block's acc
  float* ps = pacc + gs * dhp;            // [kGMax][kTile] probabilities
  float* alph = ps + kGMax * kTile;       // [kGMax] rescale of this tile
  float* pm = alph + kGMax;               // [kGMax] this block's m
  float* pl = pm + kGMax;                 // [kGMax] this block's l
  float* mM = pl + kGMax;                 // [kGMax] merged max
  float* mL = mM + kGMax;                 // [kGMax] merged sum
  float* fac = mL + kGMax;                // [kGMax][kCluster] merge factors
  float* f2 = fac + kGMax * kCluster;     // [ncl][kGMax] cluster m, factors
  float* l2 = f2 + ncl * kGMax;           // [ncl][kGMax] cluster l
  int* flag = reinterpret_cast<int*>(l2 + ncl * kGMax);

  // the positions of this split, from the device-side kv_len
  const int kv_len = max(0, min(*kv_len_ptr, smax));
  const int lo = window > 0 ? max(0, kv_len - window) : 0;
  const int chunk = (kv_len - lo + nsplit - 1) / nsplit;
  const int start = lo + split * chunk;
  const int end = min(start + chunk, kv_len);
  const int ntiles = end > start ? (end - start + kTile - 1) / kTile : 0;

  const size_t kv_row = (size_t)hkv * dh;   // stride between positions
  const T* kb = k + ((size_t)b * smax * hkv + kvh) * dh;
  const T* vb = v + ((size_t)b * smax * hkv + kvh) * dh;

  auto tile_row = [&](int buf, int which, int r) {
    return tiles + ((buf * 2 + which) * kTile + r) * rb;
  };
  // K and V rows [t0, t0 + nt) into buffer buf: 16-byte cp.async copies,
  // or element by element (padding zeroed) when rows are not 16-byte sized
  // and aligned
  auto load_tile = [&](int buf, int t0, int nt) {
    if (vec) {
      const int cpr = dh * (int)sizeof(T) / 16;   // chunks per row
      for (int idx = tid; idx < 2 * nt * cpr; idx += kThreads) {
        const int which = idx / (nt * cpr);
        const int rem = idx - which * nt * cpr;
        const int r = rem / cpr;
        const int c = rem - r * cpr;
        const T* src = (which ? vb : kb) + (size_t)(t0 + r) * kv_row +
                       c * (16 / (int)sizeof(T));
        cp_async16(tile_row(buf, which, r) + c * 16, src);
      }
    } else {
      for (int idx = tid; idx < 2 * nt * dhp; idx += kThreads) {
        const int which = idx / (nt * dhp);
        const int rem = idx - which * nt * dhp;
        const int r = rem / dhp;
        const int d = rem - r * dhp;
        T val = repro::from_float<T>(0.f);
        if (d < dh) val = (which ? vb : kb)[(size_t)(t0 + r) * kv_row + d];
        reinterpret_cast<T*>(tile_row(buf, which, r))[d] = val;
      }
    }
    cp_async_commit();
  };

  if (ntiles > 0) load_tile(0, start, min(kTile, end - start));
  const T* qb = q + ((size_t)b * hq + kvh * G + g0) * dh;   // [gb][dh]
  if (vec) {   // dhp == dh: 8 values a thread at a time
    for (int idx = 8 * tid; idx < gs * dh; idx += 8 * kThreads) {
      float q8[8];
      if (idx < gb * dh) {
        load8(qb + idx, q8);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) q8[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) qs[idx + e] = q8[e];
    }
  } else {
    for (int idx = tid; idx < gs * dhp; idx += kThreads) {
      const int g = idx / dhp;
      const int d = idx - g * dhp;
      qs[idx] = (g < gb && d < dh) ? repro::to_float(qb[g * dh + d]) : 0.f;
    }
  }

  // scores: head sg = tid / 16 (a half warp), position st = tid % 16
  const int sg = tid >> 4;
  const int st = tid & 15;
  float m = -INFINITY, l = 0.f;
  // P.V: columns 4 cq .. 4 cq + 3 of heads gg + j GG
  const int cq = tid % NQ;
  const int gg = tid / NQ;
  const bool pv_on = 4 * cq < dhp;
  float acc[GPT][4];
#pragma unroll
  for (int j = 0; j < GPT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int t0 = start + it * kTile;
    const int nt = min(kTile, end - t0);
    if (it + 1 < ntiles) {
      load_tile((it + 1) & 1, t0 + kTile, min(kTile, end - t0 - kTile));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // this tile (and q) in shared memory
    const int buf = it & 1;

    float s = -INFINITY;
    if (sg < gb && st < nt) {
      const T* kr = reinterpret_cast<const T*>(tile_row(buf, 0, st));
      const float* qr = qs + sg * dhp;
      float dot[4] = {0.f, 0.f, 0.f, 0.f};   // four chains, not one
#pragma unroll 4
      for (int d = 0; d < dhp; d += 8) {
        float kv8[8], q8[8];
        load8(kr + d, kv8);
        load8(qr + d, q8);
#pragma unroll
        for (int e = 0; e < 8; ++e) dot[e & 3] = fmaf(q8[e], kv8[e], dot[e & 3]);
      }
      s = ((dot[0] + dot[1]) + (dot[2] + dot[3])) * scale;
    }
    const float mn = fmaxf(m, repro::half_warp_max(s));
    const float alpha = mn == -INFINITY ? 1.f : expf(m - mn);
    const float p = s == -INFINITY ? 0.f : expf(s - mn);
    l = l * alpha + repro::half_warp_sum(p);
    m = mn;
    if (sg < gb) {
      ps[sg * kTile + st] = p;
      if (st == 0) alph[sg] = alpha;
    }
    __syncthreads();   // ps, alph written

    if (pv_on) {
      float a[GPT];
#pragma unroll
      for (int j = 0; j < GPT; ++j) {
        const int g = gg + j * GG;
        a[j] = g < gb ? alph[g] : 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= a[j];
      }
#pragma unroll 4
      for (int t = 0; t < nt; ++t) {
        const float4 vv = load4(
            reinterpret_cast<const T*>(tile_row(buf, 1, t)) + 4 * cq);
#pragma unroll
        for (int j = 0; j < GPT; ++j) {
          const int g = gg + j * GG;
          if (g < gb) {
            const float pw = ps[g * kTile + t];
            acc[j][0] = fmaf(pw, vv.x, acc[j][0]);
            acc[j][1] = fmaf(pw, vv.y, acc[j][1]);
            acc[j][2] = fmaf(pw, vv.z, acc[j][2]);
            acc[j][3] = fmaf(pw, vv.w, acc[j][3]);
          }
        }
      }
    }
    __syncthreads();   // the buffer and ps free for the next tile
  }

  // this block's partial (m, l, acc) in shared memory; an empty split
  // leaves m = -inf, l = 0, acc = 0
  if (st == 0 && sg < gb) {
    pm[sg] = m;
    pl[sg] = l;
  }
  if (pv_on) {
#pragma unroll
    for (int j = 0; j < GPT; ++j) {
      const int g = gg + j * GG;
      if (g < gb)
#pragma unroll
        for (int e = 0; e < 4; ++e) pacc[g * dhp + 4 * cq + e] = acc[j][e];
    }
  }
  cluster.sync();

  // level 1: the cluster's 8 partials through distributed shared memory;
  // this block merges pairs [lo1, hi1) of the gb * dh (head, column) pairs
  const int per = (gb * dh + kCluster - 1) / kCluster;
  const int lo1 = rank * per;
  const int hi1 = min(lo1 + per, gb * dh);
  if (tid < gb) {
    float mk[kCluster], mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      mk[r] = cluster.map_shared_rank(pm, r)[tid];
      mx = fmaxf(mx, mk[r]);
    }
    float lsum = 0.f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      const float f = mx == -INFINITY ? 0.f : expf(mk[r] - mx);
      fac[tid * kCluster + r] = f;
      lsum = fmaf(f, cluster.map_shared_rank(pl, r)[tid], lsum);
    }
    mM[tid] = mx;
    mL[tid] = lsum;
  }
  __syncthreads();
  // partial of cluster cl: [gs] m, [gs] l, [gs][dh] acc; a thread's (at
  // most two) pairs read their 16 remote values at once
  float* pc = part + ((size_t)row * ncl + cl) * gs * (dh + 2);
  {
    float a[kItems][kCluster];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int idx = lo1 + tid + j * kThreads;
      const int g = idx / dh;
#pragma unroll
      for (int r = 0; r < kCluster; ++r)
        a[j][r] = idx < hi1 ? cluster.map_shared_rank(pacc, r)[g * dhp + idx - g * dh]
                            : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int idx = lo1 + tid + j * kThreads;
      if (idx >= hi1) break;
      const int g = idx / dh;
      const int d = idx - g * dh;
      float asum = 0.f;
#pragma unroll
      for (int r = 0; r < kCluster; ++r)
        asum = fmaf(fac[g * kCluster + r], a[j][r], asum);
      pc[2 * gs + idx] = asum;
      if (d == 0) {
        pc[g] = mM[g];
        pc[gs + g] = mL[g];
      }
    }
  }
  fence_acq_rel();
  cluster.sync();   // every partial written; no block reads another's smem

  // the last cluster of this row to arrive merges the cluster partials
  if (rank == 0 && tid == 0) {
    int ticket;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                 : "=r"(ticket) : "l"(counters + row) : "memory");
    const int last = ticket == ncl - 1;
    if (last) counters[row] = 0;   // zeroed for the next call
#pragma unroll
    for (int r = 0; r < kCluster; ++r) *cluster.map_shared_rank(flag, r) = last;
  }
  cluster.sync();
  if (!*flag) return;
  fence_acq_rel();

  // level 2: this block merges pairs [lo1, hi1) over the ncl partials.
  // A pair's ncl acc values are loaded at once (the first pair's together
  // with every cluster's m and l); the m and l become factors
  // exp(m_c - M), then each pair's values are summed.
  const float* p0 = part + (size_t)row * ncl * gs * (dh + 2);
  const size_t pstride = (size_t)gs * (dh + 2);
  float a2[kMaxCl];
  auto fetch = [&](int idx) {
#pragma unroll
    for (int c = 0; c < kMaxCl; ++c)
      a2[c] = idx < hi1 && c < ncl ? __ldcg(p0 + c * pstride + 2 * gs + idx)
                                   : 0.f;
  };
  fetch(lo1 + tid);
  for (int idx = tid; idx < ncl * gb; idx += kThreads) {
    const int c = idx / gb;
    const int g = idx - c * gb;
    f2[c * kGMax + g] = __ldcg(p0 + c * pstride + g);
    l2[c * kGMax + g] = __ldcg(p0 + c * pstride + gs + g);
  }
  __syncthreads();
  if (tid < gb) {
    float mx = -INFINITY;
    for (int c = 0; c < ncl; ++c) mx = fmaxf(mx, f2[c * kGMax + tid]);
    float lsum = 0.f;
    for (int c = 0; c < ncl; ++c) {
      const float f =
          mx == -INFINITY ? 0.f : expf(f2[c * kGMax + tid] - mx);
      f2[c * kGMax + tid] = f;
      lsum = fmaf(f, l2[c * kGMax + tid], lsum);
    }
    mL[tid] = lsum;
  }
  __syncthreads();
  for (int idx = lo1 + tid; idx < hi1; idx += kThreads) {
    const int g = idx / dh;
    const int d = idx - g * dh;
    float asum = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCl; ++c)
      if (c < ncl) asum = fmaf(f2[c * kGMax + g], a2[c], asum);
    o[((size_t)b * hq + kvh * G + g0 + g) * dh + d] =
        repro::from_float<T>(asum / fmaxf(mL[g], 1e-30f));
    if (idx + kThreads < hi1) fetch(idx + kThreads);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           void* o, float* part, int* counters, int b, int smax, int hq,
           int hkv, int dh, int nsplit, int window, float scale,
           cudaStream_t s) {
  const int G = hq / hkv;
  const int ngroups = (G + kGMax - 1) / kGMax;
  const size_t smem = smem_bytes<T>(min(kGMax, G), dh, nsplit / kCluster);
  cudaError_t e = cudaFuncSetAttribute(
      dec_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int vec =
      dh % 8 == 0 && ((size_t)q | (size_t)k | (size_t)v) % 16 == 0;
  dim3 grid(nsplit, b * hkv * ngroups);
  dec_fwd<T, HD><<<grid, kThreads, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, kv_len, part, counters, (T*)o,
      smax, hq, hkv, dh, nsplit, ngroups, window, scale, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, const int* kv_len,
              void* o, float* part, int* counters, int b, int smax, int hq,
              int hkv, int dh, int nsplit, int window, float scale,
              cudaStream_t s) {
  if (dh <= 64)
    return launch<T, 64>(q, k, v, kv_len, o, part, counters, b, smax, hq,
                         hkv, dh, nsplit, window, scale, s);
  if (dh <= 128)
    return launch<T, 128>(q, k, v, kv_len, o, part, counters, b, smax, hq,
                          hkv, dh, nsplit, window, scale, s);
  if (dh <= 256)
    return launch<T, 256>(q, k, v, kv_len, o, part, counters, b, smax, hq,
                          hkv, dh, nsplit, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// (batch, KV head, head group) rows: one arrival counter each
extern "C" int decode_attention_rows(int b, int hq, int hkv) {
  const int G = hq / hkv;
  return b * hkv * ((G + kGMax - 1) / kGMax);
}

// floats of the cluster partials: per row, nsplit / 8 of [gs] m, [gs] l,
// [gs][dh] acc
extern "C" long long decode_attention_scratch_floats(int b, int hq, int hkv,
                                                     int dh, int nsplit) {
  const int gs = min(kGMax, hq / hkv);
  return (long long)decode_attention_rows(b, hq, hkv) * (nsplit / kCluster) *
         gs * (dh + 2);
}

extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const int* kv_len,
                                       void* o, float* scratch,
                                       int* counters, int b, int smax, int hq,
                                       int hkv, int dh, int nsplit,
                                       int window, float scale, int dtype,
                                       void* stream) {
  if (b <= 0 || hq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || dh <= 0 || nsplit <= 0 ||
      nsplit % kCluster != 0 || nsplit > kMaxCl * kCluster || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == repro::kFloat32)
    return launch_dh<float>(q, k, v, kv_len, o, scratch, counters, b, smax,
                            hq, hkv, dh, nsplit, window, scale, s);
  if (dtype == repro::kBFloat16)
    return launch_dh<__nv_bfloat16>(q, k, v, kv_len, o, scratch, counters, b,
                                    smax, hq, hkv, dh, nsplit, window, scale,
                                    s);
  return (int)cudaErrorInvalidValue;
}
