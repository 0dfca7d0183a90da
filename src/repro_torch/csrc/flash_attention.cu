// Flash-attention forward (prefill) on Hopper: causal / sliding-window GQA
// attention with an fp32 online softmax, both products on the tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_fa_kernel / flash_attention_fwd). Same function: q [B,S,Hq,dh] against
// k/v [B,Skv,Hkv,dh]; query head h reads KV head h / (Hq/Hkv); key j is
// visible to query i iff (!causal || j <= i) && (!window || j > i - window);
// the scale is the true dh^-0.5, whatever width (64 / 128 / 256) the kernel
// is instantiated at (head dims below the width read as zeros: exact).
//
// Bound on an H100. The work is 4 dh Hq flop per visible (query, key) pair.
// At the serve path's prefills (fp32, causal, S = 1000): qwen2-0.5b (Hq 14,
// dh 64) 1.79 GFLOP, recurrentgemma-9b (Hq 16 over one KV head, dh 256)
// 8.2 GFLOP. On this kernel's fp32 route (3xTF32, below: three TF32
// products per product) that is 5.4 and 24.6 GFLOP at 495 TFLOP/s: 0.0109
// and 0.0497 ms, against 8.2 and 18.4 MB of q/k/v/o (2.4 and 5.5 us at
// 3.35 TB/s): operations bind. bf16 at 989 TFLOP/s: 0.0018 ms at qwen2's.
//
// Design. The TPU kernel runs a sequential kv grid axis and keeps (m, l,
// acc) in VMEM scratch. Here a block of 8 warps owns a 64-row query tile of
// one (batch, head) and loops over the visible K/V tiles itself.
// - Products on the tensor cores with mma.sync. fp32: m16n8k8 TF32. The
//   serve path's prefill is fp32 and held to 1e-4 per element, which one
//   TF32 product (11 bits) misses, so each operand is split at fragment
//   load into a TF32 high part and a remainder and each product is lo.hi +
//   hi.lo + hi.hi (3xTF32), near fp32 accuracy. The split takes 2-4 FMA-
//   or integer-pipe operations a value (split_a / split_b, common.cuh):
//   cvt.rna.tf32 issues at a quarter rate and bound the first version. It
//   is made per fragment, not once into hi / lo planes: at dh 256 planes
//   for Q and the K/V rings do not fit in 227 KB.
//   bf16: m16n8k16 with fp32 accumulation; Q.K^T is exact per product; P
//   is split into a bf16 high part and remainder and P.V is two products,
//   because one bf16 P (8 bits) moves an output whose terms cancel by more
//   than the limit (1e-4 plus one bf16 step of the output), as
//   tests/test_torch_flash_model.py shows.
// - Warps: warp w takes rows 16 (w % 4) .. +16 of the query tile and half
//   w / 4 of every K/V tile's keys, with its own running max, sum and a
//   16 x dh accumulator: the two warps of a row are two online softmaxes
//   over alternate key halves, merged once per query tile through shared
//   memory. So there is one block barrier per K/V tile (the ring's), and
//   bf16 P goes from the S accumulator to the A operand in registers; fp32
//   P goes through the warp's rows of shared memory (the TF32 accumulator's
//   layout is not the A operand's). Fragments of Q, K and P come by
//   ldmatrix; rows are padded so its 8 rows, and fp32 V's scalar loads,
//   hit different banks.
// - K/V tiles arrive by 16-byte cp.async in two rings, K one tile ahead of
//   V: S of tile j + 1 is computed right after tile j + 2's copies are
//   issued, before the softmax and P.V of tile j, and loops run over the
//   compile-time width so that the compiler can interleave the two. Tiles
//   are 64 keys (32 at width 256 for shared memory and registers; 128 for
//   bf16 at width 64). Head dims past dh and rows past Skv are zeros in
//   shared memory, never copied out of bounds; rows that are not whole
//   16-byte copies (or unaligned pointers) are staged element by element.
// - Causal balance: query tile i visits i + 1 K/V tiles, so one block takes
//   tiles i and n - 1 - i (n + 1 tiles of work; an odd n leaves the middle
//   tile alone). qwen2's S 1000 gives 8 blocks of 2 tiles a head, 112
//   blocks, one wave on 132 SMs. Tiles wholly above the diagonal or left of
//   the window are never visited; with a window the heaviest pairs are
//   launched first.
// - Softmax in fp32: running max and sum per row in registers, 2^x on the
//   special-function unit with the scale folded into log2(e) * scale; a row
//   with nothing visible yet keeps alpha 1 and p 0 (inf * 0 would be NaN).
// - The row's log-sum-exp, for the backward (flash_attention_bwd.cu), when
//   the caller passes an lse buffer [B,Hq,S] (every width, as the
//   backward's): the softmax above runs in base 2 on scale log2(e) q.k, so
//   after the merge of the two key halves the natural-log LSE of scale q.k
//   is (m + log2 l) ln 2; a row with no visible key gets +inf, so that the
//   backward's exp(s - lse) is 0 there. It is a template flag: the serve
//   path passes null and runs the instantiation without it, whose code is
//   that of the forward alone (a runtime test cost it ~1% and a spill at
//   width 256).
#include "common.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per tile
constexpr int kWarps = 8;      // 4 row groups of 16 x 2 key halves
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr size_t kMaxSmem = 232448;

// per (type, width): K/V rows per tile, the row pitches (elements) of the
// shared tiles and the shared memory layout. Q, K and P rows are an odd
// number of 16-byte chunks, so the 8 rows an ldmatrix reads lie on
// different banks; V rows are HD + 8 elements (fp32: the scalar B-fragment
// loads, rows tig and columns gid, land on banks 8 tig + gid; bf16: an odd
// number of chunks again, for ldmatrix.trans)
template <typename T, int HD>
struct Cfg {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int BK = HD == 256 ? 32 : (!kF32 && HD == 64) ? 128 : 64;
  static constexpr int LD = HD + 16 / sizeof(T);   // Q and K rows
  static constexpr int LDV = HD + 8;               // V rows
  static constexpr int LDP = BK / 2 + 4;           // fp32 P rows, per warp
  static constexpr size_t k_off = sizeof(T) * kBQ * LD;
  static constexpr size_t v_off = k_off + sizeof(T) * 2 * BK * LD;
  static constexpr size_t p_off = v_off + sizeof(T) * 2 * BK * LDV;
  static constexpr size_t smem =
      p_off + (kF32 ? sizeof(float) * kWarps * 16 * LDP : 0);
  static_assert(smem <= kMaxSmem, "shared memory of one block");
  // the second key halves' (m, l, acc), handed over at the end of a query
  // tile, fit in the K/V ring: 4 row groups x (HD / 2 + 4) values x 32 lanes
  static_assert(sizeof(float) * 4 * (HD / 2 + 4) * 32 <= p_off - k_off,
                "merge buffer");
};

// the tensor-core helpers this kernel shares with its backward
using repro::ex2;
using repro::ldmatrix_x4;
using repro::ldmatrix_x4_trans;
using repro::mma_bf16;
using repro::split_a;
using repro::split_b;
using repro::split_bf16x2;

// rows [row0, row0 + nrows) of a [rows_total, row_stride] source into a
// shared tile with row pitch ld: 16-byte cp.async copies when vec, else
// element by element; rows past rows_total are written as zeros (columns
// past dh are zeroed by the caller and never written here)
template <typename T, int HD>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src,
                                           int row0, int nrows,
                                           int rows_total, int row_stride,
                                           int dh, bool vec) {
  constexpr int kV = 16 / sizeof(T);
  constexpr int kCpr = HD / kV;   // 16-byte chunks of a row at full width
  if (vec) {
    for (int idx = threadIdx.x; idx < nrows * kCpr; idx += kThreads) {
      const int r = idx / kCpr;
      const int c = idx % kCpr;
      if (c * kV >= dh) continue;
      T* d = dst + r * ld + c * kV;
      if (row0 + r < rows_total)
        repro::cp_async16(d, src + (size_t)(row0 + r) * row_stride + c * kV);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < nrows * dh; idx += kThreads) {
      const int r = idx / dh;
      const int d = idx - r * dh;
      dst[r * ld + d] = row0 + r < rows_total
                            ? src[(size_t)(row0 + r) * row_stride + d]
                            : repro::from_float<T>(0.f);
    }
  }
}

// s[t] (rows r0 .. +16 x keys c0 + 8 t .. +8 of the tile) = Q K^T over the
// full width (head dims past dh are zeros)
template <typename T, int HD, int NT>
__device__ __forceinline__ void qk(const T* Qs, const T* Ks, int r0, int c0,
                                   float (&s)[NT][4]) {
  using C = Cfg<T, HD>;
  static_assert(NT % 2 == 0, "n-tiles in pairs");
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
  // a k-step is 32 bytes: 8 fp32 or 16 bf16 values. ldmatrix rows: Q r0 +
  // lane % 8 + 8 ((lane / 8) % 2), the k-step's second half for lane / 16;
  // K c0 + lane % 8 + 8 (lane / 16) (the second n-tile), second half for
  // (lane / 8) % 2
  constexpr int KS = 32 / sizeof(T);
  const T* qrow = Qs + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * C::LD +
                  (KS / 2) * (lane >> 4);
  const T* krow = Ks + (c0 + (lane & 7) + 8 * (lane >> 4)) * C::LD +
                  (KS / 2) * ((lane >> 3) & 1);
  // whole up to 8 k-steps, else in steps of 4 (registers)
  constexpr int kUnroll = HD / KS <= 8 ? HD / KS : 4;
#pragma unroll kUnroll
  for (int kk = 0; kk < HD; kk += KS) {
    unsigned a[4];
    ldmatrix_x4(a, qrow + kk);
    if constexpr (C::kF32) {
      unsigned ah[4], al[4];
      split_a(a, ah, al);
      unsigned bh[NT][2], bl[NT][2];
#pragma unroll
      for (int t = 0; t < NT; t += 2) {
        unsigned b[4], h4[4], l4[4];
        ldmatrix_x4(b, krow + 8 * t * C::LD + kk);
        split_b(b, h4, l4);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          bh[t][i] = h4[i];
          bh[t + 1][i] = h4[2 + i];
          bl[t][i] = l4[i];
          bl[t + 1][i] = l4[2 + i];
        }
      }
      // the three products of an n-tile depend on each other: issue them
      // across the n-tiles
#pragma unroll
      for (int t = 0; t < NT; ++t) repro::mma_tf32(s[t], al, bh[t]);
#pragma unroll
      for (int t = 0; t < NT; ++t) repro::mma_tf32(s[t], ah, bl[t]);
#pragma unroll
      for (int t = 0; t < NT; ++t) repro::mma_tf32(s[t], ah, bh[t]);
    } else {
#pragma unroll
      for (int t = 0; t < NT; t += 2) {
        unsigned b[4];
        ldmatrix_x4(b, krow + 8 * t * C::LD + kk);
        mma_bf16(s[t], a, b[0], b[1]);
        mma_bf16(s[t + 1], a, b[2], b[3]);
      }
    }
  }
}

// fp32: o[t] (16 rows x dims 8 t .. +8) += P V over the warp's BK / 2 keys,
// P the warp's [16][LDP] rows in shared memory, V from its first key row
template <int HD, int NO>
__device__ __forceinline__ void pv_f32(const float* Pw, const float* Vs,
                                       float (&o)[NO][4]) {
  using C = Cfg<float, HD>;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const float* prow =
      Pw + ((lane & 7) + 8 * ((lane >> 3) & 1)) * C::LDP + 4 * (lane >> 4);
#pragma unroll
  for (int kk = 0; kk < C::BK / 2; kk += 8) {
    unsigned a[4], ah[4], al[4];
    ldmatrix_x4(a, prow + kk);
    split_a(a, ah, al);
    const float* vb = Vs + (kk + tig) * C::LDV + gid;
    // groups of 4 n-tiles, their three products issued across the group
#pragma unroll
    for (int t0 = 0; t0 < NO; t0 += 4) {
      unsigned bh[4][2], bl[4][2];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const unsigned bv[2] = {__float_as_uint(vb[8 * (t0 + t)]),
                                __float_as_uint(vb[8 * (t0 + t) + 4 * C::LDV])};
        split_a(bv, bh[t], bl[t]);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) repro::mma_tf32(o[t0 + t], al, bh[t]);
#pragma unroll
      for (int t = 0; t < 4; ++t) repro::mma_tf32(o[t0 + t], ah, bl[t]);
#pragma unroll
      for (int t = 0; t < 4; ++t) repro::mma_tf32(o[t0 + t], ah, bh[t]);
    }
  }
}

// bf16: o[t] += P V over the warp's keys, P as the high parts and
// remainders of the S accumulator packed to bf16x2 (ph / pl[t][row half]),
// which is the A operand's layout; V from the warp's first key row
template <int HD, int NT, int NO>
__device__ __forceinline__ void pv_bf16(const unsigned (&ph)[NT][2],
                                        const unsigned (&pl)[NT][2],
                                        const __nv_bfloat16* Vs,
                                        float (&o)[NO][4]) {
  using C = Cfg<__nv_bfloat16, HD>;
  const int lane = threadIdx.x & 31;
  // ldmatrix rows: key lane % 8 + 8 ((lane / 8) % 2), dims + 8 (lane / 16)
  const __nv_bfloat16* vrow =
      Vs + ((lane & 7) + 8 * ((lane >> 3) & 1)) * C::LDV + 8 * (lane >> 4);
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    const unsigned ahi[4] = {ph[2 * j][0], ph[2 * j][1], ph[2 * j + 1][0],
                             ph[2 * j + 1][1]};
    const unsigned alo[4] = {pl[2 * j][0], pl[2 * j][1], pl[2 * j + 1][0],
                             pl[2 * j + 1][1]};
#pragma unroll
    for (int t = 0; t < NO; t += 2) {
      unsigned b[4];
      ldmatrix_x4_trans(b, vrow + 16 * j * C::LDV + 8 * t);
      mma_bf16(o[t], alo, b[0], b[1]);
      mma_bf16(o[t + 1], alo, b[2], b[3]);
      mma_bf16(o[t], ahi, b[0], b[1]);
      mma_bf16(o[t + 1], ahi, b[2], b[3]);
    }
  }
}

template <typename T, int HD, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
fa_fwd(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
       int sq, int skv, int hq, int hkv, int dh, int causal, int window,
       float scale, int vec) {
  using C = Cfg<T, HD>;
  constexpr int BK = C::BK;
  constexpr int NT = BK / 16;   // 8-key n-tiles of a warp's key half
  constexpr int NO = HD / 8;    // 8-dim n-tiles of O
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = reinterpret_cast<T*>(smem + C::k_off);   // [2][BK][LD]
  T* Vs = reinterpret_cast<T*>(smem + C::v_off);   // [2][BK][LDV]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int rg = warp & 3;
  const int r0 = 16 * rg;           // the warp's query rows in the tile
  const int kh = warp >> 2;
  const int c0 = kh * (BK / 2);     // its keys of each K/V tile
  float* Pw = reinterpret_cast<float*>(smem + C::p_off) + warp * 16 * C::LDP;

  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int h = bh - b * hq;
  const int kvh = h / (hq / hkv);
  const T* qb = q + ((size_t)b * sq * hq + h) * dh;
  const T* kb = k + ((size_t)b * skv * hkv + kvh) * dh;
  const T* vb = v + ((size_t)b * skv * hkv + kvh) * dh;
  T* ob = o + ((size_t)b * sq * hq + h) * dh;
  const int kv_stride = hkv * dh;

  // tiles i and n - 1 - i; with a window the heaviest pairs go first
  const int nq = (sq + kBQ - 1) / kBQ;
  const int npairs = (nq + 1) / 2;
  const int pair = window > 0 ? npairs - 1 - (int)blockIdx.x : blockIdx.x;
  const float scale2 = scale * kLog2e;

  for (int which = 0; which < 2; ++which) {
    const int qt = which ? nq - 1 - pair : pair;
    if (which && qt == pair) break;
    const int q0 = qt * kBQ;
    // visible key tiles of this query tile
    int kv_end = skv;
    if (causal) kv_end = min(kv_end, q0 + kBQ);
    int kv_begin = 0;
    if (window > 0) kv_begin = max(0, q0 - window + 1);
    kv_begin = (kv_begin / BK) * BK;
    const int ntiles = kv_end > kv_begin ? (kv_end - kv_begin + BK - 1) / BK
                                         : 0;

    // K tile j + 1 and V tile j are staged together, K one tile ahead, so
    // that S of tile j + 1 is computed before the softmax of tile j and the
    // compiler can interleave the two
    auto stage_k = [&](int jj) {
      stage_rows<T, HD>(Ks + (jj & 1) * BK * C::LD, C::LD, kb,
                        kv_begin + jj * BK, BK, skv, kv_stride, dh, vec);
    };
    auto stage_v = [&](int jj) {
      stage_rows<T, HD>(Vs + (jj & 1) * BK * C::LDV, C::LDV, vb,
                        kv_begin + jj * BK, BK, skv, kv_stride, dh, vec);
    };
    __syncthreads();   // the previous query tile's readers are done
    // head dims [dh, HD) of every tile are zeros (the merge below reuses
    // the ring, so once per query tile); the copies never write them
    if (dh < HD) {
      const int w = HD - dh;
      const T zero = repro::from_float<T>(0.f);
      for (int idx = tid; idx < (kBQ + 2 * BK) * w; idx += kThreads) {
        const int r = idx / w;
        Qs[r * C::LD + dh + idx - r * w] = zero;   // Q rows, then K rows
      }
      for (int idx = tid; idx < 2 * BK * w; idx += kThreads) {
        const int r = idx / w;
        Vs[r * C::LDV + dh + idx - r * w] = zero;
      }
    }
    stage_rows<T, HD>(Qs, C::LD, qb, q0, kBQ, sq, hq * dh, dh, vec);
    if (ntiles > 0) stage_k(0);
    repro::cp_async_commit();
    if (ntiles > 0) {
      if (ntiles > 1) stage_k(1);
      stage_v(0);
    }
    repro::cp_async_commit();

    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};   // this thread's share of the row sums
    float acc[NO][4];
#pragma unroll
    for (int t = 0; t < NO; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
    float s[NT][4];
    if (ntiles > 0) {
      repro::cp_async_wait<1>();
      __syncthreads();   // Q and K tile 0 in place
      qk<T, HD, NT>(Qs, Ks, r0, c0, s);
    }

    for (int j = 0; j < ntiles; ++j) {
      const int k0 = kv_begin + j * BK;
      repro::cp_async_wait<0>();
      __syncthreads();   // K tile j + 1, V tile j in place; all warps are
                         // past S of tile j and P.V of tile j - 1
      if (j + 2 < ntiles) stage_k(j + 2);
      if (j + 1 < ntiles) stage_v(j + 1);
      repro::cp_async_commit();

      float sn[NT][4];   // S of tile j + 1
      if (j + 1 < ntiles)
        qk<T, HD, NT>(Qs, Ks + ((j + 1) & 1) * BK * C::LD, r0, c0, sn);

      // mask, scale (log2 domain), the row maxima of the warp's keys
      const int qw = q0 + r0;       // the warp's first row
      const int kw = k0 + c0;       // its first key
      const bool full = kw + BK / 2 <= skv &&
                        (!causal || kw + BK / 2 - 1 <= qw) &&
                        (window <= 0 || kw > qw + 15 - window);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = qw + gid + 8 * (e >> 1);
          const int kj = kw + 8 * t + 2 * tig + (e & 1);
          bool ok = true;
          if (!full) {
            ok = kj < skv;
            if (causal) ok = ok && kj <= qi;
            if (window > 0) ok = ok && kj > qi - window;
          }
          s[t][e] = ok ? s[t][e] * scale2 : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[t][e]);
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float mn = fmaxf(m[i], mx[i]);
        // nothing visible to this row yet: keep alpha 1 and p 0
        alpha[i] = mn == -INFINITY ? 1.f : ex2(m[i] - mn);
        m[i] = mn;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          s[t][e] = m[i] == -INFINITY ? 0.f : ex2(s[t][e] - m[i]);
          l[i] += s[t][e];
        }
      // once a row's maximum stops moving alpha is 1: skip the rescale
      // when it is 1 for every row of the warp
      if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
        for (int t = 0; t < NO; ++t) {
          acc[t][0] *= alpha[0];
          acc[t][1] *= alpha[0];
          acc[t][2] *= alpha[1];
          acc[t][3] *= alpha[1];
        }
      }
      const T* Vt = Vs + ((j & 1) * BK + c0) * C::LDV;
      if constexpr (C::kF32) {
        // P through the warp's rows of shared memory: the accumulator's
        // layout is not the TF32 A operand's
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          float* pr = Pw + gid * C::LDP + 8 * t + 2 * tig;
          *reinterpret_cast<float2*>(pr) = make_float2(s[t][0], s[t][1]);
          *reinterpret_cast<float2*>(pr + 8 * C::LDP) =
              make_float2(s[t][2], s[t][3]);
        }
        __syncwarp();
        pv_f32<HD, NO>(Pw, reinterpret_cast<const float*>(Vt), acc);
        __syncwarp();   // P read before the next tile rewrites it
      } else {
        unsigned ph[NT][2], pl[NT][2];
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          ph[t][0] = split_bf16x2(s[t][0], s[t][1], pl[t][0]);
          ph[t][1] = split_bf16x2(s[t][2], s[t][3], pl[t][1]);
        }
        pv_bf16<HD, NT, NO>(ph, pl,
                            reinterpret_cast<const __nv_bfloat16*>(Vt), acc);
      }
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = sn[t][e];
    }
    repro::cp_async_wait<0>();   // nothing in flight past the tile

    // merge the two key halves of each row: the second half's warps hand
    // (m, l, acc) over through the K/V ring, in fragment order
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
    float* xch = reinterpret_cast<float*>(Ks) + rg * (NO * 4 + 4) * 32 + lane;
    __syncthreads();   // every warp is done with the K/V ring
    if (kh) {
#pragma unroll
      for (int t = 0; t < NO; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) xch[(4 * t + e) * 32] = acc[t][e];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        xch[(4 * NO + i) * 32] = m[i];
        xch[(4 * NO + 2 + i) * 32] = l[i];
      }
    }
    __syncthreads();
    if (kh) continue;
    float a0[2], a1[2], inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m1 = xch[(4 * NO + i) * 32];
      const float l1 = xch[(4 * NO + 2 + i) * 32];
      const float mm = fmaxf(m[i], m1);
      a0[i] = mm == -INFINITY ? 0.f : exp2f(m[i] - mm);
      a1[i] = mm == -INFINITY ? 0.f : exp2f(m1 - mm);
      const float lsum = l[i] * a0[i] + l1 * a1[i];
      inv[i] = 1.f / fmaxf(lsum, 1e-30f);
      if constexpr (kLse) {
        const int qi = q0 + r0 + gid + 8 * i;
        if (tig == 0 && qi < sq)
          lse[((size_t)b * hq + h) * sq + qi] =
              mm == -INFINITY ? INFINITY : (mm + log2f(lsum)) * kLn2;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = q0 + r0 + gid + 8 * i;
      if (qi >= sq) continue;
      T* orow = ob + (size_t)qi * hq * dh;
#pragma unroll
      for (int t = 0; t < NO; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = 8 * t + 2 * tig + e;
          const float x = acc[t][2 * i + e] * a0[i] +
                          xch[(4 * t + 2 * i + e) * 32] * a1[i];
          if (d < dh) orow[d] = repro::from_float<T>(x * inv[i]);
        }
    }
  }
}

template <typename T, int HD, bool kLse>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int b, int sq, int skv, int hq, int hkv, int dh, int causal,
           int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = Cfg<T, HD>::smem;
  cudaError_t e = cudaFuncSetAttribute(
      fa_fwd<T, HD, kLse>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int vec = dh % (16 / (int)sizeof(T)) == 0 &&
                  ((size_t)q | (size_t)k | (size_t)v) % 16 == 0;
  const int nq = (sq + kBQ - 1) / kBQ;
  dim3 grid((nq + 1) / 2, b * hq);
  fa_fwd<T, HD, kLse><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, sq, skv, hq, hkv, dh,
      causal, window, scale, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* o, float* lse,
              int b, int sq, int skv, int hq, int hkv, int dh, int causal,
              int window, float scale, cudaStream_t s) {
  if (lse != nullptr) {
    if (dh <= 64)
      return launch<T, 64, true>(q, k, v, o, lse, b, sq, skv, hq, hkv, dh,
                                 causal, window, scale, s);
    if (dh <= 128)
      return launch<T, 128, true>(q, k, v, o, lse, b, sq, skv, hq, hkv, dh,
                                  causal, window, scale, s);
    if (dh <= 256)
      return launch<T, 256, true>(q, k, v, o, lse, b, sq, skv, hq, hkv, dh,
                                  causal, window, scale, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dh <= 64)
    return launch<T, 64, false>(q, k, v, o, lse, b, sq, skv, hq, hkv, dh,
                                causal, window, scale, s);
  if (dh <= 128)
    return launch<T, 128, false>(q, k, v, o, lse, b, sq, skv, hq, hkv, dh,
                                 causal, window, scale, s);
  if (dh <= 256)
    return launch<T, 256, false>(q, k, v, o, lse, b, sq, skv, hq, hkv, dh,
                                 causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// lse: null, or [B,Hq,S] fp32 for the rows' natural-log log-sum-exp
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      int b, int sq, int skv, int hq, int hkv,
                                      int dh, int causal, int window,
                                      float scale, int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || hq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || dh <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == repro::kFloat32)
    return launch_dh<float>(q, k, v, o, lse, b, sq, skv, hq, hkv, dh, causal,
                            window, scale, s);
  if (dtype == repro::kBFloat16)
    return launch_dh<__nv_bfloat16>(q, k, v, o, lse, b, sq, skv, hq, hkv, dh,
                                    causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
