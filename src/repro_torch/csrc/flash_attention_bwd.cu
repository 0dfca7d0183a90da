// Flash-attention backward on Hopper: dq, dk and dv of causal / sliding-
// window GQA attention from the forward's row log-sum-exp, the softmax
// recomputed tile by tile (FlashAttention-2's split), every product on the
// tensor cores.
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
// that is 150 GFLOP: 0.152 ms at 989 TFLOP/s, against 117 MB of q, k, v, o,
// dO, dq, dk, dv (0.035 ms at 3.35 TB/s): operations bind. In fp32 the
// kernel's route is 3xTF32 (below), three TF32 products per product at 495
// TFLOP/s: 6x the bf16 time for the same work.
//
// Design. Four launches on the caller's stream, no atomics, so repeats are
// bit-identical:
// - fa_bwd_delta: D per row in fp32, one warp a row.
// - fa_bwd_dkdv: a block of 4 warps owns a 64-key tile of one (batch, KV
//   head) and a run of the group's query heads; warp w owns keys 16 w ..
//   +16. It computes the transposed tiles S^T = K Q^T and dP^T = V dO^T,
//   with K and V (kept in shared memory for the whole block) as the A
//   operand, so P^T and dS^T come out of the accumulator already in the
//   layout of the next product's A operand: dV += P^T dO and dK += dS^T Q
//   take them from registers, and dO and Q enter as B operands (bf16: by
//   ldmatrix.trans). LSE and D are per query, i.e. per column of S^T: they
//   are staged per query tile beside Q and dO. The tiles it visits are the
//   query tiles that see the key tile, for each head of its run, one loop
//   over (head, query tile) through a two-stage ring.
// - Head split. With one block per (key tile, batch, KV head), glm4-9b's
//   heads at B 1 (2 KV heads, S 1024) give 32 blocks for 132 SMs. So the
//   group's g query heads are cut into runs of hps heads (a pure function of
//   the shapes, kernels/flash_attention/kernel.py: bwd_heads_per_split,
//   aiming at two blocks an SM): each run's block writes its fp32 partial
//   dK and dV to scratch the wrapper allocates, and fa_bwd_sum adds the
//   runs in their order (one run: the block writes dk and dv itself).
// - fa_bwd_dq: a block of 4 warps owns a 64-row query tile of one (batch,
//   head), warp w rows 16 w .. +16; it computes S = Q K^T and dP = dO V^T,
//   and dQ += dS K with dS from registers and K the B operand
//   (ldmatrix.trans), over the visible K/V tiles through a two-stage ring,
//   heaviest query tiles launched first.
// - Staging: every tile arrives by 16-byte cp.async (LSE and D by 4-byte
//   ones), two stages deep, so there is one block barrier per tile. Head
//   dims past dh and rows past S or Skv are zeros in shared memory (LSE
//   +inf past S, so P is 0 there); rows that are not whole 16-byte copies
//   (or unaligned pointers) are staged element by element. Tile rows are
//   an odd number of 16-byte chunks, so the 8 rows an ldmatrix reads lie on
//   different banks. A warp computes S^T (S) in chunks of 64 columns,
//   skips a chunk wholly masked for its 16 rows, and masks element by
//   element only a chunk that crosses the diagonal or the window edge.
//   Tiles wholly masked are never visited.
// - Registers: a dK/dV warp holds 16 x dh of dK and of dV in fp32 (64 or
//   128 registers); it computes dP^T only after dV += P^T dO, so that S^T's
//   and dP^T's chunks are never live together, and at width 128 its chunks
//   are 16 columns (S's in the dQ kernel 32): with 32, ptxas spilled at its
//   cap of 255 registers. ptxas (sm_90a, registers; no spills): dK/dV bf16
//   170 / 252 (width 64 / 128), fp32 248 / 232; dQ bf16 168 / 192, fp32
//   167 / 163; D and the sum of the runs 31-32. At width 64 in bf16 both
//   kernels fit 3 blocks an SM.
// - P in the log2 domain: P = 2^(s scale log2(e) - lse log2(e)) on the
//   special-function unit; a row with lse +inf (no visible key) gets P 0.
// - bf16: m16n8k16 with fp32 accumulation. S and dP are exact per product
//   (bf16 inputs). P and dS enter dV, dK and dQ split into a bf16 high part
//   and remainder, two products each (as the forward splits P for P.V): one
//   bf16 P, or one bf16 dS, moves the gradients by more than 3 times the
//   limit (1e-4 of the largest element plus one bf16 step of the value), as
//   tests/test_torch_flash_bwd_model.py shows on the CPU.
// - fp32: 3xTF32 m16n8k8 (lo.hi + hi.lo + hi.hi, split_a / split_b of
//   common.cuh), near fp32 accuracy. The TF32 accumulator's layout is not
//   the A operand's, but a product's k order is free: A's k slot tig takes
//   the accumulator's column 2 tig and slot tig + 4 column 2 tig + 1, so
//   P^T, dS^T and dS stay in registers, and the B operand (no ldmatrix.trans
//   for 32-bit values) is read in the same order by scalar loads, rows 2 tig
//   and 2 tig + 1, column gid: at a row pitch of dh + 4 words these fall on
//   banks 8 tig + gid, all different.
// - Width 256 (recurrentgemma-9b, g = 16, window 2048): a warp's dK and dV
//   accumulators would be 256 registers (dQ's 128), so the output head dims
//   are split across two blocks (HO = 128 dims each, the "halves" of the
//   grid): both halves compute S^T and dP^T (S and dP) over the full 256
//   dims and each accumulates its own 128 dims of dK and dV (dQ), so the
//   accumulators are those of width 128, with its 16-column chunks of S^T.
//   The cost is S^T and dP^T (S and dP) computed twice: 4 of the 10
//   products a visible pair does become 8, 14 in all. bf16 tiles fit at 64
//   rows (K, V and a two-stage Q/dO ring: 203 KB, one block an SM); fp32
//   tiles only at 32 rows, so at that width in fp32 a block has 2 warps
//   (BwdCfg::W), 200 KB of tiles and one block an SM; there every query
//   head is a run of its own (kernel.py: bwd_heads_per_split), so that an
//   fp32 accumulator sums at most S terms.
#include "common.cuh"

namespace {

using repro::ex2;
using repro::ldmatrix_x4;
using repro::ldmatrix_x4_trans;
using repro::mma_bf16;
using repro::split_a;
using repro::split_b;
using repro::split_bf16x2;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;    // keys of a dK/dV block, query rows of a dQ
                             // block, and the rows of every staged tile
constexpr int kDeltaThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kThreads == 2 * kTile, "one thread stages one LSE or D value");
static_assert(kTile == 16 * kWarps, "16 rows a warp");

// per (type, width): the row pitch of every tile (elements; an odd number
// of 16-byte chunks, and 4 words past a multiple of 32 banks in fp32), the
// 8-column n-tiles of S^T (S) a warp computes at once, and the layout of
// shared memory
template <typename T, int HD>
struct BwdCfg {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int LD = HD + 16 / sizeof(T);
  static constexpr int NCK = HD == 64 ? 8 : 2;   // of S^T (dK/dV)
  static constexpr int NCQ = HD == 64 ? 8 : 4;   // of S (dQ)
  // warps of a block and the rows of its tiles (16 a warp): fp32 tiles of
  // width 256 fit shared memory only at 32 rows
  static constexpr int W = kF32 && HD == 256 ? 2 : kWarps;
  static constexpr int TR = 16 * W;
  static constexpr int THR = 32 * W;
  static constexpr int HO = HD > 128 ? 128 : HD;   // output dims a block owns
  static constexpr int NH = HD / HO;               // blocks of one output row
  static constexpr int NO = HO / 8;   // 8-dim n-tiles of dK, dV and dQ
  static constexpr size_t tile = sizeof(T) * TR * LD;
  static constexpr size_t stats = sizeof(float) * 2 * TR;   // LSE, D
  // dK/dV: K, V, then two stages of (Q, dO, LSE, D); dQ: Q, dO, then two
  // stages of (K, V)
  static constexpr size_t stage_dkdv = 2 * tile + stats;
  static constexpr size_t smem_dkdv = 2 * tile + 2 * stage_dkdv;
  static constexpr size_t smem_dq = 6 * tile;
  static_assert(smem_dkdv <= 232448 && smem_dq <= 232448,
                "shared memory of one block");
  static_assert(NO % 4 == 0 && NCK % 2 == 0 && NCQ % 2 == 0,
                "n-tiles in groups");
  static_assert(THR == 2 * TR, "one thread stages one LSE or D value");
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// rows [row0, row0 + TR) of a [rows_total, row_stride] source into a
// shared tile: 16-byte cp.async copies when vec, else element by element;
// rows past rows_total are written as zeros (columns past dh are zeroed
// once by zero_pad and never written here)
template <typename T, int HD>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int row0,
                                           int rows_total, int row_stride,
                                           int dh, bool vec) {
  using C = BwdCfg<T, HD>;
  constexpr int LD = C::LD;
  constexpr int kV = 16 / sizeof(T);
  constexpr int kCpr = HD / kV;   // 16-byte chunks of a row at full width
  if (vec) {
    for (int idx = threadIdx.x; idx < C::TR * kCpr; idx += C::THR) {
      const int r = idx / kCpr;
      const int c = idx % kCpr;
      if (c * kV >= dh) continue;
      T* d = dst + r * LD + c * kV;
      if (row0 + r < rows_total)
        repro::cp_async16(d, src + (size_t)(row0 + r) * row_stride + c * kV);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < C::TR * dh; idx += C::THR) {
      const int r = idx / dh;
      const int d = idx - r * dh;
      dst[r * LD + d] = row0 + r < rows_total
                            ? src[(size_t)(row0 + r) * row_stride + d]
                            : repro::from_float<T>(0.f);
    }
  }
}

// head dims [dh, HD) of n consecutive tiles as zeros
template <typename T, int HD>
__device__ __forceinline__ void zero_pad(T* tiles, int n, int dh) {
  using C = BwdCfg<T, HD>;
  constexpr int LD = C::LD;
  const int w = HD - dh;
  for (int idx = threadIdx.x; idx < n * C::TR * w; idx += C::THR) {
    const int r = idx / w;
    tiles[r * LD + dh + idx - r * w] = repro::from_float<T>(0.f);
  }
}

// LSE then D of query rows [q0, q0 + TR) into Ls[2 TR]: +inf and 0 past
// sq (one value a thread: THR == 2 TR)
template <int TR>
__device__ __forceinline__ void stage_stats(float* Ls, const float* lse,
                                            const float* delta, int q0,
                                            int sq) {
  const int r = threadIdx.x % TR;
  const bool is_d = threadIdx.x >= TR;
  if (q0 + r < sq)
    cp_async4(Ls + threadIdx.x, (is_d ? delta : lse) + q0 + r);
  else
    Ls[threadIdx.x] = is_d ? 0.f : INFINITY;
}

// s[t] (the warp's 16 rows of A x rows 8 t .. +8 of B) = A B^T over the
// full width (head dims past dh are zeros); A and B point at their first
// rows. A by ldmatrix, B by ldmatrix in pairs of n-tiles; fp32 as 3xTF32
// (split_a for A, split_b for B, the forward's Q K^T)
template <typename T, int HD, int NT>
__device__ __forceinline__ void mma_abt(const T* A, const T* B,
                                        float (&s)[NT][4]) {
  using C = BwdCfg<T, HD>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
  // a k-step is 32 bytes: 8 fp32 or 16 bf16 values. ldmatrix rows: A
  // lane % 8 + 8 ((lane / 8) % 2), the k-step's second half for lane / 16;
  // B lane % 8 + 8 (lane / 16) (the second n-tile), second half for
  // (lane / 8) % 2
  constexpr int KS = 32 / sizeof(T);
  const T* arow = A + ((lane & 7) + 8 * ((lane >> 3) & 1)) * C::LD +
                  (KS / 2) * (lane >> 4);
  const T* brow = B + ((lane & 7) + 8 * (lane >> 4)) * C::LD +
                  (KS / 2) * ((lane >> 3) & 1);
  constexpr int kUnroll = HD / KS <= 8 ? HD / KS : 4;
#pragma unroll kUnroll
  for (int kk = 0; kk < HD; kk += KS) {
    unsigned a[4];
    ldmatrix_x4(a, arow + kk);
    if constexpr (C::kF32) {
      unsigned ah[4], al[4];
      split_a(a, ah, al);
      unsigned bh[NT][2], bl[NT][2];
#pragma unroll
      for (int t = 0; t < NT; t += 2) {
        unsigned b[4], h4[4], l4[4];
        ldmatrix_x4(b, brow + 8 * t * C::LD + kk);
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
        ldmatrix_x4(b, brow + 8 * t * C::LD + kk);
        mma_bf16(s[t], a, b[0], b[1]);
        mma_bf16(s[t + 1], a, b[2], b[3]);
      }
    }
  }
}

// o[u] (the warp's 16 rows x dims 8 u .. +8 of the block's HO output
// dims) += X B: X the warp's accumulator tiles x[NC] (16 rows x 8 NC
// columns, the k of this product), B the [8 NC][HO] tile rows at B (k row
// r is B's row r; B points at the block's first output dim)
template <typename T, int HD, int NC>
__device__ __forceinline__ void mma_xb(const float (&x)[NC][4], const T* B,
                                       float (&o)[BwdCfg<T, HD>::NO][4]) {
  using C = BwdCfg<T, HD>;
  constexpr int NO = C::NO;
  const int lane = threadIdx.x & 31;
  if constexpr (C::kF32) {
    // TF32 m16n8k8 with A in the accumulator's own layout: k slot tig is
    // column 2 tig, slot tig + 4 column 2 tig + 1; B's rows in that order
    const int gid = lane >> 2, tig = lane & 3;
    const float* brow = B + 2 * tig * C::LD + gid;
#pragma unroll
    for (int t = 0; t < NC; ++t) {
      const unsigned a[4] = {__float_as_uint(x[t][0]), __float_as_uint(x[t][2]),
                             __float_as_uint(x[t][1]),
                             __float_as_uint(x[t][3])};
      unsigned ah[4], al[4];
      split_a(a, ah, al);
      const float* bt = brow + 8 * t * C::LD;
      // groups of 4 n-tiles, their three products issued across the group
#pragma unroll
      for (int u0 = 0; u0 < NO; u0 += 4) {
        unsigned bh[4][2], bl[4][2];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const unsigned bv[2] = {__float_as_uint(bt[8 * (u0 + u)]),
                                  __float_as_uint(bt[8 * (u0 + u) + C::LD])};
          split_a(bv, bh[u], bl[u]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) repro::mma_tf32(o[u0 + u], al, bh[u]);
#pragma unroll
        for (int u = 0; u < 4; ++u) repro::mma_tf32(o[u0 + u], ah, bl[u]);
#pragma unroll
        for (int u = 0; u < 4; ++u) repro::mma_tf32(o[u0 + u], ah, bh[u]);
      }
    }
  } else {
    // bf16 m16n8k16: n-tiles 2 j and 2 j + 1 of X are the A operand of
    // k-step j, split into bf16 high parts and remainders; B by
    // ldmatrix.trans, rows lane % 8 + 8 ((lane / 8) % 2), dims + 8 (lane / 16)
    const T* brow = B + ((lane & 7) + 8 * ((lane >> 3) & 1)) * C::LD +
                    8 * (lane >> 4);
#pragma unroll
    for (int j = 0; j < NC / 2; ++j) {
      unsigned hi[4], lo[4];
      hi[0] = split_bf16x2(x[2 * j][0], x[2 * j][1], lo[0]);
      hi[1] = split_bf16x2(x[2 * j][2], x[2 * j][3], lo[1]);
      hi[2] = split_bf16x2(x[2 * j + 1][0], x[2 * j + 1][1], lo[2]);
      hi[3] = split_bf16x2(x[2 * j + 1][2], x[2 * j + 1][3], lo[3]);
#pragma unroll
      for (int u = 0; u < NO; u += 2) {
        unsigned b[4];
        ldmatrix_x4_trans(b, brow + 16 * j * C::LD + 8 * u);
        mma_bf16(o[u], lo, b[0], b[1]);
        mma_bf16(o[u + 1], lo, b[2], b[3]);
        mma_bf16(o[u], hi, b[0], b[1]);
        mma_bf16(o[u + 1], hi, b[2], b[3]);
      }
    }
  }
}

// D[b, h, i] = sum_d dO[b, i, h, d] O[b, i, h, d]: one warp a row
template <typename T>
__global__ void __launch_bounds__(kDeltaThreads)
fa_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, int rows, int sq, int hq, int dh) {
  const int row = blockIdx.x * (kDeltaThreads / 32) + (threadIdx.x >> 5);
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

// grid (B Hkv splits, key tiles): blockIdx.x = (b Hkv + KV head) splits +
// split, the split taking query heads [split hps, min(g, split hps + hps))
// of the group; with one split it writes dk and dv, else its fp32 partials
// (dk already scaled) into part [splits][2][B Skv Hkv dh]
template <typename T, int HD>
__global__ void __launch_bounds__(BwdCfg<T, HD>::THR)
fa_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ part,
            int sq, int skv, int hq, int hkv, int dh, int causal, int window,
            int hps, float scale, int vec) {
  using C = BwdCfg<T, HD>;
  constexpr int LD = C::LD, NC = C::NCK, NO = C::NO, QC = 8 * NC;
  constexpr int TR = C::TR;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + TR * LD;
  auto stage_q = [&](int st) {   // Q, then dO, LSE and D of a stage
    return reinterpret_cast<T*>(smem + 2 * C::tile + st * C::stage_dkdv);
  };

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int g = hq / hkv;
  const int splits = (g + hps - 1) / hps;
  const int half = blockIdx.x % C::NH;       // the output dims it owns
  const int split = (blockIdx.x / C::NH) % splits;
  const int bk = blockIdx.x / (C::NH * splits);
  const int b = bk / hkv, kvh = bk - b * hkv;
  const int k0 = blockIdx.y * TR;
  const int h0 = kvh * g + split * hps;
  const int nh = min(hps, g - split * hps);
  const size_t kv_off = ((size_t)b * skv * hkv + kvh) * dh;

  // query rows that see a key of this tile: i >= k0 (causal) and i <
  // (last key) + window (windowed); then one loop over (head, query tile)
  const int q_begin = causal ? k0 : 0;
  int q_end = sq;
  if (window > 0) q_end = min(sq, min(k0 + TR, skv) - 1 + window);
  const int nqt = q_end > q_begin ? (q_end - q_begin + TR - 1) / TR : 0;
  const int iters = nh * nqt;

  if (dh < HD) {
    zero_pad<T, HD>(Ks, 2, dh);
    zero_pad<T, HD>(stage_q(0), 2, dh);
    zero_pad<T, HD>(stage_q(1), 2, dh);
  }
  auto stage = [&](int it) {
    T* Qs = stage_q(it & 1);
    const int h = h0 + it / nqt;
    const int q0 = q_begin + (it % nqt) * TR;
    const size_t q_off = ((size_t)b * sq * hq + h) * dh;
    const size_t r_off = ((size_t)b * hq + h) * sq;
    stage_rows<T, HD>(Qs, q + q_off, q0, sq, hq * dh, dh, vec);
    stage_rows<T, HD>(Qs + TR * LD, dout + q_off, q0, sq, hq * dh, dh, vec);
    stage_stats<TR>(reinterpret_cast<float*>(Qs + 2 * TR * LD), lse + r_off,
                    delta + r_off, q0, sq);
  };
  if (iters > 0) {
    stage_rows<T, HD>(Ks, k + kv_off, k0, skv, hkv * dh, dh, vec);
    stage_rows<T, HD>(Vs, v + kv_off, k0, skv, hkv * dh, dh, vec);
    stage(0);
  }
  repro::cp_async_commit();

  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int u = 0; u < NO; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[u][e] = dv_acc[u][e] = 0.f;
  const float scale2 = scale * kLog2e;
  const int kw = k0 + 16 * warp;   // the warp's first key
  const T* Kw = Ks + 16 * warp * LD;
  const T* Vw = Vs + 16 * warp * LD;

  for (int it = 0; it < iters; ++it) {
    repro::cp_async_wait<0>();
    __syncthreads();   // tile it in place; every warp is done with it - 1
    if (it + 1 < iters) stage(it + 1);
    repro::cp_async_commit();
    const T* Qs = stage_q(it & 1);
    const T* dOs = Qs + TR * LD;
    const float* Ls = reinterpret_cast<const float*>(dOs + TR * LD);
    const float* Ds = Ls + TR;
    const int q0 = q_begin + (it % nqt) * TR;
#pragma unroll 1
    for (int c = 0; c < TR; c += QC) {
      const int qc = q0 + c;
      // nothing of the chunk visible to the warp's keys
      if (kw >= skv || qc >= sq || (causal && qc + QC - 1 < kw) ||
          (window > 0 && kw + 15 <= qc - window))
        continue;
      float s[NC][4], dp[NC][4];
      mma_abt<T, HD, NC>(Kw, Qs + c * LD, s);   // S^T
      const bool full = (!causal || kw + 15 <= qc) &&
                        (window <= 0 || kw > qc + QC - 1 - window);
#pragma unroll
      for (int t = 0; t < NC; ++t) {
        const float2 l = *reinterpret_cast<const float2*>(Ls + c + 8 * t +
                                                          2 * tig);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lv = (e & 1) ? l.y : l.x;
          float p = ex2(fmaf(s[t][e], scale2, -lv * kLog2e));
          if (!full) {
            const int qi = qc + 8 * t + 2 * tig + (e & 1);
            const int kj = kw + gid + 8 * (e >> 1);
            if ((causal && kj > qi) || (window > 0 && kj <= qi - window))
              p = 0.f;
          }
          s[t][e] = p;
        }
      }
      mma_xb<T, HD, NC>(s, dOs + c * LD + half * C::HO, dv_acc);  // dV += P^T dO
      // dP^T only now, so that it is never live with S^T's chunk
      mma_abt<T, HD, NC>(Vw, dOs + c * LD, dp);
#pragma unroll
      for (int t = 0; t < NC; ++t) {
        const float2 d = *reinterpret_cast<const float2*>(Ds + c + 8 * t +
                                                          2 * tig);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[t][e] = s[t][e] * (dp[t][e] - ((e & 1) ? d.y : d.x));
      }
      mma_xb<T, HD, NC>(dp, Qs + c * LD + half * C::HO, dk_acc);  // dK += dS^T Q
    }
  }
  repro::cp_async_wait<0>();   // nothing in flight past the block

  const size_t n = (size_t)(gridDim.x / (C::NH * splits)) * skv * dh;  // B Skv Hkv dh
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = kw + gid + 8 * i;
    if (kj >= skv) continue;
    const size_t row = kv_off + (size_t)kj * hkv * dh;
#pragma unroll
    for (int u = 0; u < NO; ++u)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = half * C::HO + 8 * u + 2 * tig + e;
        if (d >= dh) continue;
        const float x = dk_acc[u][2 * i + e] * scale;
        const float y = dv_acc[u][2 * i + e];
        if (splits == 1) {
          dk[row + d] = repro::from_float<T>(x);
          dv[row + d] = repro::from_float<T>(y);
        } else {
          part[2 * split * n + row + d] = x;
          part[(2 * split + 1) * n + row + d] = y;
        }
      }
  }
}

// dk, dv = the sums of the splits' partials, split 0 first
template <typename T>
__global__ void __launch_bounds__(kDeltaThreads)
fa_bwd_sum(const float* __restrict__ part, T* __restrict__ dk,
           T* __restrict__ dv, size_t n, int splits) {
  for (size_t i = (size_t)blockIdx.x * kDeltaThreads + threadIdx.x; i < n;
       i += (size_t)gridDim.x * kDeltaThreads) {
    float x = 0.f, y = 0.f;
    for (int s = 0; s < splits; ++s) {
      x += part[2 * s * n + i];
      y += part[(2 * s + 1) * n + i];
    }
    dk[i] = repro::from_float<T>(x);
    dv[i] = repro::from_float<T>(y);
  }
}

// grid (B Hq halves, query tiles), the last query tiles (the most keys
// under a causal mask) first
template <typename T, int HD>
__global__ void __launch_bounds__(BwdCfg<T, HD>::THR)
fa_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int sq, int skv, int hq, int hkv, int dh,
          int causal, int window, float scale, int vec) {
  using C = BwdCfg<T, HD>;
  constexpr int LD = C::LD, NC = C::NCQ, NO = C::NO, KC = 8 * NC;
  constexpr int TR = C::TR;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + TR * LD;
  T* KVs = dOs + TR * LD;   // two stages of (K, V)

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int half = blockIdx.x % C::NH;   // the output dims it owns
  const int bq = blockIdx.x / C::NH;
  const int b = bq / hq, h = bq - b * hq;
  const int kvh = h / (hq / hkv);
  const int nq = (sq + TR - 1) / TR;
  const int q0 = (causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y) * TR;
  const size_t q_off = ((size_t)b * sq * hq + h) * dh;
  const size_t r_off = ((size_t)b * hq + h) * sq;
  const size_t kv_off = ((size_t)b * skv * hkv + kvh) * dh;

  // keys that a row of this tile sees: j <= last row (causal) and j > q0 -
  // window (windowed)
  int kv_end = skv;
  if (causal) kv_end = min(kv_end, min(q0 + TR, sq));
  int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  kv_begin = (kv_begin / TR) * TR;
  const int nkt = kv_end > kv_begin ? (kv_end - kv_begin + TR - 1) / TR : 0;

  if (dh < HD) zero_pad<T, HD>(Qs, 6, dh);
  auto stage_kv = [&](int j) {
    T* Kst = KVs + (j & 1) * 2 * TR * LD;
    const int k0 = kv_begin + j * TR;
    stage_rows<T, HD>(Kst, k + kv_off, k0, skv, hkv * dh, dh, vec);
    stage_rows<T, HD>(Kst + TR * LD, v + kv_off, k0, skv, hkv * dh, dh, vec);
  };
  if (nkt > 0) {
    stage_rows<T, HD>(Qs, q + q_off, q0, sq, hq * dh, dh, vec);
    stage_rows<T, HD>(dOs, dout + q_off, q0, sq, hq * dh, dh, vec);
    stage_kv(0);
  }
  repro::cp_async_commit();

  // the thread's rows qw + gid and qw + gid + 8: -LSE in base 2, and D
  const int qw = q0 + 16 * warp;
  float nl[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = qw + gid + 8 * i;
    nl[i] = qi < sq ? -lse[r_off + qi] * kLog2e : -INFINITY;
    dd[i] = qi < sq ? delta[r_off + qi] : 0.f;
  }
  const float scale2 = scale * kLog2e;
  const T* Qw = Qs + 16 * warp * LD;
  const T* dOw = dOs + 16 * warp * LD;
  float dq_acc[NO][4];
#pragma unroll
  for (int u = 0; u < NO; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[u][e] = 0.f;

  for (int j = 0; j < nkt; ++j) {
    repro::cp_async_wait<0>();
    __syncthreads();   // K/V tile j in place; every warp is done with j - 1
    if (j + 1 < nkt) stage_kv(j + 1);
    repro::cp_async_commit();
    const T* Kst = KVs + (j & 1) * 2 * TR * LD;
    const T* Vst = Kst + TR * LD;
    const int k0 = kv_begin + j * TR;
#pragma unroll 1
    for (int c = 0; c < TR; c += KC) {
      const int kc = k0 + c;
      // nothing of the chunk visible to the warp's rows
      if (qw >= sq || kc >= skv || (causal && kc > qw + 15) ||
          (window > 0 && kc + KC - 1 <= qw - window))
        continue;
      float s[NC][4], dp[NC][4];
      mma_abt<T, HD, NC>(Qw, Kst + c * LD, s);    // S
      mma_abt<T, HD, NC>(dOw, Vst + c * LD, dp);  // dP
      const bool full = kc + KC <= skv && (!causal || kc + KC - 1 <= qw) &&
                        (window <= 0 || kc > qw + 15 - window);
#pragma unroll
      for (int t = 0; t < NC; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float p = ex2(fmaf(s[t][e], scale2, nl[i]));
          if (!full) {
            const int qi = qw + gid + 8 * i;
            const int kj = kc + 8 * t + 2 * tig + (e & 1);
            if (kj >= skv || (causal && kj > qi) ||
                (window > 0 && kj <= qi - window))
              p = 0.f;
          }
          dp[t][e] = p * (dp[t][e] - dd[i]);
        }
      mma_xb<T, HD, NC>(dp, Kst + c * LD + half * C::HO, dq_acc);  // dQ += dS K
    }
  }
  repro::cp_async_wait<0>();   // nothing in flight past the block

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = qw + gid + 8 * i;
    if (qi >= sq) continue;
    T* row = dq + q_off + (size_t)qi * hq * dh;
#pragma unroll
    for (int u = 0; u < NO; ++u)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = half * C::HO + 8 * u + 2 * tig + e;
        if (d < dh) row[d] = repro::from_float<T>(dq_acc[u][2 * i + e] * scale);
      }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, float* part,
           void* dq, void* dk, void* dv, int b, int sq, int skv, int hq,
           int hkv, int dh, int causal, int window, int hps, float scale,
           cudaStream_t stream) {
  using C = BwdCfg<T, HD>;
  cudaError_t e = cudaFuncSetAttribute(
      fa_bwd_dkdv<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::smem_dkdv);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(fa_bwd_dq<T, HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)C::smem_dq);
  if (e != cudaSuccess) return (int)e;
  const int vec = dh % (16 / (int)sizeof(T)) == 0 &&
                  ((size_t)q | (size_t)k | (size_t)v | (size_t)dout) % 16 == 0;
  const int rows = b * sq * hq;
  const int rows_per_block = kDeltaThreads / 32;
  fa_bwd_delta<T><<<(rows + rows_per_block - 1) / rows_per_block,
                    kDeltaThreads, 0, stream>>>((const T*)o, (const T*)dout,
                                                delta, rows, sq, hq, dh);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (skv > 0) {
    const int splits = (hq / hkv + hps - 1) / hps;
    const dim3 grid_kv(b * hkv * splits * C::NH, (skv + C::TR - 1) / C::TR);
    fa_bwd_dkdv<T, HD><<<grid_kv, C::THR, C::smem_dkdv, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
        (T*)dk, (T*)dv, part, sq, skv, hq, hkv, dh, causal, window, hps,
        scale, vec);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (splits > 1) {
      const size_t n = (size_t)b * skv * hkv * dh;
      const size_t blocks = (n + kDeltaThreads - 1) / kDeltaThreads;
      fa_bwd_sum<T><<<(unsigned)(blocks < 1056 ? blocks : 1056),
                      kDeltaThreads, 0, stream>>>(part, (T*)dk, (T*)dv, n,
                                                  splits);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
  }
  const dim3 grid_q(b * hq * C::NH, (sq + C::TR - 1) / C::TR);
  fa_bwd_dq<T, HD><<<grid_q, C::THR, C::smem_dq, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, sq, skv, hq, hkv, dh, causal, window, scale, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, float* delta, float* part,
              void* dq, void* dk, void* dv, int b, int sq, int skv, int hq,
              int hkv, int dh, int causal, int window, int hps, float scale,
              cudaStream_t s) {
  if (dh <= 64)
    return launch<T, 64>(q, k, v, o, dout, lse, delta, part, dq, dk, dv, b,
                         sq, skv, hq, hkv, dh, causal, window, hps, scale, s);
  if (dh <= 128)
    return launch<T, 128>(q, k, v, o, dout, lse, delta, part, dq, dk, dv, b,
                          sq, skv, hq, hkv, dh, causal, window, hps, scale,
                          s);
  if (dh <= 256)
    return launch<T, 256>(q, k, v, o, dout, lse, delta, part, dq, dk, dv, b,
                          sq, skv, hq, hkv, dh, causal, window, hps, scale,
                          s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dq, dk, dv (like q, k, v) of the attention the forward computed, from q,
// k, v, its output o, the output's gradient dout and the forward's lse
// [B,Hq,S]; delta is [B,Hq,S] fp32 scratch (D, written here). The dK/dV
// kernel cuts each group's Hq/Hkv query heads into runs of heads_per_split;
// with more than one run, part is fp32 scratch of 2 runs B Skv Hkv dh
// floats (the runs' partial dk and dv), else unused. dh <= 256.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, float* part, void* dq,
    void* dk, void* dv, int b, int sq, int skv, int hq, int hkv, int dh,
    int causal, int window, int heads_per_split, float scale, int dtype,
    void* stream) {
  if (b <= 0 || sq <= 0 || hq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || dh <= 0 || skv < 0 ||
      heads_per_split <= 0 || heads_per_split > hq / hkv ||
      (heads_per_split < hq / hkv && skv > 0 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == repro::kFloat32)
    return launch_dh<float>(q, k, v, o, dout, lse, delta, part, dq, dk, dv, b,
                            sq, skv, hq, hkv, dh, causal, window,
                            heads_per_split, scale, s);
  if (dtype == repro::kBFloat16)
    return launch_dh<__nv_bfloat16>(q, k, v, o, dout, lse, delta, part, dq,
                                    dk, dv, b, sq, skv, hq, hkv, dh, causal,
                                    window, heads_per_split, scale, s);
  return (int)cudaErrorInvalidValue;
}
