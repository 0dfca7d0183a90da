// Flash-attention forward for Hopper's bf16 train path at head width 64:
// wgmma products, K/V tiles fed by TMA through a ring of shared-memory
// stages, and warp-specialised softmax.
//
// Which calls: kernels/flash_attention/kernel.py sends here every forward
// whose q/k/v are bf16 at dh 64, 16-byte aligned, with a positive softmax
// scale and at least one key, in every mask mode (causal, sliding window,
// neither; Sq != Skv; ragged S; with or without the row LSE; any GQA
// ratio). That is every attention call of the train path of qwen2-0.5b
// (14/2 heads) and granite-moe (24/8), forward and remat's recompute. fp32
// (the serve path's 3xTF32), the widths 128 and 256 and unaligned rows
// stay on flash_attention.cu, which this kernel shares nothing with beyond
// common.cuh's helpers: that kernel's 3xTF32 split and width-256 register
// budget shaped it, and neither applies here.
//
// Bound on an H100. The work is 4 dh Hq flop per visible (query, key) pair:
// at the 8k cell's [4,8192,14,64] causal, 4.8e11 flop, 0.486 ms at 989
// TFLOP/s, against 33 MB of q/k/v/o (0.01 ms at 3.35 TB/s): the tensor
// cores bind. P.V is two products here (below), so the kernel does 1.5x the
// counted work and can reach at most ~67% of that bound.
//
// Design (one block of 384 threads a SM, persistent):
// - Tiles of 128 query rows of one (batch, head), walked by a grid of one
//   block a SM in a fixed order: block x takes tiles t = x, x + G, ...; t
//   names the query tile (nq - 1 - t / (B Hq): the causal triangle's longest
//   tiles first, the short ones fill the tail) and (batch, head) = t % (B
//   Hq), so that the query heads of one KV head run side by side and share
//   its tiles in L2. No counter: the order of every sum is fixed and
//   repeats bit for bit.
// - Warp specialisation: warps 0-7 are two consumer warpgroups, each the
//   owner of 64 of the tile's rows; warps 8-11 are the producer warpgroup,
//   one thread of which issues every load (the other three warps only hand
//   their registers over). setmaxnreg moves registers from the producer to
//   the consumers: 168 each at entry, then 24 and 240 (the same total).
// - Loads by TMA, 3-d tensor maps over q, k and v as [B][S][H dh] with the
//   head as the column offset, boxes of 64 dims (one 128-byte row) and
//   128-byte swizzle, the layout wgmma reads; rows past S of a batch arrive
//   as zeros. Q comes once a tile into a ring of two buffers, K and V tiles
//   of 128 keys into a ring of three stages, each buffer with a full and an
//   empty mbarrier, so that the producer runs stages ahead, across tiles.
// - S = Q K^T by wgmma with both operands in shared memory (m64n128k16, four
//   k-steps). S of key tile j is issued together with P.V of tile j - 1, and
//   the softmax of tile j runs while that P.V is in flight; the two
//   warpgroups take turns to issue (named barriers 1 and 2), so that one's
//   softmax overlaps the other's products.
// - Softmax in fp32 in registers, in the log2 domain: the row maximum of the
//   raw scores, then p = 2^(s scale log2(e) - m scale log2(e)) with one FMA
//   and ex2.approx; one online softmax a row (a warpgroup holds whole rows);
//   the row maxima and sums as trees, not chains (two warps a scheduler hide
//   little latency); the mask only on tiles that cross the diagonal, the
//   window's edge or the ragged end of the keys. A row with nothing visible
//   yet keeps p 0.
// - P.V with P split, as flash_attention.cu's bf16 route: P = hi + lo, each
//   bf16 (rounded), and two wgmma products with P as the register operand
//   (the S accumulator's layout is the A fragment's) and V from shared
//   memory (MN-major B). One bf16 P moves an output whose terms cancel by
//   more than the limit (tests/test_torch_flash_model.py).
// - Epilogue: O in bf16 straight from the accumulator; the row LSE as
//   flash_attention.cu writes it: fp32 [B,Hq,S], natural log, +inf for a
//   row that sees no key; the backward reads it unchanged.
// Measured at the 8k cell's shape (PERF.md, section 6): the products alone run
// at ~85% of the tensor rate and the softmax and split alone take as long
// again; together they overlap little. Three warpgroups of 64-key tiles,
// a split in integer operations, two or four stages, issuing a tile's last
// P.V with the next tile's first S, and dropping the exps each moved the
// time by under 5% or made it slower.
#include <cuda.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kDh = 64;                 // head width: one 128-byte row
constexpr int kRowBytes = 2 * kDh;
constexpr int kWG = 2;                  // consumer warpgroups
constexpr int kBQ = 64 * kWG;           // query rows a tile, 64 a warpgroup
constexpr int kBK = 128;                // keys a K/V tile (S is m64n128)
constexpr int kStages = 3;              // K/V ring
constexpr int kConsumers = 128 * kWG;
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
// 168 registers a thread at entry (65536 / 384); the producer's go to the
// consumers: 24 + 2 x 240 = 3 x 168
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// shared memory, from a 1024-byte aligned base (the swizzle's atom): Q
// [2][kBQ][64], K and V [kStages][kBK][64], then the mbarriers
struct Smem {
  static constexpr int q_bytes = kBQ * kRowBytes;
  static constexpr int kv_bytes = kBK * kRowBytes;
  static constexpr int k_off = 2 * q_bytes;
  static constexpr int v_off = k_off + kStages * kv_bytes;
  static constexpr int bar_off = v_off + kStages * kv_bytes;
  // q_full[2], q_empty[2], k_full, k_empty, v_full, v_empty [kStages]
  static constexpr int bars = 4 + 4 * kStages;
  static constexpr int bytes = bar_off + 8 * bars + 1024;   // + alignment
  static_assert(bytes <= 232448, "shared memory of one block");
};

struct Params {
  __nv_bfloat16* o;
  float* lse;
  int b, sq, skv, hq, hkv, causal, window, nq, tiles;
  float scale2;   // the softmax scale times log2(e)
};

// one tile: batch, query head, its KV head, first query row, first key of
// the first K/V tile it visits and how many it visits
struct Tile {
  int b, h, kvh, q0, k0, n;
};

__device__ __forceinline__ Tile tile_of(int t, const Params& p) {
  const int bhq = p.b * p.hq;
  const int i = t / bhq;
  const int bh = t - i * bhq;
  Tile r;
  r.b = bh / p.hq;
  r.h = bh - r.b * p.hq;
  r.kvh = r.h / (p.hq / p.hkv);
  r.q0 = (p.nq - 1 - i) * kBQ;
  const int end = p.causal ? min(p.skv, r.q0 + kBQ) : p.skv;
  const int begin = p.window > 0 ? max(0, r.q0 - p.window + 1) : 0;
  r.k0 = begin / kBK * kBK;
  r.n = end > r.k0 ? (end - r.k0 + kBK - 1) / kBK : 0;
  return r;
}

// a position in a ring of n buffers: the buffer and the parity of its round
struct Ring {
  int s = 0, ph = 0;
  __device__ __forceinline__ void next(int n) {
    if (++s == n) {
      s = 0;
      ph ^= 1;
    }
  }
};

using repro::ex2;
using repro::smem_u32;
using repro::split_bf16x2;

// mbarriers, TMA, named barriers and wgmma's fences
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
// box (c0, c1, c2) of a 3-d tensor map into shared memory at dst, its bytes
// reported to the mbarrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}
// named barrier id: one warpgroup waits at it, the one before arrives
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// registers an asynchronous wgmma reads or writes: kept in place up to here
template <int N>
__device__ __forceinline__ void keep(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void keep(unsigned (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// wgmma's descriptor of a tile of 128-byte rows in shared memory, written
// by TMA with the 128-byte swizzle: start address >> 4, the leading offset
// 16 bytes (unused: one swizzle atom spans the 64 dims), the stride 1024
// bytes (the next group of 8 rows), layout 1 (128-byte swizzle). A k-step of
// 16 dims adds 32 bytes to the start; 16 rows add 2048.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)64 << 32) | ((uint64_t)1 << 62);
}

// d (+)= A B^T, m64n128k16, bf16 in, fp32 sums; A and B by descriptor,
// both K-major; scale_d 0 starts the sum at zero
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B, m64n64k16, bf16 in, fp32 sums; A from registers (each warp's 16
// rows as the m16n8k16 A fragment), B by descriptor, MN-major (transposed:
// its 64 columns contiguous)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const unsigned (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

constexpr int kNS = kBK / 2;    // S accumulator values a thread
constexpr int kKS = kBK / 16;   // k-steps of P.V

// S = Q K^T of one K/V tile (four k-steps of 16 dims)
__device__ __forceinline__ void issue_qk(float (&s)[kNS], uint64_t dq,
                                         uint64_t dk) {
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk)
    wgmma_ss(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
}

// O += P V, P as its bf16 high parts and remainders, 16 keys a k-step
__device__ __forceinline__ void issue_pv(float (&o)[32],
                                         const unsigned (&hi)[kKS][4],
                                         const unsigned (&lo)[kKS][4],
                                         uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk) {
    wgmma_rs_n64(o, lo[kk], dv + 128 * kk);
    wgmma_rs_n64(o, hi[kk], dv + 128 * kk);
  }
}

// the row values of a tile's scores reduced by op as a tree (depth 5, not
// a chain of 32: two warps a scheduler hide little latency); value i of s
// belongs to row half (i / 2) % 2
template <int W, typename Op>
__device__ __forceinline__ void tree(float (&a)[2][kNS / 4], Op op) {
  if constexpr (W >= 1) {
#pragma unroll
    for (int t = 0; t < W; ++t) {
      a[0][t] = op(a[0][t], a[0][t + W]);
      a[1][t] = op(a[1][t], a[1][t + W]);
    }
    tree<W / 2>(a, op);
  }
}
template <typename Op>
__device__ __forceinline__ void row_reduce(const float (&s)[kNS],
                                           float (&out)[2], Op op) {
  float a[2][kNS / 4];
#pragma unroll
  for (int t = 0; t < kNS / 4; ++t) {
    a[0][t] = op(s[4 * t], s[4 * t + 1]);
    a[1][t] = op(s[4 * t + 2], s[4 * t + 3]);
  }
  tree<kNS / 8>(a, op);
  out[0] = a[0][0];
  out[1] = a[1][0];
}

// the online softmax of one tile's scores s (this thread's rows r0 and r0 +
// 8; value i is key kb + 8 (i / 4) + 2 tig + i % 2 of row r0 + 8 ((i / 2) %
// 2)): masked when kMask, the row maxima m (of raw scores) and sums l
// updated, alpha the factor the accumulator takes, s left holding p
template <bool kMask>
__device__ __forceinline__ void softmax(float (&s)[kNS], float (&m)[2],
                                        float (&l)[2], float (&alpha)[2],
                                        float scale2, int r0, int kb, int tig,
                                        const Params& p) {
  if constexpr (kMask) {
#pragma unroll
    for (int i = 0; i < kNS; ++i) {
      const int qi = r0 + 8 * ((i >> 1) & 1);
      const int kj = kb + 8 * (i >> 2) + 2 * tig + (i & 1);
      bool ok = kj < p.skv;
      if (p.causal) ok = ok && kj <= qi;
      if (p.window > 0) ok = ok && kj > qi - p.window;
      if (!ok) s[i] = -INFINITY;
    }
  }
  float mx[2], ms[2], sum[2];
  row_reduce(s, mx, [](float a, float b) { return fmaxf(a, b); });
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2)),
                  m[r]);
    // nothing visible to this row yet: p 0 (2^-inf), the sums stay 0
    ms[r] = mx[r] == -INFINITY ? 0.f : __fmul_rn(mx[r], scale2);
    alpha[r] = ex2(__fmul_rn(m[r], scale2) - ms[r]);
    m[r] = mx[r];
  }
#pragma unroll
  for (int i = 0; i < kNS; ++i)
    s[i] = ex2(fmaf(s[i], scale2, -ms[(i >> 1) & 1]));
  row_reduce(s, sum, [](float a, float b) { return a + b; });
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], alpha[r], sum[r]);
}

// P as the A fragments of P.V: the bf16 high part of each value (rounded)
// and its remainder; k-step kk takes n-tiles 2 kk (values 8 kk .. +4) and
// 2 kk + 1
__device__ __forceinline__ void split_p(const float (&s)[kNS],
                                        unsigned (&hi)[kKS][4],
                                        unsigned (&lo)[kKS][4]) {
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      hi[kk][e] = split_bf16x2(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1],
                               lo[kk][e]);
}

template <bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
fa_fwd_sm90(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t qbuf = base, kbuf = base + Smem::k_off;
  const uint32_t vbuf = base + Smem::v_off, bars = base + Smem::bar_off;
  auto q_full = [&](int s) { return bars + 8 * s; };
  auto q_empty = [&](int s) { return bars + 8 * (2 + s); };
  auto k_full = [&](int s) { return bars + 8 * (4 + s); };
  auto k_empty = [&](int s) { return bars + 8 * (4 + kStages + s); };
  auto v_full = [&](int s) { return bars + 8 * (4 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bars + 8 * (4 + 3 * kStages + s); };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    // a full buffer: the producer's arrival and the bytes of its load; an
    // empty one: one arrival from each consumer warpgroup
    for (int s = 0; s < 2; ++s) {
      mbar_init(q_full(s), 1);
      mbar_init(q_empty(s), kWG);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(k_empty(s), kWG);
      mbar_init(v_full(s), 1);
      mbar_init(v_empty(s), kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    // the producer: one thread issues every load, in the consumers' order
    // (a tile's Q, then K and V of each of its key tiles; nothing for a
    // tile that sees no key); a buffer is refilled once every consumer
    // warpgroup released it (the first round's waits pass: parity 1 of a
    // fresh barrier counts as complete)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers) {
      Ring q, kv;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        const Tile tl = tile_of(t, p);
        if (tl.n == 0) continue;
        mbar_wait(q_empty(q.s), q.ph ^ 1);
        mbar_expect_tx(q_full(q.s), Smem::q_bytes);
        tma_load(qbuf + q.s * Smem::q_bytes, &tq, q_full(q.s), tl.h * kDh,
                 tl.q0, tl.b);
        q.next(2);
        for (int j = 0; j < tl.n; ++j) {
          const int row = tl.k0 + j * kBK;
          mbar_wait(k_empty(kv.s), kv.ph ^ 1);
          mbar_expect_tx(k_full(kv.s), Smem::kv_bytes);
          tma_load(kbuf + kv.s * Smem::kv_bytes, &tk, k_full(kv.s),
                   tl.kvh * kDh, row, tl.b);
          mbar_wait(v_empty(kv.s), kv.ph ^ 1);
          mbar_expect_tx(v_full(kv.s), Smem::kv_bytes);
          tma_load(vbuf + kv.s * Smem::kv_bytes, &tv, v_full(kv.s),
                   tl.kvh * kDh, row, tl.b);
          kv.next(kStages);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = warp >> 2;               // rows 64 wg .. +64 of a tile
    const int gid = lane >> 2, tig = lane & 3;
    const int row = 64 * wg + 16 * (warp & 3) + gid;   // and row + 8
    const bool leader = (threadIdx.x & 127) == 0;
    // turns: warpgroup w issues its products once it passes barrier 1 + w,
    // then lets the next go; warpgroup 0 goes first
    auto turn = [&]() { bar_sync(1 + wg); };
    auto pass = [&]() { bar_arrive(1 + (wg + 1) % kWG); };
    if (wg == kWG - 1) bar_arrive(1);

    // this thread's rows of a tile: O (o scaled by 1 / l) and the LSE
    auto store = [&](const Tile& tl, const float (&o)[32], const float (&m)[2],
                     const float (&l)[2]) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = tl.q0 + row + 8 * r;
        if (qi >= p.sq) continue;
        const float inv = 1.f / fmaxf(l[r], 1e-30f);
        __nv_bfloat16* orow = p.o +
            (((size_t)tl.b * p.sq + qi) * p.hq + tl.h) * kDh + 2 * tig;
#pragma unroll
        for (int t8 = 0; t8 < 8; ++t8)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * t8) =
              __floats2bfloat162_rn(o[4 * t8 + 2 * r] * inv,
                                    o[4 * t8 + 2 * r + 1] * inv);
        if constexpr (kLse) {
          if (tig == 0)
            p.lse[((size_t)tl.b * p.hq + tl.h) * p.sq + qi] =
                m[r] == -INFINITY
                    ? INFINITY
                    : (__fmul_rn(m[r], p.scale2) + log2f(l[r])) * kLn2;
        }
      }
    };
    Ring q, kv;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const Tile tl = tile_of(t, p);
      const int qw = tl.q0 + 64 * wg;   // the warpgroup's first row
      const int r0 = tl.q0 + row;
      float o[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
      if (tl.n == 0) {   // no key visible: O 0, LSE +inf; nothing loaded
        const float none[2] = {0.f, 0.f};
        store(tl, o, m, none);
        continue;
      }
      mbar_wait(q_full(q.s), q.ph);
      const uint64_t dq =
          sw128_desc(qbuf + q.s * Smem::q_bytes + wg * 64 * kRowBytes);
      float sc[kNS];
      unsigned hi[kKS][4], lo[kKS][4];
      // a key tile needs no mask when every key of it is visible to every
      // row of the warpgroup
      auto soft = [&](int kb) {
        if (kb + kBK <= p.skv && (!p.causal || kb + kBK - 1 <= qw) &&
            (p.window <= 0 || kb > qw + 63 - p.window))
          softmax<false>(sc, m, l, alpha, p.scale2, r0, kb, tig, p);
        else
          softmax<true>(sc, m, l, alpha, p.scale2, r0, kb, tig, p);
      };
      // the first key tile: S alone
      mbar_wait(k_full(kv.s), kv.ph);
      turn();
      wgmma_fence();
      issue_qk(sc, dq, sw128_desc(kbuf + kv.s * Smem::kv_bytes));
      wgmma_commit();
      pass();
      wgmma_wait<0>();
      keep(sc);
      if (leader) {
        mbar_arrive(k_empty(kv.s));
        if (tl.n == 1) mbar_arrive(q_empty(q.s));
      }
      soft(tl.k0);
      split_p(sc, hi, lo);
      Ring vs = kv;   // V of the key tile whose P is in hi / lo
      kv.next(kStages);
      for (int j = 1; j < tl.n; ++j) {
        // S of key tile j and P.V of tile j - 1 in one turn; the softmax of
        // tile j runs while P.V is in flight
        mbar_wait(k_full(kv.s), kv.ph);
        mbar_wait(v_full(vs.s), vs.ph);
        turn();
        wgmma_fence();
        issue_qk(sc, dq, sw128_desc(kbuf + kv.s * Smem::kv_bytes));
        wgmma_commit();
        issue_pv(o, hi, lo, sw128_desc(vbuf + vs.s * Smem::kv_bytes));
        wgmma_commit();
        pass();
        wgmma_wait<1>();
        keep(sc);
        if (leader) {
          mbar_arrive(k_empty(kv.s));
          if (j == tl.n - 1) mbar_arrive(q_empty(q.s));
        }
        soft(tl.k0 + j * kBK);
        wgmma_wait<0>();
        keep(o);
        keep(hi);
        keep(lo);
        if (leader) mbar_arrive(v_empty(vs.s));
#pragma unroll
        for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
        split_p(sc, hi, lo);
        vs = kv;
        kv.next(kStages);
      }
      // P.V of the last key tile, alone; then the rows' sums over their
      // four threads, O and the LSE
      mbar_wait(v_full(vs.s), vs.ph);
      turn();
      wgmma_fence();
      issue_pv(o, hi, lo, sw128_desc(vbuf + vs.s * Smem::kv_bytes));
      wgmma_commit();
      pass();
      wgmma_wait<0>();
      keep(o);
      if (leader) mbar_arrive(v_empty(vs.s));
      q.next(2);
      float ls[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        ls[r] = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
        ls[r] += __shfl_xor_sync(0xffffffffu, ls[r], 2);
      }
      store(tl, o, m, ls);
    }
  }
}

// cuTensorMapEncodeTiled from the driver, through the runtime, so that the
// library links as the others do (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// a [B][rows][heads * 64] bf16 tensor as a 3-d map, boxes of 64 dims x
// box_rows rows of one batch, 128-byte swizzle; rows past `rows` read as 0
bool tensor_map(CUtensorMap* map, const void* ptr, int b, int rows, int heads,
                int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)heads * kDh, (cuuint64_t)rows,
                              (cuuint64_t)b};
  const cuuint64_t strides[2] = {(cuuint64_t)heads * kRowBytes,
                                 (cuuint64_t)rows * heads * kRowBytes};
  const cuuint32_t box[3] = {kDh, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kLse>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, const Params& p, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      fa_fwd_sm90<kLse>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem::bytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int grid = p.tiles < sms ? p.tiles : sms;
  fa_fwd_sm90<kLse><<<grid, kThreads, Smem::bytes, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B,Sq,Hq,64], k/v [B,Skv,Hkv,64], o like q, all bf16, contiguous and
// 16-byte aligned; lse null or [B,Hq,Sq] fp32; scale > 0 and skv > 0
extern "C" int flash_attention_sm90_launch(const void* q, const void* k,
                                           const void* v, void* o, float* lse,
                                           int b, int sq, int skv, int hq,
                                           int hkv, int causal, int window,
                                           float scale, void* stream) {
  if (b <= 0 || sq <= 0 || hq <= 0) return 0;
  if (skv <= 0 || hkv <= 0 || hq % hkv != 0 || !(scale > 0.f) ||
      ((size_t)q | (size_t)k | (size_t)v) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, b, sq, hq, kBQ) ||
      !tensor_map(&tk, k, b, skv, hkv, kBK) ||
      !tensor_map(&tv, v, b, skv, hkv, kBK))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = lse;
  p.b = b;
  p.sq = sq;
  p.skv = skv;
  p.hq = hq;
  p.hkv = hkv;
  p.causal = causal;
  p.window = window;
  p.nq = (sq + kBQ - 1) / kBQ;
  p.tiles = p.nq * b * hq;
  p.scale2 = scale * kLog2e;
  cudaStream_t s = (cudaStream_t)stream;
  return lse != nullptr ? launch<true>(tq, tk, tv, p, s)
                        : launch<false>(tq, tk, tv, p, s);
}
