// RG-LRU linear recurrence (the RecurrentGemma / Griffin mixer) on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan/kernel.py
// (_rglru_kernel / rglru_scan_fwd). Same function: per batch row and
// channel, h_t = a_t * h_{t-1} + u_t with h_0 = 0, over a and u [B, S, C]
// (fp32 or bf16, computed in fp32), h written in a's dtype.
//
// The TPU kernel gives each (batch, 512-channel block) a sequential walk
// over 128-step time blocks, carrying h in VMEM from one block to the next;
// its lanes are channels. Here a block likewise owns 32 channels of one
// batch row (one a lane) and walks S in tiles of kTile = 128 steps,
// carrying h in a register from one tile to the next, with the recurrence's
// associativity inside a tile: (A1, H1) then (A2, H2) is (A1 A2, A2 H1 +
// H2), and a chunk's aggregate (A, H) takes a carry h to A h + H.
//
// Bound on an H100 (3.35 TB/s) at the serve path's prefill (recurrentgemma-
// 9b, B 1, S 1000, C 4096, fp32): a and u read once, h written once, 49.2 MB,
// 0.0147 ms; one FMA and one multiply per element are negligible: bytes
// bind. So the kernel reads a and u once and keeps enough of them in
// flight to cover DRAM's latency:
//   - 128 blocks at the serve shape (C / 32 per batch row), one an SM, of 8
//     warps;
//   - the tiles stream through a ring of kStages slots in shared memory
//     (kRingBytes, 96 KB: 3 tiles in fp32, 6 in bf16): while one tile is
//     scanned, the next ones are in flight, 64 KB an SM, what 1/132 of the
//     card's bandwidth needs at ~2.5 us of latency. Each warp copies its own
//     16 rows of each tile of a and u with 16-byte cp.async copies and reads
//     only those, so it needs no block barrier to know they have landed;
//   - per tile, each warp loads its 16 steps of a and u into registers and
//     runs them from h = 0 (its aggregate), the 8 aggregates meet in shared
//     memory (one block barrier a tile), each warp folds those before its
//     own onto the carry into the tile, in order, and runs its 16 steps
//     again from registers, storing h: 32 neighbouring values a warp a
//     step. Every warp also folds all 8, which gives the carry into the
//     next tile, bit for bit the same in every warp.
// A tile's chain is 16 + 8 + 16 dependent steps, not 128, and all four
// schedulers of the SM have warps to issue.
//
// Why S is not also cut across blocks (a cluster of 8 blocks along S,
// carries through distributed shared memory, tried for this design): a cut
// along S needs each tile twice, for its aggregate and to write h once the
// carry from the tiles before it is known, so to read a and u from DRAM
// once the whole input has to stay on chip between the two passes. At the
// serve shape it (32.8 MB) exceeds the card's shared memory (132 x 227 KB):
// the blocks ran in two waves, each loading, waiting on its cluster, then
// storing, with DRAM idle in between, and in bf16 it was slower than the
// two-walk kernel it replaced. Here the loads of the next tiles overlap the
// scan and the stores of this one. bf16 keeps one channel a lane (64 B
// rows): two a lane (128 B rows) halves the blocks to 64 at C 4096 and was
// slower. Every fold runs in a fixed order, so repeated calls give the same
// bits.
//
// Any B, S and C, with no padding: rows past S are not copied and count as
// a = 1, u = 0 (the identity), channels past C are not copied, and lanes
// past C store nothing. When a row of C values is not a whole number of
// 16-byte copies (or a pointer is not 16-byte aligned), each lane loads its
// own channel one value at a time instead.
//
// The backward (rglru_bwd): the reference has no kernel for it (XLA
// differentiates its associative scan); the port trains through this
// kernel, so the gradient comes from one too. For the output gradient g
// it runs the reverse recurrence e_t = g_t + a_{t+1} e_{t+1} (e_S = 0),
// then du_t = e_t and da_t = e_t h_{t-1} (h_{-1} = 0), from the forward's
// output h. Bound at the hybrid's train shape (a, h, g [1, 4096, 4096]
// fp32 per microbatch): g, a and h read once, da and du written once, 336
// MB, 0.100 ms at 3.35 TB/s; bytes bind. It is the forward's design walked
// in reverse: a block owns 32 channels of a batch row and walks S from the
// end in tiles of 128 steps through a cp.async ring (kRingBwdBytes, 144
// KB: 3 tiles of (g, a, h) in fp32, 6 in bf16); the carry e stays in a
// register, and inside a tile each warp's 16 steps are folded from the
// end into an aggregate (A, E) that takes e_in to A e_in + E, the 8
// aggregates meet in shared memory and each warp folds those after its own
// onto the carry, in order. Its tile of a is copied one row later and its
// tile of h one row earlier than its tile of g (a_{t+1} and h_{t-1} beside
// g_t), so each warp still reads only the rows it copied, and each row of
// a and h is still read once.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 16;                 // steps of a warp in a tile
constexpr int kTile = kWarps * kRows;     // steps of a tile
constexpr int kRingBytes = 96 * 1024;     // the ring of tiles

template <typename T>
struct Ring {
  static constexpr int kRow = 32 * (int)sizeof(T);      // bytes of a row
  static constexpr int kSlot = 2 * kTile * kRow;        // a and u of a tile
  static constexpr int kStages = kRingBytes / kSlot;    // tiles in the ring
};

template <typename T>
__global__ void __launch_bounds__(32 * kWarps, 1)
rglru_fwd(const T* __restrict__ a, const T* __restrict__ u,
          T* __restrict__ h, int s, int c, int vec) {
  constexpr int kRow = Ring<T>::kRow;
  constexpr int kStages = Ring<T>::kStages;
  constexpr int kCopies = kRow / 16;          // 16-byte copies of a row
  constexpr int kPer = 16 / (int)sizeof(T);   // values of a copy
  extern __shared__ __align__(16) unsigned char ring[];  // [slot][a,u][row]
  __shared__ float2 agg[2][kWarps][32];       // warp aggregates (A, H)

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * 32;
  const int ch = c0 + lane;
  const bool live = ch < c;
  const size_t base = (size_t)blockIdx.y * s * c;
  const int ntiles = (s + kTile - 1) / kTile;

  // this warp's rows of tile i into ring slot `slot`, as one commit group
  auto load = [&](int i, int slot) {
    const int t0 = i * kTile + warp * kRows;
    const int rows = i < ntiles ? max(0, min(kRows, s - t0)) : 0;
    unsigned char* ta = ring + (size_t)slot * Ring<T>::kSlot +
                        warp * kRows * kRow;
    unsigned char* tu = ta + kTile * kRow;
    if (vec) {
      const int q = lane % kCopies;
      if (c0 + (q + 1) * kPer <= c)
        for (int r = lane / kCopies; r < rows; r += 32 / kCopies) {
          const size_t off = base + (size_t)(t0 + r) * c + c0 + q * kPer;
          repro::cp_async16(ta + r * kRow + q * 16, a + off);
          repro::cp_async16(tu + r * kRow + q * 16, u + off);
        }
    } else if (live) {
      T* da = reinterpret_cast<T*>(ta);
      T* du = reinterpret_cast<T*>(tu);
      for (int r = 0; r < rows; ++r) {
        const size_t off = base + (size_t)(t0 + r) * c + ch;
        da[r * 32 + lane] = a[off];
        du[r * 32 + lane] = u[off];
      }
    }
    repro::cp_async_commit();
  };

  for (int i = 0; i < kStages; ++i) load(i, i);
  float carry = 0.f;                          // h before the tile
  for (int i = 0; i < ntiles; ++i) {
    const int slot = i % kStages;
    const int p = i & 1;
    repro::cp_async_wait<kStages - 1>();      // this warp's rows of tile i
    __syncwarp();
    const int t0 = i * kTile + warp * kRows;
    const int rows = max(0, min(kRows, s - t0));
    const T* ta = reinterpret_cast<const T*>(
        ring + (size_t)slot * Ring<T>::kSlot + warp * kRows * kRow);
    const T* tu = ta + kTile * 32;
    float av[kRows], uv[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {         // past S: the identity
      av[r] = r < rows ? repro::to_float(ta[r * 32 + lane]) : 1.f;
      uv[r] = r < rows ? repro::to_float(tu[r * 32 + lane]) : 0.f;
    }
    __syncwarp();                             // the slot may be refilled
    load(i + kStages, slot);

    float A = 1.f, H = 0.f;                   // this warp's aggregate
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      H = fmaf(av[r], H, uv[r]);
      A *= av[r];
    }
    agg[p][warp][lane] = make_float2(A, H);
    __syncthreads();
    float cin = carry;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float2 x = agg[p][w][lane];
      if (w == warp) cin = carry;
      carry = fmaf(x.x, carry, x.y);
    }
    T* hp = h + base + (size_t)t0 * c + ch;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      cin = fmaf(av[r], cin, uv[r]);
      if (live && r < rows) hp[(size_t)r * c] = repro::from_float<T>(cin);
    }
  }
  repro::cp_async_wait<0>();
}

template <typename T>
int launch(const void* a, const void* u, void* h, int b, int s, int c,
           cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      rglru_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
  if (e != cudaSuccess) return (int)e;
  const int vec = ((size_t)c * sizeof(T)) % 16 == 0 &&
                  ((size_t)a | (size_t)u) % 16 == 0;
  dim3 grid((c + 31) / 32, b);
  rglru_fwd<T><<<grid, 32 * kWarps, kRingBytes, stream>>>(
      (const T*)a, (const T*)u, (T*)h, s, c, vec);
  return (int)cudaGetLastError();
}

constexpr int kRingBwdBytes = 144 * 1024;   // the backward's ring

template <typename T>
struct RingBwd {
  static constexpr int kRow = 32 * (int)sizeof(T);
  static constexpr int kSlot = 3 * kTile * kRow;       // g, a, h of a tile
  static constexpr int kStages = kRingBwdBytes / kSlot;
};

template <typename T>
__global__ void __launch_bounds__(32 * kWarps, 1)
rglru_bwd(const T* __restrict__ a, const T* __restrict__ h,
          const T* __restrict__ g, T* __restrict__ da, T* __restrict__ du,
          int s, int c, int vec) {
  constexpr int kRow = RingBwd<T>::kRow;
  constexpr int kStages = RingBwd<T>::kStages;
  constexpr int kCopies = kRow / 16;
  constexpr int kPer = 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char ring[];  // [slot][g,a,h][row]
  __shared__ float2 agg[2][kWarps][32];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * 32;
  const int ch = c0 + lane;
  const bool live = ch < c;
  const size_t base = (size_t)blockIdx.y * s * c;
  const int ntiles = (s + kTile - 1) / kTile;

  // slot rows [0, kRows) of this warp's part of one array from global rows
  // first + r, those inside [0, s) only
  auto stage = [&](unsigned char* dst, const T* src, int first) {
    const int lo = max(0, -first), hi = min(kRows, s - first);
    if (vec) {
      const int q = lane % kCopies;
      if (c0 + (q + 1) * kPer <= c)
        for (int r = lo + lane / kCopies; r < hi; r += 32 / kCopies)
          repro::cp_async16(dst + r * kRow + q * 16,
                            src + base + (size_t)(first + r) * c + c0 +
                                q * kPer);
    } else if (live) {
      T* d = reinterpret_cast<T*>(dst);
      for (int r = lo; r < hi; ++r)
        d[r * 32 + lane] = src[base + (size_t)(first + r) * c + ch];
    }
  };
  // this warp's rows of the k-th tile from the end into ring slot `slot`
  auto load = [&](int k, int slot) {
    if (k < ntiles) {
      const int t0 = (ntiles - 1 - k) * kTile + warp * kRows;
      unsigned char* tg = ring + (size_t)slot * RingBwd<T>::kSlot +
                          warp * kRows * kRow;
      stage(tg, g, t0);
      stage(tg + kTile * kRow, a, t0 + 1);       // a_{t+1} beside g_t
      stage(tg + 2 * kTile * kRow, h, t0 - 1);   // h_{t-1} beside g_t
    }
    repro::cp_async_commit();
  };

  for (int k = 0; k < kStages; ++k) load(k, k);
  float carry = 0.f;                          // e after the tile
  for (int k = 0; k < ntiles; ++k) {
    const int slot = k % kStages;
    const int p = k & 1;
    repro::cp_async_wait<kStages - 1>();
    __syncwarp();
    const int t0 = (ntiles - 1 - k) * kTile + warp * kRows;
    const T* tg = reinterpret_cast<const T*>(
        ring + (size_t)slot * RingBwd<T>::kSlot + warp * kRows * kRow);
    const T* ta = tg + kTile * 32;
    const T* th = tg + 2 * kTile * 32;
    float gv[kRows], bv[kRows], hv[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {         // past S: the identity
      const int t = t0 + r;
      gv[r] = t < s ? repro::to_float(tg[r * 32 + lane]) : 0.f;
      bv[r] = t + 1 < s ? repro::to_float(ta[r * 32 + lane])
                        : (t < s ? 0.f : 1.f);
      hv[r] = t > 0 && t < s ? repro::to_float(th[r * 32 + lane]) : 0.f;
    }
    __syncwarp();
    load(k + kStages, slot);

    float A = 1.f, E = 0.f;                   // this warp's aggregate
#pragma unroll
    for (int r = kRows - 1; r >= 0; --r) {
      E = fmaf(bv[r], E, gv[r]);
      A *= bv[r];
    }
    agg[p][warp][lane] = make_float2(A, E);
    __syncthreads();
    float cin = carry;
#pragma unroll
    for (int w = kWarps - 1; w >= 0; --w) {
      const float2 x = agg[p][w][lane];
      if (w == warp) cin = carry;
      carry = fmaf(x.x, carry, x.y);
    }
    T* dap = da + base + (size_t)t0 * c + ch;
    T* dup = du + base + (size_t)t0 * c + ch;
#pragma unroll
    for (int r = kRows - 1; r >= 0; --r) {
      cin = fmaf(bv[r], cin, gv[r]);
      if (live && t0 + r < s) {
        dup[(size_t)r * c] = repro::from_float<T>(cin);
        dap[(size_t)r * c] = repro::from_float<T>(cin * hv[r]);
      }
    }
  }
  repro::cp_async_wait<0>();
}

template <typename T>
int launch_bwd(const void* a, const void* h, const void* g, void* da,
               void* du, int b, int s, int c, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      rglru_bwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kRingBwdBytes);
  if (e != cudaSuccess) return (int)e;
  const int vec = ((size_t)c * sizeof(T)) % 16 == 0 &&
                  ((size_t)a | (size_t)h | (size_t)g) % 16 == 0;
  dim3 grid((c + 31) / 32, b);
  rglru_bwd<T><<<grid, 32 * kWarps, kRingBwdBytes, stream>>>(
      (const T*)a, (const T*)h, (const T*)g, (T*)da, (T*)du, s, c, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// da, du [B,S,C] (a's dtype) of the scan whose output was h, for the output
// gradient g; all [B,S,C] of one dtype
extern "C" int rglru_scan_bwd_launch(const void* a, const void* h,
                                     const void* g, void* da, void* du,
                                     int b, int s, int c, int dtype,
                                     void* stream) {
  if (b <= 0 || s <= 0 || c <= 0) return 0;
  if (b > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t strm = (cudaStream_t)stream;
  if (dtype == repro::kFloat32)
    return launch_bwd<float>(a, h, g, da, du, b, s, c, strm);
  if (dtype == repro::kBFloat16)
    return launch_bwd<__nv_bfloat16>(a, h, g, da, du, b, s, c, strm);
  return (int)cudaErrorInvalidValue;
}

extern "C" int rglru_scan_launch(const void* a, const void* u, void* h,
                                 int b, int s, int c, int dtype,
                                 void* stream) {
  if (b <= 0 || s <= 0 || c <= 0) return 0;
  if (b > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t strm = (cudaStream_t)stream;
  if (dtype == repro::kFloat32) return launch<float>(a, u, h, b, s, c, strm);
  if (dtype == repro::kBFloat16)
    return launch<__nv_bfloat16>(a, u, h, b, s, c, strm);
  return (int)cudaErrorInvalidValue;
}
