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

}  // namespace

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
