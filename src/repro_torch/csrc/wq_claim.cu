// Work-queue claim on Hopper: getREADYtasks plus the RUNNING flip for every
// worker in one data-parallel pass over the store's status/worker columns.
//
// Replaces the TPU kernel src/repro/kernels/wq_claim/kernel.py
// (_claim_kernel / wq_claim_fwd). Row i is claimed iff status[i] == READY
// and its exclusive rank among the READY rows of its worker (row order) is
// below k; claimed rows flip to RUNNING. A row whose worker id lies outside
// [0, W) gets rank 0, as in the TPU kernel and its oracle (an all-zero
// one-hot there), so it is claimed whenever it is READY and k >= 1.
//
// Why the TPU design does not carry over: it walks the rows in a sequential
// grid, carrying per-worker counts in VMEM and ranking each 1024-row block
// with a [1024, W] one-hot cumsum. GPU blocks run in no order, and at
// W = 936 the one-hot is ~1M lanes of work per block. Here instead:
//   (a) claim_count   one block per 1024-row tile counts READY rows per
//                     worker into a shared-memory histogram (one atomic per
//                     distinct worker per warp, via __match_any_sync) and
//                     writes row b of a [tiles, W] count table;
//   (b) claim_prefix  one thread per worker turns its column of the table
//                     into an exclusive prefix over tiles;
//   (c) claim_rank    one warp per tile walks its 1024 rows in row order,
//                     32 at a time: rank = tile prefix + READY rows of the
//                     same worker earlier in the tile (a running count in
//                     shared memory) + popc of the lower lanes' matches.
// W above kSmemMaxW keeps the histogram / running counts in the tile's own
// row of the global table instead of shared memory.
//
// Bound on an H100 (3.35 TB/s): 16 bytes per row (two int32 columns in, two
// out) -> 4 MB, about 1.3 us at N = 2^18. The table adds tiles * W * 4 bytes
// each way (1 MB at N = 2^18, W = 936), and three launches cost more than
// the bytes: the kernel is launch- and latency-bound.
#include "common.cuh"

namespace {

constexpr int kReady = 2;
constexpr int kRunning = 3;
constexpr int kTile = 1024;          // rows per tile (count and rank passes)
constexpr int kCountThreads = 256;
constexpr int kSteps = kTile / 32;   // warp steps per tile in the rank pass
constexpr int kSmemMaxW = 12288;     // 48 KB of int32 counts

__global__ void claim_count(const int* __restrict__ status,
                            const int* __restrict__ worker,
                            int* __restrict__ table, int n, int W,
                            int use_smem) {
  extern __shared__ int hist_smem[];
  int* row = table + (size_t)blockIdx.x * W;
  int* hist = use_smem ? hist_smem : row;
  for (int w = threadIdx.x; w < W; w += blockDim.x) hist[w] = 0;
  __syncthreads();
  const int base = blockIdx.x * kTile;
  for (int r = threadIdx.x; r < kTile; r += blockDim.x) {
    const int i = base + r;
    int w = -1;
    bool ok = false;
    if (i < n) {
      w = worker[i];
      ok = status[i] == kReady && w >= 0 && w < W;
    }
    const unsigned active = __ballot_sync(0xffffffffu, ok);
    if (ok) {
      const unsigned peers = __match_any_sync(active, w);
      if ((int)(threadIdx.x & 31) == __ffs(peers) - 1)
        atomicAdd(&hist[w], __popc(peers));
    }
  }
  __syncthreads();
  if (use_smem)
    for (int w = threadIdx.x; w < W; w += blockDim.x) row[w] = hist[w];
}

__global__ void claim_prefix(int* __restrict__ table, int tiles, int W) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  int run = 0;
  for (int t0 = 0; t0 < tiles; t0 += 8) {
    int c[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      c[j] = (t0 + j < tiles) ? table[(size_t)(t0 + j) * W + w] : 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (t0 + j < tiles) {
        table[(size_t)(t0 + j) * W + w] = run;
        run += c[j];
      }
    }
  }
}

__global__ void claim_rank(const int* __restrict__ status,
                           const int* __restrict__ worker,
                           int* __restrict__ new_status,
                           int* __restrict__ claimed,
                           int* __restrict__ table, int n, int W, int k,
                           int use_smem) {
  extern __shared__ int run_smem[];
  int* row = table + (size_t)blockIdx.x * W;
  int* run = use_smem ? run_smem : row;
  const int lane = threadIdx.x;   // one warp per tile
  if (use_smem)
    for (int w = lane; w < W; w += 32) run[w] = row[w];
  const int base = blockIdx.x * kTile;
  // stage the tile's columns in registers first so that the loads overlap
  int st[kSteps], wk[kSteps];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int i = base + s * 32 + lane;
    st[s] = i < n ? status[i] : 0;
    wk[s] = i < n ? worker[i] : -1;
  }
  __syncwarp();
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int i = base + s * 32 + lane;
    const int w = wk[s];
    const bool ready = i < n && st[s] == kReady;
    const bool counted = ready && w >= 0 && w < W;
    const unsigned active = __ballot_sync(0xffffffffu, counted);
    int rank = 0;
    unsigned peers = 0;
    if (counted) {
      peers = __match_any_sync(active, w);
      rank = run[w] + __popc(peers & lower);
    }
    __syncwarp();
    if (counted && lane == __ffs(peers) - 1) run[w] += __popc(peers);
    __syncwarp();
    if (i < n) {
      const bool claim = ready && rank < k;
      new_status[i] = claim ? kRunning : st[s];
      claimed[i] = claim ? 1 : 0;
    }
  }
}

}  // namespace

extern "C" long long wq_claim_scratch_ints(int n, int W) {
  const long long tiles = (n + kTile - 1) / kTile;
  return tiles * (long long)W;
}

extern "C" int wq_claim_launch(const int* status, const int* worker,
                               int* new_status, int* claimed, int* table,
                               int n, int W, int k, void* stream) {
  if (n <= 0) return 0;
  if (W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = (n + kTile - 1) / kTile;
  const int use_smem = W <= kSmemMaxW;
  const size_t smem = use_smem ? (size_t)W * sizeof(int) : 0;
  claim_count<<<tiles, kCountThreads, smem, s>>>(status, worker, table, n, W,
                                                 use_smem);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  claim_prefix<<<(W + 127) / 128, 128, 0, s>>>(table, tiles, W);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  claim_rank<<<tiles, 32, smem, s>>>(status, worker, new_status, claimed,
                                     table, n, W, k, use_smem);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
