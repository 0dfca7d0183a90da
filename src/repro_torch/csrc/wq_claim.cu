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
// W = 936 the one-hot is ~1M lanes of work per block.
//
// Bound on an H100 (3.35 TB/s): 16 bytes per row (two int32 columns in, two
// out) -> 1.6 MB, 0.48 us at N = 100,000. A launch alone costs a few us, so
// the kernel is bound by launches and by the chain of dependent steps, not
// by bytes. Hence one cooperative launch of a persistent grid (no more
// blocks than can be resident, so that every block reaches the grid
// barriers), each block owning tiles of 1024 rows (8 warps x 4 steps x 32
// lanes), in three phases:
//   (1) count   each warp loads its 128 rows into registers and walks them in
//               4 steps of 32: per step __match_any_sync groups the READY
//               rows of one worker, a row's rank within the warp is the
//               warp's running count of its worker (a row of W counts per
//               warp) plus the lower lanes' matches. Then the block turns the
//               8 rows of counts into an exclusive prefix over warps and
//               writes the tile's totals into row t of a [tiles, W] table;
//   (2) prefix  after a grid barrier, every column of the table becomes an
//               exclusive prefix over tiles: a block per 32 workers, each
//               warp a slice of the tiles, all its loads at once, the 8
//               slice sums combined in shared memory;
//   (3) rank    after a second grid barrier, rank = the tile's prefix + the
//               warp's prefix + the rank within the warp, with rows, ranks
//               and counts still held from phase 1; write status and flag.
// A block that owns more than one tile (more tiles than resident blocks)
// counts its other tiles again in phase 3. With W above kSmemMaxW the rows
// of counts live in a slice of global scratch per block instead of shared
// memory. Each grid barrier is one arrival count in a buffer that the
// wrapper allocates zeroed once per (device, stream) (calls on one stream run
// one after another; calls on different streams never share a buffer):
// every block adds its arrival and polls until the count reaches the grid's
// size, one hop instead of a last arrival's broadcast. Block 0 zeroes the
// second barrier's count before it arrives at the first, and the first's
// after it has passed the second, so every call finds both ready and no
// memset or second launch is needed. Data that other blocks wrote in this
// launch is read with ld.global.cg (L2), never from a stale L1 line.
#include "common.cuh"

#include <atomic>

namespace {

constexpr int kReady = 2;
constexpr int kRunning = 3;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSteps = 4;                    // warp steps of 32 rows
constexpr int kTile = kWarps * kSteps * 32;  // rows of a tile
constexpr int kSmemMaxW = 4096;              // 8 rows of counts: 128 KB
constexpr int kHeld = 32;                    // table rows a warp holds

// a thread's rows of one tile, held across the grid barriers
struct Rows {
  int st[kSteps], wk[kSteps], wr[kSteps];
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// every block of the grid arrives at `count` (0 before the first arrival)
// before any block goes on; one hop: each block's thread 0 adds its
// arrival with release semantics and polls the count with acquire loads
__device__ __forceinline__ void grid_barrier(unsigned* count) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n"
                 :: "l"(count) : "memory");
    while (ld_acquire(count) < gridDim.x) {
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;\n"
               :: "l"(p), "r"(v) : "memory");
}

// phase 1 for tile t: rows into x, ranks within each warp into x.wr, and
// cnt[warp][w] = READY rows of worker w in the tile's earlier warps; with
// `table`, the tile's totals into its row
__device__ __forceinline__ void count_tile(const int* __restrict__ status,
                                           const int* __restrict__ worker,
                                           int* cnt, int* table, int n, int W,
                                           int t, Rows& x) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* mine = cnt + (size_t)warp * W;
  __syncwarp();   // the rank pass's reads of this row by other lanes are done
  for (int w = lane; w < W; w += 32) mine[w] = 0;
  const int base = t * kTile + warp * (kSteps * 32) + lane;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int i = base + s * 32;
    x.st[s] = i < n ? status[i] : 0;
    x.wk[s] = i < n ? worker[i] : -1;
  }
  __syncwarp();
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int w = x.wk[s];
    const bool counted = x.st[s] == kReady && w >= 0 && w < W;
    const unsigned active = __ballot_sync(0xffffffffu, counted);
    unsigned peers = 0;
    int wr = 0;
    if (counted) {
      peers = __match_any_sync(active, w);
      wr = mine[w] + __popc(peers & lower);
    }
    __syncwarp();
    if (counted && lane == __ffs(peers) - 1) mine[w] += __popc(peers);
    __syncwarp();
    x.wr[s] = wr;
  }
  __syncthreads();
  for (int w = threadIdx.x; w < W; w += kThreads) {
    int c[kWarps];
#pragma unroll
    for (int j = 0; j < kWarps; ++j) c[j] = cnt[(size_t)j * W + w];
    int run = 0;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) {
      cnt[(size_t)j * W + w] = run;
      run += c[j];
    }
    if (table) table[(size_t)t * W + w] = run;
  }
  __syncthreads();
}

// phase 2: each column of the [tiles, W] table becomes its exclusive prefix
// over tiles: a block per 32 workers, each warp a slice of the tiles, up to
// kHeld of them loaded at once and held in registers (longer slices go in
// runs of kHeld, loaded twice), the 8 slice sums combined in shared memory
__device__ __forceinline__ void prefix_tiles(int* table, int tiles, int W,
                                             int* wsum) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per = (tiles + kWarps - 1) / kWarps;
  const int r0 = min(tiles, warp * per);
  const int r1 = min(tiles, r0 + per);
  for (int slab = blockIdx.x; slab * 32 < W; slab += gridDim.x) {
    const int col = slab * 32 + lane;
    int* p = table + col;
    int v[kHeld];
    int sum = 0;
    for (int r = r0; r < r1; r += kHeld) {
#pragma unroll
      for (int j = 0; j < kHeld; ++j)
        v[j] = col < W && r + j < r1 ? __ldcg(p + (size_t)(r + j) * W) : 0;
#pragma unroll
      for (int j = 0; j < kHeld; ++j) sum += v[j];
    }
    wsum[warp * 32 + lane] = sum;
    __syncthreads();
    int run = 0;
    for (int j = 0; j < warp; ++j) run += wsum[j * 32 + lane];
    for (int r = r0; r < r1; r += kHeld) {
      if (r1 - r0 > kHeld) {   // not held: load this run again
#pragma unroll
        for (int j = 0; j < kHeld; ++j)
          v[j] = col < W && r + j < r1 ? __ldcg(p + (size_t)(r + j) * W) : 0;
      }
#pragma unroll
      for (int j = 0; j < kHeld; ++j) {
        if (col < W && r + j < r1) p[(size_t)(r + j) * W] = run;
        run += v[j];
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, 1)
claim_fused(const int* __restrict__ status, const int* __restrict__ worker,
            int* __restrict__ new_status, int* __restrict__ claimed,
            int* table, int* scratch, unsigned* bar, int n, int W, int k,
            int tiles, int use_smem) {
  extern __shared__ int cnt_smem[];
  __shared__ int wsum[kWarps * 32];
  int* cnt = use_smem ? cnt_smem : scratch + (size_t)blockIdx.x * kWarps * W;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  // bar[0] counts arrivals at the first barrier and is 0 at the start (the
  // last launch reset it); bar[1] counts the second's and is reset here,
  // before this block's first arrival, which every block sees before it
  // passes the first barrier and so before it arrives at the second
  if (lead) st_relaxed(bar + 1, 0);
  Rows x;
  int last = -1;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    count_tile(status, worker, cnt, table, n, W, t, x);
    last = t;
  }
  grid_barrier(bar);
  prefix_tiles(table, tiles, W, wsum);
  grid_barrier(bar + 1);
  // every block has passed the first barrier: it is free for the next launch
  if (lead) st_relaxed(bar, 0);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // the last tile first: its rows and counts are still held
  for (int t = last; t >= 0; t -= gridDim.x) {
    if (t != last) count_tile(status, worker, cnt, nullptr, n, W, t, x);
    const int base = t * kTile + warp * (kSteps * 32) + lane;
    const int* pre = cnt + (size_t)warp * W;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int i = base + s * 32;
      const int w = x.wk[s];
      const bool ready = x.st[s] == kReady;
      int rank = 0;
      if (ready && w >= 0 && w < W)
        rank = __ldcg(table + (size_t)t * W + w) + pre[w] + x.wr[s];
      const bool claim = ready && rank < k;
      if (i < n) {
        new_status[i] = claim ? kRunning : x.st[s];
        claimed[i] = claim ? 1 : 0;
      }
    }
  }
}

__global__ void claim_empty() {}

// blocks of the cooperative grid: the tiles, but no more than can be
// resident at once; the occupancy of the last (device, shared memory) pair
// is kept
int grid_blocks(int tiles, size_t smem, int* blocks) {
  static std::atomic<unsigned long long> cache{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned key = ((unsigned)dev << 24) | (unsigned)smem;
  const unsigned long long got = cache.load(std::memory_order_relaxed);
  int resident = (int)(got & 0xffffffffu);
  if ((unsigned)(got >> 32) != key || resident == 0) {
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(claim_fused,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, claim_fused,
                                                      kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    resident = sms * per_sm;
    if (resident <= 0) return (int)cudaErrorInvalidConfiguration;
    cache.store(((unsigned long long)key << 32) | (unsigned)resident,
                std::memory_order_relaxed);
  }
  *blocks = tiles < resident ? tiles : resident;
  return 0;
}

struct Config {
  int tiles, use_smem, blocks;
  size_t smem;
};

int config(int n, int W, Config* c) {
  c->tiles = (n + kTile - 1) / kTile;
  c->use_smem = W <= kSmemMaxW;
  c->smem = c->use_smem ? (size_t)kWarps * W * sizeof(int) : 0;
  return grid_blocks(c->tiles, c->smem, &c->blocks);
}

// ints of scratch after the 2 barrier words: the [tiles, W] table, and the
// per-block rows of counts when W is above kSmemMaxW
long long table_ints(const Config& c, int W) {
  long long ints = (long long)c.tiles * W;
  if (!c.use_smem) ints += (long long)c.blocks * kWarps * W;
  return ints;
}

}  // namespace

// ints of scratch a call needs after its 2 barrier words (table_ints); a
// negative CUDA error code when the grid cannot be sized
extern "C" long long wq_claim_scratch_ints(int n, int W) {
  if (n <= 0 || W <= 0) return 0;
  Config c;
  const int e = config(n, W, &c);
  if (e) return -(long long)e;
  return table_ints(c, W);
}

// scratch: `capacity` ints, 2 barrier words (zeroed before the first call;
// a call leaves the first zeroed and zeroes the second before it uses it),
// then wq_claim_scratch_ints(n, W) ints
extern "C" int wq_claim_launch(const int* status, const int* worker,
                               int* new_status, int* claimed, int* scratch,
                               long long capacity, int n, int W, int k,
                               void* stream) {
  if (n <= 0) return 0;
  if (W <= 0) return (int)cudaErrorInvalidValue;
  Config c;
  const int e = config(n, W, &c);
  if (e) return e;
  if (capacity < 2 + table_ints(c, W)) return (int)cudaErrorInvalidValue;
  unsigned* bar = reinterpret_cast<unsigned*>(scratch);
  int* table = scratch + 2;
  int* rows = table + (size_t)c.tiles * W;
  void* args[] = {&status, &worker, &new_status, &claimed, &table, &rows,
                  &bar, &n, &W, &k, &c.tiles, &c.use_smem};
  return (int)cudaLaunchCooperativeKernel((void*)claim_fused, c.blocks,
                                          kThreads, args, c.smem,
                                          (cudaStream_t)stream);
}

// an empty kernel launched as the claim kernel would be (the same grid,
// block and shared memory, cooperatively): the floor of one launch
extern "C" int wq_claim_empty_launch(int n, int W, void* stream) {
  if (n <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  Config c;
  const int e = config(n, W, &c);
  if (e) return e;
  if (c.smem > 48 * 1024) {
    const cudaError_t a = cudaFuncSetAttribute(
        claim_empty, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)c.smem);
    if (a != cudaSuccess) return (int)a;
  }
  return (int)cudaLaunchCooperativeKernel((void*)claim_empty, c.blocks,
                                          kThreads, nullptr, c.smem,
                                          (cudaStream_t)stream);
}

extern "C" const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
