// Cross-entropy of the sequence-chunked LM-head loss on Hopper: one read of
// the logits forward, one read and one write backward.
//
// Replaces no TPU kernel. The reference computes each chunk of its loss
// (chunked_xent, src/repro/models/transformer.py:259) with XLA's logsumexp
// and take_along_axis over the chunk's logits cast to fp32, and XLA
// differentiates them; the port ran the same chain as PyTorch's own
// kernels (a cast to fp32, then max, subtract, exp, sum and log, a gather,
// and backward an exp, a multiply, a zero fill, a scatter, an add and a
// cast back), about 106 bytes of device memory moved per logit and chunk
// over its forward, the checkpoint's recompute and the backward. This
// file computes the same function on rows of logits [R, V] (bf16 or fp32,
// computed in fp32 registers, as the cast gave) and labels [R] (int32 or
// int64):
//   forward   lse[r] = log sum_j exp(l[r, j]),  gold[r] = l[r, label[r]]
//   backward  dl[r, j] = g[r] (exp(l[r, j] - lse[r]) - [j == label[r]]),
//             written in the logits' dtype (the value the fp32 chain cast
//             back), g read from device memory with a row stride (0: one
//             scalar for every row), so the host never waits for it.
//
// Bound on an H100 (3.35 TB/s): bytes. At qwen2-0.5b's chunk of 16 x 256
// rows of 151,936 bf16 logits (1.24 GB) the forward reads them once (0.37
// ms) and the backward reads and writes them once (0.74 ms); a few
// operations per logit (a conversion, a max, an FMA, an add and one 2^x on
// the special-function unit, about 45% of the read's time there) hide
// under the bytes. So each kernel makes exactly one pass over the row:
//   - one block of kThreads threads a row (4,096 blocks at that chunk),
//     each thread streaming 16-byte loads, kUnroll in flight, with the
//     cache-streaming hint (the row is not read again in this kernel);
//   - forward: an online max and sum in fp32 in base 2: a thread keeps m,
//     the largest logit seen times log2 e, and s = sum 2^(l log2 e - m),
//     one FMA and one ex2 per logit, rescaling s once per kUnroll loads
//     when their largest logit raises m. Threads' (m, s) merge by warp
//     shuffles, then through shared memory in the first warp, in a fixed
//     order, so repeated calls give the same bits. Thread 0 reads the
//     gold logit at its column (one load beside the row's pass) and writes
//     lse = ln 2 (m + log2 s) and gold;
//   - backward: each thread reads its 16 bytes, computes the gradient of
//     every value from lse and the label in registers and writes 16 bytes
//     back, with the streaming hint (the GEMM's backward reads them from
//     device memory anyway).
// Any R and V: a row whose start is not 16-byte aligned takes its values
// up to the boundary one at a time (a prologue), the ragged end likewise;
// the backward writes one value at a time where the output and the logits
// lie differently against 16 bytes. Terms below 2^-126 flush to zero
// (ex2.approx.ftz): beside a row sum of at least 1 they do not count, and
// a gradient that small is a zero to the GEMM after it.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // a block a row
constexpr int kUnroll = 4;      // 16-byte loads in flight a thread
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// the 16-byte vector of T: its kPer values in fp32, and back (rounded to
// nearest even, as torch casts)
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kPer = 4;
  __device__ static void unpack(const uint4& w, float* x) {
    x[0] = __uint_as_float(w.x);
    x[1] = __uint_as_float(w.y);
    x[2] = __uint_as_float(w.z);
    x[3] = __uint_as_float(w.w);
  }
  __device__ static uint4 pack(const float* x) {
    return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                      __float_as_uint(x[2]), __float_as_uint(x[3]));
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kPer = 8;
  __device__ static void unpack(const uint4& w, float* x) {
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(u[i] << 16);
      x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
  __device__ static unsigned pair(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const unsigned*>(&h);
  }
  __device__ static uint4 pack(const float* x) {
    return make_uint4(pair(x[0], x[1]), pair(x[2], x[3]), pair(x[4], x[5]),
                      pair(x[6], x[7]));
  }
};

// values of a row before its first 16-byte boundary
template <typename T>
__device__ __forceinline__ int head_of(const T* row, int v) {
  const int bytes = (int)((16 - (size_t)row % 16) % 16);
  return min(v, bytes / (int)sizeof(T));
}

// a thread's running (m, s): m the largest logit seen times log2 e (-inf
// before any), s the sum of 2^(l log2 e - m) over the logits seen
struct Acc {
  float m, s;
};

template <int N>
__device__ __forceinline__ void add(Acc& a, const float* x) {
  float mx = x[0];
#pragma unroll
  for (int i = 1; i < N; ++i) mx = fmaxf(mx, x[i]);
  const float m = fmaxf(a.m, mx * kLog2e);
  if (m > a.m) {            // from -inf: 0 times ex2(-inf) = 0
    a.s *= repro::ex2(a.m - m);
    a.m = m;
  }
  if (a.m == -INFINITY) return;   // every value so far is -inf
#pragma unroll
  for (int i = 0; i < N; ++i) a.s += repro::ex2(fmaf(x[i], kLog2e, -a.m));
}

__device__ __forceinline__ Acc merge(const Acc& a, const Acc& b) {
  const float m = fmaxf(a.m, b.m);
  if (m == -INFINITY) return a;
  return {m, a.s * repro::ex2(a.m - m) + b.s * repro::ex2(b.m - m)};
}

template <typename L>
__device__ __forceinline__ int label_of(const L* labels, int r, int v) {
  const long long l = (long long)labels[r];
  return l >= 0 && l < v ? (int)l : -1;
}

template <typename T, typename L>
__global__ void __launch_bounds__(kThreads)
xent_fwd(const T* __restrict__ logits, const L* __restrict__ labels,
         float* __restrict__ lse, float* __restrict__ gold, int v) {
  constexpr int kPer = Vec<T>::kPer;
  __shared__ Acc part[kThreads / 32];
  const int tid = threadIdx.x;
  const int r = blockIdx.x;
  const T* row = logits + (size_t)r * v;
  const int head = head_of(row, v);
  const int nvec = (v - head) / kPer;
  const uint4* vrow = reinterpret_cast<const uint4*>(row + head);

  Acc acc{-INFINITY, 0.f};
  if (tid < head) {
    const float x = repro::to_float(row[tid]);
    add<1>(acc, &x);
  }
  int i = tid;
  for (; i + (kUnroll - 1) * kThreads < nvec; i += kUnroll * kThreads) {
    uint4 w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) w[u] = __ldcs(vrow + i + u * kThreads);
    float x[kUnroll * kPer];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) Vec<T>::unpack(w[u], x + u * kPer);
    add<kUnroll * kPer>(acc, x);
  }
  for (; i < nvec; i += kThreads) {
    float x[kPer];
    Vec<T>::unpack(__ldcs(vrow + i), x);
    add<kPer>(acc, x);
  }
  for (int j = head + nvec * kPer + tid; j < v; j += kThreads) {
    const float x = repro::to_float(row[j]);
    add<1>(acc, &x);
  }

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const Acc b{__shfl_xor_sync(0xffffffffu, acc.m, o),
                __shfl_xor_sync(0xffffffffu, acc.s, o)};
    acc = merge(acc, b);
  }
  if ((tid & 31) == 0) part[tid >> 5] = acc;
  __syncthreads();
  if (tid >= 32) return;
  acc = tid < kThreads / 32 ? part[tid] : Acc{-INFINITY, 0.f};
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const Acc b{__shfl_xor_sync(0xffffffffu, acc.m, o),
                __shfl_xor_sync(0xffffffffu, acc.s, o)};
    acc = merge(acc, b);
  }
  if (tid == 0) {
    lse[r] = kLn2 * (acc.m + log2f(acc.s));
    const int lab = label_of(labels, r, v);
    gold[r] = lab >= 0 ? repro::to_float(row[lab]) : NAN;
  }
}

template <typename T, typename L>
__global__ void __launch_bounds__(kThreads)
xent_bwd(const T* __restrict__ logits, const L* __restrict__ labels,
         const float* __restrict__ lse, const float* __restrict__ g,
         int g_stride, T* __restrict__ out, int v, int vec) {
  constexpr int kPer = Vec<T>::kPer;
  const int tid = threadIdx.x;
  const int r = blockIdx.x;
  const T* row = logits + (size_t)r * v;
  T* orow = out + (size_t)r * v;
  const float gr = g[(size_t)r * g_stride];
  const float base = lse[r] * kLog2e;
  const int lab = label_of(labels, r, v);
  // the gradient of value x at column j
  auto grad = [&](float x, int j) {
    return gr * (repro::ex2(fmaf(x, kLog2e, -base)) - (j == lab ? 1.f : 0.f));
  };
  const int head = vec ? head_of(row, v) : v;
  const int nvec = (v - head) / kPer;
  const uint4* vrow = reinterpret_cast<const uint4*>(row + head);
  uint4* vout = reinterpret_cast<uint4*>(orow + head);

  for (int j = tid; j < head; j += kThreads)
    orow[j] = repro::from_float<T>(grad(repro::to_float(row[j]), j));
  int i = tid;
  for (; i + (kUnroll - 1) * kThreads < nvec; i += kUnroll * kThreads) {
    uint4 w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) w[u] = __ldcs(vrow + i + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float x[kPer];
      Vec<T>::unpack(w[u], x);
      const int j0 = head + (i + u * kThreads) * kPer;
#pragma unroll
      for (int k = 0; k < kPer; ++k) x[k] = grad(x[k], j0 + k);
      __stcs(vout + i + u * kThreads, Vec<T>::pack(x));
    }
  }
  for (; i < nvec; i += kThreads) {
    float x[kPer];
    Vec<T>::unpack(__ldcs(vrow + i), x);
    const int j0 = head + i * kPer;
#pragma unroll
    for (int k = 0; k < kPer; ++k) x[k] = grad(x[k], j0 + k);
    __stcs(vout + i, Vec<T>::pack(x));
  }
  for (int j = head + nvec * kPer + tid; j < v; j += kThreads)
    orow[j] = repro::from_float<T>(grad(repro::to_float(row[j]), j));
}

template <typename T, typename L>
int launch_fwd(const void* logits, const void* labels, void* lse,
               void* gold, int rows, int v, cudaStream_t stream) {
  xent_fwd<T, L><<<rows, kThreads, 0, stream>>>(
      (const T*)logits, (const L*)labels, (float*)lse, (float*)gold, v);
  return (int)cudaGetLastError();
}

template <typename T, typename L>
int launch_bwd(const void* logits, const void* labels, const void* lse,
               const void* g, int g_stride, void* out, int rows, int v,
               cudaStream_t stream) {
  // 16-byte vectors need the output to lie against 16 bytes as the logits
  // do, row by row
  const int vec = ((size_t)logits - (size_t)out) % 16 == 0;
  xent_bwd<T, L><<<rows, kThreads, 0, stream>>>(
      (const T*)logits, (const L*)labels, (const float*)lse,
      (const float*)g, g_stride, (T*)out, v, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// lse [R] and gold [R] (fp32) of logits [R, V] (dtype) at labels [R]
// (int64 when label64, else int32)
extern "C" int cross_entropy_launch(const void* logits, const void* labels,
                                    void* lse, void* gold, int rows, int v,
                                    int dtype, int label64, void* stream) {
  if (rows <= 0) return 0;
  if (v <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == repro::kFloat32)
    return label64 ? launch_fwd<float, long long>(logits, labels, lse, gold,
                                                  rows, v, s)
                   : launch_fwd<float, int>(logits, labels, lse, gold, rows,
                                            v, s);
  if (dtype == repro::kBFloat16)
    return label64 ? launch_fwd<__nv_bfloat16, long long>(
                         logits, labels, lse, gold, rows, v, s)
                   : launch_fwd<__nv_bfloat16, int>(logits, labels, lse,
                                                    gold, rows, v, s);
  return (int)cudaErrorInvalidValue;
}

// the gradient [R, V] (dtype) of the rows' loss lse - gold for its
// gradient g (fp32, row r at g[r * g_stride])
extern "C" int cross_entropy_bwd_launch(const void* logits,
                                        const void* labels, const void* lse,
                                        const void* g, int g_stride,
                                        void* out, int rows, int v,
                                        int dtype, int label64,
                                        void* stream) {
  if (rows <= 0) return 0;
  if (v <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == repro::kFloat32)
    return label64 ? launch_bwd<float, long long>(logits, labels, lse, g,
                                                  g_stride, out, rows, v, s)
                   : launch_bwd<float, int>(logits, labels, lse, g, g_stride,
                                            out, rows, v, s);
  if (dtype == repro::kBFloat16)
    return label64 ? launch_bwd<__nv_bfloat16, long long>(
                         logits, labels, lse, g, g_stride, out, rows, v, s)
                   : launch_bwd<__nv_bfloat16, int>(
                         logits, labels, lse, g, g_stride, out, rows, v, s);
  return (int)cudaErrorInvalidValue;
}
