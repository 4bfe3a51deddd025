// K1 on Hopper (sm_90a): the fused scan's per-chunk masked reductions, a
// whole chunk's batch of them at once, and the tagged fold of the chunk's
// flat state vector.
//
// Replaces deequ_tpu/ops/df32.py: masked_count, masked_sum,
// masked_extremum, masked_moments and masked_comoments (the reference's
// per-chunk reductions over (hi, lo) f32 pairs with TwoSum compensation,
// since the TPU has no f64 units) and merge_tags_f64 (the elementwise
// add / min / max of a chunk's flat vector into the scan's accumulator).
// The H100 has native f64, so every row is read and accumulated in f64.
// It computes the functions of deequ_tpu_torch/ops/masked_reduce.py's
// plain versions. For each task of a batch, over the rows where all its
// masks hold:
// - count: the rows (exact);
// - sum: their sum;
// - min, max: their extremum, the +inf / -inf identity when no row is
//   valid; a valid NaN gives NaN (the first the fixed order meets), and
//   -0.0 orders before +0.0, so no result depends on the order of rows;
// - moments: (n, mean, m2), m2 the centred two-pass sum of (x - mean)^2;
// - comoments: (n, x_avg, y_avg, ck, x_mk, y_mk), the centred sums of
//   dx*dy, dx^2 and dy^2.
// Each output goes, as f64, to its offset in the chunk's flat vector.
//
// What bounds it: reading each plane once. The batch of a resident main
// pass is ~200 tasks over 22 columns of 10^7 rows: 1.9 GB of planes, so
// ~0.57 ms at 3.35 TB/s; its f64 work (a few operations a task and row) is
// far below the card's f64 rate. Many tasks read one column (min, max,
// sum, count and moments of each) and one mask.
//
// Design (simple and deterministic first):
// - a descriptor table of the batch's tasks (struct Task), copied to the
//   card by the wrapper;
// - pass 1, grid (task, row tile): each block folds count, sum and
//   min/max (or the two sums of a co-moment task) of its tile into one
//   partial. The task index runs fastest, so the blocks in flight are the
//   tasks of a few tiles at once, and the tasks on one column read its
//   tile through L2: device memory sees about one read of each plane;
// - fold 1, a warp a task: folds the task's tile partials in tile order
//   and writes its count, sum, min or max; a moment task gets its mean(s)
//   there, once, so every tile of pass 2 centres on the same bits;
// - pass 2, grid (moment task, row tile): the centred partial sums;
// - fold 2, a warp a moment task: folds them in tile order and writes m2
//   (ck, x_mk, y_mk).
// Two launches a batch, four when it holds a moment task. No float
// atomics: within a block, thread t takes rows t, t + 256, ... of its tile
// in order, and threads and warps combine in a fixed shuffle-down tree;
// tiles start at multiples of the tile size from row 0. So a result's bits
// depend only on the task's rows and n: not on the data's alignment (a
// group scan's slots, LUT-decoded columns), the task's place in the table,
// the other tasks, or the order in which blocks finish. Built without
// --use_fast_math and -ftz=true: subnormals stay and NaN compares as NaN.
//
// deequ_k1_merge: out[i] = acc[i] + new, min(acc[i], new) or
// max(acc[i], new) by tag, new = flat[src[i]]; min/max as torch.minimum /
// torch.maximum compute them on a card (a NaN operand, acc's first, else
// fmin / fmax), so the fold is bit for bit the plain version's.
//
// Plain C interface for ctypes; each entry returns the launches'
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kTileRows = 16384;   // rows a block: 64 a thread
constexpr long long kMaxTiles = 65535;   // gridDim.y
constexpr int kMaxMasks = 3;

enum Kind { kCount = 0, kSum = 1, kMin = 2, kMax = 3, kMoments = 4, kComoments = 5 };

// One task (ops/masked_reduce.py:TASK_DTYPE).
struct Task {
  const void* x;                      // data (f64 or int32), or null
  const void* y;                      // second data of a co-moment task
  const unsigned char* m[kMaxMasks];  // bool masks, the first nmask used
  long long n;                        // rows
  int kind;
  int xtype;                          // 0 f64, 1 int32
  int ytype;
  int nmask;
  int out[6];                         // each output's offset in flat, -1 none
};
static_assert(sizeof(Task) == 88, "Task must match ops/masked_reduce.py:TASK_DTYPE");

struct Part {                         // a tile's (or a task's) first-pass fold
  unsigned long long cnt;
  double a;                           // sum, min or max; x's sum
  double b;                           // y's sum (co-moments)
};

struct Cent {                         // a tile's centred sums
  double c0, c1, c2;                  // m2 | ck, x_mk, y_mk
};

__host__ __device__ inline long long tile_rows(long long n) {
  const long long tiles = (n + kTileRows - 1) / kTileRows;
  const long long scale = (tiles + kMaxTiles - 1) / kMaxTiles;
  return kTileRows * (scale > 1 ? scale : 1);
}

__host__ __device__ inline long long tiles_of(long long n) {
  const long long t = tile_rows(n);
  const long long k = (n + t - 1) / t;
  return k > 0 ? k : 1;
}

__device__ __forceinline__ double kmin(double a, double b) {
  if (a != a) return a;
  if (b != b) return b;
  if (a < b) return a;
  if (b < a) return b;
  return __double_as_longlong(a) < 0 ? a : b;  // equal: -0.0 first
}

__device__ __forceinline__ double kmax(double a, double b) {
  if (a != a) return a;
  if (b != b) return b;
  if (a > b) return a;
  if (b > a) return b;
  return __double_as_longlong(a) < 0 ? b : a;  // equal: +0.0 first
}

__device__ __forceinline__ double identity(int kind) {
  return kind == kMin ? __longlong_as_double(0x7FF0000000000000ll)
       : kind == kMax ? __longlong_as_double((long long)0xFFF0000000000000ull)
       : 0.0;
}

__device__ __forceinline__ double combine(int kind, double a, double b) {
  return kind == kMin ? kmin(a, b) : kind == kMax ? kmax(a, b) : a + b;
}

__device__ __forceinline__ double load(const void* p, int type, long long i) {
  return type == 0 ? __ldg(static_cast<const double*>(p) + i)
                   : (double)__ldg(static_cast<const int*>(p) + i);
}

__device__ __forceinline__ bool holds(const Task& t, long long i) {
  bool ok = true;
#pragma unroll
  for (int j = 0; j < kMaxMasks; ++j)
    if (j < t.nmask) ok &= __ldg(t.m[j] + i) != 0;
  return ok;
}

// Folds (cnt, a, b) of a block in a fixed tree; thread 0 gets the result.
__device__ void block_fold(int kind, unsigned long long& cnt, double& a, double& b) {
  __shared__ unsigned long long s_cnt[kWarps];
  __shared__ double s_a[kWarps], s_b[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_down_sync(0xFFFFFFFFu, cnt, off);
    a = combine(kind, a, __shfl_down_sync(0xFFFFFFFFu, a, off));
    b += __shfl_down_sync(0xFFFFFFFFu, b, off);
  }
  if (lane == 0) { s_cnt[warp] = cnt; s_a[warp] = a; s_b[warp] = b; }
  __syncthreads();
  if (warp == 0) {
    cnt = lane < kWarps ? s_cnt[lane] : 0ull;
    a = lane < kWarps ? s_a[lane] : identity(kind);
    b = lane < kWarps ? s_b[lane] : 0.0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      cnt += __shfl_down_sync(0xFFFFFFFFu, cnt, off);
      a = combine(kind, a, __shfl_down_sync(0xFFFFFFFFu, a, off));
      b += __shfl_down_sync(0xFFFFFFFFu, b, off);
    }
  }
}

template <int K>
__device__ void scan_tile(const Task& t, long long lo, long long hi,
                          unsigned long long& cnt, double& a, double& b) {
#pragma unroll 4
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    if (!holds(t, i)) continue;
    ++cnt;
    if (K == kSum || K == kMoments || K == kComoments) a += load(t.x, t.xtype, i);
    if (K == kMin) a = kmin(a, load(t.x, t.xtype, i));
    if (K == kMax) a = kmax(a, load(t.x, t.xtype, i));
    if (K == kComoments) b += load(t.y, t.ytype, i);
  }
}

// Pass 1: grid (task, tile); parts[task * stride + tile].
__global__ void __launch_bounds__(kThreads)
k1_partials(const Task* __restrict__ tasks, Part* __restrict__ parts, long long stride) {
  const Task t = tasks[blockIdx.x];
  const long long tile = blockIdx.y;
  if (tile >= tiles_of(t.n)) return;
  const long long rows = tile_rows(t.n);
  const long long lo = tile * rows;
  const long long hi = lo + rows < t.n ? lo + rows : t.n;
  unsigned long long cnt = 0;
  double a = identity(t.kind), b = 0.0;
  switch (t.kind) {
    case kCount: scan_tile<kCount>(t, lo, hi, cnt, a, b); break;
    case kSum: scan_tile<kSum>(t, lo, hi, cnt, a, b); break;
    case kMin: scan_tile<kMin>(t, lo, hi, cnt, a, b); break;
    case kMax: scan_tile<kMax>(t, lo, hi, cnt, a, b); break;
    case kMoments: scan_tile<kMoments>(t, lo, hi, cnt, a, b); break;
    default: scan_tile<kComoments>(t, lo, hi, cnt, a, b); break;
  }
  block_fold(t.kind, cnt, a, b);
  if (threadIdx.x == 0) parts[(long long)blockIdx.x * stride + tile] = Part{cnt, a, b};
}

__device__ __forceinline__ void put(double* flat, int off, double v) {
  if (off >= 0) flat[off] = v;
}

// Fold 1: a warp a task, tiles in order; writes count/sum/min/max and a
// moment task's n and mean(s), and keeps its means in totals.
__global__ void __launch_bounds__(kThreads)
k1_fold(const Task* __restrict__ tasks, int n_tasks, const Part* __restrict__ parts,
        long long stride, Part* __restrict__ totals, double* __restrict__ flat) {
  const int w = (int)((blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= n_tasks) return;  // a whole warp
  const Task t = tasks[w];
  const long long tiles = tiles_of(t.n);
  unsigned long long cnt = 0;
  double a = identity(t.kind), b = 0.0;
  for (long long k = lane; k < tiles; k += 32) {
    const Part p = parts[(long long)w * stride + k];
    cnt += p.cnt;
    a = combine(t.kind, a, p.a);
    b += p.b;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_down_sync(0xFFFFFFFFu, cnt, off);
    a = combine(t.kind, a, __shfl_down_sync(0xFFFFFFFFu, a, off));
    b += __shfl_down_sync(0xFFFFFFFFu, b, off);
  }
  if (lane != 0) return;
  const double n = (double)cnt;
  const double denom = cnt > 1 ? n : 1.0;
  switch (t.kind) {
    case kCount: put(flat, t.out[0], n); break;
    case kSum: case kMin: case kMax: put(flat, t.out[0], a); break;
    case kMoments: {
      const double mean = a / denom;
      totals[w] = Part{cnt, mean, 0.0};
      put(flat, t.out[0], n);
      put(flat, t.out[1], mean);
      break;
    }
    default: {
      const double ma = a / denom, mb = b / denom;
      totals[w] = Part{cnt, ma, mb};
      put(flat, t.out[0], n);
      put(flat, t.out[1], ma);
      put(flat, t.out[2], mb);
      break;
    }
  }
}

// Pass 2: grid (moment task, tile); cents[m * stride + tile].
__global__ void __launch_bounds__(kThreads)
k1_centred(const Task* __restrict__ tasks, const int* __restrict__ ids,
           const Part* __restrict__ totals, Cent* __restrict__ cents, long long stride) {
  const int ti = ids[blockIdx.x];
  const Task t = tasks[ti];
  const long long tile = blockIdx.y;
  if (tile >= tiles_of(t.n)) return;
  const long long rows = tile_rows(t.n);
  const long long lo = tile * rows;
  const long long hi = lo + rows < t.n ? lo + rows : t.n;
  const double ma = totals[ti].a, mb = totals[ti].b;
  const bool co = t.kind == kComoments;
  double c0 = 0.0, c1 = 0.0, c2 = 0.0;
#pragma unroll 4
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    if (!holds(t, i)) continue;
    const double da = load(t.x, t.xtype, i) - ma;
    if (co) {
      const double db = load(t.y, t.ytype, i) - mb;
      c0 += da * db;
      c1 += da * da;
      c2 += db * db;
    } else {
      c0 += da * da;
    }
  }
  __shared__ double s[3][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    c0 += __shfl_down_sync(0xFFFFFFFFu, c0, off);
    c1 += __shfl_down_sync(0xFFFFFFFFu, c1, off);
    c2 += __shfl_down_sync(0xFFFFFFFFu, c2, off);
  }
  if (lane == 0) { s[0][warp] = c0; s[1][warp] = c1; s[2][warp] = c2; }
  __syncthreads();
  if (warp != 0) return;
  c0 = lane < kWarps ? s[0][lane] : 0.0;
  c1 = lane < kWarps ? s[1][lane] : 0.0;
  c2 = lane < kWarps ? s[2][lane] : 0.0;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    c0 += __shfl_down_sync(0xFFFFFFFFu, c0, off);
    c1 += __shfl_down_sync(0xFFFFFFFFu, c1, off);
    c2 += __shfl_down_sync(0xFFFFFFFFu, c2, off);
  }
  if (lane == 0) cents[(long long)blockIdx.x * stride + tile] = Cent{c0, c1, c2};
}

// Fold 2: a warp a moment task, tiles in order; writes m2 | ck, x_mk, y_mk.
__global__ void __launch_bounds__(kThreads)
k1_fold_centred(const Task* __restrict__ tasks, const int* __restrict__ ids, int n_moments,
                const Cent* __restrict__ cents, long long stride, double* __restrict__ flat) {
  const int w = (int)((blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= n_moments) return;
  const Task t = tasks[ids[w]];
  const long long tiles = tiles_of(t.n);
  double c0 = 0.0, c1 = 0.0, c2 = 0.0;
  for (long long k = lane; k < tiles; k += 32) {
    const Cent c = cents[(long long)w * stride + k];
    c0 += c.c0;
    c1 += c.c1;
    c2 += c.c2;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    c0 += __shfl_down_sync(0xFFFFFFFFu, c0, off);
    c1 += __shfl_down_sync(0xFFFFFFFFu, c1, off);
    c2 += __shfl_down_sync(0xFFFFFFFFu, c2, off);
  }
  if (lane != 0) return;
  if (t.kind == kMoments) {
    put(flat, t.out[2], c0);
  } else {
    put(flat, t.out[3], c0);
    put(flat, t.out[4], c1);
    put(flat, t.out[5], c2);
  }
}

// torch.minimum / torch.maximum of two f64 on a card.
__device__ __forceinline__ double tmin(double a, double b) {
  return a != a ? a : (b != b ? b : fmin(a, b));
}
__device__ __forceinline__ double tmax(double a, double b) {
  return a != a ? a : (b != b ? b : fmax(a, b));
}

__global__ void __launch_bounds__(kThreads)
k1_merge(const unsigned char* __restrict__ is_sum, const unsigned char* __restrict__ is_min,
         const double* __restrict__ acc, const double* __restrict__ flat,
         const long long* __restrict__ src, double* __restrict__ out, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const double a = acc[i];
  const double b = flat[src ? src[i] : i];
  out[i] = is_sum[i] ? a + b : (is_min[i] ? tmin(a, b) : tmax(a, b));
}

struct Layout {
  long long stride;       // tiles a task's partials take
  long long parts;        // byte offsets in the scratch
  long long totals;
  long long cents;
  long long bytes;
};

Layout layout(int n_tasks, int n_moments, long long max_n) {
  Layout l;
  l.stride = tiles_of(max_n);
  l.parts = 0;
  l.totals = l.parts + (long long)n_tasks * l.stride * (long long)sizeof(Part);
  l.cents = l.totals + (long long)n_tasks * (long long)sizeof(Part);
  l.bytes = l.cents + (long long)n_moments * l.stride * (long long)sizeof(Cent);
  return l;
}

}  // namespace

extern "C" {

// Bytes of scratch deequ_k1_reduce needs for a batch.
long long deequ_k1_scratch_bytes(int n_tasks, int n_moments, long long max_n) {
  return layout(n_tasks, n_moments, max_n).bytes;
}

// Runs a batch of n_tasks tasks (tasks: their descriptor table on the
// card; ids: the n_moments indices of its moment and co-moment tasks, on
// the card; max_n: the most rows of any task) into flat (f64 on the card),
// using scratch (deequ_k1_scratch_bytes on the card). Enqueues on stream
// and returns the CUDA error of the launches (0 = cudaSuccess).
int deequ_k1_reduce(const void* tasks, int n_tasks, const void* ids, int n_moments,
                    long long max_n, void* scratch, void* flat, void* stream) {
  if (n_tasks < 1 || n_moments < 0 || n_moments > n_tasks || max_n < 0 || !tasks ||
      !scratch || !flat || (n_moments > 0 && !ids))
    return (int)cudaErrorInvalidValue;
  const Layout l = layout(n_tasks, n_moments, max_n);
  char* base = static_cast<char*>(scratch);
  const Task* t = static_cast<const Task*>(tasks);
  const int* m = static_cast<const int*>(ids);
  Part* parts = reinterpret_cast<Part*>(base + l.parts);
  Part* totals = reinterpret_cast<Part*>(base + l.totals);
  Cent* cents = reinterpret_cast<Cent*>(base + l.cents);
  double* out = static_cast<double*>(flat);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per_block = kThreads / 32;
  k1_partials<<<dim3((unsigned)n_tasks, (unsigned)l.stride), kThreads, 0, s>>>(t, parts, l.stride);
  int err = (int)cudaGetLastError();
  if (err) return err;
  k1_fold<<<(n_tasks + per_block - 1) / per_block, kThreads, 0, s>>>(
      t, n_tasks, parts, l.stride, totals, out);
  err = (int)cudaGetLastError();
  if (err || n_moments == 0) return err;
  k1_centred<<<dim3((unsigned)n_moments, (unsigned)l.stride), kThreads, 0, s>>>(
      t, m, totals, cents, l.stride);
  err = (int)cudaGetLastError();
  if (err) return err;
  k1_fold_centred<<<(n_moments + per_block - 1) / per_block, kThreads, 0, s>>>(
      t, m, n_moments, cents, l.stride, out);
  return (int)cudaGetLastError();
}

// out[i] = tagged merge of acc[i] and flat[src ? src[i] : i] (header);
// is_sum / is_min: n bytes. Enqueues on stream; returns the launch's error.
int deequ_k1_merge(const void* is_sum, const void* is_min, const void* acc, const void* flat,
                   const void* src, void* out, long long n, void* stream) {
  if (n < 1 || !is_sum || !is_min || !acc || !flat || !out) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  k1_merge<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(is_sum), static_cast<const unsigned char*>(is_min),
      static_cast<const double*>(acc), static_cast<const double*>(flat),
      static_cast<const long long*>(src), static_cast<double*>(out), n);
  return (int)cudaGetLastError();
}

}  // extern "C"
