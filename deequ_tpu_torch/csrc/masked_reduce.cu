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
// - moments: (n, mean, m2), m2 the centred sum of (x - mean)^2;
// - comoments: (n, x_avg, y_avg, ck, x_mk, y_mk), the centred sums of
//   dx*dy, dx^2 and dy^2.
// Each output goes, as f64, to its offset in the chunk's flat vector.
//
// What bounds it: reading each plane once. The batch of a resident main
// pass is 192 tasks over 44 tensors of 10^7 rows: 184 bytes a row, 1.84
// GB, ~0.55 ms at 3.35 TB/s. Its f64 work (a few operations a task and
// row) is a tenth of that, but the instructions around it are not: the
// masks, selects and compares of every combo and row.
//
// What the first design lost (12.8% of that bound). Every task read
// its own planes, a block per (task, tile), with an 8-byte load of data and
// a 1-byte load of each mask a row: ~1,000 bytes a row through L2 for 184
// of planes, 32 bytes a warp's mask load; identical tasks (the count of one
// mask, asked by several analyzers) ran again; the moments read every plane
// a second time, centred on means a first pass had to finish; and min and
// max branched on NaN and signed zero at every row.
//
// This design: the wrapper groups the batch into sources and combos.
// - A source is one data plane, or a co-moment task's pair of planes, with
//   the masks its tasks use (at most kSourceMasks); a mask-only source
//   serves counts whose masks no data source reads. A combo is one (plane,
//   mask set) of a source (at most kSourceCombos a source): every task on
//   it maps to a field of the combo's fold. Identical tasks are one.
// - k1_tiles, grid (source, run of kRun tiles): thread 0 copies each plane
//   and mask of a tile into shared memory with one TMA bulk copy each (from
//   the 16-byte floor of the tile's first row, only the 16-byte segments
//   that hold its rows), completing on an mbarrier; where two of the
//   source's tiles fit, the next tile's copies run while the block works
//   on this one. Every combo then reads the tile from shared memory. A
//   thread turns its rows' mask bytes into one bit pattern a row once; a
//   combo keeps a row when the pattern holds its bits (no branch a row).
//   Phase A sums count, sum(s), min and max (one compare a row each; a
//   thread that met a NaN or a zero extremum folds its rows again with the
//   exact rule); the block folds them and takes the tile's centre (its
//   mean); phase B sums the deviations from that centre and their squares
//   and products, from the same shared copy. One read of each plane serves
//   every task and the moments.
// - k1_fold, a block a combo: the tile partials in a fixed order: count,
//   sums, min, max, the mean = sum / n, then the centred sums moved to that
//   mean (Chan et al.'s merge, all tiles at once: m2 = sum over tiles of
//   S2 + e * (2 * S1 + n_t * e), e = tile centre - mean, which is exact for
//   any centre); it writes every output of every task on the combo.
// Two launches a batch. What holds it below its bound now (tools/time_k1.py
// on an H100, PERF.md): the copies alone run at ~85% of it; the block's
// stages (phase A above all) are short runs of dependent instructions a
// tile, and two blocks an SM (the registers, and the pair's tiles of
// ~74 KB) hide little of their latency.
// No float atomics: thread t takes rows t, t + kThreads, ... of a tile in
// order, warps fold in a fixed shuffle-down tree and the block's warps in
// order, tiles start at multiples of kTileRows from row 0, and the fold's
// order depends on the tiles alone. So a result's bits depend only on the
// task's rows and n: not on the data's alignment (a group scan's slots,
// LUT-decoded columns), the task's place in the batch, or the other tasks
// on its source. Chunks past 65,535 runs keep the tile size: a block walks
// runs y, y + 65,535, ... Built without --use_fast_math and -ftz=true:
// subnormals stay and NaN compares as NaN. Probe builds (tools/time_k1.py):
// DEEQU_K1_STAGE_CLOCK counts thread 0's cycles in each stage of a tile;
// DEEQU_K1_COPY_ONLY stages the tiles and computes nothing.
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

// The geometry; a probe build (tools/time_k1.py) may set another, and the
// wrapper follows what deequ_k1_geometry reports.
#ifndef DEEQU_K1_THREADS
#define DEEQU_K1_THREADS 256
#endif
#ifndef DEEQU_K1_TILE_ROWS
#define DEEQU_K1_TILE_ROWS 4096
#endif
#ifndef DEEQU_K1_MIN_BLOCKS
#define DEEQU_K1_MIN_BLOCKS 2
#endif
#ifndef DEEQU_K1_RUN
#define DEEQU_K1_RUN 8
#endif

constexpr int kThreads = DEEQU_K1_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr long long kTileRows = DEEQU_K1_TILE_ROWS;
constexpr int kRows = (int)(kTileRows / kThreads);  // rows a thread
constexpr int kMinBlocks = DEEQU_K1_MIN_BLOCKS;     // blocks an SM the registers allow
constexpr long long kMaxGridY = 65535;
constexpr int kRun = DEEQU_K1_RUN;                  // tiles a block takes in a row
constexpr int kSourceMasks = 7;
constexpr int kSourceCombos = 16;
constexpr unsigned kValid = 1u << kSourceMasks;      // a row inside the tile
constexpr int kPlaneBytes = (int)(kTileRows * 8 + 16);
constexpr int kMaskBytes = (int)(kTileRows + 16);
constexpr int kMaxSharedBytes = 232448;             // a block's opt-in most on Hopper
static_assert(kTileRows % kThreads == 0, "a tile is whole rows of the block");
static_assert(kTileRows % 16 == 0, "every tile of a plane starts at its first tile's offset");
static_assert(kPlaneBytes % 16 == 0 && kMaskBytes % 16 == 0, "16-byte staging");

enum Plane { kNone = -1, kX = 0, kY = 1, kXY = 2 };
enum Flag { kFlagMin = 1, kFlagMax = 2, kFlagCentred = 4 };
enum Field { kN = 0, kSum, kMin, kMax, kMean, kM2, kXAvg, kYAvg, kCk, kXMk, kYMk };

// One source (ops/masked_reduce.py:SOURCE_DTYPE).
struct Source {
  const void* x;                          // data planes (f64 or int32), or null
  const void* y;
  const unsigned char* m[kSourceMasks];   // bool masks, the first nmask used
  long long n;                            // rows
  int xtype;                              // 0 f64, 1 int32
  int ytype;
  int nplanes;
  int nmask;
  int combo0;                             // its combos in the combo table
  int ncombo;
};
static_assert(sizeof(Source) == 104, "Source must match ops/masked_reduce.py:SOURCE_DTYPE");

// One combo (COMBO_DTYPE): its source, the source's masks it needs (bit j:
// mask j), the plane(s) it reads, its flags, and its outputs.
struct Combo {
  int source;
  unsigned need;
  int plane;
  int flags;
  int out0;
  int nout;
};
static_assert(sizeof(Combo) == 24, "Combo must match ops/masked_reduce.py:COMBO_DTYPE");

struct Out {                              // OUT_DTYPE: flat[offset] = field
  int offset;
  int field;
};
static_assert(sizeof(Out) == 8, "Out must match ops/masked_reduce.py:OUT_DTYPE");

// A tile's partial of a combo. One plane: v = (sum, min, max, S1, S2);
// a pair: v = (sum x, sum y, S1x, S1y, Sxx, Syy, Sxy); S* are sums of the
// deviations from the tile's centre (its sums over its count).
struct Part {
  unsigned long long cnt;
  double v[7];
};
static_assert(sizeof(Part) == 64, "Part must match ops/masked_reduce.py:PART_BYTES");

struct Sums {                             // phase A: a warp's or tile's sums of a combo
  unsigned long long cnt;
  double s, t, lo, hi;
};
struct WarpDevs {                         // phase B: a warp's deviation sums
  double a, b, xx, yy, xy;
};

__host__ __device__ inline long long tiles_of(long long n) {
  const long long k = (n + kTileRows - 1) / kTileRows;
  return k > 0 ? k : 1;
}

__device__ __forceinline__ double pos_inf() { return __longlong_as_double(0x7FF0000000000000ll); }
__device__ __forceinline__ double neg_inf() {
  return __longlong_as_double((long long)0xFFF0000000000000ull);
}

__device__ __forceinline__ bool negative(double x) { return __double_as_longlong(x) < 0; }

// min / max of the running a and the next b, without a branch: b wins when
// it orders first, when it is a NaN and a is not (a NaN a stays: the first
// NaN met), or when both are zeros and b's sign orders first (-0.0 before
// +0.0 for min, +0.0 before -0.0 for max). Only when `ok`.
__device__ __forceinline__ double kmin(double a, double b, bool ok = true) {
  const bool take = (b < a) | ((b != b) & (a == a)) | ((b == a) & negative(b) & !negative(a));
  return ok & take ? b : a;
}

__device__ __forceinline__ double kmax(double a, double b, bool ok = true) {
  const bool take = (b > a) | ((b != b) & (a == a)) | ((b == a) & negative(a) & !negative(b));
  return ok & take ? b : a;
}

// The 16-byte segments of a plane of `size`-byte elements that hold rows
// [lo, hi): from the 16-byte floor of row lo's first byte (*s0); returns
// their bytes.
__device__ __forceinline__ unsigned segments(const void* src, int size, long long lo,
                                             long long hi, unsigned long long* s0) {
  const unsigned long long b0 = reinterpret_cast<unsigned long long>(src) + lo * size;
  *s0 = b0 & ~15ull;
  return hi > lo
             ? (unsigned)(((b0 + (unsigned long long)((hi - lo) * size) + 15) & ~15ull) - *s0)
             : 0u;
}

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Waits for the phase of parity `parity` of the mbarrier at `bar`; traps
// rather than hang if it never completes.
__device__ __forceinline__ void wait_phase(unsigned bar, unsigned parity) {
  unsigned done = 0;
  for (long long spin = 0; !done; ++spin) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (spin > (1ll << 20)) __trap();
  }
}

template <typename T>
__device__ __forceinline__ double at(const unsigned char* p, int i) {
  return (double)reinterpret_cast<const T*>(p)[i];
}

__device__ __forceinline__ bool holds(unsigned pat, unsigned need) { return (pat & need) == need; }

// Phase A of a one-plane combo over the thread's rows (cnt, s, lo and hi
// come in as the identities). Min and max take
// one compare a row; a thread whose sum is a NaN (a valid NaN, or both
// infinities; f64 only) or whose extremum is a zero folds its rows again
// with kmin / kmax, so the result is theirs, bit for bit (the first NaN;
// -0.0 before +0.0 for min).
template <typename T>
__device__ __forceinline__ void sums_one(const unsigned char* p, const unsigned (&pat)[kRows],
                                         unsigned need, bool extrema, unsigned& cnt, double& s,
                                         double& lo, double& hi) {
  if (extrema) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool ok = holds(pat[r], need);
      const double v = at<T>(p, threadIdx.x + r * kThreads);
      cnt += ok;
      s += ok ? v : 0.0;
      lo = ok & (v < lo) ? v : lo;
      hi = ok & (v > hi) ? v : hi;
    }
    if (sizeof(T) == 8 && ((s != s) | (lo == 0.0) | (hi == 0.0))) {  // rare
      lo = pos_inf();
      hi = neg_inf();
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const bool ok = holds(pat[r], need);
        const double v = at<T>(p, threadIdx.x + r * kThreads);
        lo = kmin(lo, v, ok);
        hi = kmax(hi, v, ok);
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool ok = holds(pat[r], need);
      const double v = at<T>(p, threadIdx.x + r * kThreads);
      cnt += ok;
      s += ok ? v : 0.0;
    }
  }
}

// Phase B of a one-plane combo: deviations from the tile's centre c.
template <typename T>
__device__ __forceinline__ void devs_one(const unsigned char* p, const unsigned (&pat)[kRows],
                                         unsigned need, double c, double& a, double& xx) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const bool ok = holds(pat[r], need);
    const double d = ok ? at<T>(p, threadIdx.x + r * kThreads) - c : 0.0;
    a += d;
    xx = fma(d, d, xx);
  }
}

template <typename TX, typename TY>
__device__ __forceinline__ void sums_pair(const unsigned char* px, const unsigned char* py,
                                          const unsigned (&pat)[kRows], unsigned need,
                                          unsigned& cnt, double& s, double& t) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const bool ok = holds(pat[r], need);
    const int i = threadIdx.x + r * kThreads;
    cnt += ok;
    s += ok ? at<TX>(px, i) : 0.0;
    t += ok ? at<TY>(py, i) : 0.0;
  }
}

template <typename TX, typename TY>
__device__ __forceinline__ void devs_pair(const unsigned char* px, const unsigned char* py,
                                          const unsigned (&pat)[kRows], unsigned need,
                                          double cx, double cy, WarpDevs& w) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const bool ok = holds(pat[r], need);
    const int i = threadIdx.x + r * kThreads;
    const double dx = ok ? at<TX>(px, i) - cx : 0.0;
    const double dy = ok ? at<TY>(py, i) - cy : 0.0;
    w.a += dx;
    w.b += dy;
    w.xx = fma(dx, dx, w.xx);
    w.yy = fma(dy, dy, w.yy);
    w.xy = fma(dx, dy, w.xy);
  }
}

__device__ __forceinline__ double centre(double s, unsigned long long cnt) {
  return s / (cnt > 0 ? (double)cnt : 1.0);
}

__device__ __forceinline__ unsigned dynamic_smem_bytes() {
  unsigned v;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(v));
  return v;
}

#ifdef DEEQU_K1_STAGE_CLOCK
// A probe build's clock (tools/time_k1.py): thread 0's cycles in each
// stage of a tile, summed over the tiles ([7]: the tiles).
__device__ unsigned long long g_k1_cycles[8];
#define K1_MARK(k)                                                              \
  do {                                                                          \
    if (threadIdx.x == 0) {                                                     \
      const long long now = clock64();                                          \
      atomicAdd(&g_k1_cycles[k], (unsigned long long)(now - mark));             \
      mark = now;                                                               \
    }                                                                           \
  } while (0)
#else
#define K1_MARK(k) \
  do {             \
  } while (0)
#endif

// The i-th tile a block of grid row y takes: runs of kRun tiles, run y,
// y + rows, ...
__device__ __forceinline__ long long tile_of(long long i, long long y, long long rows) {
  return (y + (i / kRun) * rows) * kRun + i % kRun;
}

// Grid (source, run of kRun tiles); a block walks runs blockIdx.y, +
// gridDim.y, ... When two of its source's tiles fit the shared memory, the
// copies of the next tile run while the block works on this one.
// parts[combo * stride + tile].
__global__ void __launch_bounds__(kThreads, kMinBlocks)
k1_tiles(const Source* __restrict__ sources, const Combo* __restrict__ combos,
         Part* __restrict__ parts, long long stride) {
  extern __shared__ __align__(16) unsigned char staged[];
  __shared__ Source src;
  __shared__ Combo cmb[kSourceCombos];
  __shared__ union {
    Sums a[kSourceCombos][kWarps];
    WarpDevs b[kSourceCombos][kWarps];
  } warps;
  __shared__ Sums tile_sums[kSourceCombos];

  if (threadIdx.x == 0) src = sources[blockIdx.x];
  __syncthreads();
  if (threadIdx.x < src.ncombo) cmb[threadIdx.x] = combos[src.combo0 + threadIdx.x];
  if (src.nplanes < 0 || src.nplanes > 2 || src.nmask < 0 || src.nmask > kSourceMasks ||
      src.ncombo < 1 || src.ncombo > kSourceCombos ||
      src.nplanes * kPlaneBytes + src.nmask * kMaskBytes > (int)dynamic_smem_bytes())
    __trap();  // a table the wrapper would not build
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long tiles = tiles_of(src.n);
  const int xsize = src.xtype == 0 ? 8 : 4, ysize = src.ytype == 0 ? 8 : 4;

  const int stage_bytes = src.nplanes * kPlaneBytes + src.nmask * kMaskBytes;
  const bool twice = 2 * stage_bytes <= (int)dynamic_smem_bytes();  // uniform
  __shared__ __align__(8) unsigned long long full[2];  // a buffer's copies landed
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem(&full[0])) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem(&full[1])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // thread 0 copies tile t into buffer b: one bulk copy (TMA) a plane and
  // mask, completing on full[b]; every tile of a plane lands at the same
  // offset of its buffer (its pointer's, mod 16)
  auto load_tile = [&](long long t, int b) {
    if (threadIdx.x != 0) return;
    unsigned char* base = staged + b * stage_bytes;
    const long long lo = t * kTileRows;
    const long long hi = lo + kTileRows < src.n ? lo + kTileRows : src.n;
    unsigned long long from[2 + kSourceMasks];
    unsigned bytes[2 + kSourceMasks], total = 0;
    const int planes = src.nplanes, copies = src.nplanes + src.nmask;
    for (int k = 0; k < copies; ++k) {
      const void* p = k == 0 && planes > 0 ? src.x : k == 1 && planes > 1 ? src.y : src.m[k - planes];
      const int size = k < planes ? (k == 0 ? xsize : ysize) : 1;
      bytes[k] = segments(p, size, lo, hi, &from[k]);
      total += bytes[k];
    }
    // the block's reads of this buffer (before the last __syncthreads) come
    // before the copies that overwrite it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem(&full[b])),
                 "r"(total)
                 : "memory");
    for (int k = 0; k < copies; ++k) {
      if (bytes[k] == 0) continue;
      unsigned char* dst = base + (k < planes ? k * kPlaneBytes
                                              : planes * kPlaneBytes + (k - planes) * kMaskBytes);
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
          ::"r"(smem(dst)), "l"(from[k]), "r"(bytes[k]), "r"(smem(&full[b]))
          : "memory");
    }
  };
  auto at_offset = [](const unsigned char* base, const void* p) {
    return base + (reinterpret_cast<unsigned long long>(p) & 15ull);
  };
  unsigned uses[2] = {0u, 0u};  // phases of full[0], full[1] waited for

  for (long long i = 0;; ++i) {
    const long long tile = tile_of(i, blockIdx.y, gridDim.y);
    if (tile >= tiles) break;
#ifdef DEEQU_K1_STAGE_CLOCK
    long long mark = clock64();
    if (threadIdx.x == 0) atomicAdd(&g_k1_cycles[7], 1ull);
#endif
    const long long next = tile_of(i + 1, blockIdx.y, gridDim.y);
    const int b = twice ? (int)(i & 1) : 0;
    if (i == 0 || !twice) load_tile(tile, b);
    if (twice && next < tiles) load_tile(next, b ^ 1);
    wait_phase(smem(&full[b]), uses[b] & 1u);
    ++uses[b];
    const long long lo = tile * kTileRows;
    const long long hi = lo + kTileRows < src.n ? lo + kTileRows : src.n;
    const unsigned char* base = staged + b * stage_bytes;
    const unsigned char* px = at_offset(base, src.x);
    const unsigned char* py = at_offset(base + kPlaneBytes, src.y);
    const unsigned char* pm[kSourceMasks];
#pragma unroll
    for (int j = 0; j < kSourceMasks; ++j)
      pm[j] = at_offset(base + src.nplanes * kPlaneBytes + j * kMaskBytes,
                        j < src.nmask ? src.m[j] : nullptr);
    K1_MARK(0);
#ifdef DEEQU_K1_COPY_ONLY
    __syncthreads();  // a probe build: the copies alone, no partial written
    continue;
#endif

    // a bit pattern a row: its masks, and kValid inside the tile
    unsigned pat[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      pat[r] = lo + threadIdx.x + r * kThreads < hi ? kValid : 0u;
#pragma unroll
    for (int j = 0; j < kSourceMasks; ++j) {
      if (j >= src.nmask) break;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        pat[r] |= (pm[j][threadIdx.x + r * kThreads] != 0 ? 1u : 0u) << j;
    }
    K1_MARK(1);

    // phase A: count, sums, min, max of each combo
    for (int c = 0; c < src.ncombo; ++c) {
      const Combo k = cmb[c];
      const unsigned need = k.need | kValid;
      unsigned cnt = 0;
      double s = 0.0, t = 0.0, mn = pos_inf(), mx = neg_inf();
      const bool extrema = (k.flags & (kFlagMin | kFlagMax)) != 0;
      if (k.plane == kNone) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) cnt += holds(pat[r], need);
      } else if (k.plane == kXY) {
        if (src.xtype == 0 && src.ytype == 0) sums_pair<double, double>(px, py, pat, need, cnt, s, t);
        else if (src.xtype == 0) sums_pair<double, int>(px, py, pat, need, cnt, s, t);
        else if (src.ytype == 0) sums_pair<int, double>(px, py, pat, need, cnt, s, t);
        else sums_pair<int, int>(px, py, pat, need, cnt, s, t);
      } else {
        const unsigned char* p = k.plane == kX ? px : py;
        if ((k.plane == kX ? src.xtype : src.ytype) == 0)
          sums_one<double>(p, pat, need, extrema, cnt, s, mn, mx);
        else
          sums_one<int>(p, pat, need, extrema, cnt, s, mn, mx);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {  // the branches are uniform
        cnt += __shfl_down_sync(0xFFFFFFFFu, cnt, off);
        if (k.plane == kNone) continue;
        s += __shfl_down_sync(0xFFFFFFFFu, s, off);
        if (k.plane == kXY) t += __shfl_down_sync(0xFFFFFFFFu, t, off);
        if (!extrema) continue;
        mn = kmin(mn, __shfl_down_sync(0xFFFFFFFFu, mn, off));
        mx = kmax(mx, __shfl_down_sync(0xFFFFFFFFu, mx, off));
      }
      if (lane == 0) warps.a[c][warp] = Sums{cnt, s, t, mn, mx};
    }
    __syncthreads();
    K1_MARK(2);
    if (threadIdx.x < src.ncombo) {  // the warps in order
      const int c = threadIdx.x;
      Sums ts = warps.a[c][0];
      for (int w = 1; w < kWarps; ++w) {
        const Sums ws = warps.a[c][w];
        ts.cnt += ws.cnt;
        ts.s += ws.s;
        ts.t += ws.t;
        ts.lo = kmin(ts.lo, ws.lo);
        ts.hi = kmax(ts.hi, ws.hi);
      }
      tile_sums[c] = ts;
    }
    __syncthreads();
    K1_MARK(3);

    // phase B: deviations from the tile's centre, from the same shared copy
    for (int c = 0; c < src.ncombo; ++c) {
      const Combo k = cmb[c];
      if (!(k.flags & kFlagCentred) || k.plane == kNone) continue;  // uniform
      const unsigned need = k.need | kValid;
      const Sums ts = tile_sums[c];
      WarpDevs d = {0.0, 0.0, 0.0, 0.0, 0.0};
      if (k.plane == kXY) {
        const double cx = centre(ts.s, ts.cnt), cy = centre(ts.t, ts.cnt);
        if (src.xtype == 0 && src.ytype == 0) devs_pair<double, double>(px, py, pat, need, cx, cy, d);
        else if (src.xtype == 0) devs_pair<double, int>(px, py, pat, need, cx, cy, d);
        else if (src.ytype == 0) devs_pair<int, double>(px, py, pat, need, cx, cy, d);
        else devs_pair<int, int>(px, py, pat, need, cx, cy, d);
      } else {
        const unsigned char* p = k.plane == kX ? px : py;
        const double cx = centre(ts.s, ts.cnt);
        if ((k.plane == kX ? src.xtype : src.ytype) == 0)
          devs_one<double>(p, pat, need, cx, d.a, d.xx);
        else
          devs_one<int>(p, pat, need, cx, d.a, d.xx);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        d.a += __shfl_down_sync(0xFFFFFFFFu, d.a, off);
        d.xx += __shfl_down_sync(0xFFFFFFFFu, d.xx, off);
        if (k.plane != kXY) continue;  // uniform
        d.b += __shfl_down_sync(0xFFFFFFFFu, d.b, off);
        d.yy += __shfl_down_sync(0xFFFFFFFFu, d.yy, off);
        d.xy += __shfl_down_sync(0xFFFFFFFFu, d.xy, off);
      }
      if (lane == 0) warps.b[c][warp] = d;
    }
    __syncthreads();
    K1_MARK(4);
    if (threadIdx.x < src.ncombo) {
      const int c = threadIdx.x;
      const Combo k = cmb[c];
      const Sums ts = tile_sums[c];
      WarpDevs d = {0.0, 0.0, 0.0, 0.0, 0.0};
      if ((k.flags & kFlagCentred) && k.plane != kNone) {
        d = warps.b[c][0];
        for (int w = 1; w < kWarps; ++w) {
          const WarpDevs e = warps.b[c][w];
          d.a += e.a;
          d.b += e.b;
          d.xx += e.xx;
          d.yy += e.yy;
          d.xy += e.xy;
        }
      }
      Part p;
      p.cnt = ts.cnt;
      if (k.plane == kXY) {
        p.v[0] = ts.s; p.v[1] = ts.t; p.v[2] = d.a; p.v[3] = d.b;
        p.v[4] = d.xx; p.v[5] = d.yy; p.v[6] = d.xy;
      } else {
        p.v[0] = ts.s; p.v[1] = ts.lo; p.v[2] = ts.hi; p.v[3] = d.a;
        p.v[4] = d.xx; p.v[5] = 0.0; p.v[6] = 0.0;
      }
      parts[(long long)(src.combo0 + c) * stride + tile] = p;
    }
    __syncthreads();  // the next tile overwrites the shared copies
    K1_MARK(5);
  }
}

__device__ __forceinline__ double field_of(int field, unsigned long long cnt, double sum, double mn,
                                           double mx, double mean_x, double mean_y, double m2,
                                           double ck, double ymk) {
  switch (field) {
    case kN: return (double)cnt;
    case kSum: return sum;
    case kMin: return mn;
    case kMax: return mx;
    case kMean: case kXAvg: return mean_x;
    case kYAvg: return mean_y;
    case kM2: case kXMk: return m2;
    case kCk: return ck;
    default: return ymk;
  }
}

// A block a combo: the tile partials in a fixed order (thread t takes
// tiles t, t + 256, ...; a shuffle-down tree a warp; the eight warps in
// order), then every output of the combo. (A warp a combo would walk the
// 2,442 tiles of 10^7 rows as a chain of ~77 dependent loads a lane.)
__global__ void __launch_bounds__(kThreads)
k1_fold(const Source* __restrict__ sources, const Combo* __restrict__ combos,
        const Out* __restrict__ outs, const Part* __restrict__ parts, long long stride,
        double* __restrict__ flat) {
  __shared__ Sums ws[kWarps];
  __shared__ WarpDevs wd[kWarps];
  __shared__ double means[2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Combo k = combos[blockIdx.x];
  const long long tiles = tiles_of(sources[k.source].n);
  const Part* p = parts + (long long)blockIdx.x * stride;
  const bool pair = k.plane == kXY;
  unsigned long long cnt = 0;
  double s = 0.0, t = 0.0, mn = pos_inf(), mx = neg_inf();
  for (long long i = threadIdx.x; i < tiles; i += kThreads) {
    const Part q = p[i];
    cnt += q.cnt;
    s += q.v[0];
    if (pair) {
      t += q.v[1];
    } else {
      mn = kmin(mn, q.v[1]);
      mx = kmax(mx, q.v[2]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_down_sync(0xFFFFFFFFu, cnt, off);
    s += __shfl_down_sync(0xFFFFFFFFu, s, off);
    t += __shfl_down_sync(0xFFFFFFFFu, t, off);
    mn = kmin(mn, __shfl_down_sync(0xFFFFFFFFu, mn, off));
    mx = kmax(mx, __shfl_down_sync(0xFFFFFFFFu, mx, off));
  }
  if (lane == 0) ws[warp] = Sums{cnt, s, t, mn, mx};
  __syncthreads();
  if (threadIdx.x == 0) {
    cnt = ws[0].cnt; s = ws[0].s; t = ws[0].t; mn = ws[0].lo; mx = ws[0].hi;
    for (int w = 1; w < kWarps; ++w) {
      cnt += ws[w].cnt;
      s += ws[w].s;
      t += ws[w].t;
      mn = kmin(mn, ws[w].lo);
      mx = kmax(mx, ws[w].hi);
    }
    means[0] = centre(s, cnt);
    means[1] = centre(t, cnt);
  }
  __syncthreads();
  const double mean_x = means[0], mean_y = means[1];
  double xx = 0.0, yy = 0.0, xy = 0.0;
  const bool centred = (k.flags & kFlagCentred) && k.plane != kNone;
  if (centred) {
    // each tile's centred sums moved from its centre to the mean
    for (long long i = threadIdx.x; i < tiles; i += kThreads) {
      const Part q = p[i];
      if (q.cnt == 0) continue;
      const double n = (double)q.cnt;
      const double ex = q.v[0] / n - mean_x;
      if (pair) {
        const double ey = q.v[1] / n - mean_y;
        xx += q.v[4] + ex * (2.0 * q.v[2] + n * ex);
        yy += q.v[5] + ey * (2.0 * q.v[3] + n * ey);
        xy += q.v[6] + ex * q.v[3] + ey * q.v[2] + n * ex * ey;
      } else {
        xx += q.v[4] + ex * (2.0 * q.v[3] + n * ex);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      xx += __shfl_down_sync(0xFFFFFFFFu, xx, off);
      yy += __shfl_down_sync(0xFFFFFFFFu, yy, off);
      xy += __shfl_down_sync(0xFFFFFFFFu, xy, off);
    }
    if (lane == 0) wd[warp] = WarpDevs{0.0, 0.0, xx, yy, xy};
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  if (centred) {
    xx = wd[0].xx; yy = wd[0].yy; xy = wd[0].xy;
    for (int w = 1; w < kWarps; ++w) {
      xx += wd[w].xx;
      yy += wd[w].yy;
      xy += wd[w].xy;
    }
  }
  for (int o = k.out0; o < k.out0 + k.nout; ++o) {
    const Out out = outs[o];
    flat[out.offset] = field_of(out.field, cnt, s, mn, mx, mean_x, mean_y, xx, xy, yy);
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

}  // namespace

extern "C" {

// The kernel's geometry, in ops/masked_reduce.py:GEOMETRY_KEYS's order:
// rows a tile, threads a block, masks and combos a source at most, and the
// bytes of a Source, Combo, Out and Part record. Returns the values written.
int deequ_k1_geometry(long long* out, int cap) {
  const long long v[] = {kTileRows, kThreads, kSourceMasks, kSourceCombos,
                         (long long)sizeof(Source), (long long)sizeof(Combo),
                         (long long)sizeof(Out), (long long)sizeof(Part)};
  const int n = (int)(sizeof(v) / sizeof(v[0]));
  if (!out || cap < n) return 0;
  for (int i = 0; i < n; ++i) out[i] = v[i];
  return n;
}

#ifdef DEEQU_K1_STAGE_CLOCK
// A probe build's stage cycles (g_k1_cycles) into out[8]; zeroes them.
int deequ_k1_stage_cycles(unsigned long long* out) {
  int err = (int)cudaMemcpyFromSymbol(out, g_k1_cycles, sizeof(g_k1_cycles));
  if (err) return err;
  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(g_k1_cycles, zero, sizeof(zero));
}
#endif

// Bytes of the tile partials deequ_k1_reduce needs for n_combos combos
// over at most max_n rows.
long long deequ_k1_scratch_bytes(int n_combos, long long max_n) {
  return (long long)n_combos * tiles_of(max_n) * (long long)sizeof(Part);
}

// Runs a batch: desc holds, on the card, n_sources Source records, then
// n_combos Combo records, then n_outs Out records; max_n is the most rows
// of a source and stage_bytes the shared memory a block takes
// (ops/masked_reduce.py:stage_bytes: at least the largest source's tile,
// planes * (tile rows * 8 + 16) + masks * (tile rows + 16); a source whose
// two tiles fit double-buffers them). Writes into
// flat (f64 on the card) using scratch (deequ_k1_scratch_bytes on the
// card). Enqueues on stream and returns the CUDA error of the launches.
int deequ_k1_reduce(const void* desc, int n_sources, int n_combos, int n_outs, long long max_n,
                    int stage_bytes, void* scratch, void* flat, void* stream) {
  if (n_sources < 1 || n_combos < n_sources || n_outs < 0 || max_n < 0 || !desc || !scratch ||
      !flat || stage_bytes < 0 || stage_bytes > kMaxSharedBytes)
    return (int)cudaErrorInvalidValue;
  const char* base = static_cast<const char*>(desc);
  const Source* sources = reinterpret_cast<const Source*>(base);
  const Combo* combos = reinterpret_cast<const Combo*>(base + (long long)n_sources * sizeof(Source));
  const Out* outs = reinterpret_cast<const Out*>(
      base + (long long)n_sources * sizeof(Source) + (long long)n_combos * sizeof(Combo));
  Part* parts = static_cast<Part*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long stride = tiles_of(max_n);
  int err = (int)cudaFuncSetAttribute(k1_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      stage_bytes);
  if (err) return err;
  err = (int)cudaFuncSetAttribute(k1_tiles, cudaFuncAttributePreferredSharedMemoryCarveout,
                                  (int)cudaSharedmemCarveoutMaxShared);
  if (err) return err;
  const long long runs = (stride + kRun - 1) / kRun;
  const dim3 grid((unsigned)n_sources, (unsigned)(runs < kMaxGridY ? runs : kMaxGridY));
  k1_tiles<<<grid, kThreads, stage_bytes, s>>>(sources, combos, parts, stride);
  err = (int)cudaGetLastError();
  if (err) return err;
  k1_fold<<<(unsigned)n_combos, kThreads, 0, s>>>(sources, combos, outs, parts, stride,
                                                 static_cast<double*>(flat));
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
