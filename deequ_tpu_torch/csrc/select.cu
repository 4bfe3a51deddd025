// K4: the batched multi-rank radix select of a KLL chunk summary, on Hopper
// (sm_90a).
//
// Replaces deequ_tpu/ops/select_device.py:_select_u32_multirank (:149) and
// chunk_summary_select_batched (:331), the reference's XLA formulation of a
// KLL chunk summary without a sort (it has no Pallas kernel). It computes
// what deequ_tpu_torch/ops/select_device.py:chunk_summary_select_batched_plain
// computes: from (K, n) f64 values X and (K, n) bool validity M, for each
// column the summary of ops/kll_device.py (K3) bit for bit -- the k strata
// midpoints, the exact remainder (in row order here, sorted there), the
// count of valid rows, min and max -- and, through deequ_select_ranks, the
// key at any ranks with the rank inside its ties.
//
// The key of a row is the order-preserving 64-bit key of its canonical f64,
// held unsigned here (ukey): +-0 share one key, every NaN takes one key
// above +inf's, an invalid row takes +inf's key (K3 pads invalid rows with
// +inf and sorts NaNs last, stably). Each column's R targets (the k strata
// midpoints, the remainder's first rank r0 and its last m - 1) are narrowed
// together, one byte of the key a pass, most significant byte first: eight
// passes, each a histogram kernel and a resolve kernel.
//
// - pass (grid: a few blocks a column, each a span of at least 32,768
//   rows, about eight waves over the card): reads its span of X and M,
//   builds each row's key in registers, rejects most rows outside every
//   target interval with a 64 Kbit filter of the intervals' prefixes,
//   finds by binary search the interval the rest fall in (the sorted,
//   distinct prefixes of the column's targets, in shared memory up to
//   1,024 of them), and counts the next byte of the rows inside an
//   interval. The counts of a column live in shared memory while its
//   intervals fit (32 x 256 u32), else in L2 (R x 256 u32 a column); each
//   thread adds a run of equal bins once, so a constant column costs one
//   atomic a thread, not one a row. The first pass also folds the count of
//   valid rows, min and max.
// - survivors: once the rows inside the next pass's intervals number at
//   most n / 8 (known exactly from the counts), that pass also appends
//   their keys to a buffer of the column (one slot claim a warp a step of
//   2,048 rows), and every later
//   pass reads those keys instead of X and M: on normal data the fourth
//   pass compacts and passes 5-8 read a few per cent of the rows. A column
//   whose rows stay inside (a constant one) keeps reading X and M. Nothing
//   of the table's size is written.
// - resolve (a block a column): one warp a target scans its interval's 256
//   counts, takes the byte that passes the target's rank and the rank left
//   inside it, then the block rebuilds the sorted distinct prefixes, counts
//   the rows inside them, picks the next pass's source and zeroes the
//   counts it uses. No host sync anywhere.
// - the remainder (rows between the keys at r0 and m - 1, ties at either
//   end split by row order, in row order) and the strata items on the zero
//   and NaN keys (the row K3's stable sort puts at that rank): per-tile
//   counts and a bit a row marking the remainder's candidates, one scan
//   over the tiles, then a write that reads only the marked rows and
//   places each row of the remainder in its slot, and a warp a tied target
//   that finds its row.
//
// What bounds it: the bytes of X and M, 9 a row (0.64 ms for 50 x 4.76 M
// rows at 3.35 TB/s), read once a pass until the survivors take over and
// once for the remainder, with no full-size write. The counts of the
// passes where every row lies in some interval (the first two or three)
// go to shared memory.
//
// Integer counts and compares only: the result does not depend on the
// order of the atomics, and no flush to zero touches the values (no
// -ftz, no fast-math: subnormals and NaN payloads keep their bits). Plain C
// interface for ctypes; the caller allocates the outputs and the scratch
// that deequ_select_scratch_bytes asks for. Each entry returns the
// launches' cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

namespace {

typedef unsigned long long u64;
typedef long long i64;
typedef unsigned int u32;

constexpr int kPasses = 8;
constexpr int kBins = 256;
constexpr int kThreads = 256;           // pass and remainder kernels
constexpr int kResolveThreads = 1024;   // resolve and scan kernels: a block a column
constexpr int kTile = 8192;             // rows a tile of the remainder's counts
constexpr int kMinSpan = 32768;         // fewest rows a block of a pass takes
constexpr int kBlocksPerSm = 4;         // resident blocks of a pass (shared memory)
constexpr int kWaves = 8;
constexpr int kUnroll = 8;              // loads in flight a thread
constexpr int kSharedRows = 32;         // intervals a block counts in shared memory
constexpr int kSharedTab = 1024;        // interval prefixes a block searches in shared memory
constexpr int kFilterWords = 2048;      // the 64 Kbit filter of the interval prefixes
constexpr int kFilterMax = 4096;        // most intervals the filter is built for
constexpr int kPassSmem = kSharedTab * 8 + kFilterWords * 4 + kSharedRows * kBins * 4;
constexpr int kSurvivorShare = 8;       // survivors kept once at most n / 8
enum Source { kFull = 0, kCompact = 1, kSurvivors = 2 };
constexpr int kCounts = 5;              // per tile: strict, at r0's key, at m-1's, zero, NaN
constexpr u32 kAll = 0xFFFFFFFFu;
constexpr u64 kSign = 0x8000000000000000ull;
constexpr u64 kUZero = kSign;                     // +-0.0
constexpr u64 kUNan = 0xFFFFFFFFFFFFFFFFull;      // every NaN
constexpr u64 kUPosInf = 0xFFF0000000000000ull;   // +inf and every invalid row
constexpr u64 kUNegInf = 0x000FFFFFFFFFFFFFull;   // -inf
constexpr u64 kMask21 = (1ull << 21) - 1;
constexpr int kStages = 23;

__device__ __forceinline__ u64 ukey_of(double x, bool valid) {
  if (!valid) return kUPosInf;
  if (isnan(x)) return kUNan;
  if (x == 0.0) return kUZero;
  const i64 b = __double_as_longlong(x);
  return b < 0 ? ~(u64)b : (u64)b ^ kSign;
}

// The canonical f64 of a key (+0.0 for the zero key).
__device__ __forceinline__ double value_of(u64 u) {
  return __longlong_as_double((i64)((u & kSign) ? (u ^ kSign) : ~u));
}

// w = the smallest power of two with w * k >= m (at least 1), and the
// number of strata m / w (ops/kll_device.py:strata_weight).
__device__ __forceinline__ void strata_of(u64 m, int k, u64* w, u64* ns) {
  u64 ratio = (m + (u64)k - 1) / (u64)k;
  if (ratio < 1) ratio = 1;
  u64 p = 1;
  while (p < ratio) p <<= 1;
  *w = p;
  *ns = m / p;
}

template <typename T>
__device__ __forceinline__ T warp_inclusive(T v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(kAll, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// Exclusive scan of v over the block (a multiple of 32 threads), the total
// in *total; sums is 33 slots of shared memory.
template <typename T>
__device__ T block_exclusive(T v, T* sums, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const T incl = warp_inclusive(v, lane);
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const T s = lane < warps ? sums[lane] : T(0);
    const T si = warp_inclusive(s, lane);
    if (lane < warps) sums[lane] = si - s;
    if (lane == 31) sums[32] = si;
  }
  __syncthreads();
  const T out = sums[warp] + incl - v;
  *total = sums[32];
  __syncthreads();
  return out;
}

// The scratch: per column the stats of the first pass, the passes' source
// and survivors, per target (in ascending rank order j) its prefix, rank
// left and interval, per interval its prefix, per target (in the caller's
// order t) its key and tie rank, the counts of one pass (R x 256 a column),
// and per tile the remainder's counts and candidate bits.
struct Work {
  i64 K, n, W, cap, span;
  int R, k, tiles, blocks;  // blocks a column of the pass and remainder grids
  u64* count;   // [K] valid rows
  u64* umin;    // [K] least key of a valid non-NaN row
  u64* umax;    // [K] greatest key of a valid non-NaN row
  u32* nan;     // [K] a valid NaN seen
  int* D;       // [K] intervals of the current pass
  int* source;  // [K] where the current pass reads its keys (Source)
  u32* nsurv;   // [K] survivors kept
  u64* surv;    // [K, cap] their keys
  int* order;   // [K, R] the target at rank position j
  u64* pfx;     // [K, R] resolved prefix of target j
  i64* rrem;    // [K, R] rank of target j inside its interval
  int* dj;      // [K, R] interval of target j
  u32* bcnt;    // [K, R] rows in target j's next interval
  u64* utab;    // [K, R] prefix of interval d, ascending
  i64* keys;    // [K, R] signed key of target t
  i64* tie;     // [K, R] rank of target t inside its key's ties
  u32* hist;    // [K, R, 256] counts of one pass
  u32* tcnt;    // [K, tiles, 5] remainder counts a tile
  u32* tpre;    // [K, tiles, 5] the same, exclusive prefix over the tiles
  u32* cand;    // [K, tiles, kTile / 32] a bit a row: a row of the remainder's counts
};

size_t carve(Work& w, char* base, bool own_keys) {
  size_t off = 0;
  auto take = [&](auto*& p, size_t count) {
    typedef std::remove_reference_t<decltype(*p)> T;
    off = (off + 255) & ~(size_t)255;
    if (base != nullptr) p = reinterpret_cast<T*>(base + off);
    off += count * sizeof(T);
  };
  const size_t K = (size_t)w.K, KR = K * (size_t)w.R, KT = K * (size_t)w.tiles * kCounts;
  take(w.count, K);
  take(w.umin, K);
  take(w.umax, K);
  take(w.nan, K);
  take(w.D, K);
  take(w.source, K);
  take(w.nsurv, K);
  take(w.surv, K * (size_t)w.cap);
  take(w.order, KR);
  take(w.pfx, KR);
  take(w.rrem, KR);
  take(w.dj, KR);
  take(w.bcnt, KR);
  take(w.utab, KR);
  if (own_keys) {
    take(w.keys, KR);
    take(w.tie, KR);
  }
  take(w.hist, KR * kBins);
  take(w.tcnt, KT);
  take(w.tpre, KT);
  take(w.cand, K * (size_t)w.tiles * (kTile / 32));
  return off;
}

// -- kernels ---------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) init_kernel(Work w) {
  const int c = blockIdx.x;
  if (threadIdx.x == 0) {
    w.count[c] = 0;
    w.umin[c] = kUPosInf;
    w.umax[c] = kUNegInf;
    w.nan[c] = 0;
    w.source[c] = kFull;
  }
  w.hist[(size_t)c * w.R * kBins + threadIdx.x] = 0;  // pass 1's one interval
}

// A thread's run of equal bins, added once.
struct Run {
  int bin;
  u32 n;
};

__device__ __forceinline__ void add(Run& run, int bin, u32* counts) {
  if (bin == run.bin) {
    ++run.n;
    return;
  }
  if (run.bin >= 0) atomicAdd(counts + run.bin, run.n);
  run.bin = bin;
  run.n = 1;
}

__device__ __forceinline__ u32 filter_slot(u64 prefix) {
  return (u32)((prefix * 0x9E3779B97F4A7C15ull) >> 48);
}

// One pass's view of a column: its intervals and where it counts.
struct Intervals {
  const u64* tab;
  const u32* filter;  // nullptr: none
  u64 tmin, tmax;
  int D, shift;
  u32* counts;

  // The interval of a key's resolved prefix, or -1.
  __device__ __forceinline__ int find(u64 key) const {
    const u64 hp = key >> (shift + 8);
    if (hp < tmin || hp > tmax) return -1;
    if (D == 1) return 0;
    if (filter != nullptr) {
      const u32 h = filter_slot(hp);
      if (!((filter[h >> 5] >> (h & 31)) & 1u)) return -1;
    }
    int a = 0, b = D;  // the first interval whose prefix is >= hp
    while (a < b) {
      const int mid = (a + b) >> 1;
      if (tab[mid] < hp) a = mid + 1;
      else b = mid;
    }
    return tab[a] == hp ? a : -1;
  }
};

// Sets up a block's shared memory for pass p of column c: the intervals'
// prefixes (up to kSharedTab), their filter (past kSharedRows intervals, up
// to kFilterMax), the counts (while kSharedRows intervals fit), zeroed or
// copied; then syncs.
__device__ Intervals block_intervals(const Work& w, int c, int p, u64* smem) {
  u64* stab = smem;
  u32* filter = reinterpret_cast<u32*>(smem + kSharedTab);
  u32* shist = filter + kFilterWords;
  Intervals iv;
  iv.D = p == 0 ? 1 : w.D[c];
  iv.shift = 56 - 8 * p;
  const u64* gtab = w.utab + (size_t)c * w.R;
  const bool tab_shared = p > 0 && iv.D <= kSharedTab;
  const bool filtered = p > 0 && iv.D > kSharedRows && iv.D <= kFilterMax;
  const bool in_shared = iv.D <= kSharedRows;
  if (in_shared)
    for (int i = threadIdx.x; i < iv.D * kBins; i += blockDim.x) shist[i] = 0;
  if (tab_shared)
    for (int i = threadIdx.x; i < iv.D; i += blockDim.x) stab[i] = gtab[i];
  if (filtered)
    for (int i = threadIdx.x; i < kFilterWords; i += blockDim.x) filter[i] = 0;
  __syncthreads();
  if (filtered) {
    for (int i = threadIdx.x; i < iv.D; i += blockDim.x) {
      const u32 h = filter_slot(gtab[i]);
      atomicOr(filter + (h >> 5), 1u << (h & 31));
    }
    __syncthreads();
  }
  iv.tab = tab_shared ? stab : gtab;
  iv.filter = filtered ? filter : nullptr;
  iv.tmin = p == 0 ? 0 : iv.tab[0];
  iv.tmax = p == 0 ? 0 : iv.tab[iv.D - 1];
  iv.counts = in_shared ? shist : w.hist + (size_t)c * w.R * kBins;
  return iv;
}

// Adds a block's shared counts to the column's.
__device__ void flush_counts(const Work& w, int c, const Intervals& iv, u64* smem) {
  const u32* shist = reinterpret_cast<const u32*>(smem + kSharedTab) + kFilterWords;
  if (iv.counts != shist) return;
  __syncthreads();
  u32* g = w.hist + (size_t)c * w.R * kBins;
  for (int i = threadIdx.x; i < iv.D * kBins; i += blockDim.x)
    if (shist[i]) atomicAdd(g + i, shist[i]);
}

// Pass p (0-based) over one span of one column's X and M: counts byte
// 7 - p of the key of every row whose higher bytes equal an interval's
// prefix. kFirstPass also folds count, min and max; kCompact also keeps
// those rows' keys. A block whose column's pass reads elsewhere returns.
enum PassMode { kFirstPass = 0, kFullPass = 1, kCompactPass = 2 };

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    pass_kernel(const double* __restrict__ X, const unsigned char* __restrict__ M, Work w,
                int p) {
  extern __shared__ u64 smem[];
  const int c = blockIdx.y;
  if (kMode != kFirstPass && w.source[c] != (kMode == kCompactPass ? kCompact : kFull)) return;
  const i64 lo = (i64)blockIdx.x * w.span;
  if (lo >= w.n) return;
  const i64 hi = lo + w.span < w.n ? lo + w.span : w.n;
  const Intervals iv = block_intervals(w, c, kMode == kFirstPass ? 0 : p, smem);
  const double* x = X + (size_t)c * w.n;
  const unsigned char* m = M + (size_t)c * w.n;
  u64* surv = w.surv + (size_t)c * w.cap;
  const int lane = threadIdx.x & 31;

  Run run = {-1, 0};
  u32 cnt = 0, nan = 0;
  u64 umin = kUPosInf, umax = kUNegInf;
  for (i64 e0 = lo; e0 < hi; e0 += (i64)kThreads * kUnroll) {  // the same steps for all
    double v[kUnroll];
    unsigned char ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // loads first: kUnroll rows in flight
      const i64 e = e0 + (i64)u * kThreads + threadIdx.x;
      v[u] = e < hi ? __ldcs(x + e) : 0.0;
      ok[u] = e < hi ? __ldcs(m + e) : 0;
    }
    u64 kept[kUnroll];
    int nk = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (e0 + (i64)u * kThreads + threadIdx.x >= hi) continue;
      const u64 key = ukey_of(v[u], ok[u] != 0);
      if (kMode == kFirstPass) {
        if (ok[u]) {
          ++cnt;
          if (key == kUNan) {
            nan = 1;
          } else {
            umin = key < umin ? key : umin;
            umax = key > umax ? key : umax;
          }
        }
        add(run, (int)(key >> 56), iv.counts);
        continue;
      }
      const int d = iv.find(key);
      if (d < 0) continue;
      add(run, d * kBins + (int)((key >> iv.shift) & 0xFF), iv.counts);
      if (kMode == kCompactPass) kept[nk++] = key;
    }
    if (kMode == kCompactPass) {  // one slot claim a warp a step
      const u32 incl = warp_inclusive((u32)nk, lane);
      u32 at = 0;
      if (lane == 31 && incl) at = atomicAdd(w.nsurv + c, incl);
      at = __shfl_sync(kAll, at, 31) + incl - (u32)nk;
      for (int q = 0; q < nk; ++q) surv[at + q] = kept[q];
    }
  }
  if (run.bin >= 0) atomicAdd(iv.counts + run.bin, run.n);
  if (kMode == kFirstPass) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      cnt += __shfl_xor_sync(kAll, cnt, o);
      nan |= __shfl_xor_sync(kAll, nan, o);
      const u64 a = __shfl_xor_sync(kAll, umin, o), b = __shfl_xor_sync(kAll, umax, o);
      umin = a < umin ? a : umin;
      umax = b > umax ? b : umax;
    }
    if (lane == 0) {
      if (cnt) atomicAdd(w.count + c, (u64)cnt);
      if (nan) atomicOr(w.nan + c, 1u);
      if (umin != kUPosInf) atomicMin(w.umin + c, umin);
      if (umax != kUNegInf) atomicMax(w.umax + c, umax);
    }
  }
  flush_counts(w, c, iv, smem);
}

// Pass p over one tile of a column's survivors (the keys its compacting
// pass kept), for a column that reads them.
__global__ void __launch_bounds__(kThreads) survivor_pass_kernel(Work w, int p) {
  extern __shared__ u64 smem[];
  const int c = blockIdx.y;
  if (w.source[c] != kSurvivors) return;
  const i64 n = w.nsurv[c];
  const i64 span = (n + gridDim.x - 1) / gridDim.x;
  const i64 lo = (i64)blockIdx.x * span;
  if (lo >= n) return;
  const i64 hi = lo + span < n ? lo + span : n;
  const Intervals iv = block_intervals(w, c, p, smem);
  const u64* surv = w.surv + (size_t)c * w.cap;
  Run run = {-1, 0};
  for (i64 e0 = lo + threadIdx.x; e0 < hi; e0 += (i64)kThreads * kUnroll) {
    u64 keys[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const i64 e = e0 + (i64)u * kThreads;
      keys[u] = e < hi ? surv[e] : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (e0 + (i64)u * kThreads >= hi) continue;
      const int d = iv.find(keys[u]);
      if (d >= 0) add(run, d * kBins + (int)((keys[u] >> iv.shift) & 0xFF), iv.counts);
    }
  }
  if (run.bin >= 0) atomicAdd(iv.counts + run.bin, run.n);
  flush_counts(w, c, iv, smem);
}

// The summary's targets, in ascending rank order: the strata midpoints
// below n_strata, r0, the padding strata (clipped to m - 1), m - 1.
__global__ void __launch_bounds__(kThreads) summary_targets_kernel(Work w) {
  const int c = blockIdx.y;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= w.R) return;
  const u64 m = w.count[c];
  const u64 top = m > 0 ? m - 1 : 0;
  u64 wt, ns;
  strata_of(m, w.k, &wt, &ns);
  u64 rank;
  int pos;
  if (t < w.k) {
    rank = (u64)t * wt + wt / 2;
    pos = (u64)t < ns ? t : t + 1;
  } else if (t == w.k) {
    rank = ns * wt;
    pos = (int)ns;
  } else {
    rank = top;
    pos = w.k + 1;
  }
  rank = rank < top ? rank : top;
  const size_t j = (size_t)c * w.R + pos;
  w.order[j] = t;
  w.rrem[j] = (i64)rank;
  w.pfx[j] = 0;
  w.dj[j] = 0;
  if (t == 0) w.D[c] = 1;
}

__device__ __forceinline__ i64 clamp_rank(i64 r, i64 n) {
  return r < 0 ? 0 : (r >= n ? n - 1 : r);
}

// Given ranks in any order: each target's position in ascending rank order
// (ties by target index), by counting.
__global__ void __launch_bounds__(kResolveThreads)
    given_targets_kernel(Work w, const i64* __restrict__ ranks) {
  const int c = blockIdx.x;
  const size_t b = (size_t)c * w.R;
  for (int t = threadIdx.x; t < w.R; t += blockDim.x) {
    const i64 r = clamp_rank(ranks[b + t], w.n);
    int pos = 0;
    for (int i = 0; i < w.R; ++i) {
      const i64 ri = clamp_rank(ranks[b + i], w.n);
      pos += ri < r || (ri == r && i < t);
    }
    w.order[b + pos] = t;
    w.rrem[b + pos] = r;
    w.pfx[b + pos] = 0;
    w.dj[b + pos] = 0;
  }
  if (threadIdx.x == 0) w.D[c] = 1;
}

// After pass p, a warp a target: its byte (the first whose cumulative
// count in its interval's row passes the target's rank), the rank left
// inside it, and the rows inside its next interval.
__global__ void __launch_bounds__(kResolveThreads)
    resolve_targets_kernel(Work w, int p, i64* trace_pfx, i64* trace_rrem) {
  const int c = blockIdx.y, R = w.R;
  const int j = blockIdx.x * (kResolveThreads / 32) + (threadIdx.x >> 5);
  if (j >= R) return;
  const size_t base = (size_t)c * R;
  const int lane = threadIdx.x & 31;
  const uint4* row =
      reinterpret_cast<const uint4*>(w.hist + (base + (size_t)w.dj[base + j]) * kBins);
  const uint4 a = row[2 * lane], b = row[2 * lane + 1];
  const u32 v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  u32 s = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) s += v[q];
  const u32 incl = warp_inclusive(s, lane);
  const i64 r = w.rrem[base + j];
  // the first bin whose cumulative count passes r (the last bin if none)
  const u32 hit = __ballot_sync(kAll, (i64)incl > r);
  const int L = hit ? __ffs(hit) - 1 : 31;
  int bucket = 0;
  u32 below = 0, inside = 0;
  if (lane == L) {
    u32 cum = incl - s;
    int q = 0;
    for (; q < 7; ++q) {
      if ((i64)(cum + v[q]) > r) break;
      cum += v[q];
    }
    bucket = lane * 8 + q;
    below = cum;
    inside = v[q];
  }
  bucket = __shfl_sync(kAll, bucket, L);
  below = __shfl_sync(kAll, below, L);
  inside = __shfl_sync(kAll, inside, L);
  if (lane == 0) {
    const u64 np = (w.pfx[base + j] << 8) | (u64)bucket;
    const i64 nr = r - (i64)below;
    w.pfx[base + j] = np;
    w.rrem[base + j] = nr;
    w.bcnt[base + j] = inside;
    if (trace_pfx != nullptr) {
      const size_t t = ((size_t)c * kPasses + p) * R + w.order[base + j];
      trace_pfx[t] = (i64)np;
      trace_rrem[t] = nr;
    }
  }
}

// After pass p, a block a column: the next pass's intervals (the distinct
// prefixes, ascending; a target's interval is the number of distinct
// prefixes up to its own, less one), the rows inside them and where that
// pass reads; after the last pass, each target's key and tie rank in the
// caller's order.
__global__ void __launch_bounds__(kResolveThreads) resolve_intervals_kernel(Work w, int p) {
  __shared__ int sums[33];
  __shared__ u64 wide[33];
  const int c = blockIdx.x, R = w.R;
  const size_t base = (size_t)c * R;
  if (p == kPasses - 1) {
    for (int j = threadIdx.x; j < R; j += kResolveThreads) {
      const int t = w.order[base + j];
      w.keys[base + t] = (i64)(w.pfx[base + j] ^ kSign);
      w.tie[base + t] = w.rrem[base + j];
    }
    return;
  }
  int carry = 0;
  u64 rows = 0;  // rows inside the intervals this thread heads
  for (int j0 = 0; j0 < R; j0 += kResolveThreads) {
    const int j = j0 + threadIdx.x;
    int head = 0;
    u64 pj = 0;
    if (j < R) {
      pj = w.pfx[base + j];
      head = j == 0 || pj != w.pfx[base + j - 1];
    }
    int total;
    const int before = carry + block_exclusive(head, sums, &total);
    if (j < R) {
      w.dj[base + j] = before + head - 1;
      if (head) {
        w.utab[base + before] = pj;
        rows += w.bcnt[base + j];
      }
    }
    carry += total;
  }
  u64 inside;
  block_exclusive(rows, wide, &inside);
  if (threadIdx.x == 0) {
    w.D[c] = carry;
    // the next pass reads X and M, or keeps its rows' keys, or reads them
    const int src = w.source[c];
    if (src == kFull && inside <= (u64)w.cap) {
      w.source[c] = kCompact;
      w.nsurv[c] = 0;
    } else if (src == kCompact) {
      w.source[c] = kSurvivors;
    }
  }
}

// Zeroes the counts the next pass uses: D x 256 a column.
__global__ void __launch_bounds__(kThreads) zero_counts_kernel(Work w) {
  const int c = blockIdx.y;
  u32* hist = w.hist + (size_t)c * w.R * kBins;
  const size_t n = (size_t)w.D[c] * kBins;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (size_t)gridDim.x * kThreads)
    hist[i] = 0;
}

// The remainder's ends of a column: the keys and tie ranks at r0 and m - 1.
struct Ends {
  u64 ub, ut;
  i64 j0, j1;
  bool any;
};

__device__ __forceinline__ Ends ends_of(const Work& w, int c) {
  u64 wt, ns;
  const u64 m = w.count[c];
  strata_of(m, w.k, &wt, &ns);
  const size_t b = (size_t)c * w.R + w.k;
  Ends e;
  e.any = ns * wt < m;
  e.ub = (u64)w.keys[b] ^ kSign;
  e.ut = (u64)w.keys[b + 1] ^ kSign;
  e.j0 = w.tie[b];
  e.j1 = w.tie[b + 1];
  return e;
}

// A row of the remainder: strictly between the ends' keys, or on an end's
// key at a tie rank inside the remainder's share of that key's ties.
struct Flags {
  bool strict, at_lo, at_hi;
};

__device__ __forceinline__ Flags flags_of(const Ends& e, u64 key, bool in) {
  Flags f;
  f.strict = in && key > e.ub && key < e.ut;
  f.at_lo = in && key == e.ub;
  f.at_hi = in && e.ut != e.ub && key == e.ut;
  return f;
}

// The ties at r0's key before the one with tie rank q that lie in the
// remainder; the same at m - 1's key (apart from r0's).
__device__ __forceinline__ i64 lo_before(const Ends& e, i64 q) {
  const i64 lim = e.ut != e.ub ? q : (q < e.j1 + 1 ? q : e.j1 + 1);
  return lim > e.j0 ? lim - e.j0 : 0;
}
__device__ __forceinline__ i64 hi_before(const Ends& e, i64 q) {
  return e.ut != e.ub ? (q < e.j1 + 1 ? q : e.j1 + 1) : 0;
}

// Loads kUnroll rows a thread (row e0 + u * kThreads + threadIdx.x) and
// their keys; rows at or past hi get key 0, which no flag takes.
__device__ __forceinline__ void load_keys(const double* __restrict__ x,
                                          const unsigned char* __restrict__ m, i64 e0, i64 hi,
                                          u64* key) {
  double v[kUnroll];
  unsigned char ok[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {  // loads first: kUnroll rows in flight
    const i64 r = e0 + (i64)u * kThreads + threadIdx.x;
    v[u] = r < hi ? __ldcs(x + r) : 0.0;
    ok[u] = r < hi ? __ldcs(m + r) : 0;
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    key[u] = e0 + (i64)u * kThreads + threadIdx.x < hi ? ukey_of(v[u], ok[u] != 0) : 0;
}

// Per tile of kTile rows: the remainder's rows strictly between its ends,
// the rows on each end's key, on the zero key and on the NaN key.
__global__ void __launch_bounds__(kThreads)
    remainder_count_kernel(const double* __restrict__ X, const unsigned char* __restrict__ M,
                           Work w) {
  __shared__ u32 sums[kCounts];
  const int c = blockIdx.y;
  const Ends e = ends_of(w, c);
  const double* x = X + (size_t)c * w.n;
  const unsigned char* m = M + (size_t)c * w.n;
  for (int tile = blockIdx.x; tile < w.tiles; tile += gridDim.x) {
    const i64 lo = (i64)tile * kTile;
    const i64 hi = lo + kTile < w.n ? lo + kTile : w.n;
    u32* cand = w.cand + ((size_t)c * w.tiles + tile) * (kTile / 32);
    if (threadIdx.x < kCounts) sums[threadIdx.x] = 0;
    __syncthreads();
    u32 n[kCounts] = {0, 0, 0, 0, 0};
    for (i64 e0 = lo; e0 < hi; e0 += (i64)kThreads * kUnroll) {
      u64 key[kUnroll];
      load_keys(x, m, e0, hi, key);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool in = e0 + (i64)u * kThreads + threadIdx.x < hi;
        const Flags f = flags_of(e, key[u], in);
        const u32 strict = __ballot_sync(kAll, f.strict), at_lo = __ballot_sync(kAll, f.at_lo),
                  at_hi = __ballot_sync(kAll, f.at_hi);
        n[0] += __popc(strict);
        n[1] += __popc(at_lo);
        n[2] += __popc(at_hi);
        n[3] += __popc(__ballot_sync(kAll, in && key[u] == kUZero));
        n[4] += __popc(__ballot_sync(kAll, in && key[u] == kUNan));
        if ((threadIdx.x & 31) == 0)
          cand[(e0 - lo + (i64)u * kThreads + threadIdx.x) >> 5] = strict | at_lo | at_hi;
      }
    }
    if ((threadIdx.x & 31) == 0)
      for (int q = 0; q < kCounts; ++q) atomicAdd(sums + q, n[q]);
    __syncthreads();
    if (threadIdx.x < kCounts)
      w.tcnt[((size_t)c * w.tiles + tile) * kCounts + threadIdx.x] = sums[threadIdx.x];
    for (i64 word = ((hi - lo + 31) >> 5) + threadIdx.x; word < kTile / 32; word += kThreads)
      cand[word] = 0;  // the short last tile's unread words
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kResolveThreads) tile_scan_kernel(Work w) {
  __shared__ u32 sums[33];
  const int c = blockIdx.x;
  const size_t base = (size_t)c * w.tiles * kCounts;
  for (int q = 0; q < kCounts; ++q) {
    u32 carry = 0;
    for (int t0 = 0; t0 < w.tiles; t0 += kResolveThreads) {
      const int t = t0 + threadIdx.x;
      const u32 v = t < w.tiles ? w.tcnt[base + (size_t)t * kCounts + q] : 0;
      u32 total;
      const u32 before = block_exclusive(v, sums, &total);
      if (t < w.tiles) w.tpre[base + (size_t)t * kCounts + q] = carry + before;
      carry += total;
    }
  }
}

// A dense tile of the remainder write (most rows candidates: ties of a
// constant column): steps of kThreads * kUnroll rows read coalesced, their
// flags staged in shared memory, then each thread walks kUnroll
// consecutive rows from its place in one block scan.
__device__ void write_dense_tile(const double* __restrict__ x,
                                 const unsigned char* __restrict__ m, const Ends& e, i64 lo,
                                 i64 hi, i64 S, i64 B, i64 T, i64 W, double* __restrict__ out,
                                 u64* sums, unsigned char* staged) {
  constexpr int kStep = kThreads * kUnroll;
  for (i64 e0 = lo; e0 < hi; e0 += kStep) {
    u64 key[kUnroll];
    load_keys(x, m, e0, hi, key);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const Flags f = flags_of(e, key[u], e0 + (i64)u * kThreads + threadIdx.x < hi);
      staged[u * kThreads + threadIdx.x] =
          (unsigned char)(f.strict | (f.at_lo << 1) | (f.at_hi << 2));
    }
    __syncthreads();
    unsigned char mine[kUnroll];
    u64 count = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      mine[u] = staged[threadIdx.x * kUnroll + u];
      count += (u64)(mine[u] & 1) | ((u64)((mine[u] >> 1) & 1) << 21) |
               ((u64)(mine[u] >> 2) << 42);
    }
    u64 total;
    const u64 before = block_exclusive(count, sums, &total);  // also orders staged's reuse
    i64 s = S + (i64)(before & kMask21);
    i64 b = B + (i64)((before >> 21) & kMask21);
    i64 h = T + (i64)(before >> 42);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool strict = mine[u] & 1, at_lo = (mine[u] >> 1) & 1, at_hi = mine[u] >> 2;
      const bool take = strict || (at_lo && b >= e.j0 && (e.ut != e.ub || b <= e.j1)) ||
                        (at_hi && h <= e.j1);
      if (take) {
        const i64 slot = s + lo_before(e, b) + hi_before(e, h);
        const i64 r = e0 + (i64)threadIdx.x * kUnroll + u;
        if (slot < W) out[slot] = m[r] ? x[r] : INFINITY;
      }
      s += strict;
      b += at_lo;
      h += at_hi;
    }
    S += (i64)(total & kMask21);
    B += (i64)((total >> 21) & kMask21);
    T += (i64)(total >> 42);
  }
}

// Writes each remainder row of each tile into its slot: the remainder
// rows before it in row order. A thread takes one word of the tile's
// candidate bits (32 rows) and reads only the rows marked there: one walk
// counts them, one block scan places the thread, a second walk writes. A
// tile with no candidate is not read; a tile of mostly candidates is read
// whole, coalesced (write_dense_tile).
__global__ void __launch_bounds__(kThreads)
    remainder_write_kernel(const double* __restrict__ X, const unsigned char* __restrict__ M,
                           Work w, double* __restrict__ items) {
  static_assert(kTile == 32 * kThreads, "a word of candidate bits a thread");
  __shared__ u64 sums[33];
  __shared__ unsigned char staged[kThreads * kUnroll];
  const int c = blockIdx.y;
  const Ends e = ends_of(w, c);
  if (!e.any) return;
  const double* x = X + (size_t)c * w.n;
  const unsigned char* m = M + (size_t)c * w.n;
  double* out = items + (size_t)c * (w.k + w.W) + w.k;
  for (int tile = blockIdx.x; tile < w.tiles; tile += gridDim.x) {
    const size_t t = ((size_t)c * w.tiles + tile) * kCounts;
    const u32 marked = w.tcnt[t] + w.tcnt[t + 1] + w.tcnt[t + 2];
    if (marked == 0) continue;
    if (marked > kTile / 8) {
      const i64 lo = (i64)tile * kTile;
      write_dense_tile(x, m, e, lo, lo + kTile < w.n ? lo + kTile : w.n, w.tpre[t],
                       w.tpre[t + 1], w.tpre[t + 2], w.W, out, sums, staged);
      continue;
    }
    const i64 first = (i64)tile * kTile + 32 * threadIdx.x;
    const u32 word = w.cand[((size_t)c * w.tiles + tile) * (kTile / 32) + threadIdx.x];
    u64 count = 0;
    for (u32 bits = word; bits; bits &= bits - 1) {
      const i64 r = first + __ffs(bits) - 1;
      const Flags f = flags_of(e, ukey_of(x[r], m[r] != 0), true);
      count += (u64)f.strict | ((u64)f.at_lo << 21) | ((u64)f.at_hi << 42);
    }
    u64 total;
    const u64 before = block_exclusive(count, sums, &total);
    i64 s = w.tpre[t] + (i64)(before & kMask21);
    i64 b = w.tpre[t + 1] + (i64)((before >> 21) & kMask21);
    i64 h = w.tpre[t + 2] + (i64)(before >> 42);
    for (u32 bits = word; bits; bits &= bits - 1) {
      const i64 r = first + __ffs(bits) - 1;
      const double v = x[r];
      const bool ok = m[r] != 0;
      const Flags f = flags_of(e, ukey_of(v, ok), true);
      const bool take = f.strict || (f.at_lo && b >= e.j0 && (e.ut != e.ub || b <= e.j1)) ||
                        (f.at_hi && h <= e.j1);
      if (take) {
        const i64 slot = s + lo_before(e, b) + hi_before(e, h);
        if (slot < w.W) out[slot] = ok ? v : INFINITY;
      }
      s += f.strict;
      b += f.at_lo;
      h += f.at_hi;
    }
  }
}

// A warp a stratum on the zero or NaN key: the row holding that key's
// (tie rank)-th occurrence in row order gives the item.
__global__ void __launch_bounds__(kThreads)
    tie_rows_kernel(const double* __restrict__ X, const unsigned char* __restrict__ M, Work w,
                    double* __restrict__ items) {
  const int c = blockIdx.y;
  const int i = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= w.k) return;
  u64 wt, ns;
  strata_of(w.count[c], w.k, &wt, &ns);
  if ((u64)i >= ns) return;
  const size_t b = (size_t)c * w.R + i;
  const u64 key = (u64)w.keys[b] ^ kSign;
  if (key != kUZero && key != kUNan) return;
  const int which = key == kUZero ? 3 : 4;
  const u32* pre = w.tpre + (size_t)c * w.tiles * kCounts + which;
  const i64 q = w.tie[b];
  int a = 0, z = w.tiles - 1;  // the last tile whose prefix is <= q
  while (a < z) {
    const int mid = (a + z + 1) >> 1;
    if ((i64)pre[(size_t)mid * kCounts] <= q) a = mid;
    else z = mid - 1;
  }
  i64 left = q - (i64)pre[(size_t)a * kCounts];
  const i64 lo = (i64)a * kTile;
  const i64 hi = lo + kTile < w.n ? lo + kTile : w.n;
  const double* x = X + (size_t)c * w.n;
  const unsigned char* m = M + (size_t)c * w.n;
  for (i64 e0 = lo; e0 < hi; e0 += 32 * kUnroll) {
    double v[kUnroll];
    unsigned char ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // loads first: kUnroll rows in flight
      const i64 r = e0 + u * 32 + lane;
      v[u] = r < hi ? x[r] : 0.0;
      ok[u] = r < hi ? m[r] : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const i64 r = e0 + u * 32 + lane;
      u32 bits = __ballot_sync(kAll, r < hi && ukey_of(v[u], ok[u] != 0) == key);
      const int n = __popc(bits);
      if (left < n) {
        for (i64 s = 0; s < left; ++s) bits &= bits - 1;
        if (lane == 0) items[(size_t)c * (w.k + w.W) + i] = x[e0 + u * 32 + __ffs(bits) - 1];
        return;
      }
      left -= n;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    assemble_kernel(Work w, double* __restrict__ items, double* __restrict__ weights,
                    i64* __restrict__ count, double* __restrict__ mn, double* __restrict__ mx) {
  const int c = blockIdx.y;
  const i64 s = (i64)blockIdx.x * kThreads + threadIdx.x;
  if (s >= w.k + w.W) return;
  const u64 m = w.count[c];
  u64 wt, ns;
  strata_of(m, w.k, &wt, &ns);
  const u64 r0 = ns * wt;
  const u64 n_rem = r0 < m ? m - r0 : 0;
  const size_t o = (size_t)c * (w.k + w.W) + s;
  if (s < w.k) {
    if ((u64)s < ns) {
      weights[o] = (double)wt;
      const u64 key = (u64)w.keys[(size_t)c * w.R + s] ^ kSign;
      if (key != kUZero && key != kUNan) items[o] = value_of(key);  // else tie_rows_kernel's
    } else {
      weights[o] = 0.0;
      items[o] = 0.0;
    }
  } else if ((u64)(s - w.k) < n_rem) {
    weights[o] = 1.0;  // the item is remainder_write_kernel's
  } else {
    weights[o] = 0.0;
    items[o] = 0.0;
  }
  if (s == 0) {
    const double qnan = __longlong_as_double(0x7FF8000000000000ll);
    count[c] = (i64)m;
    mn[c] = w.nan[c] ? qnan : value_of(w.umin[c]);
    mx[c] = w.nan[c] ? qnan : value_of(w.umax[c]);
  }
}

// -- the host side ---------------------------------------------------------

// Events around each stage, read after the stream's work when ms is given.
struct Stages {
  float* ms;
  cudaStream_t stream;
  cudaEvent_t ev[kStages + 1];
  int n = 0;
  Stages(float* ms, cudaStream_t stream) : ms(ms), stream(stream) {
    if (ms == nullptr) return;
    cudaEventCreate(&ev[0]);
    cudaEventRecord(ev[0], stream);
  }
  void mark() {
    if (ms == nullptr || n >= kStages) return;
    ++n;
    cudaEventCreate(&ev[n]);
    cudaEventRecord(ev[n], stream);
  }
  void finish() {
    if (ms == nullptr) return;
    cudaEventSynchronize(ev[n]);
    for (int i = 0; i < n; ++i) cudaEventElapsedTime(ms + i, ev[i], ev[i + 1]);
    for (int i = 0; i <= n; ++i) cudaEventDestroy(ev[i]);
  }
};

bool shape_ok(long long K, long long n, int R) {
  return K >= 1 && K <= 65535 && n >= 1 && n < (1ll << 31) && R >= 1 && R <= (1 << 24);
}

void resolve(Work& w, int p, i64* trace_pfx, i64* trace_rrem, cudaStream_t s) {
  const int warps = kResolveThreads / 32;
  const dim3 targets((unsigned)((w.R + warps - 1) / warps), (unsigned)w.K);
  resolve_targets_kernel<<<targets, kResolveThreads, 0, s>>>(w, p, trace_pfx, trace_rrem);
  resolve_intervals_kernel<<<(unsigned)w.K, kResolveThreads, 0, s>>>(w, p);
  if (p < kPasses - 1) {
    const dim3 zero((unsigned)w.blocks, (unsigned)w.K);
    zero_counts_kernel<<<zero, kThreads, 0, s>>>(w);
  }
}

// Stages init, pass 1, targets, resolve 1, then pass and resolve 2..8.
int select_passes(const double* X, const unsigned char* M, Work& w, const i64* ranks,
                  i64* trace_pfx, i64* trace_rrem, cudaStream_t s, Stages& st) {
  cudaFuncSetAttribute(pass_kernel<kFirstPass>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kPassSmem);
  cudaFuncSetAttribute(pass_kernel<kFullPass>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kPassSmem);
  cudaFuncSetAttribute(pass_kernel<kCompactPass>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kPassSmem);
  cudaFuncSetAttribute(survivor_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kPassSmem);
  const dim3 tiles((unsigned)w.blocks, (unsigned)w.K);
  init_kernel<<<(unsigned)w.K, kThreads, 0, s>>>(w);
  st.mark();
  pass_kernel<kFirstPass><<<tiles, kThreads, kPassSmem, s>>>(X, M, w, 0);
  st.mark();
  if (ranks == nullptr) {
    const dim3 grid((unsigned)((w.R + kThreads - 1) / kThreads), (unsigned)w.K);
    summary_targets_kernel<<<grid, kThreads, 0, s>>>(w);
  } else {
    given_targets_kernel<<<(unsigned)w.K, kResolveThreads, 0, s>>>(w, ranks);
  }
  st.mark();
  resolve(w, 0, trace_pfx, trace_rrem, s);
  st.mark();
  const dim3 survivor_tiles((unsigned)w.blocks, (unsigned)w.K);
  for (int p = 1; p < kPasses; ++p) {
    pass_kernel<kFullPass><<<tiles, kThreads, kPassSmem, s>>>(X, M, w, p);
    pass_kernel<kCompactPass><<<tiles, kThreads, kPassSmem, s>>>(X, M, w, p);
    survivor_pass_kernel<<<survivor_tiles, kThreads, kPassSmem, s>>>(w, p);
    st.mark();
    resolve(w, p, trace_pfx, trace_rrem, s);
    st.mark();
  }
  return (int)cudaGetLastError();
}

// The sizes of a call; sms: the card's SMs (0 where no grid is launched).
void layout(Work& w, long long K, long long n, int R, int k, long long W, int sms) {
  w.K = K;
  w.n = n;
  w.R = R;
  w.k = k;
  w.W = W;
  w.tiles = (int)((n + kTile - 1) / kTile);
  const i64 share = n / kSurvivorShare;
  w.cap = share > kTile ? share : (n < kTile ? n : kTile);
  // about kWaves waves of resident blocks over the card, each a span of at
  // least kMinSpan rows, so a block's prologue and flush stay small
  i64 blocks = (i64)kWaves * kBlocksPerSm * sms / K;
  const i64 most = (n + kMinSpan - 1) / kMinSpan;
  blocks = blocks < most ? blocks : most;
  w.blocks = (int)(blocks > 1 ? blocks : 1);
  w.span = (n + w.blocks - 1) / w.blocks;
}

int sms_of(int* err) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *err = (int)e;
  return e == cudaSuccess ? sms : 0;
}

}  // namespace

extern "C" {

// Bytes of scratch a call over (K, n) values with R targets needs.
long long deequ_select_scratch_bytes(long long K, long long n, int R) {
  if (!shape_ok(K, n, R)) return -1;
  Work w;
  layout(w, K, n, R, 0, 0, 0);
  return (long long)carve(w, nullptr, true);
}

// The summary of each of K columns of n rows: X (K, n) f64, M (K, n) bool
// (one byte a row), k strata and W remainder slots into items and weights
// (K, k + W) f64, count (K,) int64, min and max (K,) f64. stage_ms: NULL,
// or kStages floats that receive each stage's milliseconds (the call then
// waits for the stream).
int deequ_select_summary(const void* X, const void* M, long long K, long long n, int k,
                         long long W, void* items, void* weights, void* count, void* mn,
                         void* mx, void* scratch, void* stream, float* stage_ms) {
  if (!shape_ok(K, n, k + 2) || k < 1 || W < 1) return (int)cudaErrorInvalidValue;
  int err = 0;
  const int sms = sms_of(&err);
  if (!sms) return err;
  Work w;
  layout(w, K, n, k + 2, k, W, sms);
  carve(w, static_cast<char*>(scratch), true);
  const double* x = static_cast<const double*>(X);
  const unsigned char* v = static_cast<const unsigned char*>(M);
  double* it = static_cast<double*>(items);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Stages st(stage_ms, s);
  err = select_passes(x, v, w, nullptr, nullptr, nullptr, s, st);
  if (err != 0) return err;
  const dim3 tiles((unsigned)w.blocks, (unsigned)K);
  remainder_count_kernel<<<tiles, kThreads, 0, s>>>(x, v, w);
  st.mark();
  tile_scan_kernel<<<(unsigned)K, kResolveThreads, 0, s>>>(w);
  st.mark();
  remainder_write_kernel<<<tiles, kThreads, 0, s>>>(x, v, w, it);
  st.mark();
  const dim3 ties((unsigned)((k + kThreads / 32 - 1) / (kThreads / 32)), (unsigned)K);
  tie_rows_kernel<<<ties, kThreads, 0, s>>>(x, v, w, it);
  st.mark();
  const dim3 slots((unsigned)((k + W + kThreads - 1) / kThreads), (unsigned)K);
  assemble_kernel<<<slots, kThreads, 0, s>>>(w, it, static_cast<double*>(weights),
                                             static_cast<i64*>(count), static_cast<double*>(mn),
                                             static_cast<double*>(mx));
  st.mark();
  err = (int)cudaGetLastError();
  st.finish();
  return err;
}

// The key (signed, the order-preserving key of the canonical f64) at each
// of R ranks of each column, and the rank inside that key's ties: ranks
// (K, R) int64, any order, each clipped into [0, n); keys and tie (K, R)
// int64. trace_pfx / trace_rrem: NULL, or (K, 8, R) int64 that receive each
// pass's resolved prefix (the key's top 8(p + 1) bits, unsigned) and rank
// left.
int deequ_select_ranks(const void* X, const void* M, long long K, long long n,
                       const void* ranks, int R, void* keys, void* tie, void* trace_pfx,
                       void* trace_rrem, void* scratch, void* stream) {
  if (!shape_ok(K, n, R)) return (int)cudaErrorInvalidValue;
  int err = 0;
  const int sms = sms_of(&err);
  if (!sms) return err;
  Work w;
  layout(w, K, n, R, 0, 1, sms);
  carve(w, static_cast<char*>(scratch), false);
  w.keys = static_cast<i64*>(keys);
  w.tie = static_cast<i64*>(tie);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Stages st(nullptr, s);
  return select_passes(static_cast<const double*>(X), static_cast<const unsigned char*>(M), w,
                       static_cast<const i64*>(ranks), static_cast<i64*>(trace_pfx),
                       static_cast<i64*>(trace_rrem), s, st);
}

}  // extern "C"
