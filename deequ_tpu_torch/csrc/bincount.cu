// Histogram of segment ids on Hopper (sm_90a).
//
// Replaces deequ_tpu/ops/histogram_device.py:bincount_pallas, the one Pallas
// kernel of the reference. It computes the same function: counts of ids over
// [0, num_segments), ids outside that range (negative sentinels, padding)
// dropped, optional int32 weights in place of the 1. Counts are int64, exact
// at any row count.
//
// Weighted domain (kernel and plain version alike): each bin's total is
// taken mod 2^32 and read as an int32, which is what the reference's int32
// accumulation gives; it is the exact total whenever that total lies in
// int32, whatever the partial sums along the way. Every partial here is a
// u32 that wraps, and the total is sign-extended once, at the end, so no
// block's partial can leave a range and disagree with the plain version.
//
// The TPU kernel compares every row tile against an iota of segment ids
// (O(n * num_segments) vector compares): a fit for the TPU's wide VPU and
// its sequential grid, ruinous here. The least this function can cost is
// reading the ids once (8 bytes a row for int64 ids) and writing the counts
// once (8 bytes a bin). On an H100 the atomics are what keep a histogram
// from that: shared-memory atomics keep pace with the memory, L2 atomics
// to scattered bins do not (10^7 of them take several times as long as
// reading 80 MB of ids). So the width picks one of three regimes, by one
// rule (regime() below), from the card's limits, read once per device:
//
// - shared (up to one u32 histogram in the shared memory a block may opt
//   into: 58,112 bins on an H100). Bound by reading the ids. One block of
//   1024 threads per SM, each with a private histogram in shared memory
//   (up to one copy per warp while they fit in 48 KB, so a few hot bins
//   spread their contention), fed by 16-byte evict-first vector loads
//   kept four deep in flight; each block then adds its non-zero bins to
//   the output with one 64-bit atomic each. One block per SM, not as many
//   as fit, keeps the zeroing and flushing (blocks x bins) small beside
//   the rows.
// - partition (to 2^25 bins): too wide for a histogram a block, too few
//   rows a bin for L2 atomics. Pass 1 reads the ids once, with evict-first
//   loads, sorts each tile of kTile rows by bucket (the id's high bits) in
//   shared memory, and writes each row as a u16 offset within its bucket,
//   plus the tile's bucket offsets: 2 bytes a row that stay in L2. It is
//   bound by the memory. Pass 2 gives each bucket (at most 32,768 bins;
//   about as many buckets as SMs) to one block, which counts its rows of
//   every tile in a shared-memory histogram and writes its bins of the
//   output once, with plain stores: no global atomic at all. Pass 2 is
//   bound by L2 latency (the runs a tile holds for one bucket are short)
//   and by shared-memory atomics; a skewed key space gives the block of its
//   hottest bucket more rows than the rest. More buckets (more blocks, each
//   walking every tile) and more histogram copies measured slower.
// - global (wider): every row adds straight into the 64-bit output with an
//   L2 atomic. Not reachable from the dense grouping path, which stops at
//   2^22 bins.
//
// Also measured and not taken for K5: a histogram spread over a
// thread-block cluster's shared memory (distributed shared-memory atomics
// were no faster than L2 atomics), two cluster passes over halves of a wide
// key space, and warp aggregation of equal keys (__match_any_sync costs
// more than it saves unless most of a warp's keys are equal).
//
// The multi-input entry (deequ_bincount_multi, K7) replaces the reference's
// cross-set grouping fusion, deequ_tpu/ops/segment.py:1035
// fused_group_counts, which offsets each set's int64 keys by the keyspaces
// before it on the host, concatenates them and counts the one vector with
// the Pallas kernel above (its _device_bincount, :1132). Here each set's
// keys stay as they were prepared, and the offset is added where a kernel
// loads an id: a row's slot is id + offset where id >= 0 (two's-complement
// wrap, as torch and numpy add) and -1 otherwise, then counted when inside
// [0, total). So the entry computes the reference's function bit for bit,
// even for ids outside their own keyspace. Only the shared and partition
// regimes take it (the dense grouping path stops at 2^22 bins); the global
// regime refuses it with cudaErrorInvalidValue.
//
// - shared (the summed keyspace fits a block's histogram): every input
//   walked in turn with the same vector loads into one block histogram.
// - partition: the summed keyspace is what is wide, not each set. What
//   bounds it is reading every key once and writing every count once: at
//   the main path's fused group (customer_id, status and region, 3 x 10^7
//   int64 keys over 1,078,737 + 9 + 5,001 bins) 240 MB in and 8.67 MB out,
//   0.0742 ms at 3.35 TB/s. A narrow input (own keyspace at most
//   kNarrowBins: status, region) would put all its rows in one bucket of
//   the summed space, so it is counted in a shared-memory histogram of its
//   own bins instead; a wide one (customer_id) goes through the partition
//   passes over the summed space. Two launches:
//   1. bincount_fused_read reads every input once, in one grid: the wide
//      inputs' pass-1 tiles and the narrow inputs' tiles are items of one
//      list, interleaved evenly, and each block (two of 512 threads an SM)
//      takes a contiguous run of it, so the narrow keys stream from memory
//      while the wide ones are sorted by bucket. Narrow counts (and the
//      ids past their own keyspace, with 64-bit atomics) go straight into
//      the zeroed out.
//   2. bincount_fused_bucket adds the wide inputs' buckets into out: a
//      cluster of kCluster blocks a bucket, the bucket the widest power of
//      two that still gives every SM a block (67 buckets of 2^14 bins, 134
//      blocks at the main path's shape, where one block a bucket over the
//      summed space had 67 blocks on 132 SMs). Each block counts its share
//      of the bucket's tile runs, read as packed 16-byte vectors, into its
//      own shared histogram; the cluster then sums the histograms once
//      through distributed shared memory, each block adding its slice of
//      the bins. A bucket's rows are split over its cluster, so one hot
//      bucket is counted on kCluster SMs.
//      Launch 1's atomics came first, so no bin has two writers in a
//      launch, and the narrow keys need not wait for pass 2 to store out
//      whole. It is launched as a programmatic dependent of launch 1
//      (griddepcontrol), so its blocks are set up while launch 1 drains.
//   In pass 1 a tile never straddles two inputs: each input's rows are cut
//   into tiles of their own, numbered one after the other, so a block reads
//   one pointer and one offset a tile, keeps its loads coalesced and needs
//   no lookup a row; the price is at most one partly filled tile an input.
//
//   Measured on an H100 (tools/time_k7.py, PERF.md): the kernel takes
//   about 0.127 ms at that shape (58% of its bound; the earlier route of
//   three kernels in series 0.161, the three single-input launches it
//   replaces 0.143), launch 1 0.100 and launch 2 0.025. What holds it
//   there: launch 1 writes the wide tiles' 20 MB of u16 keys beside its
//   240 MB of reads (without that write it takes 0.085 ms; the ranking
//   atomics, the scan and the stage scatter cost nothing beside it, and
//   the narrow counts 1 us), and launch 2 is bound by its shared-memory
//   atomics (14 us of its 25; 8 us is its fixed cost, with no rows).
//   Measured and not taken: dealing the items round-robin (with a grid a
//   multiple of 3 every block took one kind only: launch 1 0.135 ms);
//   copying each item's ids into shared memory with a bulk copy (TMA) two
//   items ahead, one block of 1024 threads an SM (launch 1 no faster: the
//   loads were never what it waited for); one block a bucket at 2^13 bins
//   (133 blocks; within 2% of the cluster); clusters of 4 at 2^15 bins
//   (launch 2 0.065 ms); three blocks an SM for launch 1 (registers
//   spilled, 0.119 ms); buckets of any width by a multiply-shift division,
//   so that launch 2 runs 66 clusters in one wave (no faster, and launch 1
//   paid for the division); 8 key vectors a lane in flight in launch 2,
//   two copies of region's histogram, 16-byte stores of the keys from the
//   stage, and evict-last stores of them (each within 1%, the last at the
//   risk of crowding L2 for later kernels).
//
// The inputs ride in the launch parameters, kMaxInputs at a time; longer
// lists, and rows past kChunkRows, run as further launches within the
// same call, which add into the output.
//
// Integer adds commute, so the result is bit-exact and deterministic. A
// launch counts at most kChunkRows rows at a time, so every u32 count is
// exact. The kernel allocates nothing: the caller passes the zeroed output
// and the scratch that deequ_bincount_scratch_bytes asks for. Plain C
// interface for ctypes; deequ_bincount returns the launch's
// cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

enum Regime { kShared = 0, kPartition = 1, kGlobal = 2, kRegimes = 3 };

constexpr int kThreads = 1024;          // shared and global regimes, pass 2
constexpr int kWarps = kThreads / 32;
constexpr int kTileThreads = 512;       // partition pass 1
constexpr int kRowsPerThread = 16;
constexpr int kTile = kTileThreads * kRowsPerThread;  // 8,192 rows
constexpr int kMaxBuckets = 1024;
constexpr int kMaxBucketShift = 15;     // u16 offsets: 32,768 bins a bucket
constexpr long long kChunkRows = 1ll << 31;
constexpr int kDefaultSmem = 48 * 1024;
constexpr long long kPartitionBins = (long long)kMaxBuckets << kMaxBucketShift;
constexpr int kMaxInputs = 64;          // inputs a multi-input launch carries

// The multi-input entry's partition route: an input is narrow when its own
// keyspace is at most kNarrowBins (one u32 copy of it fills kGroupWords);
// the launch's narrow inputs share a block histogram of at most kGroupWords
// words, in groups, each input kept in as many copies (one a warp, at most
// kTileThreads / 32) as fit kCopyWords words, so a few hot bins spread
// their contention over the warps.
#ifndef DEEQU_K7_COPY_WORDS
#define DEEQU_K7_COPY_WORDS 2048
#endif
// Launch 2's cluster: blocks a bucket. A probe build (tools/time_k7.py)
// may set DEEQU_K7_COPY_WORDS, DEEQU_K7_CLUSTER, DEEQU_K7_READ_BLOCKS and
// DEEQU_K7_KEY_VECS to compare; each DEEQU_K7_PROBE_* switch takes a phase
// out (NO_SORT: the wide tiles' partition; NO_SCATTER: its stage scatter
// and key write; NO_KEY_WRITE: the key write alone; NO_ATOMICS: the
// shared-memory counts; NO_REDUCE: launch 2's cluster sum; NO_FLUSH: the
// narrow flush) to time what it costs, and computes something else.
#ifndef DEEQU_K7_CLUSTER
#define DEEQU_K7_CLUSTER 2
#endif
constexpr int kGroupWords = 16384;
constexpr int kNarrowBins = kGroupWords;
constexpr int kCopyWords = DEEQU_K7_COPY_WORDS;
constexpr int kCluster = DEEQU_K7_CLUSTER;

// The inputs of one multi-input launch, passed by value: each one's int64
// ids, rows, offset and own keyspace, and (partition route) its first tile
// and, for a narrow input, where its histogram copies start in its
// group's, their number and its group. The partition route puts the wide
// inputs first (kw of them), then the narrow ones group by group.
struct Pieces {
  const long long* ids[kMaxInputs];
  long long n[kMaxInputs];
  unsigned long long off[kMaxInputs];
  int bins[kMaxInputs];
  int hist[kMaxInputs];
  int copies[kMaxInputs];
  int group[kMaxInputs];
  long long tile0[kMaxInputs + 1];  // tile0[k]: the launch's tiles
  int k, kw, hist_words;
};
static_assert(sizeof(Pieces) <= 4096, "a launch's parameters are at most 4 KB");

// -- the row walk of the shared and global regimes ---------------------------

template <typename Id> struct Vec16;
template <> struct Vec16<long long> {
  using T = longlong2;
  static constexpr int N = 2;
  __device__ static long long at(const T& v, int k) { return k == 0 ? v.x : v.y; }
  __device__ static T none() { return make_longlong2(-1, -1); }
};
template <> struct Vec16<int> {
  using T = int4;
  static constexpr int N = 4;
  __device__ static int at(const T& v, int k) {
    return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
  }
  __device__ static T none() { return make_int4(-1, -1, -1, -1); }
};

// Calls f(id, row) for every row. A block takes one contiguous range of
// 16-byte vectors and its threads keep four loads in flight; the few rows
// before the first aligned vector and after the last go to the first and
// last block.
template <typename Id, typename F>
__device__ __forceinline__ void walk(const Id* __restrict__ ids, long long n, F f) {
  using V = Vec16<Id>;
  using VT = typename V::T;
  constexpr int N = V::N;
  constexpr int U = 4;
  const long long mis = (long long)(((uintptr_t)ids & 15) / sizeof(Id));
  long long head = mis ? N - mis : 0;
  if (head > n) head = n;
  const long long nvec = (n - head) / N;
  const long long tail = head + nvec * N;
  const long long per = (nvec + gridDim.x - 1) / gridDim.x;
  const long long lo = (long long)blockIdx.x * per;
  const long long hi = lo + per < nvec ? lo + per : nvec;
  const VT* vp = reinterpret_cast<const VT*>(ids + head);
  const long long T = blockDim.x;
  for (long long v = lo + threadIdx.x; v < hi; v += U * T) {
    VT buf[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long j = v + u * T;
      buf[u] = j < hi ? __ldcs(vp + j) : V::none();
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int k = 0; k < N; ++k) f(V::at(buf[u], k), head + (v + u * T) * N + k);
    }
  }
  if (blockIdx.x == 0)
    for (long long e = threadIdx.x; e < head; e += T) f(ids[e], e);
  if (blockIdx.x == gridDim.x - 1)
    for (long long e = tail + threadIdx.x; e < n; e += T) f(ids[e], e);
}

template <typename Id>
__device__ __forceinline__ bool in_range(Id s, long long m) {
  return (unsigned long long)(long long)s < (unsigned long long)m;
}

// Input j's slot of id s: id + offset for an id >= 0, wrapping as a
// two's-complement add does; -1 (dropped) otherwise.
__device__ __forceinline__ long long offset_slot(long long s, unsigned long long off) {
  return s >= 0 ? (long long)((unsigned long long)s + off) : -1;
}

// -- shared regime ------------------------------------------------------------

// Zeroes the block's histogram copies; returns this warp's copy.
__device__ __forceinline__ unsigned* hist_zero(unsigned* hist, int m, int copies) {
  for (int i = threadIdx.x; i < m * copies; i += blockDim.x) hist[i] = 0u;
  __syncthreads();
  return hist + (int)((threadIdx.x / 32) % copies) * m;
}

// Adds the block's non-zero bins to out, one 64-bit atomic a bin.
__device__ __forceinline__ void hist_flush(const unsigned* hist, int m, int copies,
                                           unsigned long long* __restrict__ out) {
  __syncthreads();
  for (int b = threadIdx.x; b < m; b += blockDim.x) {
    unsigned c = 0u;  // wraps mod 2^32 when weighted (see the weighted domain)
    for (int k = 0; k < copies; ++k) c += hist[k * m + b];
    if (c != 0u) atomicAdd(&out[b], (unsigned long long)c);
  }
}

template <typename Id, bool Weighted>
__global__ void __launch_bounds__(kThreads)
bincount_shared(const Id* __restrict__ ids, const int32_t* __restrict__ w,
                long long n, int m, int copies, unsigned long long* __restrict__ out) {
  extern __shared__ unsigned hist[];
  unsigned* mine = hist_zero(hist, m, copies);
  walk(ids, n, [&](Id s, long long row) {
    if (in_range(s, m)) atomicAdd(&mine[(int)s], Weighted ? (unsigned)w[row] : 1u);
  });
  hist_flush(hist, m, copies, out);
}

// The multi-input entry's shared regime: every input walked in turn.
__global__ void __launch_bounds__(kThreads)
bincount_shared_multi(const Pieces p, int m, int copies,
                      unsigned long long* __restrict__ out) {
  extern __shared__ unsigned hist[];
  unsigned* mine = hist_zero(hist, m, copies);
  for (int j = 0; j < p.k; ++j) {
    const unsigned long long off = p.off[j];
    walk(p.ids[j], p.n[j], [&](long long s, long long) {
      const long long slot = offset_slot(s, off);
      if (in_range(slot, m)) atomicAdd(&mine[(int)slot], 1u);
    });
  }
  hist_flush(hist, m, copies, out);
}

// Histogram copies of a block for m bins: one a warp while they fit the
// default 48 KB, so a few hot bins spread their contention.
__host__ __device__ __forceinline__ int shared_copies(long long m) {
  const long long one = m * 4;
  const int copies = one > 0 && one <= kDefaultSmem ? (int)(kDefaultSmem / one) : 1;
  return copies < kWarps ? copies : kWarps;
}

// -- global regime ------------------------------------------------------------

template <typename Id, bool Weighted>
__global__ void __launch_bounds__(kThreads)
bincount_global(const Id* __restrict__ ids, const int32_t* __restrict__ w,
                long long n, long long m, unsigned long long* __restrict__ out) {
  walk(ids, n, [&](Id s, long long row) {
    if (in_range(s, m))
      atomicAdd(&out[s], Weighted ? (unsigned long long)(unsigned)w[row] : 1ull);
  });
}

// out[b] = its low 32 bits read as an int32: the weighted total (see above)
__global__ void bincount_wrap(long long m, unsigned long long* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = (unsigned long long)(long long)(int)(unsigned)out[i];
}

// -- partition regime ---------------------------------------------------------

// start[b] = sum of count[0..b) for b in [0, buckets]; one call per block,
// every thread takes part. buckets <= 2 * blockDim.x.
__device__ void exclusive_scan(const unsigned* count, unsigned* start, int buckets) {
  __shared__ unsigned warp_sums[32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b0 = 2 * t;
  const unsigned x0 = b0 < buckets ? count[b0] : 0u;
  const unsigned x1 = b0 + 1 < buckets ? count[b0 + 1] : 0u;
  unsigned incl = x0 + x1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const unsigned s = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0u;
    unsigned si = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, si, o);
      if (lane >= o) si += y;
    }
    warp_sums[lane] = si - s;
  }
  __syncthreads();
  const unsigned excl = incl - x0 - x1 + warp_sums[warp];
  if (b0 < buckets) start[b0] = excl;
  if (b0 + 1 < buckets) start[b0 + 1] = excl + x0;
  if (b0 < buckets && buckets <= b0 + 2) start[buckets] = excl + x0 + x1;
}

// Pass 1's second half for tile t: each kept row's rank within its bucket,
// the tile's bucket starts, the rows staged in bucket order, then written
// out. key[j] is row j * kTileThreads + threadIdx.x's id, ~0u if dropped.
template <bool Weighted>
__device__ __forceinline__ void partition_write(
    const unsigned (&key)[kRowsPerThread], const int32_t (&wv)[kRowsPerThread],
    long long t, long long tiles, int shift, int buckets, unsigned* count,
    unsigned* start, unsigned short* stage, int32_t* wstage,
    unsigned short* __restrict__ keys, int32_t* __restrict__ wsorted,
    unsigned* __restrict__ offs) {
  const unsigned low = (1u << shift) - 1u;
  const long long base = t * kTile;
  unsigned rank[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j)
    if (key[j] != ~0u) rank[j] = atomicAdd(&count[key[j] >> shift], 1u);
  __syncthreads();
  exclusive_scan(count, start, buckets);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    if (key[j] != ~0u) {
      const unsigned pos = start[key[j] >> shift] + rank[j];
#ifdef DEEQU_K7_PROBE_NO_SCATTER
      if (pos == 0xffffffffu) stage[0] = (unsigned short)(key[j] & low);
#else
      stage[pos] = (unsigned short)(key[j] & low);
#endif
      if (Weighted) wstage[pos] = wv[j];
    }
  }
  __syncthreads();
#if defined(DEEQU_K7_PROBE_NO_SCATTER) || defined(DEEQU_K7_PROBE_NO_KEY_WRITE)
  const unsigned kept = 0;
#else
  const unsigned kept = start[buckets];
#endif
  for (unsigned i = threadIdx.x; i < kept; i += blockDim.x) {
    keys[base + i] = stage[i];
    if (Weighted) wsorted[base + i] = wstage[i];
  }
  for (int b = threadIdx.x; b <= buckets; b += blockDim.x)
#if defined(DEEQU_K7_PROBE_NO_SCATTER) || defined(DEEQU_K7_PROBE_NO_KEY_WRITE)
    offs[(long long)b * tiles + t] = 0u;
#else
    offs[(long long)b * tiles + t] = start[b];
#endif
  __syncthreads();
}

// Pass 1: each tile of kTile rows, sorted by bucket (id >> shift) in shared
// memory, is written to keys[t * kTile ...] as u16 offsets within the bucket
// (weights beside them in wsorted); offs[b * tiles + t] is where bucket b
// starts in tile t, offs[buckets * tiles + t] how many rows tile t kept.
template <typename Id, bool Weighted>
__global__ void __launch_bounds__(kTileThreads, 2)
bincount_partition(const Id* __restrict__ ids, const int32_t* __restrict__ w,
                   long long n, long long m, int shift, int buckets,
                   unsigned short* __restrict__ keys, int32_t* __restrict__ wsorted,
                   unsigned* __restrict__ offs) {
  extern __shared__ unsigned smem[];
  unsigned* count = smem;                 // buckets
  unsigned* start = count + buckets;      // buckets + 1
  int32_t* wstage = reinterpret_cast<int32_t*>(start + buckets + 1);
  unsigned short* stage =
      reinterpret_cast<unsigned short*>(wstage + (Weighted ? kTile : 0));
  const long long tiles = (n + kTile - 1) / kTile;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    for (int b = threadIdx.x; b < buckets; b += blockDim.x) count[b] = 0u;
    __syncthreads();
    const long long base = t * kTile;
    Id v[kRowsPerThread];
    int32_t wv[kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const long long i = base + j * kTileThreads + threadIdx.x;
      v[j] = i < n ? __ldcs(ids + i) : (Id)-1;
      if (Weighted) wv[j] = i < n ? __ldcs(w + i) : 0;
    }
    unsigned key[kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) key[j] = in_range(v[j], m) ? (unsigned)v[j] : ~0u;
    partition_write<Weighted>(key, wv, t, tiles, shift, buckets, count, start, stage,
                              wstage, keys, wsorted, offs);
  }
}

// -- the multi-input entry's partition route (K7) -----------------------------

// Adds the block's histogram of narrow group g to out: each bin of each of
// the group's inputs summed over its copies, one 64-bit atomic a non-zero
// bin, at the input's offset.
__device__ __forceinline__ void group_flush(const Pieces& p, int g, const unsigned* hist,
                                            unsigned long long* __restrict__ out) {
  __syncthreads();
#ifdef DEEQU_K7_PROBE_NO_FLUSH
  return;
#endif
  for (int j = p.kw; j < p.k; ++j) {
    if (p.group[j] != g) continue;
    const int w = p.bins[j];
    const unsigned* h = hist + p.hist[j];
    for (int b = threadIdx.x; b < w; b += blockDim.x) {
      unsigned c = 0u;
      for (int q = 0; q < p.copies[j]; ++q) c += h[q * w + b];
      if (c != 0u) atomicAdd(&out[p.off[j] + b], (unsigned long long)c);
    }
  }
  __syncthreads();
}

// Launch 1: every input read once, in one grid. The launch's tiles of
// kTile rows (the wide inputs' first, numbered from 0, then the narrow
// ones'; tile t of input j holds its rows from (t - p.tile0[j]) * kTile)
// are items of one list, wide and narrow interleaved evenly, and block b
// of the grid (as many blocks as fit the card) takes the b-th contiguous
// run of it, so every block reads both kinds in the same mix and the
// narrow inputs stream from memory while the wide ones are partitioned. A
// wide tile is pass 1 of the partition regime (partition_write: u16 keys
// by bucket of the summed keyspace, its bucket offsets). A narrow tile
// counts into the block's histogram of its group (the launch's narrow
// inputs packed into groups of at most kGroupWords words, each input's
// bins kept in p.copies[j] copies); an id past its input's own keyspace
// adds its slot straight into out. A block flushes a group's histogram
// into out when it moves to the next group, and at its end.
#ifndef DEEQU_K7_READ_BLOCKS
#define DEEQU_K7_READ_BLOCKS 2
#endif
__global__ void __launch_bounds__(kTileThreads, DEEQU_K7_READ_BLOCKS)
bincount_fused_read(const __grid_constant__ Pieces p, long long m, int shift, int buckets,
                    unsigned short* __restrict__ keys, unsigned* __restrict__ offs,
                    unsigned long long* __restrict__ out) {
  extern __shared__ unsigned smem[];
  unsigned* hist = smem;                   // p.hist_words
  unsigned* count = hist + p.hist_words;   // buckets
  unsigned* start = count + buckets;       // buckets + 1
  unsigned short* stage = reinterpret_cast<unsigned short*>(start + buckets + 1);
  const long long wide = p.tile0[p.kw];
  const long long items = p.tile0[p.k];
  const int32_t wv[kRowsPerThread] = {};
  const int warp = threadIdx.x >> 5;
  int jw = 0, jn = p.kw, group = -1;
  const long long i_end = (blockIdx.x + 1) * items / gridDim.x;
  for (long long i = blockIdx.x * items / gridDim.x; i < i_end; ++i) {
    // item i is wide if the even share of wide items grows at it
    const long long before = i * wide / items;
    const bool is_wide = (i + 1) * wide / items > before;
    const long long t = is_wide ? before : wide + (i - before);
    int j = is_wide ? jw : jn;
    while (p.tile0[j + 1] <= t) ++j;
    (is_wide ? jw : jn) = j;
    const long long* ids = p.ids[j];
    const long long n = p.n[j];
    const long long first = (t - p.tile0[j]) * kTile;
    const unsigned long long off = p.off[j];
    if (is_wide) {
      long long v[kRowsPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const long long row = first + r * kTileThreads + threadIdx.x;
        v[r] = row < n ? offset_slot(__ldcs(ids + row), off) : -1;
      }
      for (int b = threadIdx.x; b < buckets; b += blockDim.x) count[b] = 0u;
      __syncthreads();
      unsigned key[kRowsPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) key[r] = in_range(v[r], m) ? (unsigned)v[r] : ~0u;
#ifdef DEEQU_K7_PROBE_NO_SORT
      unsigned x = 0u;
      for (int r = 0; r < kRowsPerThread; ++r) x ^= key[r];
      if (x == 0x12345678u) count[0] = x;
      for (int b = threadIdx.x; b <= buckets; b += blockDim.x) offs[(long long)b * wide + t] = 0u;
      __syncthreads();
#else
      partition_write<false>(key, wv, t, wide, shift, buckets, count, start, stage,
                             nullptr, keys, nullptr, offs);
#endif
    } else {
      if (p.group[j] != group) {
        if (group >= 0) group_flush(p, group, hist, out);
        for (int w = threadIdx.x; w < p.hist_words; w += blockDim.x) hist[w] = 0u;
        __syncthreads();
        group = p.group[j];
      }
      long long s[kRowsPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const long long row = first + r * kTileThreads + threadIdx.x;
        s[r] = row < n ? __ldcs(ids + row) : -1;
      }
      const int w = p.bins[j];
      unsigned* mine = hist + p.hist[j] + (warp % p.copies[j]) * w;
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        if (s[r] < 0) continue;
        if (s[r] < w) {
#ifdef DEEQU_K7_PROBE_NO_ATOMICS
          if (s[r] == 0x123456789ll) mine[0] = 1u;
#else
          atomicAdd(&mine[(int)s[r]], 1u);
#endif
        } else {
          const long long slot = offset_slot(s[r], off);
          if (in_range(slot, m)) atomicAdd(&out[slot], 1ull);
        }
      }
    }
  }
  if (group >= 0) group_flush(p, group, hist, out);
  __syncthreads();  // launch 2 may start once every block is here
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}


// Pass 2: block b counts bucket b's rows of every tile in shared memory and
// writes (add == 0) or adds to its 2^shift bins of the output. A warp takes
// 32 tiles at a time and four of their runs at once.
template <bool Weighted>
__global__ void __launch_bounds__(kThreads)
bincount_bucket(const unsigned short* __restrict__ keys,
                const int32_t* __restrict__ wsorted, const unsigned* __restrict__ offs,
                long long tiles, long long m, int shift, int add,
                unsigned long long* __restrict__ out) {
  extern __shared__ unsigned hist[];
  const int width = 1 << shift;
  const int b = blockIdx.x;
  for (int i = threadIdx.x; i < width; i += blockDim.x) hist[i] = 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (long long t0 = (long long)warp * 32; t0 < tiles; t0 += (long long)warps * 32) {
    unsigned s = 0u, e = 0u;
    if (t0 + lane < tiles) {
      s = offs[(long long)b * tiles + t0 + lane];
      e = offs[(long long)(b + 1) * tiles + t0 + lane];
    }
    for (int j = 0; j < 32; j += 4) {
      unsigned sj[4], ej[4], longest = 0u;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        sj[g] = __shfl_sync(0xffffffffu, s, j + g);
        ej[g] = __shfl_sync(0xffffffffu, e, j + g);
        longest = max(longest, ej[g] - sj[g]);
      }
      for (unsigned i = lane; i < longest; i += 32) {
        unsigned short k[4];
        int32_t wk[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const long long at = (t0 + j + g) * kTile + sj[g] + i;
          const bool ok = sj[g] + i < ej[g];
          k[g] = ok ? keys[at] : (unsigned short)0;
          if (Weighted) wk[g] = ok ? wsorted[at] : 0;
        }
#pragma unroll
        for (int g = 0; g < 4; ++g)
          if (sj[g] + i < ej[g]) atomicAdd(&hist[k[g]], Weighted ? (unsigned)wk[g] : 1u);
      }
    }
  }
  __syncthreads();
  const long long lo = (long long)b << shift;
  for (int i = threadIdx.x; i < width && lo + i < m; i += blockDim.x) {
    const unsigned c = hist[i];
    const unsigned long long v =
        Weighted ? (unsigned long long)(long long)(int)c : (unsigned long long)c;
    out[lo + i] = add ? out[lo + i] + v : v;
  }
}

// Launch 2 of the multi-input partition route: bucket b is counted by a
// cluster of C blocks. Block rank r of it takes every C-th run of 32
// tiles (a warp's share), counts its bucket's rows of them into its own
// shared histogram, and then, after the cluster syncs, sums its 1/C slice
// of the bins over the C histograms (distributed shared memory) and adds
// each non-zero sum to out: launch 1's atomics came first, and each bin
// has one writer here. A warp reads its 32 runs as the aligned 16-byte
// vectors that cover them, packed one after the other across its lanes
// (a prefix sum of the runs' vector counts; a lane finds its run by a
// binary search of the prefix over the warp), kKeyVecs vectors a lane in
// flight, and masks the keys outside its run.
#ifndef DEEQU_K7_KEY_VECS
#define DEEQU_K7_KEY_VECS 4
#endif
constexpr int kKeyVecs = DEEQU_K7_KEY_VECS;

template <int C>
__global__ void __launch_bounds__(kThreads)
bincount_fused_bucket(const unsigned short* __restrict__ keys,
                      const unsigned* __restrict__ offs, long long tiles, long long m,
                      int shift, unsigned long long* __restrict__ out) {
  extern __shared__ unsigned hist[];
  const int width = 1 << shift;
  const int b = blockIdx.x / C, r = blockIdx.x % C;
  for (int i = threadIdx.x; i < width; i += blockDim.x) hist[i] = 0u;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // launch 1's writes
  __syncthreads();
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const uint4* kv = reinterpret_cast<const uint4*>(keys);
  constexpr long long kTileVecs = kTile / 8;
  for (long long t0 = ((long long)r * warps + warp) * 32; t0 < tiles;
       t0 += (long long)C * warps * 32) {
    unsigned s = 0u, e = 0u;
    if (t0 + lane < tiles) {
      s = offs[(long long)b * tiles + t0 + lane];
      e = offs[(long long)(b + 1) * tiles + t0 + lane];
    }
    const unsigned nv = e > s ? ((e + 7u) >> 3) - (s >> 3) : 0u;
    unsigned incl = nv;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(full, incl, o);
      if (lane >= o) incl += y;
    }
    const unsigned excl = incl - nv;
    const unsigned total = __shfl_sync(full, incl, 31);
    for (unsigned base = 0; base < total; base += 32 * kKeyVecs) {
      uint4 vec[kKeyVecs];
      unsigned lo[kKeyVecs], hi[kKeyVecs];
#pragma unroll
      for (int u = 0; u < kKeyVecs; ++u) {
        const unsigned idx = base + u * 32 + lane;
        // the run holding vector idx: the last lane whose prefix is <= idx
        int g = 0;
#pragma unroll
        for (int step = 16; step > 0; step >>= 1) {
          if (__shfl_sync(full, excl, g + step) <= idx) g += step;
        }
        const unsigned sg = __shfl_sync(full, s, g);
        const unsigned eg = __shfl_sync(full, e, g);
        const unsigned xg = __shfl_sync(full, excl, g);
        const bool ok = idx < total;
        const unsigned vi = (sg >> 3) + (idx - xg);  // the vector within its tile
        vec[u] = ok ? __ldcg(kv + (t0 + g) * kTileVecs + vi) : make_uint4(0u, 0u, 0u, 0u);
        lo[u] = ok && sg > vi * 8 ? sg - vi * 8 : 0u;
        hi[u] = ok ? min(eg - vi * 8, 8u) : 0u;
      }
#pragma unroll
      for (int u = 0; u < kKeyVecs; ++u) {
        const unsigned words[4] = {vec[u].x, vec[u].y, vec[u].z, vec[u].w};
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (k >= (int)lo[u] && k < (int)hi[u]) {
#ifdef DEEQU_K7_PROBE_NO_ATOMICS
            if (((words[k >> 1] >> ((k & 1) * 16)) & 0xffffu) == 0x1ffffu) hist[0] = 1u;
#else
            atomicAdd(&hist[(words[k >> 1] >> ((k & 1) * 16)) & 0xffffu], 1u);
#endif
          }
        }
      }
    }
  }
  if constexpr (C > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
  // this block's slice of the bins, kKeyVecs a thread at once, so that
  // their reads of out are in flight together
  const long long lo = (long long)b << shift;
  const int slice = (width + C - 1) / C;
  const long long first = lo + r * slice;
  long long last = lo + (r + 1 < C ? (r + 1) * slice : width);
  if (last > m) last = m;
#ifdef DEEQU_K7_PROBE_NO_REDUCE
  last = first;
#endif
  for (long long i0 = first + threadIdx.x; i0 < last; i0 += kKeyVecs * blockDim.x) {
    unsigned c[kKeyVecs];
    unsigned long long v[kKeyVecs];
#pragma unroll
    for (int u = 0; u < kKeyVecs; ++u) {
      const long long i = i0 + u * blockDim.x;
      c[u] = i < last ? hist[i - lo] : 0u;
      if constexpr (C > 1) {
        cg::cluster_group cluster = cg::this_cluster();
        for (int q = 1; q < C; ++q)
          if (i < last) c[u] += cluster.map_shared_rank(hist, (r + q) % C)[i - lo];
      }
    }
#pragma unroll
    for (int u = 0; u < kKeyVecs; ++u) v[u] = c[u] ? out[i0 + u * blockDim.x] : 0ull;
#pragma unroll
    for (int u = 0; u < kKeyVecs; ++u)
      if (c[u]) out[i0 + u * blockDim.x] = v[u] + c[u];
  }
  if constexpr (C > 1) cg::this_cluster().sync();  // no block leaves while read
}

// -- the card's limits, read once per device ----------------------------------

struct Card {
  bool ready = false;
  int sms = 0;
  int optin_smem = 0;        // bytes of shared memory a block may opt into
  int partition_blocks = 0;  // resident pass-1 blocks per SM
};

constexpr int kMaxDevices = 64;
Card g_cards[kMaxDevices];
std::mutex g_cards_lock;

// Lets the kernel's dynamic shared memory reach the opt-in limit less its
// static shared memory.
template <typename K>
cudaError_t allow_smem(K kernel, int optin) {
  cudaFuncAttributes attrs;
  cudaError_t err = cudaFuncGetAttributes(&attrs, kernel);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              optin - (int)attrs.sharedSizeBytes);
}

int partition_smem(int buckets, bool weighted) {
  return (2 * buckets + 1) * 4 + kTile * (weighted ? 6 : 2);
}

// The current device's limits; queried, and the kernels' shared-memory
// limits raised, on the first call for each device. Null on a CUDA error,
// which *err then holds.
const Card* card(int* err) {
  int dev = 0;
  *err = (int)cudaGetDevice(&dev);
  if (*err != 0) return nullptr;
  if (dev < 0 || dev >= kMaxDevices) {
    *err = (int)cudaErrorInvalidDevice;
    return nullptr;
  }
  std::lock_guard<std::mutex> lock(g_cards_lock);
  Card& c = g_cards[dev];
  if (!c.ready) {
    cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&c.optin_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    const cudaError_t errs[] = {
        allow_smem(bincount_shared<long long, false>, c.optin_smem),
        allow_smem(bincount_shared<long long, true>, c.optin_smem),
        allow_smem(bincount_shared<int, false>, c.optin_smem),
        allow_smem(bincount_shared<int, true>, c.optin_smem),
        allow_smem(bincount_partition<long long, false>, c.optin_smem),
        allow_smem(bincount_partition<long long, true>, c.optin_smem),
        allow_smem(bincount_partition<int, false>, c.optin_smem),
        allow_smem(bincount_partition<int, true>, c.optin_smem),
        allow_smem(bincount_shared_multi, c.optin_smem),
        allow_smem(bincount_fused_read, c.optin_smem),
        allow_smem(bincount_fused_bucket<kCluster>, c.optin_smem),
        allow_smem(bincount_bucket<false>, c.optin_smem),
        allow_smem(bincount_bucket<true>, c.optin_smem),
    };
    for (cudaError_t e : errs) {
      if (e != cudaSuccess) {
        *err = (int)e;
        return nullptr;
      }
    }
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &c.partition_blocks, bincount_partition<long long, true>, kTileThreads,
        partition_smem(kMaxBuckets, true));
    if (c.partition_blocks < 1) c.partition_blocks = 1;
    *err = (int)cudaGetLastError();
    if (*err != 0) return nullptr;
    c.ready = true;
  }
  return &c;
}

// -- the regime rule, and what each regime needs ------------------------------

// The widest num_segments regime r takes on this card (-1: no limit):
// shared while one u32 histogram fits the shared memory a block may opt
// into (58,112 bins on an H100), partition up to kMaxBuckets buckets of
// 2^kMaxBucketShift bins.
long long widest(const Card& c, int r) {
  if (r == kShared) return c.optin_smem / 4;
  return r == kPartition ? kPartitionBins : -1;
}

// The one rule: the narrowest regime whose width covers num_segments.
int regime(const Card& c, long long m) {
  for (int r = 0; r < kGlobal; ++r)
    if (m <= widest(c, r)) return r;
  return kGlobal;
}

// Whether regime r can run at this width at all (a regime takes every
// width up to its widest, so a measurement can compare regimes at one
// width).
bool can_take(const Card& c, int r, long long m) {
  const long long w = widest(c, r);
  return r >= 0 && r < kRegimes && (w < 0 || m <= w);
}

// Buckets of the partition regime: widths a power of two, about one bucket
// an SM, at most kMaxBucketShift bits.
void buckets_for(const Card& c, long long m, int* shift, int* buckets) {
  int s = 0;
  while (s < kMaxBucketShift && ((long long)c.sms << s) < m) ++s;
  *shift = s;
  *buckets = (int)((m + (1ll << s) - 1) >> s);
}

struct Scratch {
  long long tiles;
  size_t keys, wsorted, offs, bytes;  // byte offsets, total
};

size_t round_up(size_t x) { return (x + 255) & ~(size_t)255; }

Scratch partition_scratch(long long rows, int buckets, bool weighted) {
  Scratch s;
  s.tiles = (rows + kTile - 1) / kTile;
  s.keys = 0;
  s.wsorted = round_up((size_t)s.tiles * kTile * 2);
  s.offs = s.wsorted + (weighted ? round_up((size_t)s.tiles * kTile * 4) : 0);
  s.bytes = s.offs + round_up((size_t)(buckets + 1) * s.tiles * 4);
  return s;
}

template <typename Id, bool Weighted>
int launch(const Card& c, int r, const void* idsv, const void* wv, long long n,
           long long m, void* scratch, void* outv, cudaStream_t stream) {
  const Id* ids = static_cast<const Id*>(idsv);
  const int32_t* w = static_cast<const int32_t*>(wv);
  unsigned long long* out = static_cast<unsigned long long*>(outv);
  int shift = 0, buckets = 0;
  if (r == kPartition) buckets_for(c, m, &shift, &buckets);
  for (long long off = 0; off < n; off += kChunkRows) {
    const long long rows = n - off < kChunkRows ? n - off : kChunkRows;
    const Id* id = ids + off;
    const int32_t* wt = Weighted ? w + off : nullptr;
    if (r == kShared) {
      const int copies = shared_copies(m);
      bincount_shared<Id, Weighted><<<c.sms, kThreads, (size_t)m * 4 * copies, stream>>>(
          id, wt, rows, (int)m, copies, out);
    } else if (r == kGlobal) {
      bincount_global<Id, Weighted><<<2 * c.sms, kThreads, 0, stream>>>(id, wt, rows, m, out);
    } else {
      const Scratch s = partition_scratch(rows, buckets, Weighted);
      char* base = static_cast<char*>(scratch);
      unsigned short* keys = reinterpret_cast<unsigned short*>(base + s.keys);
      int32_t* ws = reinterpret_cast<int32_t*>(base + s.wsorted);
      unsigned* offs = reinterpret_cast<unsigned*>(base + s.offs);
      long long grid = (long long)c.sms * c.partition_blocks;
      if (grid > s.tiles) grid = s.tiles;
      bincount_partition<Id, Weighted>
          <<<(unsigned)grid, kTileThreads, partition_smem(buckets, Weighted), stream>>>(
              id, wt, rows, m, shift, buckets, keys, ws, offs);
      bincount_bucket<Weighted><<<buckets, kThreads, (size_t)4 << shift, stream>>>(
          keys, ws, offs, s.tiles, m, shift, off > 0 ? 1 : 0, out);
    }
  }
  if (Weighted && (r != kPartition || n > kChunkRows))
    bincount_wrap<<<2 * c.sms, kThreads, 0, stream>>>(m, out);
  return (int)cudaGetLastError();
}

// Cuts the inputs into launches of at most kMaxInputs pieces and
// kChunkRows rows (so every u32 count of a launch is exact), skipping empty
// inputs, and calls f(pieces) for each. Input i lands at the keyspaces
// before it; tile0 holds each piece's first tile.
template <typename F>
void for_each_launch(const void* const* ids, const long long* ns,
                     const long long* keyspaces, int k, F f) {
  Pieces p;
  p.k = 0;
  p.tile0[0] = 0;
  long long rows = 0;
  auto flush = [&]() {
    if (p.k > 0) f(p);
    p.k = 0;
    rows = 0;
  };
  unsigned long long off = 0;
  for (int i = 0; i < k; off += (unsigned long long)keyspaces[i], ++i) {
    for (long long done = 0; done < ns[i];) {
      if (p.k == kMaxInputs || rows == kChunkRows) flush();
      long long piece = ns[i] - done;
      if (piece > kChunkRows - rows) piece = kChunkRows - rows;
      p.ids[p.k] = static_cast<const long long*>(ids[i]) + done;
      p.n[p.k] = piece;
      p.off[p.k] = off;
      p.bins[p.k] = (int)keyspaces[i];
      p.tile0[p.k + 1] = p.tile0[p.k] + (piece + kTile - 1) / kTile;
      ++p.k;
      rows += piece;
      done += piece;
    }
  }
  flush();
}

// The partition route's order of one launch's pieces: the wide ones first,
// then the narrow ones, packed in input order into groups of at most
// kGroupWords histogram words; tile0 renumbered in that order.
Pieces arrange(const Pieces& in) {
  Pieces p;
  p.k = 0;
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) p.kw = p.k;
    for (int j = 0; j < in.k; ++j) {
      if ((in.bins[j] <= kNarrowBins) != (pass == 1)) continue;
      p.ids[p.k] = in.ids[j];
      p.n[p.k] = in.n[j];
      p.off[p.k] = in.off[j];
      p.bins[p.k] = in.bins[j];
      ++p.k;
    }
  }
  p.tile0[0] = 0;
  p.hist_words = 0;
  int group = 0, used = 0;
  for (int j = 0; j < p.k; ++j) {
    p.tile0[j + 1] = p.tile0[j] + (p.n[j] + kTile - 1) / kTile;
    p.hist[j] = -1;
    p.copies[j] = 0;
    p.group[j] = -1;
    if (j < p.kw) continue;
    const int w = p.bins[j];
    int copies = kCopyWords / w;
    copies = copies < 1 ? 1 : (copies > kTileThreads / 32 ? kTileThreads / 32 : copies);
    if (used + copies * w > kGroupWords) {
      ++group;
      used = 0;
    }
    p.hist[j] = used;
    p.copies[j] = copies;
    p.group[j] = group;
    used += copies * w;
    if (used > p.hist_words) p.hist_words = used;
  }
  return p;
}

// Buckets of the multi-input partition route: the widest power-of-two
// bucket (at most kMaxBucketShift bits) that still gives launch 2 a block
// an SM in clusters of kCluster.
void multi_buckets(const Card& c, long long m, int* shift, int* buckets) {
  auto count = [&](int s) { return (m + (1ll << s) - 1) >> s; };
  int s = kMaxBucketShift;
  while (s > 0 && count(s) * kCluster < c.sms) --s;
  *shift = s;
  *buckets = (int)count(s);
}

bool multi_regime(const Card& c, int r, long long m) {
  return (r == kShared || r == kPartition) && can_take(c, r, m);
}

long long sum_of(const long long* keyspaces, int k) {
  long long m = 0;
  for (int i = 0; i < k; ++i) m += keyspaces[i];
  return m;
}

}  // namespace

extern "C" {

// The regime the rule gives this width on the current device: 0 shared,
// 1 partition, 2 global; a negative CUDA error if the device has none.
int deequ_bincount_regime(long long num_segments) {
  int err = 0;
  const Card* c = card(&err);
  return c ? regime(*c, num_segments) : -err;
}

// The widest width regime r takes on the current device (-1: no limit;
// -2: no device).
long long deequ_bincount_widest(int r) {
  int err = 0;
  const Card* c = card(&err);
  return c ? widest(*c, r) : -2;
}

// Bytes of scratch a launch in regime r needs; -1 if r cannot take the
// width on the current device.
long long deequ_bincount_scratch_bytes(int r, long long n, long long num_segments,
                                       int weighted) {
  int err = 0;
  const Card* c = card(&err);
  if (!c || !can_take(*c, r, num_segments)) return -1;
  if (r != kPartition) return 0;
  int shift = 0, buckets = 0;
  buckets_for(*c, num_segments, &shift, &buckets);
  const long long rows = n < kChunkRows ? n : kChunkRows;
  return (long long)partition_scratch(rows, buckets, weighted != 0).bytes;
}

// Counts into out (num_segments int64, zeroed: the shared and global
// regimes add into it, the partition regime writes it whole) in regime r,
// normally deequ_bincount_regime(num_segments). ids: n int32
// (ids_are_64 == 0) or int64 ids on the device; weights: n int32 or NULL;
// scratch: deequ_bincount_scratch_bytes(r, ...) bytes. n >= 1 and
// num_segments >= 1 (the caller skips empty launches). Enqueues on stream
// and returns the CUDA error of the launch (0 = cudaSuccess).
int deequ_bincount(int r, const void* ids, int ids_are_64, const void* weights,
                   long long n, long long num_segments, void* scratch, void* out,
                   void* stream) {
  int err = 0;
  const Card* c = card(&err);
  if (!c) return err;
  if (!can_take(*c, r, num_segments)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ids_are_64) {
    return weights ? launch<long long, true>(*c, r, ids, weights, n, num_segments, scratch, out, s)
                   : launch<long long, false>(*c, r, ids, weights, n, num_segments, scratch, out, s);
  }
  return weights ? launch<int, true>(*c, r, ids, weights, n, num_segments, scratch, out, s)
                 : launch<int, false>(*c, r, ids, weights, n, num_segments, scratch, out, s);
}

// Bytes of scratch a multi-input launch in regime r needs for these k
// inputs (deequ_bincount_multi's arguments); -1 if r cannot take their
// summed keyspace (only the shared and partition regimes take the
// multi-input entry).
long long deequ_bincount_multi_scratch_bytes(int r, const void* const* ids,
                                             const long long* ns,
                                             const long long* keyspaces, int k) {
  int err = 0;
  const Card* c = card(&err);
  const long long m = sum_of(keyspaces, k);
  if (!c || !multi_regime(*c, r, m)) return -1;
  if (r != kPartition) return 0;
  int shift = 0, buckets = 0;
  multi_buckets(*c, m, &shift, &buckets);
  long long tiles = 0;
  for_each_launch(ids, ns, keyspaces, k, [&](const Pieces& raw) {
    const Pieces p = arrange(raw);
    if (p.tile0[p.kw] > tiles) tiles = p.tile0[p.kw];
  });
  return (long long)partition_scratch(tiles * kTile, buckets, false).bytes;
}

// Counts k int64 id vectors into one out of sum(keyspaces) int64 bins
// (zeroed) in regime r (shared or partition; normally deequ_bincount_regime
// of the sum): input i's ids[i] (ns[i] rows on the device) land at id plus
// the keyspaces before it where id >= 0, and a slot outside the bins is
// dropped. scratch: deequ_bincount_multi_scratch_bytes bytes. Enqueues on
// stream and returns the CUDA error of the launches (0 = cudaSuccess;
// cudaErrorInvalidValue where r cannot take the summed keyspace).
int deequ_bincount_multi(int r, const void* const* ids, const long long* ns,
                         const long long* keyspaces, int k, void* scratch, void* out,
                         void* stream) {
  int err = 0;
  const Card* c = card(&err);
  if (!c) return err;
  const long long m = sum_of(keyspaces, k);
  if (!multi_regime(*c, r, m)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* counts = static_cast<unsigned long long*>(out);
  if (r == kShared) {
    const int copies = shared_copies(m);
    for_each_launch(ids, ns, keyspaces, k, [&](const Pieces& p) {
      bincount_shared_multi<<<c->sms, kThreads, (size_t)m * 4 * copies, st>>>(
          p, (int)m, copies, counts);
    });
    return (int)cudaGetLastError();
  }
  // partition: launch 1 reads every input (pass 1 of the wide ones, the
  // narrow ones counted and added into out), launch 2 adds the wide ones'
  // buckets into out
  int shift = 0, buckets = 0;
  multi_buckets(*c, m, &shift, &buckets);
  cudaError_t failed = cudaSuccess;
  for_each_launch(ids, ns, keyspaces, k, [&](const Pieces& raw) {
    if (failed != cudaSuccess) return;
    const Pieces p = arrange(raw);
    const long long wide = p.tile0[p.kw];
    const Scratch s = partition_scratch(wide * kTile, buckets, false);
    char* base = static_cast<char*>(scratch);
    unsigned short* keys = reinterpret_cast<unsigned short*>(base + s.keys);
    unsigned* offs = reinterpret_cast<unsigned*>(base + s.offs);
    const size_t smem = (size_t)p.hist_words * 4 +
                        (p.kw > 0 ? (size_t)partition_smem(buckets, false) : 0);
    int per_sm = 0;
    failed = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bincount_fused_read,
                                                           kTileThreads, smem);
    if (failed != cudaSuccess) return;
    long long grid = (long long)c->sms * (per_sm > 0 ? per_sm : 1);
    if (grid > p.tile0[p.k]) grid = p.tile0[p.k];
    bincount_fused_read<<<(unsigned)grid, kTileThreads, smem, st>>>(p, m, shift, buckets, keys,
                                                                    offs, counts);
    failed = cudaGetLastError();
    if (failed != cudaSuccess || wide == 0) return;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)buckets * kCluster, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = (size_t)4 << shift;
    cfg.stream = st;
    cudaLaunchAttribute attr[2];
    int n_attr = 0;
    if (kCluster > 1) {
      attr[n_attr].id = cudaLaunchAttributeClusterDimension;
      attr[n_attr].val.clusterDim.x = kCluster;
      attr[n_attr].val.clusterDim.y = 1;
      attr[n_attr].val.clusterDim.z = 1;
      ++n_attr;
    }
    attr[n_attr].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[n_attr].val.programmaticStreamSerializationAllowed = 1;
    ++n_attr;
    cfg.attrs = attr;
    cfg.numAttrs = n_attr;
    failed = cudaLaunchKernelEx(&cfg, bincount_fused_bucket<kCluster>, (const unsigned short*)keys,
                                (const unsigned*)offs, wide, m, shift, counts);
  });
  return failed != cudaSuccess ? (int)failed : (int)cudaGetLastError();
}

}  // extern "C"
