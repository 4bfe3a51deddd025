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
// Also measured and not taken: a histogram spread over a thread-block
// cluster's shared memory (distributed shared-memory atomics were no
// faster than L2 atomics), two cluster passes over halves of a wide key
// space, and warp aggregation of equal keys (__match_any_sync costs more
// than it saves unless most of a warp's keys are equal).
//
// Integer adds commute, so the result is bit-exact and deterministic. A
// launch counts at most kChunkRows rows at a time, so every u32 count is
// exact. The kernel allocates nothing: the caller passes the zeroed output
// and the scratch that deequ_bincount_scratch_bytes asks for. Plain C
// interface for ctypes; deequ_bincount returns the launch's
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

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

// -- shared regime ------------------------------------------------------------

template <typename Id, bool Weighted>
__global__ void __launch_bounds__(kThreads)
bincount_shared(const Id* __restrict__ ids, const int32_t* __restrict__ w,
                long long n, int m, int copies, unsigned long long* __restrict__ out) {
  extern __shared__ unsigned hist[];
  for (int i = threadIdx.x; i < m * copies; i += blockDim.x) hist[i] = 0u;
  __syncthreads();
  unsigned* mine = hist + (int)((threadIdx.x / 32) % copies) * m;
  walk(ids, n, [&](Id s, long long row) {
    if (in_range(s, m)) atomicAdd(&mine[(int)s], Weighted ? (unsigned)w[row] : 1u);
  });
  __syncthreads();
  for (int b = threadIdx.x; b < m; b += blockDim.x) {
    unsigned c = 0u;  // wraps mod 2^32 when weighted (see the weighted domain)
    for (int k = 0; k < copies; ++k) c += hist[k * m + b];
    if (c != 0u) atomicAdd(&out[b], (unsigned long long)c);
  }
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
  const unsigned low = (1u << shift) - 1u;
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
    // key and rank within its bucket in this tile; ~0u for a dropped row
    unsigned key[kRowsPerThread], rank[kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      if (in_range(v[j], m)) {
        key[j] = (unsigned)v[j];
        rank[j] = atomicAdd(&count[key[j] >> shift], 1u);
      } else {
        key[j] = ~0u;
      }
    }
    __syncthreads();
    exclusive_scan(count, start, buckets);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      if (key[j] != ~0u) {
        const unsigned pos = start[key[j] >> shift] + rank[j];
        stage[pos] = (unsigned short)(key[j] & low);
        if (Weighted) wstage[pos] = wv[j];
      }
    }
    __syncthreads();
    const unsigned kept = start[buckets];
    for (unsigned i = threadIdx.x; i < kept; i += blockDim.x) {
      keys[base + i] = stage[i];
      if (Weighted) wsorted[base + i] = wstage[i];
    }
    for (int b = threadIdx.x; b <= buckets; b += blockDim.x)
      offs[(long long)b * tiles + t] = start[b];
    __syncthreads();
  }
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
      const int one = (int)m * 4;
      int copies = one <= kDefaultSmem ? kDefaultSmem / one : 1;
      if (copies > kWarps) copies = kWarps;
      bincount_shared<Id, Weighted><<<c.sms, kThreads, (size_t)one * copies, stream>>>(
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

}  // extern "C"
