// Histogram of segment ids on Hopper (sm_90a).
//
// Replaces deequ_tpu/ops/histogram_device.py:bincount_pallas, the one Pallas
// kernel of the reference. It computes the same function: counts of ids over
// [0, num_segments), ids outside that range (negative sentinels, padding)
// dropped, optional int32 weights in place of the 1. Counts are int64, exact
// at any row count.
//
// The TPU kernel compares every row tile against an iota of segment ids
// (O(n * num_segments) vector compares): a fit for the TPU's wide VPU and
// its sequential grid, ruinous here (10^13 compares at a 1M-wide key
// space). This kernel is a scatter of integer atomics instead, which is
// bound by reading the ids once (8 bytes a row for int64 ids, plus 4 for
// weights) and writing the counts once (8 bytes a bin). Two regimes keep
// the atomics off device memory where they can:
//
// - narrow key space (num_segments * 4 bytes fits the shared memory a block
//   may opt into, ~58K bins on H100): each block keeps private u32
//   histograms in shared memory — up to one per warp while they fit in
//   48 KB, so a narrow key space (a few bins hit by every warp) spreads its
//   contention — walks the rows in a grid-stride loop and
//   flushes its non-zero bins to the output with one 64-bit global atomic
//   each;
// - wide key space: each row adds straight into the 64-bit output. At the
//   main path's widths (~10^6 bins for ~10^7 rows) a bin sees a handful of
//   hits, so contention is low; a skewed key (Zipf) contends on its hot bins
//   and is slower, never wrong.
//
// Integer atomics commute, so the result is bit-exact and deterministic.
// A block's shared u32 counts are exact while it sees fewer than 2^32 rows
// (n below ~5*10^11 on H100's resident grid). The kernel allocates
// nothing: the caller passes a zeroed int64 output. Plain C interface for
// ctypes; deequ_bincount returns the launch's cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kDefaultSmem = 48 * 1024;

template <typename Id, bool Weighted>
__global__ void __launch_bounds__(kThreads)
bincount_shared(const Id* __restrict__ ids, const int32_t* __restrict__ w,
                long long n, int num_segments, int copies,
                unsigned long long* __restrict__ out) {
  extern __shared__ unsigned int hist[];
  const int bins = num_segments * copies;
  for (int i = threadIdx.x; i < bins; i += blockDim.x) hist[i] = 0u;
  __syncthreads();
  unsigned int* mine = hist + (int)((threadIdx.x / 32) % copies) * num_segments;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long s = (long long)ids[i];
    if (s >= 0 && s < num_segments) {
      // weighted adds wrap mod 2^32 in shared memory; the flush below
      // sign-extends, so a block's per-bin partial is exact while it fits
      // int32 (the reference accumulates int32 over the whole input)
      atomicAdd(&mine[s], Weighted ? (unsigned int)w[i] : 1u);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < num_segments; b += blockDim.x) {
    unsigned int c = 0u;
    for (int k = 0; k < copies; ++k) c += hist[k * num_segments + b];
    if (c != 0u) {
      const unsigned long long add =
          Weighted ? (unsigned long long)(long long)(int)c
                   : (unsigned long long)c;
      atomicAdd(&out[b], add);
    }
  }
}

template <typename Id, bool Weighted>
__global__ void __launch_bounds__(kThreads)
bincount_global(const Id* __restrict__ ids, const int32_t* __restrict__ w,
                long long n, long long num_segments,
                unsigned long long* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long s = (long long)ids[i];
    if (s >= 0 && s < num_segments) {
      atomicAdd(&out[s], Weighted ? (unsigned long long)(long long)w[i] : 1ull);
    }
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

size_t max_optin_smem() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (size_t)bytes;
}

// The shared-memory regime: one u32 histogram fits the shared memory a
// block may opt into.
bool uses_shared(long long num_segments) {
  return (size_t)num_segments * sizeof(unsigned int) <= max_optin_smem();
}

long long row_blocks(long long n) { return (n + kThreads - 1) / kThreads; }

template <typename Id, bool Weighted>
int launch(const void* ids, const void* w, long long n, long long num_segments,
           void* out, cudaStream_t stream) {
  const Id* id = static_cast<const Id*>(ids);
  const int32_t* wt = static_cast<const int32_t*>(w);
  unsigned long long* o = static_cast<unsigned long long*>(out);
  const size_t one_copy = (size_t)num_segments * sizeof(unsigned int);
  if (uses_shared(num_segments)) {
    int copies = 1;
    if (one_copy <= kDefaultSmem) {
      copies = (int)(kDefaultSmem / one_copy);
      if (copies > kWarps) copies = kWarps;
    }
    const size_t smem = one_copy * copies;
    auto kernel = bincount_shared<Id, Weighted>;
    if (smem > kDefaultSmem) {
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    }
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  smem);
    long long blocks = (long long)sm_count() * (per_sm > 0 ? per_sm : 1);
    if (blocks > row_blocks(n)) blocks = row_blocks(n);
    kernel<<<(unsigned int)blocks, kThreads, smem, stream>>>(
        id, wt, n, (int)num_segments, copies, o);
  } else {
    long long blocks = (long long)sm_count() * 16;
    if (blocks > row_blocks(n)) blocks = row_blocks(n);
    bincount_global<Id, Weighted><<<(unsigned int)blocks, kThreads, 0, stream>>>(
        id, wt, n, num_segments, o);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ids: n int32 (ids_are_64 == 0) or int64 ids on the device; weights: n
// int32 or NULL; out: num_segments zeroed int64 counts. n >= 1 and
// num_segments >= 1 (the caller skips empty launches). Returns the CUDA
// error of the launch (0 = cudaSuccess).
int deequ_bincount(const void* ids, int ids_are_64, const void* weights,
                   long long n, long long num_segments, void* out,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ids_are_64) {
    return weights ? launch<int64_t, true>(ids, weights, n, num_segments, out, s)
                   : launch<int64_t, false>(ids, weights, n, num_segments, out, s);
  }
  return weights ? launch<int32_t, true>(ids, weights, n, num_segments, out, s)
                 : launch<int32_t, false>(ids, weights, n, num_segments, out, s);
}

// Which regime a launch of this width takes (1 = shared memory, 0 = global
// atomics), so a caller can report it beside a timing.
int deequ_bincount_uses_shared(long long num_segments) {
  return uses_shared(num_segments) ? 1 : 0;
}

}  // extern "C"
