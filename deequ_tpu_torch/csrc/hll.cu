// HyperLogLog register fold on Hopper (sm_90a): hash and fold in one pass.
//
// Replaces the device half of deequ_tpu/ops/hll.py: idx_rank_numeric /
// idx_rank_pair_device (the canonical f64 -> (hi, lo) f32 split and the bits
// of the pair, _pair_bits_u32), idx_rank_u32 (two murmur fmix32 rounds, clz)
// and registers_from_idx_rank (the register max, which the TPU takes as a
// one-hot bf16 matmul on the MXU, _registers_mxu_fold). It computes the same
// function as deequ_tpu_torch/ops/hll.py:registers_plain, bit for bit: for
// every valid row an (idx, rank) pair, and register[i] = the largest rank
// at idx i (0 where no row lands).
//
// Input modes (one column of one chunk):
// - f64 values: the canonical split as numpy computes it (-0.0 folds to
//   +0.0; hi = f32(x) rounded to nearest, f32 subnormals kept, past the f32
//   range inf; lo = f32(x - hi); a NaN keeps its sign and its top 23 payload
//   bits and gets the quiet bit; lo of a non-finite hi is the bits of
//   np.float32(np.nan)). NaN and inf are read from the f64 bits, never from
//   the card's conversion, which would give a canonical NaN. Built without
//   --use_fast_math and -ftz=true: either flushes f32 subnormals.
// - bool values (1 byte a row): hashed as the u32 bits 0/1 with lo = 0.
// - int32 string codes with the dictionary's packed (idx, rank) table:
//   idx = packed >> 6, rank = packed & 0x3F; a code < 0 (null) or past the
//   table is dropped. The table is gathered here, so the codes are read once.
// An optional validity mask (1 byte a row) drops rows where it is 0.
//
// What bounds it: reading the input once (8 bytes a row for f64, plus the
// mask's byte); the hash is ~40 integer operations a row, far below the
// card's integer rate. 512 registers hit by every row would serialise on
// L2 atomics, so each block keeps its own register file in shared memory,
// and a row takes the shared-memory atomic only where its rank beats what
// the register already holds: after the first rows almost none does. Each
// block then max-folds its non-zero registers into the output with one
// global atomicMax each. Max commutes, so the result is exact and
// deterministic. The kernel allocates nothing: the caller passes the
// zeroed output. Plain C interface for ctypes; deequ_hll_registers returns
// the launch's cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;           // rows a thread has in flight
constexpr int kBlocksPerSm = 4;      // 2,048 threads: a full SM
constexpr int kMaxDevices = 64;
constexpr uint32_t kSeed = 42u;      // ops/hll.py:XXHASH_SEED
constexpr uint32_t kNaN32 = 0x7FC00000u;

enum Mode { kF64 = 0, kBool = 1, kLut = 2 };

template <int M> struct In;
template <> struct In<kF64> { using T = double; };
template <> struct In<kBool> { using T = unsigned char; };
template <> struct In<kLut> { using T = int; };

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// The bits of the canonical (hi, lo) split (header).
__device__ __forceinline__ void split_bits(double x, uint32_t* hb, uint32_t* lb) {
  const unsigned long long b = (unsigned long long)__double_as_longlong(x);
  const uint32_t sign = (uint32_t)(b >> 32) & 0x80000000u;
  if ((b & 0x7FF0000000000000ull) == 0x7FF0000000000000ull) {
    const bool nan = (b & 0x000FFFFFFFFFFFFFull) != 0;
    *hb = nan ? (sign | kNaN32 | ((uint32_t)(b >> 29) & 0x7FFFFFu)) : (sign | 0x7F800000u);
    *lb = kNaN32;
    return;
  }
  const double c = x == 0.0 ? 0.0 : x;
  const float hi = __double2float_rn(c);
  *hb = __float_as_uint(hi);
  *lb = isinf(hi) ? kNaN32 : __float_as_uint(__double2float_rn(c - (double)hi));
}

// ops/hll.py:idx_rank_u32
__device__ __forceinline__ void idx_rank(uint32_t hb, uint32_t lb, int p, uint32_t* idx,
                                         int* rank) {
  const uint32_t a = fmix32(fmix32(hb ^ kSeed) ^ lb);
  const uint32_t b = fmix32(fmix32(lb ^ kSeed ^ 0x9E3779B9u) ^ hb);
  *idx = a >> (32 - p);
  const uint32_t w1 = a << p;
  const int r = w1 ? __clz(w1) + 1 : (32 - p) + __clz(b) + 1;
  const int cap = 64 - p + 1;
  *rank = r < cap ? r : cap;
}

template <int M>
__device__ __forceinline__ typename In<M>::T load(const void* x, long long r) {
  const typename In<M>::T* p = static_cast<const typename In<M>::T*>(x);
  if constexpr (M == kBool) {
    return p[r];
  } else {
    return __ldcs(p + r);  // read once: evict first
  }
}

// (idx, rank) of one loaded row; false where the mode drops it.
template <int M>
__device__ __forceinline__ bool hash(typename In<M>::T v, const int* lut, long long lut_len,
                                     int p, uint32_t* idx, int* rank) {
  if constexpr (M == kF64) {
    uint32_t hb, lb;
    split_bits(v, &hb, &lb);
    idx_rank(hb, lb, p, idx, rank);
    return true;
  } else if constexpr (M == kBool) {
    idx_rank(v ? 1u : 0u, 0u, p, idx, rank);
    return true;
  } else {
    if (v < 0 || (long long)v >= lut_len) return false;
    const int packed = __ldg(lut + v);
    *idx = (uint32_t)packed >> 6;
    *rank = packed & 0x3F;
    return true;
  }
}

template <int M>
__global__ void __launch_bounds__(kThreads)
hll_fold(const void* __restrict__ x, const unsigned char* __restrict__ valid,
         const int* __restrict__ lut, long long lut_len, long long n, int p,
         int* __restrict__ regs) {
  extern __shared__ int sregs[];
  const int m = 1 << p;
  for (int j = threadIdx.x; j < m; j += blockDim.x) sregs[j] = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += kUnroll * stride) {
    typename In<M>::T v[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // loads first: kUnroll rows in flight
      const long long r = i + u * stride;
      ok[u] = r < n;
      v[u] = ok[u] ? load<M>(x, r) : (typename In<M>::T)0;
      if (valid != nullptr && ok[u]) ok[u] = __ldcs(valid + r) != 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      uint32_t idx;
      int rank;
      if (ok[u] && hash<M>(v[u], lut, lut_len, p, &idx, &rank) &&
          rank > *(volatile int*)(sregs + idx))
        atomicMax(sregs + idx, rank);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const int r = sregs[j];
    if (r) atomicMax(regs + j, r);
  }
}

// SMs of each device, read once.
int sms_of(int* err) {
  static std::mutex mu;
  static int sms[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev >= kMaxDevices) {
    *err = e != cudaSuccess ? (int)e : (int)cudaErrorInvalidDevice;
    return 0;
  }
  std::lock_guard<std::mutex> lock(mu);
  if (sms[dev] == 0) {
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) {
      *err = (int)e;
      return 0;
    }
  }
  return sms[dev];
}

template <int M>
void launch(int sms, const void* x, const unsigned char* valid, const int* lut,
            long long lut_len, long long n, int p, int* regs, cudaStream_t stream) {
  long long grid = (n + (long long)kThreads * kUnroll - 1) / ((long long)kThreads * kUnroll);
  if (grid > (long long)kBlocksPerSm * sms) grid = (long long)kBlocksPerSm * sms;
  hll_fold<M><<<(unsigned)grid, kThreads, (size_t)4 << p, stream>>>(x, valid, lut, lut_len, n,
                                                                     p, regs);
}

}  // namespace

extern "C" {

// Max-folds the HLL (idx, rank) of n rows into regs (2^p int32 on the
// device, zeroed by the caller). mode 0: x is n f64 values; 1: n bytes of
// bool values; 2: n int32 string codes into lut (lut_len int32 packed
// entries). valid: n bytes (0 drops the row) or NULL. 4 <= p <= 12, n >= 1.
// Enqueues on stream and returns the CUDA error of the launch
// (0 = cudaSuccess).
int deequ_hll_registers(int mode, const void* x, const void* valid, const void* lut,
                        long long lut_len, long long n, int p, void* regs, void* stream) {
  if (p < 4 || p > 12 || n < 1 || mode < kF64 || mode > kLut ||
      (mode == kLut && (lut == nullptr || lut_len < 1)))
    return (int)cudaErrorInvalidValue;
  int err = 0;
  const int sms = sms_of(&err);
  if (!sms) return err;
  const unsigned char* v = static_cast<const unsigned char*>(valid);
  const int* t = static_cast<const int*>(lut);
  int* out = static_cast<int*>(regs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kF64) launch<kF64>(sms, x, v, t, lut_len, n, p, out, s);
  else if (mode == kBool) launch<kBool>(sms, x, v, t, lut_len, n, p, out, s);
  else launch<kLut>(sms, x, v, t, lut_len, n, p, out, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
