// K6: histogram of segment ids as a one-hot matrix product on Hopper's
// tensor cores (sm_90a).
//
// Replaces deequ_tpu/ops/histogram_device.py:154 bincount_onehot (the
// "onehot" variant of the histogram tier, called through bincount_variant,
// :281), the factored blocked one-hot matmul the reference runs by default
// on its accelerator for every histogram of at most 2^17 bins: an id splits
// into (hi, lo) digits of a lo-radix B, and the counts are
// one_hot(hi)^T @ one_hot(lo), accumulated over row blocks on bf16 planes
// in f32 and folded into integers a block. It computes the tier's function:
// counts over [0, num_segments), ids outside it (negatives, ids >= m, int64
// ids past 2^31) dropped, unweighted counts exact, and with int32 weights
// each bin's total mod 2^32 read as an int32 — bit for bit the plain
// versions' (histogram_device.bincount_plain and bincount_onehot_plain).
//
// What bounds it. Reading each id once (4 or 8 bytes a row) and writing each
// count once, over the memory rate; or the product's operations,
// n * A_pad * B * 2, over the card's dense INT8 tensor rate (1,979 TOP/s on
// an H100 SXM): the one-hot product does A_pad * B multiply-adds a row
// where a scatter does one add, so past a few thousand bins the operations,
// not the bytes, are the bound, and K5 (csrc/bincount.cu) is the faster
// formulation. The variant policy (ops/device_policy.py) routes K6 only
// where the card's sweep (chip_smoke.py, PERF.md) found it no slower.
//
// Design.
// - The digits. B, a power of two from 8 to 128 (to 32 weighted), is the
//   one of least work a row by a rough count (plan_for): every block
//   column stages every row again and every tile tests every 32-row step,
//   so wide keyspaces take the widest radix and narrow ones the least
//   padding; A_pad is ceil(m / B) rounded up to 16. A block's chunk of kChunk rows is loaded
//   once into shared memory as a u16 hi digit (0xFFFF: dropped) and a u8 lo
//   digit a row (and the u32 weight): no one-hot plane is ever written to
//   memory, so the ids are read once a block, 4 or 8 bytes a row.
// - Integer MMA. Each warp owns a tile of 16 hi values by B lo values: NT =
//   B / 8 accumulators of mma.sync.m16n8k32.u8.u8.s32, whose K dimension is
//   32 rows. The A fragment (16 x 32, hi == tile row) and the B fragment
//   (32 x 8, lo == column) are built in registers from the staged digits
//   with SIMD byte compares (__vcmpeq2 / __vcmpeq4) — 0/1 u8 operands
//   multiplied into s32, exact with no float fold. A warp skips a step of
//   32 rows none of whose hi digits falls in its tile (most steps, past a
//   few thousand bins).
// - The grid. Blocks of 8 warps cover up to 8 hi tiles; with fewer tiles,
//   the warps of a tile split its rows (rg row groups) and add their
//   accumulators in shared memory first. The grid runs over (output tiles x
//   row slices), sized to fill the card; a slice holds at most 2^23 rows,
//   so every s32 accumulator stays exact (and below 2^31 weighted: 255 *
//   2^23). Each block adds its non-zero bins into the int64 output with one
//   64-bit atomic each.
// - Weighted. Each weight splits into its four unsigned bytes, which ride
//   the B operand (the lo one-hot times the byte): four products, each exact
//   in s32 per slice, combined with shifts mod 2^32 before the atomic; a
//   last small kernel reads each bin's total mod 2^32 as an int32.
// - The multi-input entry (deequ_onehot_multi, K6 for a fused group, the
//   counterpart of K7's) takes K int64 key vectors and their keyspaces as
//   one virtual row space and adds each vector's offset where its ids are
//   loaded: a row's slot is id + offset where 0 <= id < total - offset,
//   else dropped — fused_bincount_plain's function, ids past their own
//   keyspace landing in the later sets' bins as there.
//
// Widths up to kMaxSegments (2^22, the dense grouping limit; weighted
// 2^20, where the radix stops at 32 and the hi digits must stay u16) are
// taken; wider ones are refused with cudaErrorInvalidValue.
//
// The kernel allocates nothing: the caller passes the zeroed int64 output.
// Plain C interface for ctypes; each entry returns the launches'
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kChunk = 2048;                  // rows staged a block at a time
constexpr int kRowsPerThread = kChunk / kThreads;
constexpr long long kMaxSliceRows = 1ll << 23;
constexpr long long kMaxSegments = 1ll << 22;
constexpr long long kMaxWeightedSegments = 1ll << 20;
constexpr long long kMaxHi = 65520;           // hi digits stay below kDropped
constexpr int kBlocksPerSm = 4;
constexpr int kMaxInputs = 32;
constexpr unsigned short kDropped = 0xFFFF;

// The inputs of one launch as one virtual row space: input i holds rows
// [start[i], start[i + 1]); an id of it counts at slot id + off[i] when
// 0 <= id < lim[i] (lim = bins - off). w: the int32 weights (one input
// only), or null.
struct Inputs {
  const void* ptr[kMaxInputs];
  long long start[kMaxInputs + 1];
  long long lim[kMaxInputs];
  long long off[kMaxInputs];
  const int* w;
  int k;
  int is64;
};

// The launch geometry (module comment).
struct Plan {
  int log_b = 0;          // lo radix B = 1 << log_b
  long long a_pad = 0;    // hi values, a multiple of 16
  int tiles = 0;          // a_pad / 16
  int ht = 0;             // hi tiles a block
  int rg = 0;             // row groups a tile in a block
  int grid_x = 0;         // blocks over the tiles
  long long slices = 0;   // blocks over the rows
  long long slice_rows = 0;
};

// Bytes equal to 1 where the u16 hi digit of rows 0..3 (h.x: rows 0, 1;
// h.y: rows 2, 3) equals the one in both halves of gg.
__device__ __forceinline__ unsigned hi_bytes(uint2 h, unsigned gg) {
  const unsigned e01 = __vcmpeq2(h.x, gg);
  const unsigned e23 = __vcmpeq2(h.y, gg);
  return __byte_perm(e01, e23, 0x6420) & 0x01010101u;
}

// Byte p of each of four u32 words, in order.
__device__ __forceinline__ unsigned byte_plane(uint4 w, int p) {
  const unsigned sel = (unsigned)p | ((unsigned)(p + 4) << 4);
  const unsigned lo = __byte_perm(w.x, w.y, sel);
  const unsigned hi = __byte_perm(w.z, w.w, sel);
  return __byte_perm(lo, hi, 0x5410);
}

__device__ __forceinline__ void mma_u8(unsigned (&c)[4], unsigned a0, unsigned a1,
                                       unsigned a2, unsigned a3, unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One block: the rows of slice blockIdx.y, the hi tiles [blockIdx.x * ht,
// + ht). Warp w takes tile w % ht and row group w / ht; warps past ht * rg
// idle. Within a chunk, row group r takes the steps of 32 rows r, r + rg,...
template <int NT, bool W>
__global__ void __launch_bounds__(kThreads)
onehot_count(const Inputs in, long long m, int log_b, int tiles, int ht, int rg,
             long long slice_rows, long long total_rows, unsigned long long* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned short* hi_s = reinterpret_cast<unsigned short*>(smem);
  unsigned char* lo_s = smem + kChunk * 2;
  unsigned* w_s = reinterpret_cast<unsigned*>(smem + kChunk * 3);
  unsigned* red = reinterpret_cast<unsigned*>(smem + kChunk * (W ? 7 : 3));
  constexpr int B = NT * 8;
  constexpr int kPlanes = W ? 4 : 1;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int my_tile = warp % ht, my_rg = warp / ht;
  const int tile = blockIdx.x * ht + my_tile;
  const bool live = my_rg < rg && tile < tiles;
  const unsigned hi0 = (unsigned)tile * 16u + (unsigned)g;
  const unsigned gg0 = hi0 * 0x00010001u;
  const unsigned gg1 = (hi0 + 8u) * 0x00010001u;

  const int red_words = rg > 1 ? ht * 16 * B : 0;
  for (int i = tid; i < red_words; i += kThreads) red[i] = 0;

  unsigned acc[kPlanes][NT][4];
#pragma unroll
  for (int p = 0; p < kPlanes; ++p)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[p][t][c] = 0;

  const long long row0 = (long long)blockIdx.y * slice_rows;
  const long long row_end = min(row0 + slice_rows, total_rows);
  // The ids of the next chunk are loaded into registers while the warps
  // multiply the current one, so a block keeps its loads in flight
  // instead of waiting out one memory round trip a chunk. Rows past the
  // slice load as -1 (dropped).
  long long ids[kRowsPerThread];
  unsigned wts[W ? kRowsPerThread : 1];
  int load_idx = 0, digit_idx = 0;
  auto fetch = [&](long long c0) {
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const long long r = c0 + j * kThreads + tid;
      ids[j] = -1;
      if (r < row_end) {
        while (r >= in.start[load_idx + 1]) ++load_idx;
        const long long local = r - in.start[load_idx];
        ids[j] = in.is64 ? static_cast<const long long*>(in.ptr[load_idx])[local]
                         : (long long)static_cast<const int*>(in.ptr[load_idx])[local];
        if constexpr (W) wts[j] = (unsigned)in.w[local];
      }
    }
  };
  if (row0 < row_end) fetch(row0);
  for (long long c0 = row0; c0 < row_end; c0 += kChunk) {
    __syncthreads();  // the previous chunk is consumed
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int i = j * kThreads + tid;
      const long long r = c0 + i;
      unsigned short hv = kDropped;
      unsigned char lv = 0;
      unsigned wv = 0;
      if (r < row_end) {
        while (r >= in.start[digit_idx + 1]) ++digit_idx;
        const long long id = ids[j];
        if (id >= 0 && id < in.lim[digit_idx]) {
          const long long slot = id + in.off[digit_idx];
          hv = (unsigned short)(slot >> log_b);
          lv = (unsigned char)(slot & (B - 1));
          if constexpr (W) wv = wts[j];
        }
      }
      hi_s[i] = hv;
      lo_s[i] = lv;
      if constexpr (W) w_s[i] = wv;
    }
    __syncthreads();
    if (c0 + kChunk < row_end) fetch(c0 + kChunk);
    if (!live) continue;
    const int steps = (int)((min((long long)kChunk, row_end - c0) + 31) / 32);
    for (int s = my_rg; s < steps; s += rg) {
      const int base = s * 32 + tig * 4;
      const uint2 h0 = *reinterpret_cast<const uint2*>(hi_s + base);
      const uint2 h1 = *reinterpret_cast<const uint2*>(hi_s + base + 16);
      const unsigned a0 = hi_bytes(h0, gg0), a1 = hi_bytes(h0, gg1);
      const unsigned a2 = hi_bytes(h1, gg0), a3 = hi_bytes(h1, gg1);
      if (!__any_sync(0xffffffffu, (a0 | a1 | a2 | a3) != 0u)) continue;
      const unsigned l0 = *reinterpret_cast<const unsigned*>(lo_s + base);
      const unsigned l1 = *reinterpret_cast<const unsigned*>(lo_s + base + 16);
      unsigned p0[kPlanes], p1[kPlanes];
      if constexpr (W) {
        const uint4 w0 = *reinterpret_cast<const uint4*>(w_s + base);
        const uint4 w1 = *reinterpret_cast<const uint4*>(w_s + base + 16);
#pragma unroll
        for (int p = 0; p < kPlanes; ++p) {
          p0[p] = byte_plane(w0, p);
          p1[p] = byte_plane(w1, p);
        }
      } else {
        p0[0] = p1[0] = 0x01010101u;
      }
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const unsigned key = (unsigned)(t * 8 + g) * 0x01010101u;
        const unsigned e0 = __vcmpeq4(l0, key), e1 = __vcmpeq4(l1, key);
#pragma unroll
        for (int p = 0; p < kPlanes; ++p)
          mma_u8(acc[p][t], a0, a1, a2, a3, e0 & p0[p], e1 & p1[p]);
      }
    }
  }

  // Accumulator c of n-tile t holds bin (hi0 + (c >= 2 ? 8 : 0),
  // t * 8 + tig * 2 + (c & 1)); weighted, the four byte planes combine
  // mod 2^32.
  if (rg > 1) {
    if (live) {
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          unsigned v = acc[0][t][c];
          if constexpr (W) v += (acc[1][t][c] << 8) + (acc[2][t][c] << 16) + (acc[3][t][c] << 24);
          if (v) {
            const int row = g + (c >= 2 ? 8 : 0), col = t * 8 + tig * 2 + (c & 1);
            atomicAdd(red + (my_tile * 16 + row) * B + col, v);
          }
        }
    }
    __syncthreads();
    for (int i = tid; i < red_words; i += kThreads) {
      const unsigned v = red[i];
      if (!v) continue;
      const long long hi = (long long)blockIdx.x * ht * 16 + i / B;
      const long long slot = hi * B + (i % B);
      if (slot < m) atomicAdd(out + slot, (unsigned long long)v);
    }
  } else if (live) {
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        unsigned v = acc[0][t][c];
        if constexpr (W) v += (acc[1][t][c] << 8) + (acc[2][t][c] << 16) + (acc[3][t][c] << 24);
        if (!v) continue;
        const long long hi = (long long)hi0 + (c >= 2 ? 8 : 0);
        const long long slot = hi * B + t * 8 + tig * 2 + (c & 1);
        if (slot < m) atomicAdd(out + slot, (unsigned long long)v);
      }
  }
}

// Weighted: each bin's total mod 2^32, read as an int32, sign-extended.
__global__ void onehot_wrap32(unsigned long long* out, long long m) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < m) out[i] = (unsigned long long)(long long)(int)(unsigned)out[i];
}

// -- the card and the plan -------------------------------------------------------

constexpr int kMaxDevices = 64;
int g_sms[kMaxDevices];
std::mutex g_lock;

// The current device's SM count (0 on a CUDA error, which *err holds).
int sms(int* err) {
  int dev = 0;
  *err = (int)cudaGetDevice(&dev);
  if (*err != 0) return 0;
  if (dev < 0 || dev >= kMaxDevices) {
    *err = (int)cudaErrorInvalidDevice;
    return 0;
  }
  std::lock_guard<std::mutex> lock(g_lock);
  if (g_sms[dev] == 0) {
    *err = (int)cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (*err != 0) return 0;
  }
  return g_sms[dev];
}

Plan plan_for(long long m, long long n, bool weighted, int card_sms) {
  Plan p;
  long long best = -1;
  const int widest = weighted ? 5 : 7;
  for (int lb = 3; lb <= widest; ++lb) {
    const long long b = 1ll << lb;
    const long long a_pad = ((m + b - 1) / b + 15) / 16 * 16;
    if (a_pad > kMaxHi) continue;
    const long long tiles = a_pad / 16;
    const long long blocks = (tiles + kWarpsPerBlock - 1) / kWarpsPerBlock;
    // Work a step of 32 rows, in rough instruction counts: each block
    // column stages every row again (~40), each tile tests every step
    // (~20) and multiplies its b / 8 n-tiles (~12 each).
    const long long cost = blocks * 40 + tiles * (20 + 12 * (b / 8));
    if (best < 0 || cost < best) {
      best = cost;
      p.log_b = lb;
      p.a_pad = a_pad;
    }
  }
  p.tiles = (int)(p.a_pad / 16);
  p.ht = p.tiles < kWarpsPerBlock ? p.tiles : kWarpsPerBlock;
  p.rg = kWarpsPerBlock / p.ht;
  p.grid_x = (p.tiles + p.ht - 1) / p.ht;
  const long long chunks = (n + kChunk - 1) / kChunk;
  long long want = ((long long)kBlocksPerSm * card_sms + p.grid_x - 1) / p.grid_x;
  const long long least = (n + kMaxSliceRows - 1) / kMaxSliceRows;
  if (want < least) want = least;
  if (want > chunks) want = chunks;
  if (want < 1) want = 1;
  const long long per = (chunks + want - 1) / want;
  p.slice_rows = (per > 0 ? per : 1) * kChunk;
  p.slices = (n + p.slice_rows - 1) / p.slice_rows;
  if (p.slices < 1) p.slices = 1;
  return p;
}

size_t smem_bytes(const Plan& p, bool weighted) {
  const size_t staged = (size_t)kChunk * (weighted ? 7 : 3);
  const size_t red = p.rg > 1 ? (size_t)p.ht * 16 * ((size_t)1 << p.log_b) * 4 : 0;
  return staged + red;
}

template <bool W>
cudaError_t launch_nt(const Plan& p, const Inputs& in, long long m, long long rows,
                      unsigned long long* out, cudaStream_t st) {
  const dim3 grid((unsigned)p.grid_x, (unsigned)p.slices, 1);
  const size_t smem = smem_bytes(p, W);
  switch (p.log_b) {
#define DEEQU_K6_CASE(LB, NT)                                                          \
  case LB:                                                                             \
    onehot_count<NT, W><<<grid, kThreads, smem, st>>>(in, m, LB, p.tiles, p.ht, p.rg, \
                                                      p.slice_rows, rows, out);       \
    break;
    DEEQU_K6_CASE(3, 1)
    DEEQU_K6_CASE(4, 2)
    DEEQU_K6_CASE(5, 4)
#undef DEEQU_K6_CASE
    default:
      if constexpr (W) return cudaErrorInvalidValue;  // weighted B stops at 32
      switch (p.log_b) {
        case 6:
          onehot_count<8, false><<<grid, kThreads, smem, st>>>(
              in, m, 6, p.tiles, p.ht, p.rg, p.slice_rows, rows, out);
          break;
        case 7:
          onehot_count<16, false><<<grid, kThreads, smem, st>>>(
              in, m, 7, p.tiles, p.ht, p.rg, p.slice_rows, rows, out);
          break;
        default:
          return cudaErrorInvalidValue;
      }
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The geometry the kernel takes for m bins over n rows (weighted or not) on
// the current card: {log2 B, A_pad, tiles, hi tiles a block, row groups,
// grid x, slices, rows a slice, rows a chunk}. Returns 0, or the CUDA error
// of reading the card, or cudaErrorInvalidValue past kMaxSegments.
int deequ_onehot_plan(long long m, long long n, int weighted, long long* out9) {
  if (m < 1 || m > (weighted ? kMaxWeightedSegments : kMaxSegments) || n < 0)
    return (int)cudaErrorInvalidValue;
  int err = 0;
  const int card = sms(&err);
  if (!card) return err;
  const Plan p = plan_for(m, n, weighted != 0, card);
  const long long vals[9] = {p.log_b, p.a_pad, p.tiles, p.ht, p.rg, p.grid_x,
                             p.slices, p.slice_rows, kChunk};
  for (int i = 0; i < 9; ++i) out9[i] = vals[i];
  return 0;
}

// The widest num_segments the kernel takes, weighted or not.
long long deequ_onehot_widest(int weighted) {
  return weighted ? kMaxWeightedSegments : kMaxSegments;
}

// Counts n ids (int64 when ids_are_64, else int32) over m bins into out (m
// zeroed int64), with int32 weights when weights is not null (module
// comment for the weighted domain). Enqueues on stream; returns the CUDA
// error of the launches (cudaErrorInvalidValue past kMaxSegments).
int deequ_onehot(const void* ids, int ids_are_64, const void* weights, long long n,
                 long long m, void* out, void* stream) {
  const bool weighted = weights != nullptr;
  if (m < 1 || m > (weighted ? kMaxWeightedSegments : kMaxSegments) || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  int err = 0;
  const int card = sms(&err);
  if (!card) return err;
  const Plan p = plan_for(m, n, weighted, card);
  Inputs in = {};
  in.ptr[0] = ids;
  in.start[0] = 0;
  in.start[1] = n;
  in.lim[0] = m;
  in.off[0] = 0;
  in.w = static_cast<const int*>(weights);
  in.k = 1;
  in.is64 = ids_are_64 ? 1 : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* counts = static_cast<unsigned long long*>(out);
  cudaError_t e = weighted ? launch_nt<true>(p, in, m, n, counts, st)
                           : launch_nt<false>(p, in, m, n, counts, st);
  if (e != cudaSuccess) return (int)e;
  if (weighted) {
    onehot_wrap32<<<(unsigned)((m + 255) / 256), 256, 0, st>>>(counts, m);
  }
  return (int)cudaGetLastError();
}

// Counts k int64 id vectors into one out of sum(keyspaces) int64 bins
// (zeroed): input i's ids[i] (ns[i] rows) count at id plus the keyspaces
// before it where 0 <= id and the slot is inside the bins. Inputs ride
// kMaxInputs to a launch; each launch adds into out. Returns the CUDA error
// of the launches (cudaErrorInvalidValue past kMaxSegments bins).
int deequ_onehot_multi(const void* const* ids, const long long* ns,
                       const long long* keyspaces, int k, void* out, void* stream) {
  long long m = 0;
  for (int i = 0; i < k; ++i) m += keyspaces[i];
  if (k < 1 || m < 1 || m > kMaxSegments) return (int)cudaErrorInvalidValue;
  int err = 0;
  const int card = sms(&err);
  if (!card) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* counts = static_cast<unsigned long long*>(out);
  long long off = 0;
  for (int first = 0; first < k; first += kMaxInputs) {
    Inputs in = {};
    in.is64 = 1;
    long long rows = 0;
    for (int i = first; i < k && in.k < kMaxInputs; ++i) {
      in.ptr[in.k] = ids[i];
      in.start[in.k] = rows;
      in.lim[in.k] = m - off;
      in.off[in.k] = off;
      rows += ns[i];
      off += keyspaces[i];
      ++in.k;
    }
    for (int i = in.k; i <= kMaxInputs; ++i) in.start[i] = rows;
    if (rows == 0) continue;
    const Plan p = plan_for(m, rows, false, card);
    const cudaError_t e = launch_nt<false>(p, in, m, rows, counts, st);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
