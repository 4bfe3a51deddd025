// K6: histogram of segment ids as a one-hot matrix product on Hopper's
// integer tensor cores (sm_90a).
//
// Replaces deequ_tpu/ops/histogram_device.py:154 bincount_onehot (the
// "onehot" variant of the histogram tier, called through bincount_variant,
// :307), the factored blocked one-hot matmul the reference runs by default
// on its accelerator for every histogram of at most 2^17 bins: an id splits
// into (hi, lo) digits of a lo-radix B, and the counts are
// one_hot(hi)^T @ one_hot(lo), accumulated over row blocks. It computes the
// tier's function: counts over [0, num_segments), ids outside it
// (negatives, ids >= m, int64 ids past 2^31) dropped, unweighted counts
// exact, and with int32 weights each bin's total mod 2^32 read as an int32
// — bit for bit the plain versions' (histogram_device.bincount_plain and
// bincount_onehot_plain).
//
// The product. Each warp owns one tile of 16 hi values by B lo values (B a
// power of two from 8 to 128, to 32 weighted): NT = B / 8 accumulators of
// mma.sync.m16n8k32.u8.u8.s32, whose K dimension is 32 rows, exact with no
// float fold. The A fragment is the hi one-hot of the step's 32 rows (16
// x 32), the B fragment the lo one-hot (32 x 8) of each n-tile. The 32
// K-slots of a step may hold any 32 rows as long as both fragments agree
// slot for slot. A fragment register is four slots at once: the A
// registers, and the B registers below 8 n-tiles, compare four bytes with
// a key (eq80: three integer instructions); from 8 n-tiles on, unweighted,
// a B register is one PTX prmt that looks each slot's lo / 8 up in a table
// of one set byte (lo_selectors builds the selectors once a step), since
// past that the compares, six a n-tile, bound the loop. An accumulator
// holds 128 a row from a compared B byte (0x80) and 1 from a looked-up one
// (Fragments::unit_shift); weighted, each weight rides the B operand as
// four byte planes, each plane's accumulator exact in s32 (255 x 2^23 <
// 2^31), combined mod 2^32 before the output. No warp accumulates more than
// 2^23 rows (kMaxWarpRows), so no accumulator can overflow.
//
// Two routes, by one rule (plan_for): B is the least power of two (8 to 128,
// 32 weighted) with 16 * B >= m; when one tile of 16 * B bins covers the
// keyspace (m <= kNarrowBins = 2,048, the widest whose accumulators fit one
// warp's registers: 16 x 128 bins are 64 s32 registers a lane; weighted 512,
// four planes of 16 x 32) the narrow route takes it, else the wide route,
// in tiles of 16 * B bins: B = 64 while kMaxTiles = 2,048 tiles of 1,024
// bins cover m (to 2^21 bins), then 128 (to 2^22); weighted 32, tiles of
// 512. A narrower tile halves a step's n-tiles and more tiles cost the
// partition more: B = 64 took 0.178 ms at 2^17 bins where 128 took 0.197,
// and 0.321 ms at 2^22 where 128 took 0.306.
//
// - Narrow (onehot_narrow). What bounds it is reading the ids once: 80 MB
//   of int64 ids at 10^7 rows, 0.0239 ms at 3.35 TB/s; the product, n * 16
//   * B * 2 operations, is 0.0103 ms at 1,024 bins over 1,979 TOP/s. The ids
//   go from device memory straight into MMA fragments, with no shared memory
//   and no block barrier in the row loop: a persistent grid of warps, two
//   blocks of 8 a SM, each warp a contiguous range of
//   16-byte vectors read with coalesced evict-first loads, eight rows a
//   lane, the next eight loaded while these multiply (to 4 n-tiles; wider
//   tiles have no registers for it). A lane turns its two rows of a 64-row
//   group into one word of digits (hi, hi, lo, lo bytes; a dropped row's hi
//   0x7F matches no tile row), and the lanes of a step's tig group gather
//   the 8 rows they multiply with four shuffles: lanes 0-15 feed the
//   group's first step, 16-31 its second. No step is tested or skipped:
//   every row lands in the warp's one tile. At the end the block's warps
//   add their accumulators in shared memory, and one 64-bit atomic a
//   non-zero bin goes to the output.
// - Wide (onehot_tile_count, onehot_tile_scan, onehot_partition,
//   onehot_tiles). Rows are partitioned by tile first, then each tile is
//   multiplied over its own rows only, so the product is n * 16 * B * 2
//   operations (0.010 ms at 10^7 rows and B = 64), not n * A_pad * B * 2,
//   and no warp tests a row outside its tile. A global counting sort:
//   pass 1 counts each block's rows a tile (shared-memory counters, one copy
//   a warp where they fit) and reserves the block's place within each tile
//   with one global atomic a (block, tile); a one-block scan lays the tiles'
//   regions out one after another, each padded to 32 rows; pass 2 reads the
//   ids again, sorts each 8,192-row chunk by tile in shared memory and
//   writes each tile's run of u16 in-tile digits (and u32 weights) to its
//   place in the tile's region, coalesced. Both passes find a chunk's rows'
//   inputs first and then start all eight loads a thread in straight-line
//   code, so they are in flight at once. The multiply then gives each block
//   of 8 warps an equal contiguous range of the regions' 32-row steps (a
//   hot tile's rows spread over as many blocks as its steps fill, with no
//   contention on any counter); a step is 64 contiguous bytes, each tig
//   group's 8 digits one 16-byte load shared by its 8 lanes (no shuffle). A
//   block adds its tile's accumulators in shared memory and then into the
//   output: plain adds where no other block holds rows of the tile, one
//   64-bit atomic a non-zero bin where one does. The ids are read twice
//   (pass 1 and 2), the digits written once and read once: at 10^7 int64
//   rows 160 + 20 + 20 MB. K5's partition regime keeps tile-local runs
//   (one read), whose second pass is bound by L2 latency; the counting
//   sort's contiguous regions are what let the multiply stream 64-byte
//   steps, so its partition is K6's own, beside K5's.
//
// The multi-input entry (deequ_onehot_multi, K6 for a fused group, the
// counterpart of K7's) takes K int64 key vectors and their keyspaces as one
// virtual row space and adds each vector's offset where its ids are loaded:
// a row's slot is id + offset where 0 <= id < total - offset, else dropped
// — fused_bincount_plain's function, ids past their own keyspace landing in
// the later sets' bins as there. It takes the same two routes by the summed
// keyspace.
//
// Measured on an H100 80GB HBM3 at 700 W (10^7 int64 Zipf ids, the kernel
// alone, in turns; PERF.md; tools/time_k6.py builds each probe) and not
// taken:
// - each lane loading its tig group's eight rows itself (16-byte loads
//   shared by the group's 8 lanes, eight digit computations a lane a step)
//   in place of the narrow route's coalesced loads and shuffles: 0.074 ms
//   at 9 bins against 0.034;
// - compares at every NT (DEEQU_K6_EQ_FRAGMENTS): 0.117 ms at 2,048 bins
//   against 0.095, and 0.218 against 0.192 at 2^17 with B = 128 tiles;
// - no load ahead (DEEQU_K6_NO_AHEAD): 0.0345 ms at 9 bins against 0.0338;
// - three narrow blocks a SM at 1 or 2 n-tiles (85 registers): 0.037 ms at
//   9 bins against 0.034;
// - two partition blocks a SM of 1,024 threads (32 registers, spilled):
//   0.398 ms at 2^17 against 0.195; two of 512: 0.192 against 0.197 at
//   2^17, 0.323 against 0.304 at 2^22;
// - three multiplying blocks a SM at B = 64: 0.1756 ms at 2^17 against
//   0.1759.
// wgmma reads B only from shared memory, and the lo one-hot is built a row
// at a time in registers, so it was not tried: mma.sync takes both
// fragments from registers. K5 (csrc/bincount.cu) stays faster at every
// width: 0.031 ms at 9 bins, 0.070 at 2^17.
//
// Widths up to kMaxSegments (2^22, the dense grouping limit; weighted 2^20,
// 2,048 tiles of 512 bins) are taken; wider ones are refused with
// cudaErrorInvalidValue.
//
// The kernel allocates nothing: the caller passes the zeroed int64 output
// and the scratch deequ_onehot_scratch_bytes asks for (none on the narrow
// route). Plain C interface for ctypes; each entry returns the launches'
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kWarps = 8;                       // warps of a multiplying block
constexpr int kThreads = kWarps * 32;
constexpr int kBlocksPerSm = 2;                 // multiplying blocks a SM
constexpr int kPartThreads = 1024;              // the partition passes' blocks, one a SM
constexpr int kPartRows = 8;                    // rows a thread a chunk
constexpr int kChunk = kPartThreads * kPartRows;  // rows a chunk
constexpr int kCountWords = 12288;              // pass 1's counters (48 KB)
constexpr long long kMaxWarpRows = 1ll << 23;   // rows an accumulator takes
constexpr long long kRoundRows = 1ll << 30;     // rows of one round of launches
constexpr long long kMaxSegments = 1ll << 22;
constexpr long long kMaxWeightedSegments = 1ll << 20;
constexpr int kMaxLogB = 7, kMaxWeightedLogB = 5;
constexpr long long kNarrowBins = 16ll << kMaxLogB;  // 2,048
constexpr long long kNarrowWeightedBins = 16ll << kMaxWeightedLogB;  // 512
constexpr int kMaxTiles = 2048;
constexpr int kMaxInputs = 32;
constexpr unsigned kDropHi = 0x7Fu;             // the hi digit of a dropped row
constexpr unsigned kFull = 0xffffffffu;

// The pieces of one round as one virtual row space: piece i holds rows
// [start[i], start[i + 1]); an id of it counts at slot id + off[i] when
// 0 <= id < lim[i] (lim = bins - off). w: the int32 weights of piece 0
// (one piece only), or null.
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
  int wide = 0;             // 0: the narrow route, 1: the wide route
  int log_b = 0;            // lo radix B = 1 << log_b
  int tiles = 0;            // tiles of 16 * B bins (1 on the narrow route)
  int blocks = 0;           // multiplying blocks
  int part_blocks = 0;      // blocks of the partition passes (wide)
  int copies = 0;           // pass 1's counter copies a block (wide)
  long long round_rows = 0; // rows a round takes at most
};

// 0x80 in each byte of d that is 0, else 0. Every byte of d must be below
// 0x80, so the add carries out of no byte.
__device__ __forceinline__ unsigned eq80(unsigned d) {
  return ~(d + 0x7F7F7F7Fu) & 0x80808080u;
}

// Byte p of each of four u32 words, in order.
__device__ __forceinline__ unsigned byte_plane(uint4 w, int p) {
  const unsigned sel = (unsigned)p | ((unsigned)(p + 4) << 4);
  const unsigned lo = __byte_perm(w.x, w.y, sel);
  const unsigned hi = __byte_perm(w.z, w.w, sel);
  return __byte_perm(lo, hi, 0x5410);
}

// PTX prmt in its default mode: a selector nibble with bit 3 set replicates
// the sign of the byte it picks (__byte_perm reads only bits 0-2).
__device__ __forceinline__ unsigned prmt(unsigned a, unsigned b, unsigned sel) {
  unsigned d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
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

template <bool W> struct Planes { static constexpr int P = W ? 4 : 1; };

// Whether the B fragments of NT n-tiles are byte-permute lookups (one
// PRMT a register, after ~24 instructions a step to build the selectors)
// rather than compares (three instructions a register): from 8 n-tiles
// on, unweighted. DEEQU_K6_EQ_FRAGMENTS (a probe) compares at every NT.
// unit_shift: what one counted row adds to an unweighted accumulator,
// 0x80 from a compare's B byte, 1 from a lookup's.
template <int NT, bool W> struct Fragments {
#ifdef DEEQU_K6_EQ_FRAGMENTS
  static constexpr bool permute = false;
#else
  static constexpr bool permute = !W && NT >= 8;
#endif
  static constexpr int unit_shift = permute ? 0 : 7;
};

// Four slots' lo bytes (v = lo ^ g in each byte, for lane g) as two PRMT
// selectors: in sel_lo, nibble j = lo_j / 8 where lo_j % 8 == g, with bit 3
// set otherwise or where lo_j / 8 >= 8 (a selector nibble with bit 3
// replicates the sign of a table byte, and no table byte has one: 0); in
// sel_hi, lo_j / 8 - 8 likewise. A nibble then picks byte lo_j / 8 (mod 8)
// of an 8-byte table that holds 1 at byte t % 8 for n-tile t.
__device__ __forceinline__ unsigned nibbles(unsigned x) {  // bytes < 16 -> nibbles
  return __byte_perm(x | (x >> 4), 0u, 0x0020);
}
__device__ __forceinline__ void lo_selectors(unsigned v, unsigned& sel_lo, unsigned& sel_hi) {
  const unsigned miss = nibbles((eq80(v & 0x07070707u) ^ 0x80808080u) >> 4);
  const unsigned hi = nibbles((v >> 3) & 0x0F0F0F0Fu);
  sel_lo = hi | miss;
  sel_hi = (hi ^ 0x8888u) | miss;
}

// One step of 32 rows into the warp's tile. Lane (g = lane / 4, tig = lane
// % 4) holds the hi and lo digits of its K-slots tig*4 + 0..3 (h01, l01)
// and 16 + tig*4 + 0..3 (h23, l23), one byte a slot, and weighted the byte
// planes of their weights (p01[p], p23[p]). A rows g and g + 8 are the hi
// values; B column g of n-tile t is lo value 8t + g.
template <int NT, bool W>
__device__ __forceinline__ void mma_step(unsigned (&acc)[Planes<W>::P][NT][4], unsigned h01,
                                         unsigned h23, unsigned l01, unsigned l23,
                                         const unsigned (&p01)[4], const unsigned (&p23)[4],
                                         unsigned g) {
  const unsigned gg = g * 0x01010101u, g8 = gg + 0x08080808u;
  const unsigned a0 = eq80(h01 ^ gg) >> 7, a1 = eq80(h01 ^ g8) >> 7;
  const unsigned a2 = eq80(h23 ^ gg) >> 7, a3 = eq80(h23 ^ g8) >> 7;
  const unsigned v01 = l01 ^ gg, v23 = l23 ^ gg;
  if constexpr (Fragments<NT, W>::permute) {
    unsigned s01[2], s23[2];
    lo_selectors(v01, s01[0], s01[1]);
    lo_selectors(v23, s23[0], s23[1]);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int k = t & 7;
      const unsigned tx = k < 4 ? 1u << (8 * k) : 0u, ty = k < 4 ? 0u : 1u << (8 * (k - 4));
      mma_u8(acc[0][t], a0, a1, a2, a3, prmt(tx, ty, s01[t >> 3]), prmt(tx, ty, s23[t >> 3]));
    }
  } else {
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const unsigned key = (unsigned)t * 0x08080808u;
      const unsigned e0 = eq80(v01 ^ key), e1 = eq80(v23 ^ key);
      if constexpr (W) {
        const unsigned m0 = (e0 >> 7) * 0xFFu, m1 = (e1 >> 7) * 0xFFu;
#pragma unroll
        for (int p = 0; p < 4; ++p) mma_u8(acc[p][t], a0, a1, a2, a3, m0 & p01[p], m1 & p23[p]);
      } else {
        mma_u8(acc[0][t], a0, a1, a2, a3, e0, e1);
      }
    }
  }
}

// Accumulator c of n-tile t: its count (weighted: the planes combined mod
// 2^32; unweighted: shifted down by Fragments::unit_shift).
template <int NT, bool W>
__device__ __forceinline__ unsigned acc_value(const unsigned (&acc)[Planes<W>::P][NT][4],
                                              int t, int c) {
  if constexpr (W)
    return acc[0][t][c] + (acc[1][t][c] << 8) + (acc[2][t][c] << 16) + (acc[3][t][c] << 24);
  else
    return acc[0][t][c] >> Fragments<NT, W>::unit_shift;
}

// Adds the warp's accumulators into the block's tile in shared memory
// (row * B + column, 16 x B words).
template <int NT, bool W>
__device__ __forceinline__ void acc_to_shared(const unsigned (&acc)[Planes<W>::P][NT][4],
                                              unsigned* red, int lane) {
  constexpr int B = NT * 8;
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const unsigned v = acc_value<NT, W>(acc, t, c);
      if (v) atomicAdd(red + (g + (c >= 2 ? 8 : 0)) * B + t * 8 + tig * 2 + (c & 1), v);
    }
}

// -- the narrow route ---------------------------------------------------------

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
  __device__ static long long at(const T& v, int k) {
    return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
  }
  __device__ static T none() { return make_int4(-1, -1, -1, -1); }
};

// The digits of one row in the narrow route's one tile: hi (kDropHi when
// the row is dropped) and lo.
__device__ __forceinline__ unsigned row_hi(long long id, long long lim, unsigned off, int lb) {
  return (unsigned long long)id < (unsigned long long)lim ? ((unsigned)id + off) >> lb : kDropHi;
}
__device__ __forceinline__ unsigned row_lo(long long id, unsigned off, int lb) {
  return ((unsigned)id + off) & ((1u << lb) - 1u);
}

// Two rows' digits as one word: hi a, hi b, lo a, lo b.
__device__ __forceinline__ unsigned digit_pair(long long a, long long b, long long lim,
                                               unsigned off, int lb) {
  return row_hi(a, lim, off, lb) | (row_hi(b, lim, off, lb) << 8) |
         (row_lo(a, off, lb) << 16) | (row_lo(b, off, lb) << 24);
}

// A group of 64 rows, two a lane as digit_pair words (and weighted their
// weights' byte planes: pw01 = planes 0 and 1, pw23 = planes 2 and 3, each
// as [a, b, a, b]): lanes 0-15 feed the first step, 16-31 the second; a tig
// group takes its 8 rows from four lanes by shuffles.
template <int NT, bool W>
__device__ __forceinline__ void mma_group(unsigned (&acc)[Planes<W>::P][NT][4], unsigned word,
                                          unsigned pw01, unsigned pw23, int lane) {
  const unsigned g = (unsigned)lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int src = half * 16 + tig * 4;
    const unsigned s0 = __shfl_sync(kFull, word, src), s1 = __shfl_sync(kFull, word, src + 1);
    const unsigned s2 = __shfl_sync(kFull, word, src + 2), s3 = __shfl_sync(kFull, word, src + 3);
    unsigned p01[4] = {0, 0, 0, 0}, p23[4] = {0, 0, 0, 0};
    if constexpr (W) {
      const unsigned q0 = __shfl_sync(kFull, pw01, src), r0 = __shfl_sync(kFull, pw23, src);
      const unsigned q1 = __shfl_sync(kFull, pw01, src + 1), r1 = __shfl_sync(kFull, pw23, src + 1);
      const unsigned q2 = __shfl_sync(kFull, pw01, src + 2), r2 = __shfl_sync(kFull, pw23, src + 2);
      const unsigned q3 = __shfl_sync(kFull, pw01, src + 3), r3 = __shfl_sync(kFull, pw23, src + 3);
      p01[0] = __byte_perm(q0, q1, 0x5410);
      p01[1] = __byte_perm(q0, q1, 0x7632);
      p01[2] = __byte_perm(r0, r1, 0x5410);
      p01[3] = __byte_perm(r0, r1, 0x7632);
      p23[0] = __byte_perm(q2, q3, 0x5410);
      p23[1] = __byte_perm(q2, q3, 0x7632);
      p23[2] = __byte_perm(r2, r3, 0x5410);
      p23[3] = __byte_perm(r2, r3, 0x7632);
    }
    mma_step<NT, W>(acc, __byte_perm(s0, s1, 0x5410), __byte_perm(s2, s3, 0x5410),
                    __byte_perm(s0, s1, 0x7632), __byte_perm(s2, s3, 0x7632), p01, p23, g);
  }
}

// The weights' byte planes of rows a and b (mma_group).
__device__ __forceinline__ void weight_planes(unsigned wa, unsigned wb, unsigned& pw01,
                                              unsigned& pw23) {
  pw01 = __byte_perm(wa, wb, 0x5140);
  pw23 = __byte_perm(wa, wb, 0x7362);
}

// Every row of one piece into the warp's accumulators: the 16-byte vectors
// in contiguous ranges a warp (eight rows a lane in flight), then the rows
// before the first aligned vector and after the last (at most 2 (N - 1))
// as one group of warp 0.
template <typename Id, int NT, bool W>
__device__ __forceinline__ void narrow_piece(unsigned (&acc)[Planes<W>::P][NT][4],
                                             const Id* ids, const int* w, long long n,
                                             long long lim, unsigned off, int lb, int gw,
                                             int nw, int lane) {
  using V = Vec16<Id>;
  using VT = typename V::T;
  constexpr int N = V::N;
  constexpr int U = 8 / N;
  const long long mis = (long long)(((uintptr_t)ids & 15) / sizeof(Id));
  long long head = mis ? N - mis : 0;
  if (head > n) head = n;
  long long nv = (n - head) / N;
  const long long tail = head + nv * N;
  long long per = (nv + nw - 1) / nw;
  per = (per + 31) / 32 * 32;
  const long long v0 = (long long)gw * per;
  const long long v1 = v0 + per < nv ? v0 + per : nv;
  const VT* vp = reinterpret_cast<const VT*>(ids + head);
  // Narrow tiles (few n-tiles, unweighted) load the next batch before
  // multiplying this one; wider ones have no registers to spare for it.
#ifdef DEEQU_K6_NO_AHEAD
  constexpr bool kAhead = false;
#else
  constexpr bool kAhead = !W && NT <= 4;
#endif
  VT buf[U];
  auto load = [&](VT (&into)[U], long long v) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long j = v + u * 32 + lane;
      into[u] = j < v1 ? __ldcs(vp + j) : V::none();
    }
  };
  if (kAhead && v0 < v1) load(buf, v0);
  for (long long v = v0; v < v1; v += 32 * U) {
    VT next[U];
    if constexpr (kAhead) {
      if (v + 32 * U < v1) load(next, v + 32 * U);
    } else {
      load(buf, v);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long j = v + u * 32 + lane;
#pragma unroll
      for (int k = 0; k < N; k += 2) {
        unsigned pw01 = 0, pw23 = 0;
        if constexpr (W) {
          const long long r = head + j * N + k;
          weight_planes(j < v1 ? (unsigned)__ldcs(w + r) : 0u,
                        j < v1 ? (unsigned)__ldcs(w + r + 1) : 0u, pw01, pw23);
        }
        mma_group<NT, W>(acc, digit_pair(V::at(buf[u], k), V::at(buf[u], k + 1), lim, off, lb),
                         pw01, pw23, lane);
      }
    }
    if constexpr (kAhead) {
#pragma unroll
      for (int u = 0; u < U; ++u) buf[u] = next[u];
    }
  }
  if (gw == 0 && head + (n - tail) > 0) {
    const long long e = lane < head ? lane : tail + (lane - head);
    const bool live = lane < head || e < n;
    const long long ia = live ? (long long)ids[e] : -1;
    unsigned pw01 = 0, pw23 = 0;
    if constexpr (W) weight_planes(live ? (unsigned)w[e] : 0u, 0u, pw01, pw23);
    mma_group<NT, W>(acc, digit_pair(ia, -1, lim, off, lb), pw01, pw23, lane);
  }
}

// The narrow route: the whole keyspace in one tile of 16 x B bins, every
// row of every piece once into the warp's accumulators, the block's warps
// added in shared memory, one 64-bit atomic a non-zero bin into out.
template <int NT, bool W>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
onehot_narrow(const __grid_constant__ Inputs in, long long m, int lb,
              unsigned long long* __restrict__ out) {
  constexpr int B = NT * 8;
  __shared__ unsigned red[16 * B];
  const int tid = threadIdx.x, lane = tid & 31;
  const int gw = blockIdx.x * kWarps + (tid >> 5), nw = gridDim.x * kWarps;
  for (int i = tid; i < 16 * B; i += kThreads) red[i] = 0u;
  unsigned acc[Planes<W>::P][NT][4];
#pragma unroll
  for (int p = 0; p < Planes<W>::P; ++p)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[p][t][c] = 0u;
  for (int j = 0; j < in.k; ++j) {
    const long long n = in.start[j + 1] - in.start[j];
    if (n == 0) continue;
    const unsigned off = (unsigned)in.off[j];
    if (in.is64)
      narrow_piece<long long, NT, W>(acc, static_cast<const long long*>(in.ptr[j]), in.w, n,
                                     in.lim[j], off, lb, gw, nw, lane);
    else
      narrow_piece<int, NT, W>(acc, static_cast<const int*>(in.ptr[j]), in.w, n, in.lim[j],
                               off, lb, gw, nw, lane);
  }
  __syncthreads();
  acc_to_shared<NT, W>(acc, red, lane);
  __syncthreads();
  for (int i = tid; i < 16 * B && i < m; i += kThreads)
    if (red[i]) atomicAdd(out + i, (unsigned long long)red[i]);
}

// -- the wide route -----------------------------------------------------------

// The slots of a thread's kPartRows rows of a chunk (row c0 + j *
// kPartThreads + threadIdx.x), -1 where dropped or past r1; idx is the
// thread's piece cursor (rows ascend). The pieces are found first and the
// loads started after, in straight-line code, so all of them are in flight
// at once. Weighted (one piece), wv gets the rows' weights.
template <typename Id, bool W>
__device__ __forceinline__ void chunk_slots(const Inputs& in, long long c0, long long r1, int& idx,
                                            long long (&slot)[kPartRows],
                                            unsigned (&wv)[kPartRows]) {
  int piece[kPartRows];
  long long local[kPartRows];
#pragma unroll
  for (int j = 0; j < kPartRows; ++j) {
    const long long r = c0 + j * kPartThreads + threadIdx.x;
    if (r < r1)
      while (r >= in.start[idx + 1]) ++idx;
    piece[j] = idx;
    local[j] = r - in.start[idx];
  }
  Id id[kPartRows];
#pragma unroll
  for (int j = 0; j < kPartRows; ++j) {
    const bool live = c0 + j * kPartThreads + threadIdx.x < r1;
    id[j] = live ? __ldcs(static_cast<const Id*>(in.ptr[piece[j]]) + local[j]) : (Id)-1;
    if constexpr (W) wv[j] = live ? (unsigned)__ldcs(in.w + local[j]) : 0u;
  }
#pragma unroll
  for (int j = 0; j < kPartRows; ++j) {
    const long long v = id[j];
    slot[j] = (unsigned long long)v < (unsigned long long)in.lim[piece[j]] ? v + in.off[piece[j]]
                                                                          : -1;
  }
}

// This block's contiguous range of the round's rows (both partition passes
// take the same one).
__device__ __forceinline__ void block_rows(long long rows, long long& r0, long long& r1) {
  const long long per = (rows + gridDim.x - 1) / gridDim.x;
  r0 = (long long)blockIdx.x * per;
  r1 = r0 + per < rows ? r0 + per : rows;
}

// start[b] = sum of count[0..b) for b in [0, buckets]; one call per block,
// every thread takes part, kScanItems buckets a thread: buckets <=
// kMaxTiles.
constexpr int kScanItems = (kMaxTiles + kPartThreads - 1) / kPartThreads;
__device__ void exclusive_scan(const unsigned* count, unsigned* start, int buckets) {
  __shared__ unsigned warp_sums[32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b0 = kScanItems * t;
  unsigned x[kScanItems], sum = 0u;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    x[k] = b0 + k < buckets ? count[b0 + k] : 0u;
    sum += x[k];
  }
  unsigned incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const unsigned s = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0u;
    unsigned si = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, si, o);
      if (lane >= o) si += y;
    }
    warp_sums[lane] = si - s;
  }
  __syncthreads();
  unsigned excl = incl - sum + warp_sums[warp];
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    if (b0 + k < buckets) start[b0 + k] = excl;
    excl += x[k];
  }
  if (b0 < buckets && buckets <= b0 + kScanItems) start[buckets] = excl;
}

// Pass 1: the block's rows counted a tile (copies of the counters, one a
// warp where they fit); then, for every tile it holds rows of, the block's
// place within the tile: rel[block * tiles + tile] = atomicAdd(total[tile]).
template <typename Id>
__global__ void __launch_bounds__(kPartThreads)
onehot_tile_count(const __grid_constant__ Inputs in, long long rows, int tile_shift, int tiles,
                  int copies, unsigned* __restrict__ total, unsigned* __restrict__ rel) {
  extern __shared__ unsigned cnt[];
  const int tid = threadIdx.x;
  for (int i = tid; i < copies * tiles; i += kPartThreads) cnt[i] = 0u;
  __syncthreads();
  unsigned* mine = cnt + ((tid >> 5) % copies) * tiles;
  long long r0, r1;
  block_rows(rows, r0, r1);
  int idx = 0;
  for (long long c0 = r0; c0 < r1; c0 += kChunk) {
    long long slot[kPartRows];
    unsigned wv[kPartRows];
    chunk_slots<Id, false>(in, c0, r1, idx, slot, wv);
#pragma unroll
    for (int j = 0; j < kPartRows; ++j)
      if (slot[j] >= 0) atomicAdd(&mine[(int)(slot[j] >> tile_shift)], 1u);
  }
  __syncthreads();
  for (int t = tid; t < tiles; t += kPartThreads) {
    unsigned c = 0u;
    for (int q = 0; q < copies; ++q) c += cnt[q * tiles + t];
    if (c) rel[(long long)blockIdx.x * tiles + t] = atomicAdd(&total[t], c);
  }
}

// The tiles' regions: tstart[t] = sum over the tiles before t of their rows
// padded to 32, tstart[tiles] the whole.
__global__ void __launch_bounds__(kPartThreads)
onehot_tile_scan(const unsigned* __restrict__ total, int tiles, unsigned* __restrict__ tstart) {
  __shared__ unsigned padded[kMaxTiles];
  for (int t = threadIdx.x; t < tiles; t += kPartThreads) padded[t] = (total[t] + 31u) & ~31u;
  __syncthreads();
  exclusive_scan(padded, tstart, tiles);
}

// Pass 2: the block's rows again, chunk by chunk: each chunk sorted by tile
// in shared memory, each tile's run written to its place in the tile's
// region as u16 in-tile digits (and the weights beside them).
template <typename Id, bool W>
__global__ void __launch_bounds__(kPartThreads)
onehot_partition(const __grid_constant__ Inputs in, long long rows, int tile_shift, int tiles,
                 const unsigned* __restrict__ rel, const unsigned* __restrict__ tstart,
                 unsigned short* __restrict__ digits, unsigned* __restrict__ wts) {
  extern __shared__ unsigned smem[];
  unsigned* cnt = smem;                  // tiles: the chunk's rows a tile
  unsigned* lstart = cnt + tiles;        // tiles + 1: their starts in the stage
  unsigned* cur = lstart + tiles + 1;    // tiles: the block's next place a tile
  unsigned* stage = cur + tiles;         // kChunk: tile << 16 | digit
  unsigned* wstage = stage + kChunk;     // kChunk (weighted)
  const int tid = threadIdx.x;
  const unsigned mask = (1u << tile_shift) - 1u;
  for (int t = tid; t < tiles; t += kPartThreads) {
    cnt[t] = 0u;
    cur[t] = tstart[t] + rel[(long long)blockIdx.x * tiles + t];  // read only where held
  }
  __syncthreads();
  long long r0, r1;
  block_rows(rows, r0, r1);
  int idx = 0;
  for (long long c0 = r0; c0 < r1; c0 += kChunk) {
    long long slot[kPartRows];
    unsigned key[kPartRows], rank[kPartRows], wv[kPartRows];
    chunk_slots<Id, W>(in, c0, r1, idx, slot, wv);
#pragma unroll
    for (int j = 0; j < kPartRows; ++j)
      key[j] = slot[j] >= 0 ? ((unsigned)(slot[j] >> tile_shift) << 16) | ((unsigned)slot[j] & mask)
                            : ~0u;
#pragma unroll
    for (int j = 0; j < kPartRows; ++j)
      if (key[j] != ~0u) rank[j] = atomicAdd(&cnt[key[j] >> 16], 1u);
    __syncthreads();
    exclusive_scan(cnt, lstart, tiles);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPartRows; ++j) {
      if (key[j] == ~0u) continue;
      const unsigned pos = lstart[key[j] >> 16] + rank[j];
      stage[pos] = key[j];
      if constexpr (W) wstage[pos] = wv[j];
    }
    __syncthreads();
    const unsigned kept = lstart[tiles];
    for (unsigned i = tid; i < kept; i += kPartThreads) {
      const unsigned k = stage[i], t = k >> 16;
      const unsigned p = cur[t] + (i - lstart[t]);
      digits[p] = (unsigned short)(k & 0xFFFFu);
      if constexpr (W) wts[p] = wstage[i];
    }
    __syncthreads();
    for (int t = tid; t < tiles; t += kPartThreads) {
      cur[t] += cnt[t];
      cnt[t] = 0u;
    }
    __syncthreads();
  }
}

// The multiply: each block an equal contiguous range of the regions' steps
// of 32 rows, tile by tile; warp w takes the range's steps w, w + 8, ...,
// four in flight. A tig group's 8 digits of a step are one 16-byte load its
// 8 lanes share; rows past a tile's count (its region's padding) are
// dropped. A tile's accumulators are added in shared memory, then into
// out: plain adds where the block holds the whole region, atomics else.
template <int NT, bool W>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
onehot_tiles(const unsigned short* __restrict__ digits, const unsigned* __restrict__ wts,
             const unsigned* __restrict__ total, const unsigned* __restrict__ tstart, int tiles,
             long long m, unsigned long long* __restrict__ out) {
  constexpr int B = NT * 8;
  constexpr int LB = NT == 16 ? 7 : (NT == 8 ? 6 : (NT == 4 ? 5 : (NT == 2 ? 4 : 3)));
  constexpr int TB = 16 * B;
  constexpr int U = 4;
  constexpr unsigned kPad = kDropHi << LB;  // a padding row's digit: hi 0x7F
  constexpr unsigned kPad2 = kPad | kPad << 16;
  __shared__ unsigned red[TB];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const unsigned g = (unsigned)lane >> 2;
  const int tig = lane & 3;
  for (int i = tid; i < TB; i += kThreads) red[i] = 0u;
  const long long steps = tstart[tiles] / 32;
  const long long per = (steps + gridDim.x - 1) / gridDim.x;
  const long long s0 = (long long)blockIdx.x * per;
  const long long s1 = s0 + per < steps ? s0 + per : steps;
  if (s0 >= s1) return;
  // the tile whose region holds step s0: the last with tstart <= s0 * 32
  int lo = 0, hi = tiles;
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if ((long long)tstart[mid] <= s0 * 32) lo = mid; else hi = mid;
  }
  int t = lo;
  __syncthreads();
  for (long long s = s0; s < s1; ++t) {
    const unsigned e0 = tstart[t], e1 = tstart[t + 1];
    const long long end = s1 < (long long)(e1 / 32) ? s1 : (long long)(e1 / 32);
    if (end <= s) continue;
    const unsigned valid = e0 + total[t];
    unsigned acc[Planes<W>::P][NT][4];
#pragma unroll
    for (int p = 0; p < Planes<W>::P; ++p)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[p][n][c] = 0u;
    for (long long st = s + warp; st < end; st += kWarps * U) {
      uint4 d[U], w0[U], w1[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long su = st + u * kWarps;
        const long long e = su * 32 + tig * 8;
        const bool live = su < end;
        d[u] = live ? __ldcs(reinterpret_cast<const uint4*>(digits + e))
                    : make_uint4(kPad2, kPad2, kPad2, kPad2);
        if constexpr (W) {
          const uint4 none = make_uint4(0, 0, 0, 0);
          w0[u] = live ? __ldcs(reinterpret_cast<const uint4*>(wts + e)) : none;
          w1[u] = live ? __ldcs(reinterpret_cast<const uint4*>(wts + e + 4)) : none;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long su = st + u * kWarps;
        if (su >= end) break;
        const long long e = su * 32 + tig * 8;
        unsigned wd[4] = {d[u].x, d[u].y, d[u].z, d[u].w};
        if (e + 8 > (long long)valid) {  // the region's last step: its padding dropped
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if (e + k >= (long long)valid)
              wd[k / 2] = (k & 1) ? (wd[k / 2] & 0xFFFFu) | (kPad << 16)
                                  : (wd[k / 2] & 0xFFFF0000u) | kPad;
        }
        const unsigned lomask = (unsigned)(B - 1) * 0x01010101u;
        unsigned p01[4] = {0, 0, 0, 0}, p23[4] = {0, 0, 0, 0};
        if constexpr (W) {
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            p01[p] = byte_plane(w0[u], p);
            p23[p] = byte_plane(w1[u], p);
          }
        }
        mma_step<NT, W>(acc, __byte_perm(wd[0] >> LB, wd[1] >> LB, 0x6420),
                        __byte_perm(wd[2] >> LB, wd[3] >> LB, 0x6420),
                        __byte_perm(wd[0], wd[1], 0x6420) & lomask,
                        __byte_perm(wd[2], wd[3], 0x6420) & lomask, p01, p23, g);
      }
    }
    acc_to_shared<NT, W>(acc, red, lane);
    __syncthreads();
    const bool whole = (long long)e0 >= s0 * 32 && (long long)e1 <= s1 * 32;
    const long long base = (long long)t * TB;
    for (int i = tid; i < TB; i += kThreads) {
      const unsigned v = red[i];
      if (!v) continue;
      red[i] = 0u;
      const long long slot = base + i;
      if (slot >= m) continue;
      if (whole) out[slot] += v;
      else atomicAdd(out + slot, (unsigned long long)v);
    }
    __syncthreads();
    s = end;
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
bool g_smem_set[kMaxDevices][2][2];
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

long long widest(bool weighted) { return weighted ? kMaxWeightedSegments : kMaxSegments; }

// One rule for both routes: B the least power of two from 8 (to 128; 32
// weighted) with 16 * B >= m; the narrow route when that one tile covers m.
Plan plan_for(long long m, long long rows, bool weighted, int card_sms) {
  Plan p;
  const int max_lb = weighted ? kMaxWeightedLogB : kMaxLogB;
  const long long per_hi = (m + 15) / 16;
  p.log_b = 3;
  while ((1ll << p.log_b) < per_hi && p.log_b < max_lb) ++p.log_b;
  p.wide = (16ll << p.log_b) < m ? 1 : 0;
  // Wide and unweighted: the least B from 64 whose kMaxTiles tiles cover m
  // (64 to 2^21 bins, then 128): fewer n-tiles make a step cheaper, more
  // tiles make the partition dearer (PERF.md).
  if (p.wide && !weighted)
    for (p.log_b = 6; ((long long)kMaxTiles << (p.log_b + 4)) < m;) ++p.log_b;
  const long long tile_bins = 16ll << p.log_b;
  p.tiles = (int)((m + tile_bins - 1) / tile_bins);
  p.round_rows = rows < kRoundRows ? rows : kRoundRows;
  // at most kMaxWarpRows / 2 rows a warp (a warp's range is rounded up)
  const long long least = (p.round_rows + kWarps * (kMaxWarpRows / 2) - 1) /
                          (kWarps * (kMaxWarpRows / 2));
  long long blocks = (long long)kBlocksPerSm * card_sms;
  if (!p.wide) {
    const long long useful = (p.round_rows + kThreads * 8 - 1) / (kThreads * 8);
    if (blocks > useful) blocks = useful;
  }
  if (blocks < least) blocks = least;
  if (blocks < 1) blocks = 1;
  p.blocks = (int)blocks;
  if (p.wide) {
    p.part_blocks = card_sms;
    int copies = kCountWords / p.tiles;
    if (copies > kPartThreads / 32) copies = kPartThreads / 32;
    p.copies = copies > 1 ? copies : 1;
  }
  return p;
}

size_t align256(size_t b) { return (b + 255) / 256 * 256; }

// The wide route's scratch, in order: total (tiles), tstart (tiles + 1),
// rel (partition blocks x tiles), digits (u16) and weights (u32) of the
// round's rows padded a tile.
struct Scratch {
  unsigned* total;
  unsigned* tstart;
  unsigned* rel;
  unsigned short* digits;
  unsigned* wts;
};

size_t scratch_layout(const Plan& p, bool weighted, char* base, Scratch* s) {
  if (!p.wide) return 0;
  const size_t slots = (size_t)p.round_rows + 32 * (size_t)p.tiles;
  size_t at = 0;
  const size_t sizes[5] = {
      align256((size_t)p.tiles * 4), align256(((size_t)p.tiles + 1) * 4),
      align256((size_t)p.part_blocks * p.tiles * 4), align256(slots * 2),
      weighted ? align256(slots * 4) : 0};
  if (s) {
    s->total = reinterpret_cast<unsigned*>(base);
    s->tstart = reinterpret_cast<unsigned*>(base + sizes[0]);
    s->rel = reinterpret_cast<unsigned*>(base + sizes[0] + sizes[1]);
    s->digits = reinterpret_cast<unsigned short*>(base + sizes[0] + sizes[1] + sizes[2]);
    s->wts = weighted ? reinterpret_cast<unsigned*>(base + sizes[0] + sizes[1] + sizes[2] +
                                                    sizes[3])
                      : nullptr;
  }
  for (size_t b : sizes) at += b;
  return at;
}

size_t partition_smem(int tiles, bool weighted) {
  return ((size_t)3 * tiles + 1) * 4 + (size_t)kChunk * 4 * (weighted ? 2 : 1);
}

template <bool W>
cudaError_t launch_narrow(const Plan& p, const Inputs& in, long long m,
                          unsigned long long* out, cudaStream_t st) {
  switch (p.log_b) {
#define DEEQU_K6_NARROW(LB, NT)                                                   \
  case LB:                                                                        \
    onehot_narrow<NT, W><<<p.blocks, kThreads, 0, st>>>(in, m, LB, out);          \
    break;
    DEEQU_K6_NARROW(3, 1)
    DEEQU_K6_NARROW(4, 2)
    DEEQU_K6_NARROW(5, 4)
#undef DEEQU_K6_NARROW
    default:
      if constexpr (W) return cudaErrorInvalidValue;  // weighted B stops at 32
      switch (p.log_b) {
        case 6:
          onehot_narrow<8, false><<<p.blocks, kThreads, 0, st>>>(in, m, 6, out);
          break;
        case 7:
          onehot_narrow<16, false><<<p.blocks, kThreads, 0, st>>>(in, m, 7, out);
          break;
        default:
          return cudaErrorInvalidValue;
      }
  }
  return cudaGetLastError();
}

template <typename Id, bool W>
cudaError_t launch_wide(const Plan& p, const Inputs& in, long long rows, long long m,
                        const Scratch& s, unsigned long long* out, cudaStream_t st) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const size_t part_smem = partition_smem(p.tiles, W);
  {
    std::lock_guard<std::mutex> lock(g_lock);
    bool& set = g_smem_set[dev][W ? 1 : 0][sizeof(Id) == 8 ? 1 : 0];
    if (!set) {
      e = cudaFuncSetAttribute(onehot_partition<Id, W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)partition_smem(kMaxTiles, W));
      if (e != cudaSuccess) return e;
      set = true;
    }
  }
  const int tile_shift = p.log_b + 4;
  e = cudaMemsetAsync(s.total, 0, (size_t)p.tiles * 4, st);
  if (e != cudaSuccess) return e;
  onehot_tile_count<Id><<<p.part_blocks, kPartThreads, (size_t)p.copies * p.tiles * 4, st>>>(
      in, rows, tile_shift, p.tiles, p.copies, s.total, s.rel);
  onehot_tile_scan<<<1, kPartThreads, 0, st>>>(s.total, p.tiles, s.tstart);
  onehot_partition<Id, W><<<p.part_blocks, kPartThreads, part_smem, st>>>(
      in, rows, tile_shift, p.tiles, s.rel, s.tstart, s.digits, s.wts);
  if constexpr (W)
    onehot_tiles<4, true><<<p.blocks, kThreads, 0, st>>>(s.digits, s.wts, s.total, s.tstart,
                                                         p.tiles, m, out);
  else
    if (p.log_b == 6)
      onehot_tiles<8, false><<<p.blocks, kThreads, 0, st>>>(s.digits, s.wts, s.total, s.tstart,
                                                            p.tiles, m, out);
    else
      onehot_tiles<16, false><<<p.blocks, kThreads, 0, st>>>(s.digits, s.wts, s.total, s.tstart,
                                                             p.tiles, m, out);
  return cudaGetLastError();
}

// The pieces of every input, cut at kRoundRows rows, packed into rounds of
// at most kMaxInputs pieces and kRoundRows rows; each round runs its route
// and adds into out.
cudaError_t run_rounds(const void* const* ids, const long long* ns, const long long* offs,
                       int k, int is64, const int* weights, long long m, void* scratch,
                       unsigned long long* out, cudaStream_t st) {
  const bool weighted = weights != nullptr;
  long long all = 0;
  for (int i = 0; i < k; ++i) all += ns[i];
  if (all == 0) return cudaSuccess;
  int err = 0;
  const int card = sms(&err);
  if (!card) return (cudaError_t)err;
  const Plan p = plan_for(m, all, weighted, card);
  Scratch s = {};
  if (p.wide) {
    if (!scratch) return cudaErrorInvalidValue;
    scratch_layout(p, weighted, static_cast<char*>(scratch), &s);
  }
  const size_t esize = is64 ? 8 : 4;
  Inputs in = {};
  in.is64 = is64;
  long long rows = 0;
  auto flush = [&]() -> cudaError_t {
    if (in.k == 0) return cudaSuccess;
    for (int i = in.k; i <= kMaxInputs; ++i) in.start[i] = rows;
    const cudaError_t e =
        !p.wide ? (weighted ? launch_narrow<true>(p, in, m, out, st)
                            : launch_narrow<false>(p, in, m, out, st))
                : is64 ? (weighted ? launch_wide<long long, true>(p, in, rows, m, s, out, st)
                                   : launch_wide<long long, false>(p, in, rows, m, s, out, st))
                       : (weighted ? launch_wide<int, true>(p, in, rows, m, s, out, st)
                                   : launch_wide<int, false>(p, in, rows, m, s, out, st));
    in = Inputs{};
    in.is64 = is64;
    rows = 0;
    return e;
  };
  for (int i = 0; i < k; ++i) {
    for (long long done = 0; done < ns[i];) {
      if (in.k == kMaxInputs || rows == kRoundRows) {
        const cudaError_t e = flush();
        if (e != cudaSuccess) return e;
      }
      long long take = ns[i] - done;
      if (take > kRoundRows - rows) take = kRoundRows - rows;
      in.ptr[in.k] = static_cast<const char*>(ids[i]) + done * esize;
      in.start[in.k] = rows;
      in.lim[in.k] = m - offs[i];
      in.off[in.k] = offs[i];
      if (weighted) in.w = weights + done;  // one input: one piece a round
      ++in.k;
      rows += take;
      done += take;
    }
  }
  return flush();
}

}  // namespace

extern "C" {

// The geometry the kernel takes for m bins over n rows (weighted or not) on
// the current card: {route (0 narrow, 1 wide), log2 B, tiles, bins a tile,
// the narrow route's widest, multiplying blocks, partition blocks, pass 1's
// counter copies, rows a partition chunk, rows a round, scratch bytes}.
// Returns 0, or the CUDA error of reading the card, or
// cudaErrorInvalidValue past the widest width.
int deequ_onehot_plan(long long m, long long n, int weighted, long long* out11) {
  if (m < 1 || m > widest(weighted != 0) || n < 0) return (int)cudaErrorInvalidValue;
  int err = 0;
  const int card = sms(&err);
  if (!card) return err;
  const Plan p = plan_for(m, n, weighted != 0, card);
  const long long vals[11] = {
      p.wide, p.log_b, p.tiles, 16ll << p.log_b,
      weighted ? kNarrowWeightedBins : kNarrowBins, p.blocks, p.part_blocks, p.copies,
      kChunk, p.round_rows, (long long)scratch_layout(p, weighted != 0, nullptr, nullptr)};
  for (int i = 0; i < 11; ++i) out11[i] = vals[i];
  return 0;
}

// The scratch bytes a call for m bins over n rows in all takes (0 on the
// narrow route); -1 past the widest width.
long long deequ_onehot_scratch_bytes(long long m, long long n, int weighted) {
  long long plan[11];
  if (deequ_onehot_plan(m, n, weighted, plan) != 0) return -1;
  return plan[10];
}

// The widest num_segments the kernel takes, weighted or not.
long long deequ_onehot_widest(int weighted) { return widest(weighted != 0); }

// Counts n ids (int64 when ids_are_64, else int32) over m bins into out (m
// zeroed int64), with int32 weights when weights is not null (module
// comment for the weighted domain), using scratch (deequ_onehot_scratch_bytes).
// Enqueues on stream; returns the CUDA error of the launches
// (cudaErrorInvalidValue past the widest width).
int deequ_onehot(const void* ids, int ids_are_64, const void* weights, long long n,
                 long long m, void* scratch, void* out, void* stream) {
  const bool weighted = weights != nullptr;
  if (m < 1 || m > widest(weighted) || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* counts = static_cast<unsigned long long*>(out);
  const long long off = 0;
  const void* const ptrs[1] = {ids};
  const cudaError_t e = run_rounds(ptrs, &n, &off, 1, ids_are_64 ? 1 : 0,
                                   static_cast<const int*>(weights), m, scratch, counts, st);
  if (e != cudaSuccess) return (int)e;
  if (weighted) onehot_wrap32<<<(unsigned)((m + 255) / 256), 256, 0, st>>>(counts, m);
  return (int)cudaGetLastError();
}

// Counts k int64 id vectors into one out of sum(keyspaces) int64 bins
// (zeroed): input i's ids[i] (ns[i] rows) count at id plus the keyspaces
// before it where 0 <= id and the slot is inside the bins, using scratch
// (deequ_onehot_scratch_bytes of the summed keyspace and rows). Returns the
// CUDA error of the launches (cudaErrorInvalidValue past kMaxSegments bins).
int deequ_onehot_multi(const void* const* ids, const long long* ns,
                       const long long* keyspaces, int k, void* scratch, void* out,
                       void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  long long m = 0;
  for (int i = 0; i < k; ++i) m += keyspaces[i];
  if (m < 1 || m > kMaxSegments) return (int)cudaErrorInvalidValue;
  long long* offs = new long long[k];
  long long off = 0;
  for (int i = 0; i < k; ++i) {
    offs[i] = off;
    off += keyspaces[i];
  }
  const cudaError_t e = run_rounds(ids, ns, offs, k, 1, nullptr, m, scratch,
                                   static_cast<unsigned long long*>(out),
                                   static_cast<cudaStream_t>(stream));
  delete[] offs;
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
