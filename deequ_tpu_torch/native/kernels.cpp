// Native host kernels for deequ_tpu_torch (a copy of deequ_tpu/native/kernels.cpp).
//
// The device path is PyTorch on CUDA; these C++ kernels cover the *host-side*
// hot loops that feed it — the role the reference's Catalyst/JVM layer plays
// for Spark (SURVEY.md §2.4). All operate on a packed string batch:
// one contiguous utf-8 buffer plus an (n+1)-entry offset array, which is
// exactly how dictionary values are shipped from numpy without per-string
// Python objects.
//
// Exposed via ctypes (see native/__init__.py), built with g++ at first use;
// a failed build raises. The pure-Python versions (ops/hll.py:hash_strings_plain,
// analyzers/scan.py:_classify_string, len) are what the tests hold them against.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 kernels.cpp -o libnative_<hash>.so

#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// xxHash64 (public algorithm, reimplemented) — batch over a packed buffer.
// Mirrors deequ_tpu_torch.ops.hll.xxhash64_bytes bit-for-bit.
// ---------------------------------------------------------------------------

static const uint64_t P1 = 0x9E3779B185EBCA87ULL;
static const uint64_t P2 = 0xC2B2AE3D27D4EB4FULL;
static const uint64_t P3 = 0x165667B19E3779F9ULL;
static const uint64_t P4 = 0x85EBCA77C2B2AE63ULL;
static const uint64_t P5 = 0x27D4EB2F165667C5ULL;

static inline uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

static inline uint64_t read64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;  // little-endian hosts only (x86-64 / arm64)
}

static inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

static uint64_t xxh64(const uint8_t* data, int64_t n, uint64_t seed) {
  const uint8_t* p = data;
  const uint8_t* end = data + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2;
    uint64_t v2 = seed + P2;
    uint64_t v3 = seed;
    uint64_t v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = rotl64(v1 + read64(p) * P2, 31) * P1; p += 8;
      v2 = rotl64(v2 + read64(p) * P2, 31) * P1; p += 8;
      v3 = rotl64(v3 + read64(p) * P2, 31) * P1; p += 8;
      v4 = rotl64(v4 + read64(p) * P2, 31) * P1; p += 8;
    } while (p <= limit);
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    uint64_t vs[4] = {v1, v2, v3, v4};
    for (int i = 0; i < 4; i++) {
      uint64_t k = rotl64(vs[i] * P2, 31) * P1;
      h ^= k;
      h = h * P1 + P4;
    }
  } else {
    h = seed + P5;
  }
  h += (uint64_t)n;
  while (p + 8 <= end) {
    uint64_t k = rotl64(read64(p) * P2, 31) * P1;
    h ^= k;
    h = rotl64(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= (uint64_t)read32(p) * P1;
    h = rotl64(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p) * P5;
    h = rotl64(h, 11) * P1;
    p++;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

void xxhash64_batch(const uint8_t* buffer, const int64_t* offsets, int64_t n,
                    uint64_t seed, uint64_t* out) {
  for (int64_t i = 0; i < n; i++) {
    out[i] = xxh64(buffer + offsets[i], offsets[i + 1] - offsets[i], seed);
  }
}

// ---------------------------------------------------------------------------
// DataType classification — regex-free scanner equivalent to the reference's
// FRACTIONAL ^(-|\+)? ?\d*\.\d*$ / INTEGRAL ^(-|\+)? ?\d*$ /
// BOOLEAN ^(true|false)$ patterns (StatefulDataType.scala:36-38), matching
// deequ_tpu_torch.analyzers.scan._classify_string.
// Classes: 1=fractional, 2=integral, 3=boolean, 4=string.
// ---------------------------------------------------------------------------

static int32_t classify(const uint8_t* s, int64_t n) {
  // boolean?
  if (n == 4 && std::memcmp(s, "true", 4) == 0) return 3;
  if (n == 5 && std::memcmp(s, "false", 5) == 0) return 3;
  // optional sign, then optional single space, then digits with <= 1 dot
  int64_t i = 0;
  if (i < n && (s[i] == '-' || s[i] == '+')) i++;
  if (i < n && s[i] == ' ') i++;
  int dots = 0;
  for (; i < n; i++) {
    if (s[i] == '.') {
      dots++;
      if (dots > 1) return 4;
    } else if (s[i] < '0' || s[i] > '9') {
      return 4;
    }
  }
  return dots == 1 ? 1 : 2;  // note: "" and "-" classify as integral, like
                             // the reference's \d* patterns
}

void classify_batch(const uint8_t* buffer, const int64_t* offsets, int64_t n,
                    int32_t* out) {
  for (int64_t i = 0; i < n; i++) {
    out[i] = classify(buffer + offsets[i], offsets[i + 1] - offsets[i]);
  }
}

// ---------------------------------------------------------------------------
// Batch utf-8 length (code points) — for MinLength/MaxLength lookup tables.
// Counts non-continuation bytes, matching Python's len(str).
// ---------------------------------------------------------------------------

void utf8_lengths(const uint8_t* buffer, const int64_t* offsets, int64_t n,
                  int64_t* out) {
  for (int64_t i = 0; i < n; i++) {
    int64_t count = 0;
    for (int64_t j = offsets[i]; j < offsets[i + 1]; j++) {
      if ((buffer[j] & 0xC0) != 0x80) count++;
    }
    out[i] = count;
  }
}

}  // extern "C"
