// Batch xxHash (XXH64 / XXH32) for the host-side feature pipeline.
//
// The training-time hashing contract (reference commons/feature_utils.py:36-46)
// calls xxh64 once per string value through Python; at pod-feeding rates the
// per-call Python overhead dominates.  This translation unit implements the
// public xxHash algorithm (Yann Collet's spec, public domain) and exposes
// batch entry points over a concatenated string buffer: one C call hashes an
// entire column.
//
// Build: g++ -O3 -shared -fPIC -o libfasthash.so fasthash.cpp
// (done at first use by recommendations_tpu_torch/native/__init__.py)

#include <cstdint>
#include <cstring>

namespace {

// ----- XXH64 ---------------------------------------------------------------

constexpr uint64_t P64_1 = 0x9E3779B185EBCA87ULL;
constexpr uint64_t P64_2 = 0xC2B2AE3D27D4EB4FULL;
constexpr uint64_t P64_3 = 0x165667B19E3779F9ULL;
constexpr uint64_t P64_4 = 0x85EBCA77C2B2AE63ULL;
constexpr uint64_t P64_5 = 0x27D4EB2F165667C5ULL;

inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t read64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;  // little-endian hosts only (x86/ARM/TPU VMs)
}

inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint64_t xxh64_round(uint64_t acc, uint64_t input) {
  acc += input * P64_2;
  acc = rotl64(acc, 31);
  return acc * P64_1;
}

inline uint64_t xxh64_merge(uint64_t h, uint64_t v) {
  h ^= xxh64_round(0, v);
  return h * P64_1 + P64_4;
}

uint64_t xxh64(const uint8_t* p, size_t len, uint64_t seed) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + P64_1 + P64_2;
    uint64_t v2 = seed + P64_2;
    uint64_t v3 = seed;
    uint64_t v4 = seed - P64_1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xxh64_round(v1, read64(p));
      v2 = xxh64_round(v2, read64(p + 8));
      v3 = xxh64_round(v3, read64(p + 16));
      v4 = xxh64_round(v4, read64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = xxh64_merge(h, v1);
    h = xxh64_merge(h, v2);
    h = xxh64_merge(h, v3);
    h = xxh64_merge(h, v4);
  } else {
    h = seed + P64_5;
  }
  h += static_cast<uint64_t>(len);
  while (p + 8 <= end) {
    h ^= xxh64_round(0, read64(p));
    h = rotl64(h, 27) * P64_1 + P64_4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= static_cast<uint64_t>(read32(p)) * P64_1;
    h = rotl64(h, 23) * P64_2 + P64_3;
    p += 4;
  }
  while (p < end) {
    h ^= static_cast<uint64_t>(*p) * P64_5;
    h = rotl64(h, 11) * P64_1;
    ++p;
  }
  h ^= h >> 33;
  h *= P64_2;
  h ^= h >> 29;
  h *= P64_3;
  h ^= h >> 32;
  return h;
}

// ----- XXH32 ---------------------------------------------------------------

constexpr uint32_t P32_1 = 2654435761U;
constexpr uint32_t P32_2 = 2246822519U;
constexpr uint32_t P32_3 = 3266489917U;
constexpr uint32_t P32_4 = 668265263U;
constexpr uint32_t P32_5 = 374761393U;

inline uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

uint32_t xxh32(const uint8_t* p, size_t len, uint32_t seed) {
  const uint8_t* end = p + len;
  uint32_t h;
  if (len >= 16) {
    uint32_t v1 = seed + P32_1 + P32_2;
    uint32_t v2 = seed + P32_2;
    uint32_t v3 = seed;
    uint32_t v4 = seed - P32_1;
    const uint8_t* limit = end - 16;
    do {
      v1 = rotl32(v1 + read32(p) * P32_2, 13) * P32_1;
      v2 = rotl32(v2 + read32(p + 4) * P32_2, 13) * P32_1;
      v3 = rotl32(v3 + read32(p + 8) * P32_2, 13) * P32_1;
      v4 = rotl32(v4 + read32(p + 12) * P32_2, 13) * P32_1;
      p += 16;
    } while (p <= limit);
    h = rotl32(v1, 1) + rotl32(v2, 7) + rotl32(v3, 12) + rotl32(v4, 18);
  } else {
    h = seed + P32_5;
  }
  h += static_cast<uint32_t>(len);
  while (p + 4 <= end) {
    h = rotl32(h + read32(p) * P32_3, 17) * P32_4;
    p += 4;
  }
  while (p < end) {
    h = rotl32(h + (*p) * P32_5, 11) * P32_1;
    ++p;
  }
  h ^= h >> 15;
  h *= P32_2;
  h ^= h >> 13;
  h *= P32_3;
  h ^= h >> 16;
  return h;
}

}  // namespace

extern "C" {

// Hash n strings packed in `buf` (offsets[i]..offsets[i+1]) with XXH64(seed)
// and write `hash - 2^63` int64 results (the feature-id contract).
void hash_strings_to_long(const uint8_t* buf, const int64_t* offsets,
                          int64_t n, uint64_t seed, int64_t* out) {
  constexpr uint64_t SHIFT = 0x8000000000000000ULL;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* s = buf + offsets[i];
    size_t len = static_cast<size_t>(offsets[i + 1] - offsets[i]);
    out[i] = static_cast<int64_t>(xxh64(s, len, seed) - SHIFT);
  }
}

uint64_t xxh64_single(const uint8_t* buf, int64_t len, uint64_t seed) {
  return xxh64(buf, static_cast<size_t>(len), seed);
}

uint32_t xxh32_single(const uint8_t* buf, int64_t len, uint32_t seed) {
  return xxh32(buf, static_cast<size_t>(len), seed);
}

}  // extern "C"
