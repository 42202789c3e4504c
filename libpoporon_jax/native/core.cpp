// libpoporon_jax native core — host-side runtime support in C++.
//
// The device data path is JAX/XLA; this library covers the host-side scalar
// work that the reference implements natively in C (structure
// construction and byte/bit staging), re-designed for bulk/batch use:
//
//   * xoshiro128++ / splitmix32 bulk stream generation (semantics of
//     reference src/rng.c:27-132)
//   * LDPC RANDOM / QC_RANDOM parity-matrix construction emitting CSR
//     directly (semantics of reference src/ldpc.c:283-582, including the
//     two-pass draw order and staircase parity columns)
//   * Fisher-Yates interleaver permutations (src/ldpc.c:150-281)
//   * MSB-first bit pack/unpack for fast host staging of codeword
//     batches
//
// Exposed as a plain C ABI consumed via ctypes (libpoporon_jax/utils/
// native.py); NumPy fallbacks exist for every entry point.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Xo128 {
  uint32_t s[4];

  static uint32_t splitmix(uint32_t z) {
    z = (z ^ (z >> 16)) * 0x85EBCA6Bu;
    z = (z ^ (z >> 13)) * 0xC2B2AE35u;
    return z ^ (z >> 16);
  }

  explicit Xo128(uint32_t seed) {
    uint32_t z = seed + 0x6C078965u;
    s[0] = splitmix(z);
    z = s[0] + 0x9D2C5680u;
    s[1] = splitmix(z);
    z = s[1] + 0xEFC60000u;
    s[2] = splitmix(z);
    z = s[2] + 0x12345678u;
    s[3] = splitmix(z);
  }

  static uint32_t rotl(uint32_t x, int k) { return (x << k) | (x >> (32 - k)); }

  uint32_t next() {
    uint32_t result = rotl(s[0] + s[3], 7) + s[0];
    uint32_t t = s[1] << 9;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 11);
    return result;
  }
};

}  // namespace

extern "C" {

// ------------------------------------------------------------------ RNG

void pptpu_xoshiro_fill_u32(uint32_t seed, uint32_t* out, uint64_t count) {
  Xo128 rng(seed);
  for (uint64_t i = 0; i < count; ++i) out[i] = rng.next();
}

void pptpu_xoshiro_fill_bytes(uint32_t seed, uint8_t* out, uint64_t size) {
  Xo128 rng(seed);
  uint64_t i = 0;
  while (i + 4 <= size) {
    uint32_t v = rng.next();
    std::memcpy(out + i, &v, 4);
    i += 4;
  }
  if (i < size) {
    uint32_t v = rng.next();
    std::memcpy(out + i, &v, size - i);
  }
}

// Fisher-Yates permutation with the reference draw semantics
// (ldpc.c:203-209): for i = n-1 .. 1, j = next() % (i+1), swap.
void pptpu_fisher_yates(uint32_t seed, uint32_t* perm, uint64_t n) {
  for (uint64_t i = 0; i < n; ++i) perm[i] = static_cast<uint32_t>(i);
  Xo128 rng(seed);
  for (uint64_t i = n - 1; i > 0; --i) {
    uint64_t j = rng.next() % (i + 1);
    uint32_t t = perm[i];
    perm[i] = perm[j];
    perm[j] = t;
  }
}

// --------------------------------------------------- LDPC matrix builds

// RANDOM builder: emits CSR (row_ptr[parity_bits+1], col_idx[used]) with
// the exact draw/count/fill order of the reference.  Returns the number
// of used edges.
uint64_t pptpu_ldpc_build_random(uint32_t seed, uint64_t info_bits,
                                 uint64_t parity_bits, uint32_t col_weight,
                                 uint32_t* row_ptr, uint32_t* col_idx) {
  std::vector<uint32_t> counts(parity_bits, 0);
  {
    Xo128 rng(seed);
    for (uint64_t i = 0; i < info_bits; ++i)
      for (uint32_t j = 0; j < col_weight; ++j)
        counts[rng.next() % parity_bits]++;
  }
  for (uint64_t i = 0; i < parity_bits; ++i) counts[i] += (i == 0) ? 1 : 2;
  row_ptr[0] = 0;
  for (uint64_t i = 0; i < parity_bits; ++i) row_ptr[i + 1] = row_ptr[i] + counts[i];

  std::fill(counts.begin(), counts.end(), 0);
  {
    Xo128 rng(seed);
    for (uint64_t i = 0; i < info_bits; ++i)
      for (uint32_t j = 0; j < col_weight; ++j) {
        uint64_t t = rng.next() % parity_bits;
        col_idx[row_ptr[t] + counts[t]++] = static_cast<uint32_t>(i);
      }
  }
  for (uint64_t i = 0; i < parity_bits; ++i) {
    if (i > 0) col_idx[row_ptr[i] + counts[i]++] =
        static_cast<uint32_t>(info_bits + i - 1);
    col_idx[row_ptr[i] + counts[i]++] = static_cast<uint32_t>(info_bits + i);
  }
  return row_ptr[parity_bits];
}

// QC_RANDOM builder (ldpc.c:413-541); out-of-range targets dropped.
uint64_t pptpu_ldpc_build_qc(uint32_t seed, uint64_t info_bits,
                             uint64_t parity_bits, uint32_t col_weight,
                             uint32_t lifting, uint32_t* row_ptr,
                             uint32_t* col_idx) {
  uint64_t base_rows = (parity_bits + lifting - 1) / lifting;
  std::vector<uint32_t> counts(parity_bits, 0);
  {
    Xo128 rng(seed);
    for (uint64_t i = 0; i < info_bits; ++i) {
      uint64_t pos = i % lifting;
      for (uint32_t j = 0; j < col_weight; ++j) {
        uint64_t br = rng.next() % base_rows;
        uint64_t sh = rng.next() % lifting;
        uint64_t t = br * lifting + (pos + sh) % lifting;
        if (t < parity_bits) counts[t]++;
      }
    }
  }
  for (uint64_t i = 0; i < parity_bits; ++i) counts[i] += (i == 0) ? 1 : 2;
  row_ptr[0] = 0;
  for (uint64_t i = 0; i < parity_bits; ++i) row_ptr[i + 1] = row_ptr[i] + counts[i];

  std::fill(counts.begin(), counts.end(), 0);
  {
    Xo128 rng(seed);
    for (uint64_t i = 0; i < info_bits; ++i) {
      uint64_t pos = i % lifting;
      for (uint32_t j = 0; j < col_weight; ++j) {
        uint64_t br = rng.next() % base_rows;
        uint64_t sh = rng.next() % lifting;
        uint64_t t = br * lifting + (pos + sh) % lifting;
        if (t < parity_bits)
          col_idx[row_ptr[t] + counts[t]++] = static_cast<uint32_t>(i);
      }
    }
  }
  for (uint64_t i = 0; i < parity_bits; ++i) {
    if (i > 0) col_idx[row_ptr[i] + counts[i]++] =
        static_cast<uint32_t>(info_bits + i - 1);
    col_idx[row_ptr[i] + counts[i]++] = static_cast<uint32_t>(info_bits + i);
  }
  return row_ptr[parity_bits];
}

// ----------------------------------------------------- bit pack/unpack

// MSB-first unpack: bytes [rows, nbytes] -> bits [rows, nbits]
void pptpu_unpack_bits(const uint8_t* bytes, uint8_t* bits, uint64_t rows,
                       uint64_t nbytes, uint64_t nbits) {
  for (uint64_t r = 0; r < rows; ++r) {
    const uint8_t* src = bytes + r * nbytes;
    uint8_t* dst = bits + r * nbits;
    for (uint64_t b = 0; b < nbits; ++b)
      dst[b] = (src[b >> 3] >> (7 - (b & 7))) & 1;
  }
}

void pptpu_pack_bits(const uint8_t* bits, uint8_t* bytes, uint64_t rows,
                     uint64_t nbits, uint64_t nbytes) {
  for (uint64_t r = 0; r < rows; ++r) {
    const uint8_t* src = bits + r * nbits;
    uint8_t* dst = bytes + r * nbytes;
    std::memset(dst, 0, nbytes);
    for (uint64_t b = 0; b < nbits; ++b)
      if (src[b]) dst[b >> 3] |= static_cast<uint8_t>(1u << (7 - (b & 7)));
  }
}

}  // extern "C"
