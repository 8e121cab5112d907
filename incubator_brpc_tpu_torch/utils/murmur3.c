/* MurmurHash3 x86_32 (butil::MurmurHash32), the native counterpart of
 * utils/hashes.py's murmur3_32_py: the same blocks, tail and finalizer,
 * so both return the same value for every input.
 *
 * Built with the host C compiler on first use by utils/hashes.py and
 * bound with ctypes:  cc -O2 -shared -fPIC murmur3.c -o libmurmur3.so
 */
#include <stddef.h>
#include <stdint.h>
#include <string.h>

static inline uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

uint32_t brpc_murmur3_32(const uint8_t *data, size_t len, uint32_t seed) {
  const uint32_t c1 = 0xCC9E2D51u, c2 = 0x1B873593u;
  uint32_t h = seed, k;
  size_t nblocks = len / 4, i;
  for (i = 0; i < nblocks; ++i) {
    memcpy(&k, data + 4 * i, 4); /* little-endian blocks, any alignment */
    k *= c1;
    k = rotl32(k, 15);
    k *= c2;
    h ^= k;
    h = rotl32(h, 13);
    h = h * 5 + 0xE6546B64u;
  }
  const uint8_t *tail = data + 4 * nblocks;
  k = 0;
  switch (len & 3) {
    case 3: k ^= (uint32_t)tail[2] << 16; /* fall through */
    case 2: k ^= (uint32_t)tail[1] << 8;  /* fall through */
    case 1:
      k ^= tail[0];
      k *= c1;
      k = rotl32(k, 15);
      k *= c2;
      h ^= k;
  }
  h ^= (uint32_t)len;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}
