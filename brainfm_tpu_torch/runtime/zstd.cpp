// A Zstandard decoder (RFC 8878), host-side, for the zarr chunks and the
// OCDBT nodes of the JAX package's orbax checkpoints (train/orbax_read.py,
// runtime/ocdbt.py). Built with g++ into a shared library and loaded with
// ctypes by runtime/zstd.py; it links nothing but the C++ runtime.
//
// Covered: zstd frames (single-segment or windowed, any content-size field,
// several frames one after another, skippable frames; a non-zero
// dictionary ID is refused), Raw, RLE and Compressed blocks, literals Raw,
// RLE, Compressed and Treeless (Huffman trees from direct or FSE-compressed
// weights, 1 or 4 streams), sequences with Predefined, RLE, FSE-compressed
// and Repeat tables and the repeat offsets, and the XXH64 content checksum.
// Output goes into a buffer of the length the caller expects: a frame that
// would write more, or (unless the caller gives only a bound) a stream that
// ends short of it, is an error. Errors
// carry the byte offset in the input where decoding stopped; nothing is
// reported as decoded after one.
//
// C interface:
//   zstd_decode(src, n, dst, cap, exact, &out_len, &err_offset) -> status
//     (exact: the output must be cap bytes; else at most cap)
//   zstd_decode_batch(count, srcs, src_lens, dsts, dst_lens, threads,
//                     status[], err_offset[]) -> number of failed items
//   zstd_xxh64(p, n, seed), zstd_crc32c(p, n)
// Status: 0 ok, -1 truncated input, -2 corrupt input, -3 dictionary
// required, -4 checksum mismatch, -5 output length differs from the
// expected length.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

namespace {

enum Status { OK = 0, TRUNCATED = -1, CORRUPT = -2, DICTIONARY = -3,
              CHECKSUM = -4, SIZE = -5 };

struct Error {
  int code;
  size_t offset;
};

[[noreturn]] void fail(int code, size_t offset) { throw Error{code, offset}; }

inline uint32_t rd16(const uint8_t* p) { return p[0] | (uint32_t(p[1]) << 8); }
inline uint32_t rd24(const uint8_t* p) {
  return rd16(p) | (uint32_t(p[2]) << 16);
}
inline uint32_t rd32(const uint8_t* p) { return rd16(p) | (rd16(p + 2) << 16); }
inline uint64_t rd64(const uint8_t* p) {
  return rd32(p) | (uint64_t(rd32(p + 4)) << 32);
}
inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

constexpr size_t BLOCK_MAX = 128 * 1024;

// ------------------------------------------------------------------ XXH64

constexpr uint64_t P1 = 0x9E3779B185EBCA87ULL, P2 = 0xC2B2AE3D27D4EB4FULL,
                   P3 = 0x165667B19E3779F9ULL, P4 = 0x85EBCA77C2B2AE63ULL,
                   P5 = 0x27D4EB2F165667C5ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}
inline uint64_t xmerge(uint64_t acc, uint64_t v) {
  return (acc ^ xround(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = seed + P5;
  }
  h += n;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, rd64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (uint64_t(rd32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; p++) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ----------------------------------------------------------------- CRC32C

struct Crc32cTable {
  uint32_t t[256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      t[i] = c;
    }
  }
};

uint32_t crc32c(const uint8_t* p, size_t n) {
  static const Crc32cTable table;
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++) c = table.t[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// ------------------------------------------------------------ bit readers

// Forward little-endian bit reader (FSE table descriptions). Bits past
// the end read as zeros; the caller checks `pos` against the length.
struct FwdBits {
  const uint8_t* p;
  size_t len;
  size_t pos = 0;   // bits consumed
  uint32_t read(int n) {   // n <= 16
    uint64_t v = 0;
    const size_t byte = pos >> 3;
    for (size_t i = 0; i < 4 && byte + i < len; i++)
      v |= uint64_t(p[byte + i]) << (8 * i);
    const uint32_t r = uint32_t((v >> (pos & 7)) & ((1u << n) - 1));
    pos += n;
    return r;
  }
  size_t bytes() const { return (pos + 7) >> 3; }
};

// Backward bit reader (FSE, Huffman and sequence streams): the stream is
// one little-endian number whose highest set bit marks its end; reading
// goes from there down to bit 0. Bits below 0 read as zeros, so `bits`
// turns negative when a reader overruns the stream.
struct BackBits {
  const uint8_t* p;
  size_t len;
  int64_t bits;
  void init(const uint8_t* s, size_t n, size_t off) {
    if (n == 0) fail(CORRUPT, off);
    if (s[n - 1] == 0) fail(CORRUPT, off + n - 1);
    p = s;
    len = n;
    bits = int64_t(n - 1) * 8 + highbit(s[n - 1]);
  }
  uint64_t at(int64_t pos, int n) const {   // bits [pos, pos + n), n <= 56
    if (n == 0) return 0;
    if (pos < 0) {
      int64_t hi = pos + n;
      return hi <= 0 ? 0 : at(0, int(hi)) << (-pos);
    }
    size_t byte = size_t(pos) >> 3;
    uint64_t v;
    if (byte + 8 <= len) {
      memcpy(&v, p + byte, 8);
    } else {
      v = 0;
      for (size_t i = byte; i < len; i++)
        v |= uint64_t(p[i]) << (8 * (i - byte));
    }
    return (v >> (pos & 7)) & ((1ULL << n) - 1);
  }
  uint64_t read(int n) {
    bits -= n;
    return at(bits, n);
  }
  uint64_t peek(int n) const { return at(bits - n, n); }
};

// ------------------------------------------------------------------- FSE

struct FseTable {
  int al = -1;   // accuracy log; -1: no table yet
  uint8_t sym[512];
  uint8_t nb[512];
  uint16_t base[512];
};

void fse_build(FseTable& t, const int16_t* norm, int nsym, int al, size_t off) {
  const int size = 1 << al;
  uint16_t next[256];
  int high = size;
  for (int s = 0; s < nsym; s++) {
    if (norm[s] == -1) {
      t.sym[--high] = uint8_t(s);
      next[s] = 1;
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s < nsym; s++) {
    if (norm[s] <= 0) continue;
    next[s] = uint16_t(norm[s]);
    for (int i = 0; i < norm[s]; i++) {
      t.sym[pos] = uint8_t(s);
      do pos = (pos + step) & mask; while (pos >= high);
    }
  }
  if (pos != 0) fail(CORRUPT, off);
  for (int i = 0; i < size; i++) {
    const uint16_t d = next[t.sym[i]]++;
    t.nb[i] = uint8_t(al - highbit(d));
    t.base[i] = uint16_t((d << t.nb[i]) - size);
  }
  t.al = al;
}

void fse_rle(FseTable& t, uint8_t symbol) {
  t.al = 0;
  t.sym[0] = symbol;
  t.nb[0] = 0;
  t.base[0] = 0;
}

// An FSE table description at s[0, n); returns the bytes it takes.
size_t fse_read(FseTable& t, const uint8_t* s, size_t n, int max_al,
                int max_symbol, size_t off) {
  FwdBits in{s, n};
  const int al = 5 + int(in.read(4));
  if (al > max_al) fail(CORRUPT, off);
  int remaining = 1 << al;
  int16_t norm[256];
  int nsym = 0;
  while (remaining > 0) {
    if (nsym > max_symbol) fail(CORRUPT, off + in.bytes());
    const int bits = highbit(uint32_t(remaining + 1)) + 1;
    uint32_t val = in.read(bits);
    const uint32_t lower = (1u << (bits - 1)) - 1;
    const uint32_t threshold = (1u << bits) - 1 - uint32_t(remaining + 1);
    if ((val & lower) < threshold) {
      in.pos -= 1;
      val &= lower;
    } else if (val > lower) {
      val -= threshold;
    }
    const int proba = int(val) - 1;
    remaining -= proba < 0 ? -proba : proba;
    norm[nsym++] = int16_t(proba);
    if (proba == 0) {
      for (;;) {
        const uint32_t repeat = in.read(2);
        for (uint32_t i = 0; i < repeat; i++) {
          if (nsym > max_symbol) fail(CORRUPT, off + in.bytes());
          norm[nsym++] = 0;
        }
        if (repeat != 3) break;
      }
    }
  }
  if (in.bytes() > n) fail(TRUNCATED, off + n);
  if (remaining != 0) fail(CORRUPT, off + in.bytes());
  fse_build(t, norm, nsym, al, off);
  return in.bytes();
}

// The predefined sequence tables (RFC 8878 3.1.1.3.2.2).
const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct Defaults {
  FseTable ll, ml, of;
  Defaults() {
    fse_build(ll, LL_DEFAULT, 36, 6, 0);
    fse_build(ml, ML_DEFAULT, 53, 6, 0);
    fse_build(of, OF_DEFAULT, 29, 5, 0);
  }
};

const Defaults& defaults() {
  static const Defaults d;
  return d;
}

const uint32_t LL_BASE[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,
                              9,  10, 11,  12,  13,  14,   15,   16,   18,
                              20, 22, 24,  28,  32,  40,   48,   64,   128,
                              256, 512, 1024, 2048, 4096, 8192, 16384, 32768,
                              65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13,
                              14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24,
                              25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
                              37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131,
                              259, 515, 1027, 2051, 4099, 8195, 16387, 32771,
                              65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

// --------------------------------------------------------------- Huffman

constexpr int HUF_MAX_BITS = 11;

struct HufTable {
  int maxbits = 0;   // 0: no table yet
  uint8_t sym[1 << HUF_MAX_BITS];
  uint8_t nb[1 << HUF_MAX_BITS];
};

// A Huffman tree description at s[0, n); returns the bytes it takes.
size_t huf_read(HufTable& t, const uint8_t* s, size_t n, size_t off) {
  if (n < 1) fail(TRUNCATED, off);
  uint8_t w[256];
  int nw = 0;
  size_t used;
  const int header = s[0];
  if (header >= 128) {   // direct: 4 bits a weight
    nw = header - 127;
    used = 1 + size_t(nw + 1) / 2;
    if (used > n) fail(TRUNCATED, off + n);
    for (int i = 0; i < nw; i++)
      w[i] = (i & 1) ? (s[1 + i / 2] & 15) : (s[1 + i / 2] >> 4);
  } else {               // FSE-compressed weights, two interleaved states
    used = 1 + size_t(header);
    if (header == 0) fail(CORRUPT, off);
    if (used > n) fail(TRUNCATED, off + n);
    FseTable ft;
    const size_t hb = fse_read(ft, s + 1, header, 6, 255, off + 1);
    if (hb >= size_t(header)) fail(CORRUPT, off + 1);
    BackBits b;
    b.init(s + 1 + hb, header - hb, off + 1 + hb);
    uint32_t s1 = uint32_t(b.read(ft.al)), s2 = uint32_t(b.read(ft.al));
    for (;;) {   // at most 255 weights; the last one is implied
      if (nw == 255) fail(CORRUPT, off);
      w[nw++] = ft.sym[s1];
      s1 = ft.base[s1] + uint32_t(b.read(ft.nb[s1]));
      if (b.bits < 0) {
        if (nw == 255) fail(CORRUPT, off);
        w[nw++] = ft.sym[s2];
        break;
      }
      if (nw == 255) fail(CORRUPT, off);
      w[nw++] = ft.sym[s2];
      s2 = ft.base[s2] + uint32_t(b.read(ft.nb[s2]));
      if (b.bits < 0) {
        if (nw == 255) fail(CORRUPT, off);
        w[nw++] = ft.sym[s1];
        break;
      }
    }
  }
  uint32_t total = 0;
  for (int i = 0; i < nw; i++) {
    if (w[i] > HUF_MAX_BITS) fail(CORRUPT, off);
    if (w[i]) total += 1u << (w[i] - 1);
  }
  if (total == 0) fail(CORRUPT, off);
  const int maxbits = highbit(total) + 1;
  if (maxbits > HUF_MAX_BITS) fail(CORRUPT, off);
  const uint32_t rest = (1u << maxbits) - total;
  if (rest & (rest - 1)) fail(CORRUPT, off);
  w[nw++] = uint8_t(highbit(rest) + 1);   // the last weight is implied
  int rank_count[HUF_MAX_BITS + 2] = {0};
  uint8_t bits[256];
  for (int i = 0; i < nw; i++) {
    bits[i] = w[i] ? uint8_t(maxbits + 1 - w[i]) : 0;
    rank_count[bits[i]]++;
  }
  uint32_t rank_idx[HUF_MAX_BITS + 2];
  rank_idx[maxbits] = 0;
  for (int i = maxbits; i >= 1; i--) {
    rank_idx[i - 1] =
        rank_idx[i] + uint32_t(rank_count[i]) * (1u << (maxbits - i));
    if (rank_idx[i - 1] > (1u << maxbits)) fail(CORRUPT, off);
    memset(t.nb + rank_idx[i], i, rank_idx[i - 1] - rank_idx[i]);
  }
  if (rank_idx[0] != (1u << maxbits)) fail(CORRUPT, off);
  for (int i = 0; i < nw; i++) {
    if (!bits[i]) continue;
    const uint32_t len = 1u << (maxbits - bits[i]);
    memset(t.sym + rank_idx[bits[i]], i, len);
    rank_idx[bits[i]] += len;
  }
  t.maxbits = maxbits;
  return used;
}

// K Huffman streams s[j][0, n[j]) decoded into out[j][0, count[j]); the
// streams are independent, so they are decoded in lockstep for the
// processor to overlap their table lookups.
template <int K>
void huf_streams(const HufTable& t, const uint8_t* const* s, const size_t* n,
                 uint8_t* const* out, const size_t* count, const size_t* off) {
  BackBits b[K];
  size_t common = count[0];
  for (int j = 0; j < K; j++) {
    b[j].init(s[j], n[j], off[j]);
    common = std::min(common, count[j]);
  }
  const int mb = t.maxbits;
  for (size_t i = 0; i < common; i++) {
    for (int j = 0; j < K; j++) {
      const uint32_t v = uint32_t(b[j].peek(mb));
      out[j][i] = t.sym[v];
      b[j].bits -= t.nb[v];
    }
  }
  for (int j = 0; j < K; j++) {
    for (size_t i = common; i < count[j]; i++) {
      const uint32_t v = uint32_t(b[j].peek(mb));
      out[j][i] = t.sym[v];
      b[j].bits -= t.nb[v];
    }
    if (b[j].bits != 0) fail(CORRUPT, off[j]);
  }
}

// ------------------------------------------------------------------ frame

struct Frame {
  HufTable huf;
  FseTable ll, ml, of;
  uint32_t rep[3] = {1, 4, 8};
  uint8_t lit[BLOCK_MAX + 8];
};

// The literals section of a compressed block at s[0, n). Sets `lit` and
// `nlit`; returns the bytes the section takes.
size_t literals(Frame& f, const uint8_t* s, size_t n, size_t off,
                const uint8_t** lit, size_t* nlit) {
  if (n < 1) fail(TRUNCATED, off);
  const int type = s[0] & 3, sf = (s[0] >> 2) & 3;
  if (type <= 1) {   // Raw, RLE
    size_t hs, regen;
    if (sf == 0 || sf == 2) {
      hs = 1;
      regen = s[0] >> 3;
    } else if (sf == 1) {
      hs = 2;
      if (n < hs) fail(TRUNCATED, off + n);
      regen = (s[0] >> 4) + (size_t(s[1]) << 4);
    } else {
      hs = 3;
      if (n < hs) fail(TRUNCATED, off + n);
      regen = (s[0] >> 4) + (size_t(s[1]) << 4) + (size_t(s[2]) << 12);
    }
    if (regen > BLOCK_MAX) fail(CORRUPT, off);
    *nlit = regen;
    if (type == 0) {
      if (hs + regen > n) fail(TRUNCATED, off + n);
      *lit = s + hs;
      return hs + regen;
    }
    if (hs + 1 > n) fail(TRUNCATED, off + n);
    memset(f.lit, s[hs], regen);
    *lit = f.lit;
    return hs + 1;
  }
  size_t hs, regen, comp;
  const bool one = sf == 0;
  if (sf <= 1) {
    hs = 3;
    if (n < hs) fail(TRUNCATED, off + n);
    const uint32_t v = rd24(s);
    regen = (v >> 4) & 0x3FF;
    comp = (v >> 14) & 0x3FF;
  } else if (sf == 2) {
    hs = 4;
    if (n < hs) fail(TRUNCATED, off + n);
    const uint32_t v = rd32(s);
    regen = (v >> 4) & 0x3FFF;
    comp = v >> 18;
  } else {
    hs = 5;
    if (n < hs) fail(TRUNCATED, off + n);
    const uint64_t v = rd32(s) | (uint64_t(s[4]) << 32);
    regen = (v >> 4) & 0x3FFFF;
    comp = (v >> 22) & 0x3FFFF;
  }
  if (regen > BLOCK_MAX) fail(CORRUPT, off);
  if (hs + comp > n) fail(TRUNCATED, off + n);
  const uint8_t* p = s + hs;
  size_t left = comp, poff = off + hs;
  if (type == 2) {
    const size_t used = huf_read(f.huf, p, left, poff);
    p += used;
    left -= used;
    poff += used;
  } else if (f.huf.maxbits == 0) {
    fail(CORRUPT, off);   // Treeless with no earlier tree in this frame
  }
  if (one) {
    uint8_t* out = f.lit;
    huf_streams<1>(f.huf, &p, &left, &out, &regen, &poff);
  } else {
    if (left < 6) fail(CORRUPT, poff);
    const size_t l1 = rd16(p), l2 = rd16(p + 2), l3 = rd16(p + 4);
    if (l1 + l2 + l3 > left - 6) fail(CORRUPT, poff);
    const size_t l4 = left - 6 - l1 - l2 - l3;
    const size_t seg = (regen + 3) / 4;
    if (3 * seg > regen) fail(CORRUPT, poff);
    const size_t lens[4] = {l1, l2, l3, l4};
    const uint8_t* q[4] = {p + 6, p + 6 + l1, p + 6 + l1 + l2,
                           p + 6 + l1 + l2 + l3};
    const size_t qoff[4] = {poff + 6, poff + 6 + l1, poff + 6 + l1 + l2,
                            poff + 6 + l1 + l2 + l3};
    uint8_t* out[4] = {f.lit, f.lit + seg, f.lit + 2 * seg, f.lit + 3 * seg};
    const size_t counts[4] = {seg, seg, seg, regen - 3 * seg};
    huf_streams<4>(f.huf, q, lens, out, counts, qoff);
  }
  *lit = f.lit;
  *nlit = regen;
  return hs + comp;
}

// One sequence table's mode (0 predefined, 1 RLE, 2 FSE, 3 repeat).
size_t seq_table(FseTable& t, const FseTable& def, int mode, const uint8_t* s,
                 size_t n, int max_al, int max_symbol, size_t off) {
  switch (mode) {
    case 0:
      t = def;
      return 0;
    case 1:
      if (n < 1) fail(TRUNCATED, off);
      if (s[0] > max_symbol) fail(CORRUPT, off);
      fse_rle(t, s[0]);
      return 1;
    case 2:
      return fse_read(t, s, n, max_al, max_symbol, off);
    default:
      if (t.al < 0) fail(CORRUPT, off);   // repeat with no earlier table
      return 0;
  }
}

// A compressed block at s[0, n) into out[*op...), out[0, cap) being the
// output buffer and fstart where this frame's output began.
void compressed_block(Frame& f, const uint8_t* s, size_t n, size_t off,
                      uint8_t* out, size_t cap, size_t fstart, size_t* op) {
  const uint8_t* lit;
  size_t nlit;
  size_t pos = literals(f, s, n, off, &lit, &nlit);
  if (pos >= n) fail(TRUNCATED, off + n);
  size_t nseq = s[pos++];
  if (nseq >= 128) {
    if (pos >= n) fail(TRUNCATED, off + n);
    if (nseq < 255) {
      nseq = ((nseq - 128) << 8) + s[pos++];
    } else {
      if (pos + 2 > n) fail(TRUNCATED, off + n);
      nseq = s[pos] + (size_t(s[pos + 1]) << 8) + 0x7F00;
      pos += 2;
    }
  }
  const size_t bstart = *op;
  size_t o = *op;
  if (nseq == 0) {
    if (pos != n) fail(CORRUPT, off + pos);
  } else {
    if (pos >= n) fail(TRUNCATED, off + n);
    const uint8_t modes = s[pos++];
    if (modes & 3) fail(CORRUPT, off + pos - 1);
    const Defaults& d = defaults();
    pos += seq_table(f.ll, d.ll, modes >> 6, s + pos, n - pos, 9, 35,
                     off + pos);
    pos += seq_table(f.of, d.of, (modes >> 4) & 3, s + pos, n - pos, 8, 31,
                     off + pos);
    pos += seq_table(f.ml, d.ml, (modes >> 2) & 3, s + pos, n - pos, 9, 52,
                     off + pos);
    BackBits b;
    b.init(s + pos, n - pos, off + pos);
    uint32_t sll = uint32_t(b.read(f.ll.al));
    uint32_t sof = uint32_t(b.read(f.of.al));
    uint32_t sml = uint32_t(b.read(f.ml.al));
    const uint8_t* lend = lit + nlit;
    for (size_t i = 0; i < nseq; i++) {
      const int ofc = f.of.sym[sof], llc = f.ll.sym[sll], mlc = f.ml.sym[sml];
      if (ofc > 31) fail(CORRUPT, off + pos);
      const uint32_t ofv = (1u << ofc) + uint32_t(b.read(ofc));
      const size_t ml = ML_BASE[mlc] + b.read(ML_BITS[mlc]);
      const size_t ll = LL_BASE[llc] + b.read(LL_BITS[llc]);
      uint32_t offset;
      if (ofv > 3) {
        offset = ofv - 3;
        f.rep[2] = f.rep[1];
        f.rep[1] = f.rep[0];
        f.rep[0] = offset;
      } else {
        const int idx = int(ofv) - 1 + (ll == 0);
        if (idx == 0) {
          offset = f.rep[0];
        } else {
          offset = idx == 3 ? f.rep[0] - 1 : f.rep[idx];
          if (idx > 1) f.rep[2] = f.rep[1];
          f.rep[1] = f.rep[0];
          f.rep[0] = offset;
        }
      }
      if (i + 1 < nseq) {
        sll = f.ll.base[sll] + uint32_t(b.read(f.ll.nb[sll]));
        sml = f.ml.base[sml] + uint32_t(b.read(f.ml.nb[sml]));
        sof = f.of.base[sof] + uint32_t(b.read(f.of.nb[sof]));
      }
      if (ll > size_t(lend - lit)) fail(CORRUPT, off + pos);
      if (ll + ml > cap - o) fail(SIZE, off);
      memcpy(out + o, lit, ll);
      lit += ll;
      o += ll;
      if (offset == 0 || offset > o - fstart) fail(CORRUPT, off + pos);
      uint8_t* dst = out + o;
      const uint8_t* src = dst - offset;
      if (offset >= ml) {
        memcpy(dst, src, ml);
      } else {
        for (size_t k = 0; k < ml; k++) dst[k] = src[k];
      }
      o += ml;
    }
    if (b.bits != 0) fail(CORRUPT, off + pos);
    nlit = size_t(lend - lit);
  }
  if (nlit > cap - o) fail(SIZE, off);
  memcpy(out + o, lit, nlit);
  o += nlit;
  if (o - bstart > BLOCK_MAX) fail(CORRUPT, off);
  *op = o;
}

// One zstd frame starting at src[pos] (after its magic number was checked);
// returns the position after it.
size_t frame(const uint8_t* src, size_t n, size_t pos, uint8_t* out,
             size_t cap, size_t* op) {
  size_t p = pos + 4;
  if (p >= n) fail(TRUNCATED, n);
  const uint8_t fhd = src[p++];
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1,
            checksum = (fhd >> 2) & 1, did_flag = fhd & 3;
  if (fhd & 0x08) fail(CORRUPT, p - 1);   // reserved bit
  uint64_t window = 0;
  if (!single) {
    if (p >= n) fail(TRUNCATED, n);
    const uint8_t wd = src[p++];
    const uint64_t base = 1ULL << (10 + (wd >> 3));
    window = base + (base / 8) * (wd & 7);
  }
  const int did_size[4] = {0, 1, 2, 4};
  const size_t ds = did_size[did_flag];
  if (p + ds > n) fail(TRUNCATED, n);
  uint32_t did = 0;
  for (size_t i = 0; i < ds; i++) did |= uint32_t(src[p + i]) << (8 * i);
  if (did != 0) fail(DICTIONARY, p);
  p += ds;
  const size_t fcs_sizes[4] = {size_t(single), 2, 4, 8};
  const size_t fcs_size = fcs_sizes[fcs_flag];
  if (p + fcs_size > n) fail(TRUNCATED, n);
  uint64_t fcs = 0;
  for (size_t i = 0; i < fcs_size; i++) fcs |= uint64_t(src[p + i]) << (8 * i);
  if (fcs_size == 2) fcs += 256;
  p += fcs_size;
  if (single) window = fcs;
  const size_t block_max = size_t(std::min<uint64_t>(window, BLOCK_MAX));
  std::unique_ptr<Frame> f(new Frame());
  const size_t fstart = *op;
  for (;;) {
    if (p + 3 > n) fail(TRUNCATED, n);
    const uint32_t bh = rd24(src + p);
    const size_t boff = p;
    p += 3;
    const int last = bh & 1, type = (bh >> 1) & 3;
    const size_t bsize = bh >> 3;
    if (bsize > block_max) fail(CORRUPT, boff);
    if (type == 0) {
      if (p + bsize > n) fail(TRUNCATED, n);
      if (bsize > cap - *op) fail(SIZE, boff);
      memcpy(out + *op, src + p, bsize);
      *op += bsize;
      p += bsize;
    } else if (type == 1) {
      if (p + 1 > n) fail(TRUNCATED, n);
      if (bsize > cap - *op) fail(SIZE, boff);
      memset(out + *op, src[p], bsize);
      *op += bsize;
      p += 1;
    } else if (type == 2) {
      if (p + bsize > n) fail(TRUNCATED, n);
      compressed_block(*f, src + p, bsize, p, out, cap, fstart, op);
      p += bsize;
    } else {
      fail(CORRUPT, boff);
    }
    if (last) break;
  }
  if (fcs_flag != 0 || single) {
    if (*op - fstart != fcs) fail(CORRUPT, p);
  }
  if (checksum) {
    if (p + 4 > n) fail(TRUNCATED, n);
    const uint32_t want = rd32(src + p);
    if (uint32_t(xxh64(out + fstart, *op - fstart, 0)) != want)
      fail(CHECKSUM, p);
    p += 4;
  }
  return p;
}

// Decode src[0, n) into out[0, cap): exactly cap bytes, or (exact false)
// at most cap, the length in *out_len.
int decode(const uint8_t* src, size_t n, uint8_t* out, size_t cap, bool exact,
           size_t* out_len, size_t* err_offset) {
  try {
    if (n == 0) fail(TRUNCATED, 0);
    size_t pos = 0, op = 0;
    while (pos < n) {
      if (n - pos < 4) fail(TRUNCATED, n);
      const uint32_t magic = rd32(src + pos);
      if (magic == 0xFD2FB528u) {
        pos = frame(src, n, pos, out, cap, &op);
      } else if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
        if (n - pos < 8) fail(TRUNCATED, n);
        const uint64_t len = rd32(src + pos + 4);
        if (len > n - pos - 8) fail(TRUNCATED, n);
        pos += 8 + len;
      } else {
        fail(CORRUPT, pos);
      }
    }
    if (exact && op != cap) fail(SIZE, n);
    *out_len = op;
    *err_offset = 0;
    return OK;
  } catch (const Error& e) {
    *err_offset = e.offset;
    return e.code;
  } catch (const std::bad_alloc&) {
    *err_offset = 0;
    return CORRUPT;
  }
}

}  // namespace

extern "C" {

int zstd_decode(const uint8_t* src, uint64_t n, uint8_t* dst, uint64_t cap,
                int exact, uint64_t* out_len, uint64_t* err_offset) {
  size_t len = 0, off = 0;
  const int r = decode(src, n, dst, cap, exact != 0, &len, &off);
  *out_len = len;
  *err_offset = off;
  return r;
}

int64_t zstd_decode_batch(int64_t count, const uint8_t* const* srcs,
                          const uint64_t* src_lens, uint8_t* const* dsts,
                          const uint64_t* dst_lens, int threads,
                          int32_t* status, uint64_t* err_offsets) {
  std::atomic<int64_t> next{0}, failed{0};
  auto work = [&]() {
    for (int64_t i; (i = next.fetch_add(1)) < count;) {
      size_t len = 0, off = 0;
      status[i] = decode(srcs[i], src_lens[i], dsts[i], dst_lens[i], true,
                         &len, &off);
      err_offsets[i] = off;
      if (status[i] != OK) failed.fetch_add(1);
    }
  };
  const int nt = int(std::max<int64_t>(1, std::min<int64_t>(threads, count)));
  std::vector<std::thread> pool;
  for (int t = 1; t < nt; t++) pool.emplace_back(work);
  work();
  for (auto& t : pool) t.join();
  return failed.load();
}

uint64_t zstd_xxh64(const uint8_t* p, uint64_t n, uint64_t seed) {
  return xxh64(p, n, seed);
}

uint32_t zstd_crc32c(const uint8_t* p, uint64_t n) { return crc32c(p, n); }

}  // extern "C"
