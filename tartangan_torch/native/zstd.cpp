// A Zstandard frame decoder (RFC 8878) and CRC32C, for reading the orbax
// checkpoints that the JAX package writes (utils/zstd.py, utils/ocdbt.py,
// utils/orbax.py). Every node of an OCDBT store and every zarr chunk in
// such a checkpoint is a zstd frame; Python has no zstd module, so the port
// decodes them here.
//
// What it decodes: zstd frames with or without a content size, single
// segment or with a window descriptor, skippable frames, and several
// frames back to back; raw, RLE and compressed blocks; raw, RLE and
// Huffman literals in 1 or 4 streams, treeless literals reusing the last
// table; sequences whose literal-length, offset and match-length tables
// are predefined, RLE, FSE-compressed or repeated; the three repeat
// offsets; the XXH64 content checksum, which is checked. Dictionaries are
// not supported: a frame that names one is refused.
//
// The C interface: tt_zstd_decompress returns a malloc'd buffer (freed
// with tt_zstd_free) or null with a message in err; tt_crc32c is the
// Castagnoli CRC of the OCDBT trailers; tt_xxh64 is exposed for tests.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const char* what) { throw Error(what); }

inline int highest_bit(uint32_t v) { return 31 - __builtin_clz(v); }

inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

// ------------------------------------------------------------------ XXH64
constexpr uint64_t P1 = 0x9E3779B185EBCA87ULL, P2 = 0xC2B2AE3D27D4EB4FULL,
                   P3 = 0x165667B19E3779F9ULL, P4 = 0x85EBCA77C2B2AE63ULL,
                   P5 = 0x27D4EB2F165667C5ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t xxh_round(uint64_t acc, uint64_t input) {
  acc += input * P2;
  return rotl(acc, 31) * P1;
}

inline uint64_t xxh_merge(uint64_t acc, uint64_t val) {
  acc ^= xxh_round(0, val);
  return acc * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t len, uint64_t seed) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xxh_round(v1, load64(p));
      v2 = xxh_round(v2, load64(p + 8));
      v3 = xxh_round(v3, load64(p + 16));
      v4 = xxh_round(v4, load64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xxh_merge(h, v1);
    h = xxh_merge(h, v2);
    h = xxh_merge(h, v3);
    h = xxh_merge(h, v4);
  } else {
    h = seed + P5;
  }
  h += len;
  while (p + 8 <= end) {
    h ^= xxh_round(0, load64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= uint64_t(load32(p)) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p++) * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ------------------------------------------------------------------ CRC32C
struct Crc32cTable {
  uint32_t t[8][256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      t[0][i] = c;
    }
    for (int s = 1; s < 8; ++s)
      for (uint32_t i = 0; i < 256; ++i)
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

const Crc32cTable& crc_table() {
  static const Crc32cTable table;
  return table;
}

uint32_t crc32c(const uint8_t* p, size_t n, uint32_t crc) {
  const auto& T = crc_table().t;
  crc = ~crc;
  while (n >= 8) {  // slicing by 8
    uint64_t v = load64(p) ^ crc;
    crc = T[7][v & 0xFF] ^ T[6][(v >> 8) & 0xFF] ^ T[5][(v >> 16) & 0xFF] ^
          T[4][(v >> 24) & 0xFF] ^ T[3][(v >> 32) & 0xFF] ^
          T[2][(v >> 40) & 0xFF] ^ T[1][(v >> 48) & 0xFF] ^ T[0][v >> 56];
    p += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ T[0][(crc ^ *p++) & 0xFF];
  return ~crc;
}

// ------------------------------------------------------------ bit readers
// Forward, little-endian bit order (FSE table headers).
struct ForwardBits {
  const uint8_t* src;
  size_t len;
  size_t bit = 0;
  uint32_t read(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; ++i, ++bit) {
      if ((bit >> 3) >= len) fail("zstd: FSE table header runs past its input");
      v |= uint32_t((src[bit >> 3] >> (bit & 7)) & 1) << i;
    }
    return v;
  }
  size_t bytes_used() const { return (bit + 7) >> 3; }
};

// Backward bit stream (Huffman streams, FSE weights, sequences): it is
// read from its end towards its start; `pos` is the number of bits not
// yet read and may go negative, the bits below the start reading as 0.
struct BackwardBits {
  const uint8_t* src;
  int64_t len;
  int64_t pos;

  BackwardBits(const uint8_t* s, int64_t n) : src(s), len(n) {
    if (n <= 0) fail("zstd: empty bit stream");
    uint8_t last = s[n - 1];
    if (last == 0) fail("zstd: bit stream without its end mark");
    pos = n * 8 - (8 - highest_bit(last));
  }

  // Up to 56 bits.
  inline uint64_t read(int n) {
    if (n == 0) return 0;
    pos -= n;
    if (pos >= 0 && (pos >> 3) + 8 <= len) {
      return (load64(src + (pos >> 3)) >> (pos & 7)) & ((uint64_t(1) << n) - 1);
    }
    return read_slow(n);
  }

  uint64_t read_slow(int n) {
    uint64_t v = 0;
    for (int i = 0; i < n; ++i) {
      int64_t b = pos + i;
      if (b >= 0) v |= uint64_t((src[b >> 3] >> (b & 7)) & 1) << i;
    }
    return v;
  }
};

// ------------------------------------------------------------------- FSE
struct FseTable {
  int log = 0;
  std::vector<uint8_t> symbol, bits;
  std::vector<uint16_t> base;

  void build(const int16_t* norm, int nsym, int accuracy) {
    const int size = 1 << accuracy;
    log = accuracy;
    symbol.assign(size, 0);
    bits.assign(size, 0);
    base.assign(size, 0);
    std::vector<uint16_t> next(nsym > 0 ? nsym : 1, 0);
    int high = size - 1;
    for (int s = 0; s < nsym; ++s) {
      if (norm[s] == -1) {
        symbol[high--] = uint8_t(s);
        next[s] = 1;
      } else {
        next[s] = uint16_t(norm[s] > 0 ? norm[s] : 0);
      }
    }
    const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
    int pos = 0;
    for (int s = 0; s < nsym; ++s) {
      for (int i = 0; i < norm[s]; ++i) {
        symbol[pos] = uint8_t(s);
        do pos = (pos + step) & mask; while (pos > high);
      }
    }
    if (pos != 0) fail("zstd: bad FSE distribution");
    for (int i = 0; i < size; ++i) {
      uint32_t n = next[symbol[i]]++;
      bits[i] = uint8_t(accuracy - highest_bit(n));
      base[i] = uint16_t((n << bits[i]) - size);
    }
  }

  void build_rle(uint8_t s) {
    log = 0;
    symbol.assign(1, s);
    bits.assign(1, 0);
    base.assign(1, 0);
  }

  // Reads a table description at src; returns the bytes it used.
  size_t read(const uint8_t* src, size_t len, int max_log, int max_sym) {
    ForwardBits in{src, len};
    int accuracy = int(in.read(4)) + 5;
    if (accuracy > max_log) fail("zstd: FSE accuracy too large");
    int remaining = (1 << accuracy) + 1;
    int16_t norm[256];
    int s = 0;
    while (remaining > 1) {
      if (s > max_sym) fail("zstd: too many FSE symbols");
      int nbits = highest_bit(uint32_t(remaining)) + 1;
      uint32_t lower = (1u << (nbits - 1)) - 1;
      uint32_t threshold = (1u << nbits) - 1 - uint32_t(remaining);
      uint32_t v = in.read(nbits - 1);
      if (v >= threshold) {
        v |= in.read(1) << (nbits - 1);
        if (v > lower) v -= threshold;
      }
      int proba = int(v) - 1;
      remaining -= proba < 0 ? -proba : proba;
      norm[s++] = int16_t(proba);
      if (proba == 0) {
        for (;;) {
          int repeat = int(in.read(2));
          for (int i = 0; i < repeat; ++i) {
            if (s > max_sym) fail("zstd: too many FSE symbols");
            norm[s++] = 0;
          }
          if (repeat != 3) break;
        }
      }
    }
    if (remaining != 1) fail("zstd: FSE distribution does not sum up");
    build(norm, s, accuracy);
    return in.bytes_used();
  }
};

struct FseState {
  const FseTable* t;
  uint32_t state;
  void init(const FseTable& table, BackwardBits& in) {
    t = &table;
    state = uint32_t(in.read(table.log));
  }
  inline uint8_t peek() const { return t->symbol[state]; }
  inline void update(BackwardBits& in) {
    state = t->base[state] + uint32_t(in.read(t->bits[state]));
  }
};

// --------------------------------------------------------------- Huffman
constexpr int kHufMaxBits = 11;

struct HufTable {
  int max_bits = 0;
  std::vector<uint8_t> symbol, bits;

  // weights[i] for symbols 0..n-1; the last symbol's weight is implied.
  void build(std::vector<uint8_t> w) {
    uint32_t sum = 0;
    for (uint8_t x : w) {
      if (x > kHufMaxBits) fail("zstd: Huffman weight too large");
      if (x) sum += 1u << (x - 1);
    }
    if (sum == 0) fail("zstd: Huffman weights all zero");
    max_bits = highest_bit(sum) + 1;
    if (max_bits > kHufMaxBits) fail("zstd: Huffman table too deep");
    uint32_t left = (1u << max_bits) - sum;
    if (left & (left - 1)) fail("zstd: Huffman weights do not sum to a power of two");
    w.push_back(uint8_t(highest_bit(left) + 1));
    if (w.size() > 256) fail("zstd: too many Huffman symbols");
    const int size = 1 << max_bits;
    symbol.assign(size, 0);
    bits.assign(size, 0);
    int rank_count[kHufMaxBits + 2] = {0};
    std::vector<int> nb(w.size());
    for (size_t i = 0; i < w.size(); ++i) {
      nb[i] = w[i] ? max_bits + 1 - w[i] : 0;
      rank_count[nb[i]]++;
    }
    int rank_idx[kHufMaxBits + 2] = {0};
    rank_idx[max_bits] = 0;
    for (int b = max_bits; b >= 1; --b) {
      rank_idx[b - 1] = rank_idx[b] + rank_count[b] * (1 << (max_bits - b));
      for (int j = rank_idx[b]; j < rank_idx[b - 1]; ++j) bits[j] = uint8_t(b);
    }
    if (rank_idx[0] != size) fail("zstd: bad Huffman code lengths");
    for (size_t i = 0; i < w.size(); ++i) {
      if (!nb[i]) continue;
      int code = rank_idx[nb[i]], n = 1 << (max_bits - nb[i]);
      std::memset(&symbol[code], int(i), size_t(n));
      rank_idx[nb[i]] += n;
    }
  }

  // A tree description at src; returns the bytes it used.
  size_t read(const uint8_t* src, size_t len) {
    if (len < 1) fail("zstd: missing Huffman tree description");
    uint8_t header = src[0];
    std::vector<uint8_t> w;
    if (header >= 128) {  // direct: 4 bits a weight
      size_t n = header - 127, bytes = (n + 1) / 2;
      if (1 + bytes > len) fail("zstd: truncated Huffman weights");
      for (size_t i = 0; i < n; ++i) {
        uint8_t b = src[1 + i / 2];
        w.push_back(i % 2 == 0 ? b >> 4 : b & 15);
      }
      build(w);
      return 1 + bytes;
    }
    size_t csize = header;
    if (csize == 0 || 1 + csize > len) fail("zstd: bad Huffman weights size");
    const uint8_t* p = src + 1;
    FseTable table;
    size_t used = table.read(p, csize, 6, 255);
    if (used >= csize) fail("zstd: Huffman weights have no stream");
    BackwardBits in(p + used, int64_t(csize - used));
    FseState s1, s2;
    s1.init(table, in);
    s2.init(table, in);
    for (;;) {  // two interleaved states until the stream runs out
      if (w.size() > 254) fail("zstd: too many Huffman weights");
      w.push_back(s1.peek());
      s1.update(in);
      if (in.pos < 0) {
        w.push_back(s2.peek());
        break;
      }
      w.push_back(s2.peek());
      s2.update(in);
      if (in.pos < 0) {
        w.push_back(s1.peek());
        break;
      }
    }
    build(w);
    return 1 + csize;
  }

  void decode_stream(const uint8_t* src, size_t len, uint8_t* out, size_t n) const {
    BackwardBits in(src, int64_t(len));
    uint32_t mask = (1u << max_bits) - 1;
    uint32_t state = uint32_t(in.read(max_bits));
    for (size_t i = 0; i < n; ++i) {
      out[i] = symbol[state];
      int b = bits[state];
      state = ((state << b) | uint32_t(in.read(b))) & mask;
    }
    if (in.pos != -max_bits) fail("zstd: Huffman stream not consumed exactly");
  }
};

// ------------------------------------------------------------- sequences
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1,  1,  1,  1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

const uint32_t kLLBase[36] = {
    0,  1,  2,  3,  4,  5,   6,   7,   8,   9,    10,   11,
    12, 13, 14, 15, 16, 18,  20,  22,  24,  28,   32,   40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2,  3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,  15,   16,   17,   18,
    19, 20, 21, 22, 23, 24, 25, 26, 27, 28,  29,  30,  31,   32,   33,   34,
    35, 37, 39, 41, 43, 47, 51, 59, 67, 83,  99,  131, 259,  515,  1027, 2051,
    4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

constexpr size_t kBlockMax = 128 * 1024;

// What persists from block to block within a frame.
struct FrameState {
  HufTable huf;
  bool have_huf = false;
  FseTable ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint64_t rep[3] = {1, 4, 8};
};

struct Decoder {
  std::vector<uint8_t>& out;
  size_t frame_start = 0;
  FrameState fs;
  std::vector<uint8_t> lit;

  explicit Decoder(std::vector<uint8_t>& o) : out(o) {}

  // ------------------------------------------------------------ literals
  size_t literals(const uint8_t* src, size_t len) {
    if (len < 1) fail("zstd: empty compressed block");
    int type = src[0] & 3, sf = (src[0] >> 2) & 3;
    size_t regen, csize = 0, hsize;
    if (type < 2) {
      if (sf == 0 || sf == 2) {
        hsize = 1;
        regen = src[0] >> 3;
      } else if (sf == 1) {
        hsize = 2;
        if (len < 2) fail("zstd: truncated literals header");
        regen = (src[0] >> 4) + (size_t(src[1]) << 4);
      } else {
        hsize = 3;
        if (len < 3) fail("zstd: truncated literals header");
        regen = (src[0] >> 4) + (size_t(src[1]) << 4) + (size_t(src[2]) << 12);
      }
      if (regen > kBlockMax) fail("zstd: literals too long");
      lit.resize(regen);
      if (type == 0) {
        if (hsize + regen > len) fail("zstd: truncated raw literals");
        if (regen) std::memcpy(lit.data(), src + hsize, regen);
        return hsize + regen;
      }
      if (hsize + 1 > len) fail("zstd: truncated RLE literals");
      std::memset(lit.data(), src[hsize], regen);
      return hsize + 1;
    }
    int streams = sf == 0 ? 1 : 4;
    hsize = sf < 2 ? 3 : (sf == 2 ? 4 : 5);
    if (len < hsize) fail("zstd: truncated literals header");
    uint64_t h = 0;
    for (size_t i = 0; i < hsize; ++i) h |= uint64_t(src[i]) << (8 * i);
    int fbits = sf < 2 ? 10 : (sf == 2 ? 14 : 18);
    regen = (h >> 4) & ((1u << fbits) - 1);
    csize = (h >> (4 + fbits)) & ((1u << fbits) - 1);
    if (regen > kBlockMax) fail("zstd: literals too long");
    if (hsize + csize > len) fail("zstd: truncated Huffman literals");
    const uint8_t* p = src + hsize;
    size_t avail = csize;
    if (type == 2) {
      size_t used = fs.huf.read(p, avail);
      fs.have_huf = true;
      p += used;
      avail -= used;
    } else if (!fs.have_huf) {
      fail("zstd: treeless literals without an earlier Huffman table");
    }
    lit.resize(regen);
    if (streams == 1) {
      fs.huf.decode_stream(p, avail, lit.data(), regen);
    } else {
      if (avail < 6) fail("zstd: truncated jump table");
      size_t s1 = p[0] | (p[1] << 8), s2 = p[2] | (p[3] << 8),
             s3 = p[4] | (p[5] << 8);
      if (6 + s1 + s2 + s3 > avail) fail("zstd: bad jump table");
      size_t s4 = avail - 6 - s1 - s2 - s3;
      size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) fail("zstd: too few literals for four streams");
      const uint8_t* q = p + 6;
      fs.huf.decode_stream(q, s1, lit.data(), seg);
      fs.huf.decode_stream(q + s1, s2, lit.data() + seg, seg);
      fs.huf.decode_stream(q + s1 + s2, s3, lit.data() + 2 * seg, seg);
      fs.huf.decode_stream(q + s1 + s2 + s3, s4, lit.data() + 3 * seg,
                           regen - 3 * seg);
    }
    return hsize + csize;
  }

  // One sequence table: returns the bytes its description used.
  size_t table(int mode, const uint8_t* p, size_t len, FseTable& t, bool& have,
               const int16_t* def, int ndef, int def_log, int max_log,
               int max_sym) {
    switch (mode) {
      case 0:
        t.build(def, ndef, def_log);
        have = true;
        return 0;
      case 1:
        if (len < 1) fail("zstd: truncated RLE table");
        if (p[0] > max_sym) fail("zstd: RLE symbol out of range");
        t.build_rle(p[0]);
        have = true;
        return 1;
      case 2: {
        size_t used = t.read(p, len, max_log, max_sym);
        have = true;
        return used;
      }
      default:
        if (!have) fail("zstd: repeated table without an earlier one");
        return 0;
    }
  }

  void sequences(const uint8_t* src, size_t len) {
    size_t nseq, pos;
    if (len < 1) fail("zstd: missing sequences section");
    if (src[0] < 128) {
      nseq = src[0];
      pos = 1;
    } else if (src[0] < 255) {
      if (len < 2) fail("zstd: truncated sequences header");
      nseq = ((size_t(src[0]) - 128) << 8) + src[1];
      pos = 2;
    } else {
      if (len < 3) fail("zstd: truncated sequences header");
      nseq = src[1] + (size_t(src[2]) << 8) + 0x7F00;
      pos = 3;
    }
    size_t lit_pos = 0;
    if (nseq > 0) {
      if (pos >= len) fail("zstd: missing table modes");
      uint8_t modes = src[pos++];
      if (modes & 3) fail("zstd: reserved bits set in table modes");
      pos += table(modes >> 6, src + pos, len - pos, fs.ll, fs.have_ll,
                   kLLDefault, 36, 6, 9, 35);
      pos += table((modes >> 4) & 3, src + pos, len - pos, fs.of, fs.have_of,
                   kOFDefault, 29, 5, 8, 31);
      pos += table((modes >> 2) & 3, src + pos, len - pos, fs.ml, fs.have_ml,
                   kMLDefault, 53, 6, 9, 52);
      if (pos > len) fail("zstd: truncated sequence tables");
      BackwardBits in(src + pos, int64_t(len - pos));
      FseState ll, of, ml;
      ll.init(fs.ll, in);
      of.init(fs.of, in);
      ml.init(fs.ml, in);
      for (size_t i = 0; i < nseq; ++i) {
        uint8_t llc = ll.peek(), ofc = of.peek(), mlc = ml.peek();
        if (llc > 35 || mlc > 52 || ofc > 31) fail("zstd: sequence code out of range");
        uint64_t ofv = (uint64_t(1) << ofc) + in.read(ofc);
        uint64_t mlen = kMLBase[mlc] + in.read(kMLBits[mlc]);
        uint64_t llen = kLLBase[llc] + in.read(kLLBits[llc]);
        if (i + 1 < nseq) {
          ll.update(in);
          ml.update(in);
          of.update(in);
        }
        uint64_t offset;
        if (ofv > 3) {
          offset = ofv - 3;
          fs.rep[2] = fs.rep[1];
          fs.rep[1] = fs.rep[0];
          fs.rep[0] = offset;
        } else {
          uint64_t idx = ofv - 1 + (llen == 0 ? 1 : 0);
          if (idx == 0) {
            offset = fs.rep[0];
          } else {
            offset = idx < 3 ? fs.rep[idx] : fs.rep[0] - 1;
            if (idx > 1) fs.rep[2] = fs.rep[1];
            fs.rep[1] = fs.rep[0];
            fs.rep[0] = offset;
          }
        }
        if (llen > lit.size() - lit_pos) fail("zstd: sequence past its literals");
        out.insert(out.end(), lit.begin() + lit_pos, lit.begin() + lit_pos + llen);
        lit_pos += llen;
        size_t have = out.size() - frame_start;
        if (offset == 0 || offset > have) fail("zstd: match offset before the frame");
        size_t from = out.size() - offset;
        if (offset >= mlen) {
          out.resize(out.size() + mlen);
          std::memcpy(out.data() + out.size() - mlen, out.data() + from, mlen);
        } else {
          size_t at = out.size();
          out.resize(at + mlen);
          uint8_t* d = out.data();
          for (size_t k = 0; k < mlen; ++k) d[at + k] = d[from + k];
        }
      }
      if (in.pos != 0) fail("zstd: sequence stream not consumed exactly");
    }
    out.insert(out.end(), lit.begin() + lit_pos, lit.end());
  }

  void compressed_block(const uint8_t* src, size_t len) {
    size_t used = literals(src, len);
    size_t before = out.size();
    sequences(src + used, len - used);
    if (out.size() - before > kBlockMax) fail("zstd: block too long");
  }

  // One frame at src; returns the bytes it used.
  size_t frame(const uint8_t* src, size_t len) {
    if (len < 4) fail("zstd: truncated frame");
    uint32_t magic = load32(src);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable
      if (len < 8) fail("zstd: truncated skippable frame");
      uint64_t n = load32(src + 4);
      if (8 + n > len) fail("zstd: truncated skippable frame");
      return size_t(8 + n);
    }
    if (magic != 0xFD2FB528u) fail("zstd: bad magic number");
    if (len < 5) fail("zstd: truncated frame header");
    uint8_t fhd = src[4];
    int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
        did_flag = fhd & 3;
    if (fhd & 8) fail("zstd: reserved bit set in frame header");
    size_t pos = 5;
    if (!single) {
      if (pos >= len) fail("zstd: truncated frame header");
      pos++;  // window descriptor: the whole output is kept, so unused
    }
    const int did_sizes[4] = {0, 1, 2, 4};
    uint64_t dict = 0;
    for (int i = 0; i < did_sizes[did_flag]; ++i) {
      if (pos >= len) fail("zstd: truncated frame header");
      dict |= uint64_t(src[pos++]) << (8 * i);
    }
    if (dict != 0) fail("zstd: frame needs a dictionary, which is not supported");
    const int fcs_sizes[4] = {single ? 1 : 0, 2, 4, 8};
    int fcs_size = fcs_sizes[fcs_flag];
    bool has_size = fcs_size > 0;
    uint64_t content = 0;
    for (int i = 0; i < fcs_size; ++i) {
      if (pos >= len) fail("zstd: truncated frame header");
      content |= uint64_t(src[pos++]) << (8 * i);
    }
    if (fcs_size == 2) content += 256;
    frame_start = out.size();
    fs = FrameState();
    if (has_size) out.reserve(out.size() + size_t(content));
    for (;;) {
      if (pos + 3 > len) fail("zstd: truncated block header");
      uint32_t bh = src[pos] | (src[pos + 1] << 8) | (src[pos + 2] << 16);
      pos += 3;
      int last = bh & 1, type = (bh >> 1) & 3;
      size_t bsize = bh >> 3;
      if (type == 3) fail("zstd: reserved block type");
      if (type == 1) {
        if (pos + 1 > len) fail("zstd: truncated RLE block");
        if (bsize > kBlockMax) fail("zstd: block too long");
        out.insert(out.end(), bsize, src[pos]);
        pos += 1;
      } else {
        if (pos + bsize > len) fail("zstd: truncated block");
        if (bsize > kBlockMax) fail("zstd: block too long");
        if (type == 0) {
          out.insert(out.end(), src + pos, src + pos + bsize);
        } else {
          compressed_block(src + pos, bsize);
        }
        pos += bsize;
      }
      if (has_size && out.size() - frame_start > content)
        fail("zstd: output past the frame's stated content size");
      if (last) break;
    }
    if (has_size && out.size() - frame_start != content)
      fail("zstd: output shorter than the frame's stated content size");
    if (checksum) {
      if (pos + 4 > len) fail("zstd: truncated content checksum");
      uint32_t want = load32(src + pos);
      uint32_t got = uint32_t(xxh64(out.data() + frame_start,
                                    out.size() - frame_start, 0));
      if (want != got) fail("zstd: content checksum mismatch");
      pos += 4;
    }
    return pos;
  }
};

void set_error(char* err, int64_t errlen, const char* what) {
  if (err && errlen > 0) {
    std::strncpy(err, what, size_t(errlen - 1));
    err[errlen - 1] = 0;
  }
}

}  // namespace

extern "C" {

// Decodes every frame in src[0:n]. Returns a malloc'd buffer of *out_len
// bytes (free it with tt_zstd_free), or null with a message in err.
uint8_t* tt_zstd_decompress(const uint8_t* src, int64_t n, int64_t* out_len,
                            char* err, int64_t errlen) {
  try {
    std::vector<uint8_t> out;
    Decoder dec(out);
    size_t pos = 0;
    while (pos < size_t(n)) pos += dec.frame(src + pos, size_t(n) - pos);
    uint8_t* buf = static_cast<uint8_t*>(std::malloc(out.size() ? out.size() : 1));
    if (!buf) fail("zstd: out of memory");
    if (!out.empty()) std::memcpy(buf, out.data(), out.size());
    *out_len = int64_t(out.size());
    return buf;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return nullptr;
  }
}

void tt_zstd_free(uint8_t* p) { std::free(p); }

uint32_t tt_crc32c(const uint8_t* p, int64_t n, uint32_t crc) {
  return crc32c(p, size_t(n), crc);
}

uint64_t tt_xxh64(const uint8_t* p, int64_t n, uint64_t seed) {
  return xxh64(p, size_t(n), seed);
}

}  // extern "C"
