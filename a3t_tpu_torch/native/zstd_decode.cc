// A Zstandard frame decoder (RFC 8878), written for reading the zarr chunks
// and the OCDBT nodes of orbax checkpoints without a zstd library.
//
// It takes every frame a conforming encoder writes without a dictionary:
// all frame header flags, raw / RLE / compressed blocks, raw / RLE /
// compressed / treeless literals with one or four Huffman streams, FSE
// tables in predefined / RLE / compressed / repeat modes, the three repeat
// offsets, skippable frames, concatenated frames and the XXH64 content
// checksum.  A frame that names a dictionary is refused.
//
// Every read and write is bounds-checked: malformed input gives a negative
// error code (see a3t_zstd_error_name) and never touches memory outside the
// caller's buffers.  The library also exports CRC-32C, the checksum of the
// OCDBT node format.
//
// Built at first use by a3t_tpu_torch/compat/zstd.py (host_build):
//   c++ -O2 -std=c++17 -fPIC -Wall -shared zstd_decode.cc -o liba3t_zstd.so

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Error : int {
  kOk = 0,
  kSrcTruncated = -1,
  kBadMagic = -2,
  kReservedBit = -3,
  kDictionary = -4,
  kWindowTooLarge = -5,
  kBlockType = -6,
  kBlockTooLarge = -7,
  kDstTooSmall = -8,
  kLiterals = -9,
  kHuffman = -10,
  kFseTable = -11,
  kSequences = -12,
  kOffset = -13,
  kBitstream = -14,
  kChecksum = -15,
  kContentSize = -16,
  kNoPreviousTable = -17,
  kOutOfMemory = -18,
};

const char* error_name(int code) {
  switch (code) {
    case kSrcTruncated: return "input truncated";
    case kBadMagic: return "not a zstd frame (bad magic number)";
    case kReservedBit: return "reserved bit set";
    case kDictionary: return "frame needs a dictionary (not supported)";
    case kWindowTooLarge: return "window size too large";
    case kBlockType: return "reserved block type";
    case kBlockTooLarge: return "block larger than the block maximum";
    case kDstTooSmall: return "output larger than the given size";
    case kLiterals: return "corrupt literals section";
    case kHuffman: return "corrupt Huffman table or stream";
    case kFseTable: return "corrupt FSE table description";
    case kSequences: return "corrupt sequences section";
    case kOffset: return "match offset outside the decoded data";
    case kBitstream: return "corrupt bitstream";
    case kChecksum: return "content checksum mismatch";
    case kContentSize: return "decoded size differs from the frame's content size";
    case kNoPreviousTable: return "repeat or treeless mode without a previous table";
    case kOutOfMemory: return "out of memory";
    default: return "unknown error";
  }
}

struct Fail {
  int code;
};

[[noreturn]] void fail(int code) { throw Fail{code}; }

inline uint32_t load_le32(const uint8_t* p) {
  return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) |
         (uint32_t(p[3]) << 24);
}

inline uint64_t load_le64(const uint8_t* p) {
  return uint64_t(load_le32(p)) | (uint64_t(load_le32(p + 4)) << 32);
}

inline int highbit32(uint32_t v) {  // v > 0
  return 31 - __builtin_clz(v);
}

// ---------------------------------------------------------------- XXH64

constexpr uint64_t P1 = 11400714785074694791ULL;
constexpr uint64_t P2 = 14029467366897019727ULL;
constexpr uint64_t P3 = 1609587929392839161ULL;
constexpr uint64_t P4 = 9650029242287828579ULL;
constexpr uint64_t P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t xxh_round(uint64_t acc, uint64_t input) {
  acc += input * P2;
  acc = rotl(acc, 31);
  return acc * P1;
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
      v1 = xxh_round(v1, load_le64(p));
      v2 = xxh_round(v2, load_le64(p + 8));
      v3 = xxh_round(v3, load_le64(p + 16));
      v4 = xxh_round(v4, load_le64(p + 24));
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
  h += uint64_t(len);
  while (p + 8 <= end) {
    h ^= xxh_round(0, load_le64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= uint64_t(load_le32(p)) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= uint64_t(*p) * P5;
    h = rotl(h, 11) * P1;
    ++p;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------- CRC-32C

struct Crc32cTable {
  uint32_t t[8][256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

const Crc32cTable& crc_table() {
  static const Crc32cTable table;
  return table;
}

uint32_t crc32c(const uint8_t* p, size_t len) {
  const auto& t = crc_table().t;
  uint32_t c = 0xFFFFFFFFu;
  while (len >= 8) {
    uint32_t lo = load_le32(p) ^ c, hi = load_le32(p + 4);
    c = t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF] ^
        t[4][lo >> 24] ^ t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^
        t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
    p += 8;
    len -= 8;
  }
  while (len--) c = (c >> 8) ^ t[0][(c ^ *p++) & 0xFF];
  return c ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------- bit readers

// The forward bitstream of FSE table descriptions: little-endian, bits taken
// from the least significant end of each byte first.
struct ForwardBits {
  const uint8_t* p;
  size_t len;
  size_t bit = 0;  // bits consumed
  uint32_t peek(int n) const {  // n <= 25; bits past the end read as 0
    size_t byte = bit >> 3;
    uint64_t v = 0;
    for (int i = 0; i < 5 && byte + i < len; ++i) v |= uint64_t(p[byte + i]) << (8 * i);
    return uint32_t((v >> (bit & 7)) & ((1ull << n) - 1));
  }
  void skip(int n) { bit += n; }
  size_t bytes_used() const { return (bit + 7) >> 3; }
};

// The backward bitstream of Huffman streams and sequences: read from the end
// of the buffer towards its start, the highest bits first, after the 1-bit
// end marker of the last byte.
struct BackwardBits {
  const uint8_t* p = nullptr;
  size_t len = 0;
  int64_t pos = 0;  // bits not yet read: bits [0, pos) of the buffer

  void init(const uint8_t* src, size_t n) {
    if (n == 0) fail(kBitstream);
    p = src;
    len = n;
    uint8_t last = src[n - 1];
    if (last == 0) fail(kBitstream);
    pos = int64_t(n - 1) * 8 + highbit32(last);
  }
  // The n bits (n <= 32) below position pos, bits below the buffer's start
  // reading as 0.
  uint32_t peek(int n) const {
    if (n == 0) return 0;
    int64_t lo = pos - n;
    if (lo >= 0) {
      size_t byte = size_t(lo >> 3);
      uint64_t v;
      if (byte + 8 <= len) {
        v = load_le64(p + byte);
      } else {
        v = 0;
        for (size_t i = 0; byte + i < len && i < 8; ++i) v |= uint64_t(p[byte + i]) << (8 * i);
      }
      return uint32_t((v >> (lo & 7)) & ((1ull << n) - 1));
    }
    if (pos <= 0) return 0;
    uint64_t v = 0;
    for (size_t i = 0; i < 8 && i < len; ++i) v |= uint64_t(p[i]) << (8 * i);
    v &= (pos >= 64) ? ~0ull : ((1ull << pos) - 1);
    return uint32_t(v << (-lo));
  }
  uint32_t read(int n) {
    uint32_t v = peek(n);
    pos -= n;
    return v;
  }
  uint64_t read_long(int n) {  // n <= 64
    if (n <= 32) return read(n);
    uint64_t hi = read(n - 32);
    return (hi << 32) | read(32);
  }
  bool overrun() const { return pos < 0; }
  bool done() const { return pos == 0; }
};

// ---------------------------------------------------------------- FSE

struct FseEntry {
  uint16_t symbol;
  uint8_t nbits;
  uint16_t base;  // next state = base + read(nbits)
};

struct FseTable {
  int accuracy = 0;
  std::vector<FseEntry> entries;
};

constexpr int kMaxSymbols = 256;

// Builds the decoding table from normalized counts (-1 = "less than one").
void build_fse(FseTable& t, const int16_t* norm, int nsym, int accuracy) {
  const int size = 1 << accuracy;
  t.accuracy = accuracy;
  t.entries.assign(size, FseEntry{0, 0, 0});
  std::vector<uint16_t> next(nsym);
  int high = size - 1;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      t.entries[high--].symbol = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint16_t(norm[s] > 0 ? norm[s] : 0);
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3;
  const int mask = size - 1;
  int position = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t.entries[position].symbol = uint16_t(s);
      do {
        position = (position + step) & mask;
      } while (position > high);
    }
  }
  if (position != 0) fail(kFseTable);
  for (int u = 0; u < size; ++u) {
    FseEntry& e = t.entries[u];
    uint32_t state = next[e.symbol]++;
    if (state == 0) fail(kFseTable);
    int nbits = accuracy - highbit32(state);
    e.nbits = uint8_t(nbits);
    e.base = uint16_t((state << nbits) - size);
  }
}

void build_fse_rle(FseTable& t, int symbol) {
  t.accuracy = 0;
  t.entries.assign(1, FseEntry{uint16_t(symbol), 0, 0});
}

// Reads an FSE table description (RFC 8878 4.1.1); returns the bytes used.
size_t read_fse_description(FseTable& t, const uint8_t* src, size_t len,
                            int max_accuracy, int max_symbol) {
  if (len == 0) fail(kFseTable);
  ForwardBits bits{src, len};
  int accuracy = int(bits.peek(4)) + 5;
  bits.skip(4);
  if (accuracy > max_accuracy) fail(kFseTable);
  int16_t norm[kMaxSymbols] = {};
  int remaining = (1 << accuracy) + 1;
  int threshold = 1 << accuracy;
  int nbits = accuracy + 1;
  int symbol = 0;
  while (remaining > 1) {
    if (symbol > max_symbol) fail(kFseTable);
    if (bits.bit > len * 8) fail(kFseTable);
    int max = (2 * threshold - 1) - remaining;
    int value;
    uint32_t raw = bits.peek(nbits);
    if (int(raw & (threshold - 1)) < max) {
      value = int(raw & (threshold - 1));
      bits.skip(nbits - 1);
    } else {
      value = int(raw & (2 * threshold - 1));
      if (value >= threshold) value -= max;
      bits.skip(nbits);
    }
    int count = value - 1;
    remaining -= count < 0 ? -count : count;
    norm[symbol++] = int16_t(count);
    if (count == 0) {
      for (;;) {
        if (bits.bit > len * 8) fail(kFseTable);
        int repeat = int(bits.peek(2));
        bits.skip(2);
        for (int i = 0; i < repeat; ++i) {
          if (symbol > max_symbol) fail(kFseTable);
          norm[symbol++] = 0;
        }
        if (repeat != 3) break;
      }
    }
    while (remaining < threshold) {
      --nbits;
      threshold >>= 1;
    }
  }
  if (remaining != 1 || bits.bit > len * 8) fail(kFseTable);
  build_fse(t, norm, symbol, accuracy);
  return bits.bytes_used();
}

struct FseState {
  const FseTable* t;
  uint32_t state;
  void init(BackwardBits& b, const FseTable& table) {
    t = &table;
    state = b.read(table.accuracy);
  }
  int symbol() const { return t->entries[state].symbol; }
  void update(BackwardBits& b) {
    const FseEntry& e = t->entries[state];
    state = e.base + b.read(e.nbits);
  }
};

// ---------------------------------------------------------------- Huffman

constexpr int kHufMaxBits = 11;

struct HufTable {
  int max_bits = 0;
  std::vector<uint8_t> symbol;  // indexed by the next max_bits bits
  std::vector<uint8_t> nbits;
};

// Weights (num = explicit count) -> decoding table; the last weight is
// implied by the others.
void build_huffman(HufTable& h, uint8_t* weights, int num) {
  if (num < 1 || num > 255) fail(kHuffman);
  uint32_t total = 0;
  for (int i = 0; i < num; ++i) {
    if (weights[i] > kHufMaxBits) fail(kHuffman);
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  if (total == 0) fail(kHuffman);
  int max_bits = highbit32(total) + 1;
  if (max_bits > kHufMaxBits) fail(kHuffman);
  uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) fail(kHuffman);  // must be a power of two
  weights[num] = uint8_t(highbit32(rest) + 1);
  const int nsym = num + 1;
  h.max_bits = max_bits;
  h.symbol.assign(size_t(1) << max_bits, 0);
  h.nbits.assign(size_t(1) << max_bits, 0);
  // slots are handed out by weight, lowest first, then by symbol
  uint32_t pos = 0;
  for (int w = 1; w <= max_bits; ++w) {
    for (int s = 0; s < nsym; ++s) {
      if (weights[s] != w) continue;
      uint32_t n = 1u << (w - 1);
      if (pos + n > (1u << max_bits)) fail(kHuffman);
      for (uint32_t i = 0; i < n; ++i) {
        h.symbol[pos + i] = uint8_t(s);
        h.nbits[pos + i] = uint8_t(max_bits + 1 - w);
      }
      pos += n;
    }
  }
  if (pos != (1u << max_bits)) fail(kHuffman);
}

// Reads a Huffman tree description; returns the bytes used.
size_t read_huffman_description(HufTable& h, const uint8_t* src, size_t len) {
  if (len < 1) fail(kHuffman);
  uint8_t weights[256] = {};
  int header = src[0];
  int num;
  size_t used;
  if (header >= 128) {  // direct: 4 bits per weight
    num = header - 127;
    size_t bytes = size_t(num + 1) / 2;
    if (1 + bytes > len) fail(kHuffman);
    for (int i = 0; i < num; ++i) {
      uint8_t b = src[1 + i / 2];
      weights[i] = (i % 2 == 0) ? (b >> 4) : (b & 15);
    }
    used = 1 + bytes;
  } else {  // FSE-compressed weights, two interleaved states
    size_t csize = size_t(header);
    if (csize == 0 || 1 + csize > len) fail(kHuffman);
    const uint8_t* p = src + 1;
    FseTable table;
    size_t desc = read_fse_description(table, p, csize, 6, 255);
    if (desc >= csize) fail(kHuffman);
    BackwardBits b;
    b.init(p + desc, csize - desc);
    FseState s1, s2;
    s1.init(b, table);
    s2.init(b, table);
    num = 0;
    for (;;) {
      if (num > 254) fail(kHuffman);
      weights[num++] = uint8_t(s1.symbol());
      s1.update(b);
      if (b.overrun()) {
        if (num > 254) fail(kHuffman);
        weights[num++] = uint8_t(s2.symbol());
        break;
      }
      if (num > 254) fail(kHuffman);
      weights[num++] = uint8_t(s2.symbol());
      s2.update(b);
      if (b.overrun()) {
        if (num > 254) fail(kHuffman);
        weights[num++] = uint8_t(s1.symbol());
        break;
      }
    }
    used = 1 + csize;
  }
  build_huffman(h, weights, num);
  return used;
}

struct HufStream {
  BackwardBits b;
  uint8_t* out;
  size_t n;     // symbols to decode
  size_t done;  // symbols decoded
};

// Decodes 1 or 4 streams.  While every stream has 56 bits left and 5
// symbols to go, each takes one 8-byte load for 5 symbols (5 x 11 bits fit
// in 56), the streams interleaved; the tails go symbol by symbol.
void decode_huffman_streams(const HufTable& h, HufStream* s, int count) {
  const int mb = h.max_bits;
  const uint32_t mask = (1u << mb) - 1;
  const uint8_t* sym = h.symbol.data();
  const uint8_t* nb = h.nbits.data();
  for (;;) {
    bool fast = true;
    for (int k = 0; k < count; ++k)
      fast &= s[k].b.pos >= 56 && s[k].n - s[k].done >= 5;
    if (!fast) break;
    for (int k = 0; k < count; ++k) {
      HufStream& st = s[k];
      int64_t lo = st.b.pos - 56;  // the 8 bytes at lo >> 3 lie in the buffer
      uint64_t c = load_le64(st.b.p + (lo >> 3)) >> (lo & 7);
      int avail = 56;
      uint8_t* o = st.out + st.done;
      for (int i = 0; i < 5; ++i) {
        uint32_t idx = uint32_t(c >> (avail - mb)) & mask;
        o[i] = sym[idx];
        avail -= nb[idx];
      }
      st.b.pos -= 56 - avail;
      st.done += 5;
    }
  }
  for (int k = 0; k < count; ++k) {
    HufStream& st = s[k];
    for (size_t i = st.done; i < st.n; ++i) {
      uint32_t idx = st.b.peek(mb);
      st.out[i] = sym[idx];
      st.b.pos -= nb[idx];
      if (st.b.pos < 0) fail(kHuffman);
    }
    if (!st.b.done()) fail(kHuffman);
  }
}

// ---------------------------------------------------------------- sequences

constexpr uint32_t kLLBase[36] = {
    0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
    12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
constexpr uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                                 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10,  11,  12,   13,   14,   15,   16,
    17, 18, 19, 20, 21, 22, 23, 24,  25,  26,   27,   28,   29,   30,
    31, 32, 33, 34, 35, 37, 39, 41,  43,  47,   51,   59,   67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
constexpr uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                                 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

constexpr int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                    2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                    2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
constexpr int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
constexpr int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

constexpr int kMaxLL = 35, kMaxML = 52, kMaxOF = 31;

// ---------------------------------------------------------------- frames

struct Frame {
  // the decoder's state across the blocks of one frame
  HufTable huf;
  bool have_huf = false;
  FseTable ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint64_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> literals;
};

struct Output {
  uint8_t* dst;
  size_t cap;
  size_t pos;        // bytes written in all frames
  size_t frame0;     // where this frame's output starts
  void put(const uint8_t* src, size_t n) {
    if (n > cap - pos) fail(kDstTooSmall);
    std::memcpy(dst + pos, src, n);
    pos += n;
  }
  void fill(uint8_t byte, size_t n) {
    if (n > cap - pos) fail(kDstTooSmall);
    std::memset(dst + pos, byte, n);
    pos += n;
  }
  void match(uint64_t offset, size_t n) {
    if (offset == 0 || offset > pos - frame0) fail(kOffset);
    if (n > cap - pos) fail(kDstTooSmall);
    uint8_t* d = dst + pos;
    const uint8_t* s = d - offset;
    if (offset >= n) {
      std::memcpy(d, s, n);
    } else {
      for (size_t i = 0; i < n; ++i) d[i] = s[i];  // overlapping copy
    }
    pos += n;
  }
};

// Literals section; returns the bytes used and leaves the literals in f.
size_t decode_literals(Frame& f, const uint8_t* src, size_t len) {
  if (len < 1) fail(kLiterals);
  int type = src[0] & 3;
  int size_format = (src[0] >> 2) & 3;
  if (type == 0 || type == 1) {  // raw or RLE
    size_t header, regen;
    if (size_format == 0 || size_format == 2) {
      header = 1;
      regen = src[0] >> 3;
    } else if (size_format == 1) {
      if (len < 2) fail(kLiterals);
      header = 2;
      regen = (src[0] >> 4) + (size_t(src[1]) << 4);
    } else {
      if (len < 3) fail(kLiterals);
      header = 3;
      regen = (src[0] >> 4) + (size_t(src[1]) << 4) + (size_t(src[2]) << 12);
    }
    if (regen > (128u << 10)) fail(kLiterals);
    if (type == 0) {
      if (header + regen > len) fail(kLiterals);
      f.literals.assign(src + header, src + header + regen);
      return header + regen;
    }
    if (header + 1 > len) fail(kLiterals);
    f.literals.assign(regen, src[header]);
    return header + 1;
  }
  // compressed (2) or treeless (3)
  size_t header, regen, csize;
  int streams = size_format == 0 ? 1 : 4;
  if (size_format <= 1) {
    if (len < 3) fail(kLiterals);
    uint32_t v = src[0] | (uint32_t(src[1]) << 8) | (uint32_t(src[2]) << 16);
    header = 3;
    regen = (v >> 4) & 0x3FF;
    csize = (v >> 14) & 0x3FF;
  } else if (size_format == 2) {
    if (len < 4) fail(kLiterals);
    uint32_t v = load_le32(src);
    header = 4;
    regen = (v >> 4) & 0x3FFF;
    csize = v >> 18;
  } else {
    if (len < 5) fail(kLiterals);
    uint64_t v = load_le32(src) | (uint64_t(src[4]) << 32);
    header = 5;
    regen = (v >> 4) & 0x3FFFF;
    csize = size_t(v >> 22);
  }
  if (regen > (128u << 10)) fail(kLiterals);
  if (header + csize > len) fail(kLiterals);
  const uint8_t* p = src + header;
  size_t rest = csize;
  if (type == 2) {
    size_t used = read_huffman_description(f.huf, p, rest);
    f.have_huf = true;
    p += used;
    rest -= used;
  } else if (!f.have_huf) {
    fail(kNoPreviousTable);
  }
  f.literals.resize(regen);
  HufStream hs[4];
  if (streams == 1) {
    hs[0].b.init(p, rest);
    hs[0].out = f.literals.data();
    hs[0].n = regen;
    hs[0].done = 0;
    decode_huffman_streams(f.huf, hs, 1);
  } else {
    if (rest < 6) fail(kLiterals);
    size_t s1 = p[0] | (size_t(p[1]) << 8);
    size_t s2 = p[2] | (size_t(p[3]) << 8);
    size_t s3 = p[4] | (size_t(p[5]) << 8);
    if (6 + s1 + s2 + s3 > rest) fail(kLiterals);
    size_t s4 = rest - 6 - s1 - s2 - s3;
    size_t seg = (regen + 3) / 4;
    if (3 * seg > regen) fail(kLiterals);
    const uint8_t* q = p + 6;
    const size_t sizes[4] = {s1, s2, s3, s4};
    for (int k = 0; k < 4; ++k) {
      hs[k].b.init(q, sizes[k]);
      hs[k].out = f.literals.data() + k * seg;
      hs[k].n = k < 3 ? seg : regen - 3 * seg;
      hs[k].done = 0;
      q += sizes[k];
    }
    decode_huffman_streams(f.huf, hs, 4);
  }
  return header + csize;
}

// One table of the sequences section; returns the bytes used.
size_t read_sequence_table(FseTable& t, bool& have, int mode, const uint8_t* src,
                           size_t len, const int16_t* defaults, int ndefaults,
                           int default_accuracy, int max_accuracy, int max_symbol) {
  switch (mode) {
    case 0:
      build_fse(t, defaults, ndefaults, default_accuracy);
      have = true;
      return 0;
    case 1:
      if (len < 1) fail(kSequences);
      if (src[0] > max_symbol) fail(kSequences);
      build_fse_rle(t, src[0]);
      have = true;
      return 1;
    case 2: {
      size_t used = read_fse_description(t, src, len, max_accuracy, max_symbol);
      if (used > len) fail(kSequences);
      have = true;
      return used;
    }
    default:
      if (!have) fail(kNoPreviousTable);
      return 0;
  }
}

void decode_block(Frame& f, const uint8_t* src, size_t len, Output& out,
                  size_t block_max) {
  size_t block_start = out.pos;
  size_t used = decode_literals(f, src, len);
  const uint8_t* p = src + used;
  size_t rest = len - used;
  if (rest < 1) fail(kSequences);
  size_t nseq;
  if (p[0] == 0) {
    nseq = 0;
    p += 1;
    rest -= 1;
  } else if (p[0] < 128) {
    nseq = p[0];
    p += 1;
    rest -= 1;
  } else if (p[0] < 255) {
    if (rest < 2) fail(kSequences);
    nseq = (size_t(p[0] - 128) << 8) + p[1];
    p += 2;
    rest -= 2;
  } else {
    if (rest < 3) fail(kSequences);
    nseq = p[1] + (size_t(p[2]) << 8) + 0x7F00;
    p += 3;
    rest -= 3;
  }
  const uint8_t* lit = f.literals.data();
  size_t nlit = f.literals.size();
  size_t lit_pos = 0;
  if (nseq > 0) {
    if (rest < 1) fail(kSequences);
    uint8_t modes = p[0];
    if (modes & 3) fail(kReservedBit);
    p += 1;
    rest -= 1;
    size_t u;
    u = read_sequence_table(f.ll, f.have_ll, modes >> 6, p, rest, kLLDefault, 36, 6, 9, kMaxLL);
    p += u;
    rest -= u;
    u = read_sequence_table(f.of, f.have_of, (modes >> 4) & 3, p, rest, kOFDefault, 29, 5, 8, kMaxOF);
    p += u;
    rest -= u;
    u = read_sequence_table(f.ml, f.have_ml, (modes >> 2) & 3, p, rest, kMLDefault, 53, 6, 9, kMaxML);
    p += u;
    rest -= u;
    BackwardBits b;
    b.init(p, rest);
    FseState ll, of, ml;
    ll.init(b, f.ll);
    of.init(b, f.of);
    ml.init(b, f.ml);
    for (size_t i = 0; i < nseq; ++i) {
      int of_code = of.symbol();
      int ll_code = ll.symbol();
      int ml_code = ml.symbol();
      if (of_code > kMaxOF || ll_code > kMaxLL || ml_code > kMaxML) fail(kSequences);
      uint64_t of_value = (uint64_t(1) << of_code) + b.read_long(of_code);
      uint32_t ml_value = kMLBase[ml_code] + b.read(kMLBits[ml_code]);
      uint32_t ll_value = kLLBase[ll_code] + b.read(kLLBits[ll_code]);
      uint64_t offset;
      if (of_value > 3) {
        offset = of_value - 3;
        f.rep[2] = f.rep[1];
        f.rep[1] = f.rep[0];
        f.rep[0] = offset;
      } else {
        int idx = int(of_value) - 1 + (ll_value == 0 ? 1 : 0);
        if (idx == 0) {
          offset = f.rep[0];
        } else {
          offset = idx == 3 ? f.rep[0] - 1 : f.rep[idx];
          if (offset == 0) fail(kOffset);
          if (idx > 1) f.rep[2] = f.rep[1];
          f.rep[1] = f.rep[0];
          f.rep[0] = offset;
        }
      }
      if (b.overrun()) fail(kSequences);
      if (i + 1 < nseq) {
        ll.update(b);
        ml.update(b);
        of.update(b);
        if (b.overrun()) fail(kSequences);
      }
      if (ll_value > nlit - lit_pos) fail(kSequences);
      out.put(lit + lit_pos, ll_value);
      lit_pos += ll_value;
      out.match(offset, ml_value);
      if (out.pos - block_start > block_max) fail(kBlockTooLarge);
    }
    if (!b.done()) fail(kSequences);
  } else if (rest != 0) {
    fail(kSequences);
  }
  out.put(lit + lit_pos, nlit - lit_pos);
  if (out.pos - block_start > block_max) fail(kBlockTooLarge);
}

// Decodes one frame (or skips one skippable frame) starting at src;
// returns the bytes of src it took.
size_t decode_frame(const uint8_t* src, size_t len, Output& out) {
  if (len < 4) fail(kSrcTruncated);
  uint32_t magic = load_le32(src);
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable frame
    if (len < 8) fail(kSrcTruncated);
    uint64_t size = load_le32(src + 4);
    if (size > len - 8) fail(kSrcTruncated);
    return size_t(8 + size);
  }
  if (magic != 0xFD2FB528u) fail(kBadMagic);
  size_t i = 4;
  if (i >= len) fail(kSrcTruncated);
  uint8_t fhd = src[i++];
  int fcs_flag = fhd >> 6;
  bool single_segment = (fhd >> 5) & 1;
  bool checksum = (fhd >> 2) & 1;
  int did_flag = fhd & 3;
  if (fhd & 8) fail(kReservedBit);
  uint64_t window = 0;
  if (!single_segment) {
    if (i >= len) fail(kSrcTruncated);
    uint8_t wd = src[i++];
    int exponent = wd >> 3, mantissa = wd & 7;
    if (exponent > 31) fail(kWindowTooLarge);  // windows beyond 3.75 TiB
    uint64_t base = uint64_t(1) << (10 + exponent);
    window = base + (base / 8) * mantissa;
  }
  static const int kDidBytes[4] = {0, 1, 2, 4};
  int did_bytes = kDidBytes[did_flag];
  if (i + did_bytes > len) fail(kSrcTruncated);
  uint32_t did = 0;
  for (int k = 0; k < did_bytes; ++k) did |= uint32_t(src[i + k]) << (8 * k);
  i += did_bytes;
  if (did != 0) fail(kDictionary);
  int fcs_bytes = fcs_flag == 0 ? (single_segment ? 1 : 0) : (1 << fcs_flag);
  if (i + fcs_bytes > len) fail(kSrcTruncated);
  bool have_fcs = fcs_bytes > 0;
  uint64_t fcs = 0;
  for (int k = 0; k < fcs_bytes; ++k) fcs |= uint64_t(src[i + k]) << (8 * k);
  if (fcs_bytes == 2) fcs += 256;
  i += fcs_bytes;
  if (single_segment) window = fcs;
  const size_t block_max = size_t(window < (128u << 10) ? window : (128u << 10));

  Frame f;
  out.frame0 = out.pos;
  for (;;) {
    if (i + 3 > len) fail(kSrcTruncated);
    uint32_t bh = src[i] | (uint32_t(src[i + 1]) << 8) | (uint32_t(src[i + 2]) << 16);
    i += 3;
    bool last = bh & 1;
    int type = (bh >> 1) & 3;
    size_t size = bh >> 3;
    switch (type) {
      case 0:  // raw
        if (size > block_max) fail(kBlockTooLarge);
        if (i + size > len) fail(kSrcTruncated);
        out.put(src + i, size);
        i += size;
        break;
      case 1:  // RLE: one byte, repeated size times
        if (size > block_max) fail(kBlockTooLarge);
        if (i + 1 > len) fail(kSrcTruncated);
        out.fill(src[i], size);
        i += 1;
        break;
      case 2:  // compressed
        if (size > block_max) fail(kBlockTooLarge);
        if (i + size > len) fail(kSrcTruncated);
        decode_block(f, src + i, size, out, block_max);
        i += size;
        break;
      default:
        fail(kBlockType);
    }
    if (last) break;
  }
  size_t produced = out.pos - out.frame0;
  if (have_fcs && produced != fcs) fail(kContentSize);
  if (checksum) {
    if (i + 4 > len) fail(kSrcTruncated);
    uint32_t want = load_le32(src + i);
    uint32_t got = uint32_t(xxh64(out.dst + out.frame0, produced, 0));
    if (want != got) fail(kChecksum);
    i += 4;
  }
  return i;
}

}  // namespace

extern "C" {

// Decodes the frames in src[0, src_len) into dst[0, dst_cap); returns the
// bytes written, or a negative error code.
long long a3t_zstd_decompress(const uint8_t* src, size_t src_len, uint8_t* dst,
                              size_t dst_cap) {
  Output out{dst, dst_cap, 0, 0};
  try {
    if (src_len == 0) fail(kSrcTruncated);
    size_t i = 0;
    while (i < src_len) i += decode_frame(src + i, src_len - i, out);
  } catch (const Fail& e) {
    return e.code;
  } catch (...) {  // std::bad_alloc
    return kOutOfMemory;
  }
  return (long long)out.pos;
}

// The first frame's content size, -1 when its header does not state it, or
// a negative error code below -1.
long long a3t_zstd_content_size(const uint8_t* src, size_t len) {
  if (len < 5) return kSrcTruncated;
  if (load_le32(src) != 0xFD2FB528u) return kBadMagic;
  uint8_t fhd = src[4];
  int fcs_flag = fhd >> 6;
  bool single_segment = (fhd >> 5) & 1;
  static const int kDidBytes[4] = {0, 1, 2, 4};
  size_t i = 5 + (single_segment ? 0 : 1) + kDidBytes[fhd & 3];
  int fcs_bytes = fcs_flag == 0 ? (single_segment ? 1 : 0) : (1 << fcs_flag);
  if (fcs_bytes == 0) return -1;
  if (i + fcs_bytes > len) return kSrcTruncated;
  uint64_t fcs = 0;
  for (int k = 0; k < fcs_bytes; ++k) fcs |= uint64_t(src[i + k]) << (8 * k);
  if (fcs_bytes == 2) fcs += 256;
  return (long long)fcs;
}

const char* a3t_zstd_error_name(int code) { return error_name(code); }

unsigned long long a3t_xxh64(const uint8_t* src, size_t len, unsigned long long seed) {
  return xxh64(src, len, seed);
}

unsigned int a3t_crc32c(const uint8_t* src, size_t len) { return crc32c(src, len); }

}  // extern "C"
