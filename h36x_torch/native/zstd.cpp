// zstd frame decoder (RFC 8878) for the port's native host library.
//
// Orbax writes every OCDBT node, manifest and zarr chunk of a checkpoint as
// zstd frames; this decoder reads them without the zstd library. It covers
// what the RFC defines for frames without a dictionary:
//   - frames one after another, skippable frames skipped;
//   - raw, RLE and compressed blocks;
//   - literals raw, RLE, Huffman-compressed (1 or 4 streams, the tree given
//     directly or FSE-compressed) and treeless (the previous block's tree);
//   - sequences with predefined, RLE, FSE-compressed and repeated tables,
//     the three repeat offsets, matches that overlap their own output;
//   - the XXH64 content checksum, checked when the frame carries one.
// A frame that names a dictionary is refused. Every read is checked against
// the end of its buffer: corrupt input returns an error, never reads out of
// bounds. Output grows in a std::vector, bounded by the frame's declared
// content size where it has one.
//
// C interface (ctypes, h36x_torch/utils/zstd.py):
//   int  h36x_zstd_decompress(const uint8_t* src, size_t n, uint8_t** out,
//                             size_t* out_n, char* err, int err_len);
//   void h36x_zstd_free(uint8_t* p);
// 0 on success (*out malloc'ed, freed by h36x_zstd_free), else 1 with a
// message in err.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Corrupt : std::runtime_error {
  explicit Corrupt(const std::string& m) : std::runtime_error(m) {}
};

[[noreturn]] void fail(const std::string& m) { throw Corrupt(m); }

inline int highbit32(uint32_t v) { return 31 - __builtin_clz(v); }

inline uint64_t load_le(const uint8_t* p, size_t n) {
  uint64_t v = 0;
  for (size_t i = 0; i < n; ++i) v |= uint64_t(p[i]) << (8 * i);
  return v;
}

// bits [lo, lo + n) of a little-endian byte string of `size` bytes, n <= 56;
// bytes past the end read as zero (the callers check their positions)
inline uint64_t bits_at(const uint8_t* s, size_t size, uint64_t lo, int n) {
  if (n == 0) return 0;
  uint64_t byte = lo >> 3;
  int shift = int(lo & 7);
  uint64_t w;
  if (byte + 8 <= size) {
    std::memcpy(&w, s + byte, 8);
  } else {
    w = byte < size ? load_le(s + byte, size - byte) : 0;
  }
  return (w >> shift) & ((uint64_t(1) << n) - 1);
}

// ---- XXH64 ---------------------------------------------------------------

const uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
               P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
               P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) {
  acc += in * P2;
  return rotl(acc, 31) * P1;
}
inline uint64_t xmerge(uint64_t acc, uint64_t v) {
  acc ^= xround(0, v);
  return acc * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t len) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xround(v1, load_le(p, 8));
      v2 = xround(v2, load_le(p + 8, 8));
      v3 = xround(v3, load_le(p + 16, 8));
      v4 = xround(v4, load_le(p + 24, 8));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(h, v1);
    h = xmerge(h, v2);
    h = xmerge(h, v3);
    h = xmerge(h, v4);
  } else {
    h = P5;
  }
  h += uint64_t(len);
  while (p + 8 <= end) {
    h ^= xround(0, load_le(p, 8));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= load_le(p, 4) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p) * P5;
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

// ---- bit readers ---------------------------------------------------------

// A backward bitstream (RFC 8878 4.1): read from the end, the last byte's
// highest set bit marks where the data stops. Reading past the start gives
// zeros and leaves `pos` negative: `overflowed()` reports it.
struct BackBits {
  const uint8_t* s;
  size_t size;
  int64_t pos;  // bits left to read
  BackBits(const uint8_t* src, size_t n) : s(src), size(n) {
    if (n == 0) fail("empty bitstream");
    uint8_t last = src[n - 1];
    if (last == 0) fail("bitstream's last byte is 0 (no end mark)");
    pos = int64_t(n - 1) * 8 + highbit32(last);
  }
  uint64_t read(int n) {
    if (n == 0) return 0;
    int64_t lo = pos - n;
    uint64_t v;
    if (lo >= 0) {
      v = bits_at(s, size, uint64_t(lo), n);
    } else {
      int have = pos > 0 ? int(pos) : 0;
      v = have ? bits_at(s, size, 0, have) << (n - have) : 0;
    }
    pos = lo;
    return v;
  }
  uint64_t peek(int n) const {
    int64_t lo = pos - n;
    if (lo >= 0) return bits_at(s, size, uint64_t(lo), n);
    int have = pos > 0 ? int(pos) : 0;
    return have ? bits_at(s, size, 0, have) << (n - have) : 0;
  }
  void skip(int n) { pos -= n; }
  bool overflowed() const { return pos < 0; }
};

// ---- FSE -----------------------------------------------------------------

struct FseEntry {
  uint16_t symbol;
  uint8_t nbits;
  uint16_t baseline;
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> t;
};

// Decoding table from normalized counts (-1: "less than 1"), RFC 8878 4.1.1.
void build_fse(FseTable& out, const int16_t* norm, int nsym, int log) {
  int size = 1 << log;
  out.log = log;
  out.t.assign(size, FseEntry{0, 0, 0});
  std::vector<uint16_t> next(nsym);
  int high = size - 1;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      out.t[high--].symbol = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint16_t(norm[s]);
    }
  }
  int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, p = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      out.t[p].symbol = uint16_t(s);
      do {
        p = (p + step) & mask;
      } while (p > high);
    }
  }
  if (p != 0) fail("FSE table: counts do not fill the table");
  for (int u = 0; u < size; ++u) {
    uint16_t s = out.t[u].symbol;
    uint32_t x = next[s]++;
    int nb = log - highbit32(x);
    out.t[u].nbits = uint8_t(nb);
    out.t[u].baseline = uint16_t((x << nb) - size);
  }
}

// Read an FSE table description at src[0..n) (RFC 8878 4.1.1); returns the
// bytes it took.
size_t read_fse(FseTable& out, const uint8_t* src, size_t n, int max_log, int max_sym) {
  if (n < 1) fail("FSE table description truncated");
  int log = (src[0] & 0xF) + 5;
  if (log > max_log) fail("FSE accuracy log " + std::to_string(log) + " above " +
                          std::to_string(max_log));
  uint64_t bit = 4;
  int remaining = (1 << log) + 1, threshold = 1 << log, nb = log + 1;
  std::vector<int16_t> norm(max_sym + 1, 0);
  int sym = 0;
  while (remaining > 1) {
    if (sym > max_sym) fail("FSE table: too many symbols");
    if (bit >= uint64_t(n) * 8) fail("FSE table description truncated");
    int maxv = (2 * threshold - 1) - remaining;
    int v = int(bits_at(src, n, bit, nb));
    int count;
    if ((v & (threshold - 1)) < maxv) {
      count = v & (threshold - 1);
      bit += nb - 1;
    } else {
      count = v & (2 * threshold - 1);
      if (count >= threshold) count -= maxv;
      bit += nb;
    }
    count -= 1;
    remaining -= count < 0 ? -count : count;
    norm[sym++] = int16_t(count);
    if (count == 0) {
      for (;;) {
        int rep = int(bits_at(src, n, bit, 2));
        bit += 2;
        if (sym + rep > max_sym + 1) fail("FSE table: zero run past the last symbol");
        sym += rep;
        if (rep != 3) break;
      }
    }
    while (remaining < threshold && threshold > 1) {
      nb -= 1;
      threshold >>= 1;
    }
  }
  if (remaining != 1) fail("FSE table: counts do not sum to the table size");
  size_t used = (bit + 7) / 8;
  if (used > n) fail("FSE table description truncated");
  build_fse(out, norm.data(), sym, log);
  return used;
}

void rle_fse(FseTable& out, uint8_t symbol) {
  out.log = 0;
  out.t.assign(1, FseEntry{symbol, 0, 0});
}

// ---- Huffman -------------------------------------------------------------

struct HufTable {
  int log = 0;  // 0: none yet
  std::vector<uint16_t> t;  // (symbol << 8) | nbits, 1 << log entries
};

// Huffman tree description (RFC 8878 4.2.1); returns the bytes it took.
size_t read_huffman(HufTable& out, const uint8_t* src, size_t n) {
  if (n < 1) fail("Huffman tree description truncated");
  uint8_t head = src[0];
  std::vector<uint8_t> w;
  size_t used;
  if (head < 128) {
    used = 1 + size_t(head);
    if (used > n || head == 0) fail("Huffman tree description truncated");
    FseTable ft;
    size_t h = read_fse(ft, src + 1, head, 6, 255);
    if (h >= head) fail("Huffman weights: no bitstream");
    BackBits br(src + 1 + h, head - h);
    uint32_t s1 = uint32_t(br.read(ft.log)), s2 = uint32_t(br.read(ft.log));
    if (br.overflowed()) fail("Huffman weights: bitstream too short");
    for (;;) {
      if (w.size() >= 255) fail("Huffman weights: too many");
      const FseEntry& e1 = ft.t[s1];
      w.push_back(uint8_t(e1.symbol));
      s1 = e1.baseline + uint32_t(br.read(e1.nbits));
      if (br.overflowed()) {
        w.push_back(uint8_t(ft.t[s2].symbol));
        break;
      }
      if (w.size() >= 255) fail("Huffman weights: too many");
      const FseEntry& e2 = ft.t[s2];
      w.push_back(uint8_t(e2.symbol));
      s2 = e2.baseline + uint32_t(br.read(e2.nbits));
      if (br.overflowed()) {
        w.push_back(uint8_t(ft.t[s1].symbol));
        break;
      }
    }
  } else {
    size_t count = size_t(head) - 127;
    used = 1 + (count + 1) / 2;
    if (used > n) fail("Huffman tree description truncated");
    for (size_t i = 0; i < count; ++i) {
      uint8_t b = src[1 + i / 2];
      w.push_back(i % 2 == 0 ? (b >> 4) : (b & 0xF));
    }
  }
  uint32_t total = 0;
  for (uint8_t x : w) {
    if (x > 11) fail("Huffman weight above 11");
    if (x) total += 1u << (x - 1);
  }
  if (total == 0) fail("Huffman weights all zero");
  int maxbits = highbit32(total) + 1;
  if (maxbits > 11) fail("Huffman code longer than 11 bits");
  uint32_t rest = (1u << maxbits) - total;
  if (rest & (rest - 1)) fail("Huffman weights do not complete a tree");
  w.push_back(uint8_t(highbit32(rest) + 1));
  if (w.size() > 256) fail("Huffman: more than 256 symbols");
  std::vector<uint32_t> start(13, 0);
  uint32_t pos = 0;
  for (int wt = 1; wt <= maxbits; ++wt) {
    start[wt] = pos;
    for (uint8_t x : w)
      if (x == wt) pos += (1u << wt) >> 1;
  }
  if (pos != (1u << maxbits)) fail("Huffman table not full");
  out.log = maxbits;
  out.t.assign(size_t(1) << maxbits, 0);
  for (size_t s = 0; s < w.size(); ++s) {
    int wt = w[s];
    if (!wt) continue;
    uint32_t len = (1u << wt) >> 1;
    uint16_t e = uint16_t((s << 8) | uint32_t(maxbits + 1 - wt));
    for (uint32_t i = 0; i < len; ++i) out.t[start[wt] + i] = e;
    start[wt] += len;
  }
  return used;
}

// Decode `count[j]` literals from each of the `streams` Huffman streams
// src[j][0..n[j]) into out[j] (RFC 8878 4.2.2): each stream is read
// backward, and must end exactly where its last literal does. The fast loop
// takes five codes (at most 55 bits) from one 56-bit window per stream while
// every window lies inside its stream (bytes [(pos - 56) / 8, + 8) end at
// or before n), the streams interleaved so that their table lookups overlap.
void huffman_streams(const HufTable& h, int streams, const uint8_t* const* src,
                     const size_t* n, uint8_t* const* out, const size_t* count) {
  std::vector<BackBits> br;
  for (int j = 0; j < streams; ++j) br.emplace_back(src[j], n[j]);
  const uint16_t* t = h.t.data();
  const uint64_t mask = (uint64_t(1) << h.log) - 1;
  size_t i[4] = {0, 0, 0, 0};
  for (;;) {
    bool fast = true;
    for (int j = 0; j < streams; ++j)
      fast = fast && i[j] + 5 <= count[j] && br[j].pos >= 56;
    if (!fast) break;
    uint64_t w[4];
    int avail[4];
    for (int j = 0; j < streams; ++j) {
      uint64_t lo = uint64_t(br[j].pos) - 56;
      std::memcpy(&w[j], src[j] + (lo >> 3), 8);
      w[j] >>= lo & 7;
      avail[j] = 56;
    }
    for (int k = 0; k < 5; ++k) {
      for (int j = 0; j < streams; ++j) {
        uint16_t e = t[(w[j] >> (avail[j] - h.log)) & mask];
        out[j][i[j]++] = uint8_t(e >> 8);
        avail[j] -= e & 0xFF;
      }
    }
    for (int j = 0; j < streams; ++j) br[j].pos -= 56 - avail[j];
  }
  for (int j = 0; j < streams; ++j) {
    for (; i[j] < count[j]; ++i[j]) {
      uint16_t e = t[br[j].peek(h.log)];
      out[j][i[j]] = uint8_t(e >> 8);
      br[j].skip(e & 0xFF);
      if (br[j].overflowed()) fail("Huffman stream shorter than its literals");
    }
    if (br[j].pos != 0) fail("Huffman stream longer than its literals");
  }
}

// ---- sequences -----------------------------------------------------------

const uint32_t LL_BASE[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {3,   4,   5,   6,   7,    8,    9,    10,   11,    12,    13,
                              14,  15,  16,  17,  18,   19,   20,   21,   22,    23,    24,
                              25,  26,  27,  28,  29,   30,   31,   32,   33,    34,    35,
                              37,  39,  41,  43,  47,   51,   59,   67,   83,    99,    131,
                              259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  1,  1,  1,  1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct FrameState {
  HufTable huf;
  FseTable ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint32_t rep[3] = {1, 4, 8};
};

// One table of the sequences section by its 2-bit mode; returns the bytes
// its description took.
size_t seq_table(FseTable& t, bool& have, int mode, const uint8_t* src, size_t n,
                 const int16_t* def, int def_n, int def_log, int max_log, int max_sym,
                 const char* what) {
  switch (mode) {
    case 0:
      build_fse(t, def, def_n, def_log);
      have = true;
      return 0;
    case 1:
      if (n < 1) fail(std::string(what) + " RLE symbol missing");
      if (src[0] > max_sym) fail(std::string(what) + " RLE symbol out of range");
      rle_fse(t, src[0]);
      have = true;
      return 1;
    case 2: {
      size_t used = read_fse(t, src, n, max_log, max_sym);
      have = true;
      return used;
    }
    default:
      if (!have) fail(std::string(what) + " repeat mode with no previous table");
      return 0;
  }
}

// A compressed block (RFC 8878 3.1.1.3) appended to `out`; its output may
// not take `out` past `limit` bytes.
void decode_block(FrameState& st, const uint8_t* src, size_t n, std::vector<uint8_t>& out,
                  size_t frame_start, size_t limit) {
  // literals section
  if (n < 1) fail("compressed block empty");
  int ltype = src[0] & 3, sf = (src[0] >> 2) & 3;
  size_t regen, csize = 0, hsize;
  if (ltype < 2) {
    if ((sf & 1) == 0) {
      hsize = 1;
      regen = src[0] >> 3;
    } else if (sf == 1) {
      hsize = 2;
      if (n < 2) fail("literals header truncated");
      regen = load_le(src, 2) >> 4;
    } else {
      hsize = 3;
      if (n < 3) fail("literals header truncated");
      regen = load_le(src, 3) >> 4;
    }
  } else {
    hsize = sf < 2 ? 3 : sf + 2;
    if (n < hsize) fail("literals header truncated");
    uint64_t h = load_le(src, hsize);
    int szbits = sf < 2 ? 10 : (sf == 2 ? 14 : 18);
    regen = (h >> 4) & ((1u << szbits) - 1);
    csize = (h >> (4 + szbits)) & ((1u << szbits) - 1);
  }
  if (regen > 128 * 1024) fail("literals section above 128 KB");
  std::vector<uint8_t> lit(regen);
  size_t p = hsize;
  if (ltype == 0) {
    if (p + regen > n) fail("raw literals truncated");
    if (regen) std::memcpy(lit.data(), src + p, regen);
    p += regen;
  } else if (ltype == 1) {
    if (p + 1 > n) fail("RLE literal truncated");
    if (regen) std::memset(lit.data(), src[p], regen);
    p += 1;
  } else {
    if (p + csize > n) fail("compressed literals truncated");
    const uint8_t* c = src + p;
    size_t cn = csize;
    if (ltype == 2) {
      size_t used = read_huffman(st.huf, c, cn);
      c += used;
      cn -= used;
    } else if (st.huf.log == 0) {
      fail("treeless literals with no previous Huffman table");
    }
    if (sf == 0) {
      uint8_t* o = lit.data();
      huffman_streams(st.huf, 1, &c, &cn, &o, &regen);
    } else {
      if (cn < 6) fail("jump table truncated");
      size_t s1 = load_le(c, 2), s2 = load_le(c + 2, 2), s3 = load_le(c + 4, 2);
      if (6 + s1 + s2 + s3 >= cn) fail("Huffman streams larger than the literals");
      size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) fail("4-stream literals too short");
      const uint8_t* q = c + 6;
      const uint8_t* srcs[4] = {q, q + s1, q + s1 + s2, q + s1 + s2 + s3};
      size_t sizes[4] = {s1, s2, s3, cn - 6 - s1 - s2 - s3};
      uint8_t* outs[4] = {lit.data(), lit.data() + seg, lit.data() + 2 * seg,
                          lit.data() + 3 * seg};
      size_t counts[4] = {seg, seg, seg, regen - 3 * seg};
      huffman_streams(st.huf, 4, srcs, sizes, outs, counts);
    }
    p += csize;
  }

  // sequences section
  if (p >= n) fail("sequences section missing");
  size_t nseq = src[p++];
  if (nseq >= 128) {
    if (nseq < 255) {
      if (p >= n) fail("sequence count truncated");
      nseq = ((nseq - 128) << 8) + src[p++];
    } else {
      if (p + 2 > n) fail("sequence count truncated");
      nseq = load_le(src + p, 2) + 0x7F00;
      p += 2;
    }
  }
  size_t lit_pos = 0;
  if (nseq > 0) {
    if (p >= n) fail("sequence modes truncated");
    uint8_t modes = src[p++];
    if (modes & 3) fail("reserved bits of the sequence modes set");
    p += seq_table(st.ll, st.have_ll, modes >> 6, src + p, n - p, LL_DEFAULT, 36, 6, 9, 35,
                   "literal lengths");
    p += seq_table(st.of, st.have_of, (modes >> 4) & 3, src + p, n - p, OF_DEFAULT, 29, 5, 8,
                   31, "offsets");
    p += seq_table(st.ml, st.have_ml, (modes >> 2) & 3, src + p, n - p, ML_DEFAULT, 53, 6, 9,
                   52, "match lengths");
    if (p >= n) fail("sequence bitstream missing");
    BackBits br(src + p, n - p);
    uint32_t sll = uint32_t(br.read(st.ll.log));
    uint32_t sof = uint32_t(br.read(st.of.log));
    uint32_t sml = uint32_t(br.read(st.ml.log));
    for (size_t i = 0; i < nseq; ++i) {
      uint32_t llc = st.ll.t[sll].symbol, ofc = st.of.t[sof].symbol, mlc = st.ml.t[sml].symbol;
      if (llc > 35 || mlc > 52 || ofc > 31) fail("sequence code out of range");
      uint64_t ofv = (uint64_t(1) << ofc) + br.read(int(ofc));
      uint64_t ml = ML_BASE[mlc] + br.read(ML_BITS[mlc]);
      uint64_t ll = LL_BASE[llc] + br.read(LL_BITS[llc]);
      if (br.overflowed()) fail("sequence bitstream too short");
      uint64_t off;
      if (ofv > 3) {
        off = ofv - 3;
        st.rep[2] = st.rep[1];
        st.rep[1] = st.rep[0];
        st.rep[0] = uint32_t(off);
      } else {
        uint64_t idx = ll == 0 ? ofv + 1 : ofv;
        if (idx == 1) {
          off = st.rep[0];
        } else {
          if (idx == 2) {
            off = st.rep[1];
          } else if (idx == 3) {
            off = st.rep[2];
          } else {
            off = uint64_t(st.rep[0]) - 1;
          }
          if (idx != 2) st.rep[2] = st.rep[1];
          st.rep[1] = st.rep[0];
          st.rep[0] = uint32_t(off);
        }
      }
      if (off == 0) fail("offset 0");
      if (ll > regen - lit_pos) fail("sequence takes more literals than the block has");
      if (out.size() + ll + ml > limit) fail("block decodes above the block maximum");
      out.insert(out.end(), lit.begin() + lit_pos, lit.begin() + lit_pos + ll);
      lit_pos += ll;
      size_t have = out.size() - frame_start;
      if (off > have) fail("match offset before the start of the frame");
      size_t from = out.size() - off;
      if (off >= ml) {
        out.insert(out.end(), ml, 0);
        std::memcpy(out.data() + out.size() - ml, out.data() + from, ml);
      } else {
        out.reserve(out.size() + ml);
        for (uint64_t k = 0; k < ml; ++k) out.push_back(out[from + k]);
      }
      if (i + 1 < nseq) {
        const FseEntry& el = st.ll.t[sll];
        sll = el.baseline + uint32_t(br.read(el.nbits));
        const FseEntry& em = st.ml.t[sml];
        sml = em.baseline + uint32_t(br.read(em.nbits));
        const FseEntry& eo = st.of.t[sof];
        sof = eo.baseline + uint32_t(br.read(eo.nbits));
        if (br.overflowed()) fail("sequence bitstream too short");
      }
    }
    if (br.pos != 0) fail("sequence bitstream not fully consumed");
  } else if (p != n) {
    fail("bytes after a block with no sequences");
  }
  if (out.size() + (regen - lit_pos) > limit) fail("block decodes above the block maximum");
  out.insert(out.end(), lit.begin() + lit_pos, lit.end());
}

// One frame at src[0..n); returns the bytes it took.
size_t decode_frame(const uint8_t* src, size_t n, std::vector<uint8_t>& out) {
  if (n < 4) fail("frame truncated");
  uint32_t magic = uint32_t(load_le(src, 4));
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
    if (n < 8) fail("skippable frame truncated");
    uint64_t len = load_le(src + 4, 4);
    if (8 + len > n) fail("skippable frame truncated");
    return size_t(8 + len);
  }
  if (magic != 0xFD2FB528u) fail("not a zstd frame (bad magic)");
  size_t p = 4;
  if (p >= n) fail("frame header truncated");
  uint8_t fhd = src[p++];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
      did_flag = fhd & 3;
  if (fhd & 0x08) fail("reserved bit of the frame header set");
  uint64_t window = 0;
  if (!single) {
    if (p >= n) fail("frame header truncated");
    uint8_t wd = src[p++];
    int wlog = 10 + (wd >> 3);
    uint64_t base = uint64_t(1) << wlog;
    window = base + (base / 8) * (wd & 7);
  }
  static const int DID_SIZE[4] = {0, 1, 2, 4};
  if (p + DID_SIZE[did_flag] > n) fail("frame header truncated");
  uint64_t did = load_le(src + p, DID_SIZE[did_flag]);
  p += DID_SIZE[did_flag];
  if (did != 0) fail("frame names dictionary " + std::to_string(did) +
                     "; dictionaries are not supported");
  int fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : (1 << fcs_flag);
  if (p + fcs_size > n) fail("frame header truncated");
  uint64_t fcs = load_le(src + p, fcs_size);
  bool has_fcs = fcs_size > 0;
  if (fcs_size == 2) fcs += 256;
  p += fcs_size;
  if (single) window = fcs;
  uint64_t block_max = window < 128 * 1024 ? window : 128 * 1024;
  size_t start = out.size();
  // reserve what the header declares, but no more than a generous ratio
  // of the input: a corrupt header must not allocate gigabytes
  if (has_fcs) out.reserve(start + size_t(fcs < 64 * uint64_t(n) + (1 << 20) ? fcs : 0));
  FrameState st;
  for (;;) {
    if (p + 3 > n) fail("block header truncated");
    uint32_t bh = uint32_t(load_le(src + p, 3));
    p += 3;
    int last = bh & 1, btype = (bh >> 1) & 3;
    size_t bsize = bh >> 3;
    if (btype == 3) fail("reserved block type");
    if (btype == 1) {
      if (bsize > block_max) fail("RLE block larger than the block maximum");
      if (p + 1 > n) fail("RLE block truncated");
      out.insert(out.end(), bsize, src[p]);
      p += 1;
    } else {
      if (p + bsize > n) fail("block truncated");
      if (bsize > block_max) fail("block larger than the block maximum");
      if (btype == 0) {
        out.insert(out.end(), src + p, src + p + bsize);
      } else {
        decode_block(st, src + p, bsize, out, start, out.size() + size_t(block_max));
      }
      p += bsize;
    }
    if (has_fcs && out.size() - start > fcs) fail("frame longer than its content size");
    if (last) break;
  }
  if (has_fcs && out.size() - start != fcs) fail("frame shorter than its content size");
  if (checksum) {
    if (p + 4 > n) fail("content checksum truncated");
    uint32_t want = uint32_t(load_le(src + p, 4));
    uint32_t got = uint32_t(xxh64(out.data() + start, out.size() - start));
    if (want != got) fail("content checksum mismatch");
    p += 4;
  }
  return p;
}

}  // namespace

extern "C" {

int h36x_zstd_decompress(const uint8_t* src, size_t n, uint8_t** out, size_t* out_n,
                         char* err, int err_len) {
  *out = nullptr;
  *out_n = 0;
  try {
    std::vector<uint8_t> buf;
    if (n == 0) fail("empty input");
    size_t p = 0;
    while (p < n) p += decode_frame(src + p, n - p, buf);
    uint8_t* m = static_cast<uint8_t*>(std::malloc(buf.size() ? buf.size() : 1));
    if (!m) fail("out of memory");
    if (!buf.empty()) std::memcpy(m, buf.data(), buf.size());
    *out = m;
    *out_n = buf.size();
    return 0;
  } catch (const std::exception& e) {
    if (err && err_len > 0) {
      std::strncpy(err, e.what(), size_t(err_len) - 1);
      err[err_len - 1] = 0;
    }
    return 1;
  }
}

void h36x_zstd_free(uint8_t* p) { std::free(p); }

}  // extern "C"
