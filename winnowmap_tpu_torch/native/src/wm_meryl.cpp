// meryl v1 on-disk database codec: the stuffedBits bit container and the
// Elias-Fano k-mer block encoding, so this framework reads and writes real
// meryl databases (64 .merylData + 64 .merylIndex files + a merylIndex
// master, reference ext/meryl/src/utility/src/bits/stuffedBits-v1*.{H,C},
// ext/meryl/src/utility/src/kmers-v1/kmers-files.C:24-128 and
// kmers-v1/kmers-writer.C:183-284).
//
// Bitstream model (stuffedBits): a sequence of blocks, each up to maxBits
// bits; bits fill each little-endian uint64 word MSB-first; no value spans
// a block boundary (writes that would overflow close the block and start
// the next one; reads advance when exactly at a block's end).  A "dump"
// serializes: maxBits u64, blocksLen u32, blocksMax u32, bgn[blocksLen]
// u64, len[blocksLen] u64, then each block's words.
//
// Only kCode 1 (Elias-Fano suffixes) and cCode 1/2 (32/64-bit binary
// values) exist in the reference; k <= 32 keeps every suffix in one word.
#include "wm_base.h"

#include <cstring>
#include <vector>

namespace {

struct BitReader {
  const uint8_t* buf;
  int64_t nbytes;
  int64_t off = 0;  // byte offset of the dump being parsed

  // current dump
  std::vector<int64_t> blk_word_off;  // absolute byte offset of block words
  std::vector<uint64_t> blk_len;      // bits per block
  uint32_t blk = 0;
  uint64_t pos = 0;   // bit position within current block
  bool ok = true;

  uint64_t raw64(int64_t byte_off) const {
    uint64_t v;
    std::memcpy(&v, buf + byte_off, 8);
    return v;  // host is little-endian, matching the on-disk order
  }

  // Parse the container header of the next dump; false at end of file.
  bool next_dump() {
    if (off + 16 > nbytes) return false;
    // maxBits u64 (unused on read), blocksLen u32, blocksMax u32
    uint32_t blocksLen, blocksMax;
    std::memcpy(&blocksLen, buf + off + 8, 4);
    std::memcpy(&blocksMax, buf + off + 12, 4);
    (void)blocksMax;
    int64_t p = off + 16 + 8 * (int64_t)blocksLen;  // skip bgn[]
    blk_word_off.clear();
    blk_len.clear();
    int64_t w = p + 8 * (int64_t)blocksLen;
    for (uint32_t i = 0; i < blocksLen; ++i) {
      uint64_t len = raw64(p + 8 * (int64_t)i);
      blk_word_off.push_back(w);
      blk_len.push_back(len);
      w += 8 * (int64_t)((len + 63) / 64);
    }
    if (w > nbytes) { ok = false; return false; }
    off = w;
    blk = 0;
    pos = 0;
    return blocksLen > 0 && blk_len[0] > 0;
  }

  // reference stuffedBits::moveToNextBlock (stuffedBits-v1.H)
  void advance(uint64_t width) {
    if (pos + width <= blk_len[blk]) return;
    if (pos != blk_len[blk]) { ok = false; return; }
    if (++blk >= blk_len.size()) { ok = false; return; }
    pos = 0;
  }

  uint64_t word(uint64_t wrd) const {
    return raw64(blk_word_off[blk] + 8 * (int64_t)wrd);
  }

  uint64_t get_binary(uint32_t width) {
    if (width == 0) return 0;
    advance(width);
    if (!ok) return 0;
    uint64_t wrd = pos >> 6;
    uint32_t bit = 64 - (uint32_t)(pos & 63);  // bits left in this word
    uint64_t value;
    if (width < bit) {
      value = (word(wrd) >> (bit - width)) & ((~0ull) >> (64 - width));
    } else if (width == bit) {
      value = word(wrd) & ((width == 64) ? ~0ull : ((~0ull) >> (64 - width)));
    } else {
      uint32_t w1 = bit, w2 = width - bit;
      uint64_t l = (word(wrd) & ((w1 == 64) ? ~0ull : ((~0ull) >> (64 - w1))))
                   << w2;
      uint64_t r = word(wrd + 1) >> (64 - w2);
      value = l | r;
    }
    pos += width;
    return value;
  }

  uint64_t get_unary() {
    advance(1);
    if (!ok) return 0;
    uint64_t value = 0;
    uint64_t wrd = pos >> 6;
    uint32_t bit = 64 - (uint32_t)(pos & 63);
    uint64_t w = word(wrd) << (64 - bit);
    while (w == 0) {
      value += bit;
      pos += bit;
      wrd += 1;
      bit = 64;
      if (pos >= blk_len[blk]) { ok = false; return 0; }
      w = word(wrd);
    }
    uint32_t zeros = 0;
    while (!(w & (1ull << 63))) { w <<= 1; ++zeros; }
    value += zeros;
    pos += zeros + 1;
    return value;
  }
};

struct BitWriter {
  uint64_t maxBits;
  std::vector<std::vector<uint64_t>> blocks;
  std::vector<uint64_t> lens;
  std::vector<uint64_t> cur;
  uint64_t pos = 0;

  explicit BitWriter(uint64_t max_bits) : maxBits(max_bits) {
    cur.assign(maxBits / 64, 0);
  }

  void close_block() {
    blocks.push_back(cur);
    lens.push_back(pos);
    cur.assign(maxBits / 64, 0);
    pos = 0;
  }

  // reference stuffedBits::ensureSpaceInCurrentBlock
  void ensure(uint64_t n) {
    if (pos + n > maxBits) close_block();
  }

  void put_bits(uint32_t width, uint64_t value) {
    // place `width` bits MSB-first at `pos` (block space already ensured)
    if (width == 0) return;
    if (width < 64) value &= (~0ull) >> (64 - width);
    uint64_t wrd = pos >> 6;
    uint32_t bit = 64 - (uint32_t)(pos & 63);
    if (width <= bit) {
      cur[wrd] |= value << (bit - width);
    } else {
      uint32_t w2 = width - bit;
      cur[wrd] |= value >> w2;
      cur[wrd + 1] |= value << (64 - w2);
    }
    pos += width;
  }

  void set_binary(uint32_t width, uint64_t value) {
    if (width == 0) return;
    ensure(width);
    put_bits(width, value);
  }

  void set_unary(uint64_t value) {
    ensure(value + 1);
    pos += value;  // zeros (words are pre-cleared)
    put_bits(1, 1);
  }

  // serialize as one stuffedBits dump
  std::vector<uint8_t> dump() {
    std::vector<std::vector<uint64_t>> bl = blocks;
    std::vector<uint64_t> ln = lens;
    if (pos > 0 || bl.empty()) {
      bl.push_back(cur);
      ln.push_back(pos);
    }
    uint32_t outLen = (uint32_t)bl.size();
    uint32_t blocksMax = ((outLen + 31) / 32) * 32;  // grows 32 at a time
    std::vector<uint8_t> out;
    auto w64 = [&](uint64_t v) {
      size_t o = out.size();
      out.resize(o + 8);
      std::memcpy(out.data() + o, &v, 8);
    };
    auto w32 = [&](uint32_t v) {
      size_t o = out.size();
      out.resize(o + 4);
      std::memcpy(out.data() + o, &v, 4);
    };
    w64(maxBits);
    w32(outLen);
    w32(blocksMax);
    uint64_t bgn = 0;
    for (uint32_t i = 0; i < outLen; ++i) {
      w64(bgn);
      bgn += ln[i];
    }
    for (uint32_t i = 0; i < outLen; ++i) w64(ln[i]);
    for (uint32_t i = 0; i < outLen; ++i) {
      uint64_t nw = (ln[i] + 63) / 64;
      size_t o = out.size();
      out.resize(o + 8 * nw);
      std::memcpy(out.data() + o, bl[i].data(), 8 * nw);
    }
    return out;
  }
};

constexpr uint64_t M1_DATA = 0x7461446c7972656dull;  // "merylDat" (LE)
constexpr uint64_t M2_DATA = 0x0a3030656c694661ull;  // "aFile00\n"

}  // namespace

extern "C" {

// Decode every block of one .merylData file into flat (kmer, value) arrays
// (k-mer = blockPrefix << suffix_size | suffix; requires k <= 32 so a k-mer
// fits u64).  Returns the k-mer count, -1 on a malformed stream, -2 if the
// encoding needs >64-bit suffixes.  Output arrays are malloc'd; free with
// wm_free.
int64_t wm_meryl_decode_data(const uint8_t* buf, int64_t nbytes,
                             uint32_t suffix_size, uint64_t** kmers_out,
                             uint64_t** vals_out) {
  BitReader br{buf, nbytes};
  std::vector<uint64_t> kmers, vals;
  while (true) {
    if (br.off >= br.nbytes) break;
    if (!br.next_dump()) {
      if (!br.ok) return -1;
      continue;  // empty dump: keep scanning (mirrors loadBlock's false)
    }
    uint64_t m1 = br.get_binary(64);
    uint64_t m2 = br.get_binary(64);
    if (m1 != M1_DATA || m2 != M2_DATA) return -1;
    uint64_t blockPrefix = br.get_binary(64);
    uint64_t nKmers = br.get_binary(64);
    uint32_t kCode = (uint32_t)br.get_binary(8);
    uint32_t unaryBits = (uint32_t)br.get_binary(32);
    uint32_t binaryBits = (uint32_t)br.get_binary(32);
    br.get_binary(64);
    uint32_t cCode = (uint32_t)br.get_binary(8);
    br.get_binary(64);
    br.get_binary(64);
    (void)unaryBits;
    if (nKmers > 0 && kCode != 1) return -1;
    if (nKmers > 0 && cCode != 1 && cCode != 2) return -1;
    if (binaryBits > 64) return -2;
    uint64_t thisPrefix = 0;
    for (uint64_t kk = 0; kk < nKmers; ++kk) {
      thisPrefix += br.get_unary();
      uint64_t suffix = (thisPrefix << binaryBits) | br.get_binary(binaryBits);
      kmers.push_back((blockPrefix << suffix_size) | suffix);
    }
    for (uint64_t kk = 0; kk < nKmers; ++kk)
      vals.push_back(br.get_binary(cCode == 1 ? 32 : 64));
    if (!br.ok) return -1;
  }
  int64_t n = (int64_t)kmers.size();
  *kmers_out = (uint64_t*)malloc(sizeof(uint64_t) * (n ? n : 1));
  *vals_out = (uint64_t*)malloc(sizeof(uint64_t) * (n ? n : 1));
  std::memcpy(*kmers_out, kmers.data(), sizeof(uint64_t) * n);
  std::memcpy(*vals_out, vals.data(), sizeof(uint64_t) * n);
  return n;
}

// Encode one block of suffixes/values as a stuffedBits dump (reference
// merylFileWriter::writeBlockToFile, kmers-writer.C:183-284, including its
// block sizing).  Returns a malloc'd byte buffer (length in *nbytes_out).
uint8_t* wm_meryl_encode_block(uint64_t block_prefix, int64_t n,
                               const uint64_t* sufs, const uint64_t* vals,
                               uint32_t suffix_size, uint32_t vct,
                               int64_t* nbytes_out) {
  uint32_t unaryBits = 0;
  uint64_t unarySum = 1;
  while (unarySum < (uint64_t)n) {
    unaryBits += 1;
    unarySum <<= 1;
  }
  uint32_t binaryBits = suffix_size - unaryBits;
  uint64_t blockSize = 10 * 64;
  blockSize += 2 * unarySum;
  blockSize += (uint64_t)n * binaryBits / 16;
  blockSize += (uint64_t)n * 32 / 16;
  blockSize = (blockSize & 0xfffffffffffffc00ull) + 1024;

  BitWriter bw(blockSize);
  bw.set_binary(64, M1_DATA);
  bw.set_binary(64, M2_DATA);
  bw.set_binary(64, block_prefix);
  bw.set_binary(64, (uint64_t)n);
  bw.set_binary(8, 1);
  bw.set_binary(32, unaryBits);
  bw.set_binary(32, binaryBits);
  bw.set_binary(64, 0);
  bw.set_binary(8, vct);
  bw.set_binary(64, 0);
  bw.set_binary(64, 0);
  uint64_t lastPrefix = 0;
  for (int64_t kk = 0; kk < n; ++kk) {
    uint64_t thisPrefix = sufs[kk] >> binaryBits;
    bw.set_unary(thisPrefix - lastPrefix);
    bw.set_binary(binaryBits, sufs[kk]);
    lastPrefix = thisPrefix;
  }
  for (int64_t kk = 0; kk < n; ++kk) bw.set_binary(32 * vct, vals[kk]);
  std::vector<uint8_t> out = bw.dump();
  uint8_t* res = (uint8_t*)malloc(out.size() ? out.size() : 1);
  std::memcpy(res, out.data(), out.size());
  *nbytes_out = (int64_t)out.size();
  return res;
}

}  // extern "C"
