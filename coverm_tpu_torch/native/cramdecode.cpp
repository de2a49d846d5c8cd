// Native CRAM 3.0 slice decoder for coverm-tpu.
//
// The record-model decode (series codecs -> feature loop -> BAM record
// bytes) is the hot loop of CRAM ingestion; the pure-python decoder in
// io/cram.py runs ~40k records/s, this one runs millions.  It mirrors
// io/cram.py EXACTLY (that module is the from-spec reference
// implementation and remains the oracle + fallback): same codec
// semantics, same feature handling incl. embedded-reference fill and
// the substitution matrix, same mate resolution and RG:Z
// reconstruction, same BAM wire emission.  On ANY malformed input it
// returns an error and the caller falls back to the python decoder for
// that slice.
//
// Entry points (C ABI, ctypes): ct_cram_decode_slice / ct_cram_out /
// ct_cram_free.  Blocks arrive DECOMPRESSED (python handles gzip/bzip2/
// lzma; rANS is native already).

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <string>
#include <vector>

#include "stats_state.h"

namespace cram {

struct DecodeError {};

// ------------------------------------------------------------- readers ----

struct Buf {
  const uint8_t* d;
  int64_t n;
  int64_t p = 0;
};

static inline uint8_t rd_u8(Buf& b) {
  if (b.p >= b.n) throw DecodeError{};
  return b.d[b.p++];
}

static int64_t read_itf8(Buf& b) {
  uint32_t b0 = rd_u8(b);
  if (b0 < 0x80) return b0;
  if (b0 < 0xC0) return ((b0 & 0x3F) << 8) | rd_u8(b);
  if (b0 < 0xE0) {
    uint32_t v = (b0 & 0x1F) << 16;
    v |= (uint32_t)rd_u8(b) << 8;
    v |= rd_u8(b);
    return v;
  }
  if (b0 < 0xF0) {
    uint32_t v = (b0 & 0x0F) << 24;
    v |= (uint32_t)rd_u8(b) << 16;
    v |= (uint32_t)rd_u8(b) << 8;
    v |= rd_u8(b);
    return v;
  }
  uint32_t v = (b0 & 0x0F) << 28;
  v |= (uint32_t)rd_u8(b) << 20;
  v |= (uint32_t)rd_u8(b) << 12;
  v |= (uint32_t)rd_u8(b) << 4;
  v |= rd_u8(b) & 0x0F;
  return (int64_t)(int32_t)v;  // 5-byte form is signed 32-bit
}

static int64_t read_ltf8(Buf& b) {
  uint8_t b0 = rd_u8(b);
  int n = 0;
  while (n < 8 && ((b0 << n) & 0x80)) n++;
  if (n == 0) return b0;
  if (n == 8) {
    uint64_t v = 0;
    for (int k = 0; k < 8; k++) v = (v << 8) | rd_u8(b);
    return (int64_t)v;
  }
  int64_t v = b0 & (0x7F >> n);
  for (int k = 0; k < n; k++) v = (v << 8) | rd_u8(b);
  return v;
}

struct BitReader {
  const uint8_t* d = nullptr;
  int64_t n = 0;
  int64_t byte = 0;
  int bit = 0;

  inline int read_bit() {
    if (byte >= n) throw DecodeError{};
    int v = (d[byte] >> (7 - bit)) & 1;
    if (++bit == 8) {
      bit = 0;
      byte++;
    }
    return v;
  }

  inline int64_t read_bits(int k) {
    int64_t v = 0;
    while (k > 0) {
      if (byte >= n) throw DecodeError{};
      int avail = 8 - bit;
      int take = k < avail ? k : avail;
      v = (v << take) | ((d[byte] >> (avail - take)) & ((1 << take) - 1));
      bit += take;
      if (bit == 8) {
        bit = 0;
        byte++;
      }
      k -= take;
    }
    return v;
  }
};

struct ExtStream {
  // d may be null for a SIZE-ONLY stream (stats mode: a block whose
  // data is never read — e.g. a quality stream — is not even
  // decompressed; only n, its uncompressed size, keeps skip_n in
  // lockstep).  Any actual read of a size-only stream throws, which
  // sends the slice to the python fallback.
  const uint8_t* d = nullptr;
  int64_t n = 0;
  int64_t p = 0;

  inline int64_t itf8() {
    if (!d) throw DecodeError{};
    Buf b{d, n, p};
    int64_t v = read_itf8(b);
    p = b.p;
    return v;
  }

  inline uint8_t byte() {
    if (!d || p >= n) throw DecodeError{};
    return d[p++];
  }

  inline void read_n(int64_t k, std::string& out) {
    if (!d || p + k > n) throw DecodeError{};
    out.assign((const char*)d + p, (size_t)k);
    p += k;
  }

  inline void read_until(uint8_t stop, std::string& out) {
    if (!d) throw DecodeError{};
    const uint8_t* q = (const uint8_t*)memchr(d + p, stop, (size_t)(n - p));
    if (!q) throw DecodeError{};
    out.assign((const char*)d + p, (size_t)(q - (d + p)));
    p = (q - d) + 1;
  }

  // stats-mode fast paths: consume WITHOUT copying (the coverage scan
  // never reads names / bases / qualities, only stream positions must
  // stay in lockstep).  skip_n works on size-only streams (d null).
  inline void skip_n(int64_t k) {
    if (k < 0 || p + k > n) throw DecodeError{};
    p += k;
  }

  inline int64_t skip_until(uint8_t stop) {
    if (!d) throw DecodeError{};
    const uint8_t* q = (const uint8_t*)memchr(d + p, stop, (size_t)(n - p));
    if (!q) throw DecodeError{};
    int64_t len = q - (d + p);
    p = (q - d) + 1;
    return len;
  }
};

// -------------------------------------------------------------- codecs ----

struct Ctx;  // fwd

struct Codec {
  uint8_t kind = 0;  // matches io/cram.py codec ids
  int32_t cid = 0;
  int64_t offset = 0;
  int32_t nbits = 0;
  int32_t k = 0;
  uint8_t stop = 0;
  bool is_const = false;
  int64_t const_val = 0;
  int max_hlen = 0;
  // huffman canonical decode: per bit length, sorted (code, symbol)
  std::vector<std::vector<std::pair<uint32_t, int64_t>>> by_len;
  std::unique_ptr<Codec> len_enc, val_enc;
};

struct Ctx {
  BitReader core;
  std::map<int32_t, ExtStream> ext;

  ExtStream& stream(int32_t cid) {
    auto it = ext.find(cid);
    if (it == ext.end()) throw DecodeError{};
    return it->second;
  }
};

static int64_t huff_decode(const Codec& c, Ctx& ctx) {
  if (c.is_const) return c.const_val;
  uint32_t code = 0;
  for (int ln = 1; ln <= c.max_hlen; ln++) {
    code = (code << 1) | (uint32_t)ctx.core.read_bit();
    const auto& tab = c.by_len[(size_t)ln];
    for (const auto& cs : tab)
      if (cs.first == code) return cs.second;
  }
  throw DecodeError{};
}

static int64_t decode_int(const Codec& c, Ctx& ctx) {
  switch (c.kind) {
    case 1:  // EXTERNAL
      return ctx.stream(c.cid).itf8();
    case 3:  // HUFFMAN
      return huff_decode(c, ctx);
    case 6:  // BETA
      return ctx.core.read_bits(c.nbits) - c.offset;
    case 9: {  // GAMMA
      int n = 0;
      while (ctx.core.read_bit() == 0) {
        if (++n > 63) throw DecodeError{};
      }
      int64_t v = 1;
      for (int i = 0; i < n; i++) v = (v << 1) | ctx.core.read_bit();
      return v - c.offset;
    }
    case 7: {  // SUBEXP
      int i = 0;
      while (ctx.core.read_bit() == 1) {
        if (++i > 63) throw DecodeError{};
      }
      int64_t v;
      if (i == 0) {
        v = ctx.core.read_bits(c.k);
      } else {
        int b = c.k + i - 1;
        if (b > 62) throw DecodeError{};
        v = ((int64_t)1 << b) | ctx.core.read_bits(b);
      }
      return v - c.offset;
    }
    default:
      throw DecodeError{};
  }
}

static uint8_t decode_byte(const Codec& c, Ctx& ctx) {
  if (c.kind == 1) return ctx.stream(c.cid).byte();
  return (uint8_t)decode_int(c, ctx);
}

// Skip a read NAME: its bytes AND length feed nothing in the stats
// decode, so a BYTE_ARRAY_STOP name stream that was left compressed
// (size-only, d null) is simply not read at all — the stream has no
// other consumer to fall out of lockstep with.
static void skip_name(const Codec& c, Ctx& ctx);

// Consume a byte-array series without materialising it; returns the
// byte count (the CIGAR length of IN/SC/BB features).
static int64_t skip_bytes(const Codec& c, Ctx& ctx) {
  if (c.kind == 5) {  // BYTE_ARRAY_STOP
    return ctx.stream(c.cid).skip_until(c.stop);
  }
  if (c.kind == 4) {  // BYTE_ARRAY_LEN
    int64_t n = decode_int(*c.len_enc, ctx);
    if (n < 0 || n > (1 << 28)) throw DecodeError{};
    if (c.val_enc->kind == 1) {
      ctx.stream(c.val_enc->cid).skip_n(n);
    } else {
      for (int64_t i = 0; i < n; i++) decode_byte(*c.val_enc, ctx);
    }
    return n;
  }
  throw DecodeError{};
}

static void skip_name(const Codec& c, Ctx& ctx) {
  if (c.kind == 5) {
    ExtStream& s = ctx.stream(c.cid);
    if (s.d == nullptr) return;  // size-only: never read, no-op
    s.skip_until(c.stop);
    return;
  }
  skip_bytes(c, ctx);
}

static void decode_bytes(const Codec& c, Ctx& ctx, std::string& out) {
  if (c.kind == 5) {  // BYTE_ARRAY_STOP
    ctx.stream(c.cid).read_until(c.stop, out);
    return;
  }
  if (c.kind == 4) {  // BYTE_ARRAY_LEN
    int64_t n = decode_int(*c.len_enc, ctx);
    if (n < 0 || n > (1 << 28)) throw DecodeError{};
    if (c.val_enc->kind == 1) {
      ctx.stream(c.val_enc->cid).read_n(n, out);
    } else {
      out.clear();
      out.reserve((size_t)n);
      for (int64_t i = 0; i < n; i++)
        out.push_back((char)decode_byte(*c.val_enc, ctx));
    }
    return;
  }
  throw DecodeError{};
}

static void parse_encoding(Buf& b, Codec& c) {
  int64_t codec_id = read_itf8(b);
  int64_t nparam = read_itf8(b);
  Buf pb{b.d + b.p, nparam, 0};
  if (b.p + nparam > b.n) throw DecodeError{};
  b.p += nparam;
  c.kind = (uint8_t)codec_id;
  switch (codec_id) {
    case 0:  // NULL
      break;
    case 1:
      c.cid = (int32_t)read_itf8(pb);
      break;
    case 3: {  // HUFFMAN (canonical; io/cram.py HuffmanCodec)
      int64_t n = read_itf8(pb);
      std::vector<int64_t> syms((size_t)n);
      for (int64_t i = 0; i < n; i++) syms[(size_t)i] = read_itf8(pb);
      int64_t m = read_itf8(pb);
      if (m != n) throw DecodeError{};
      std::vector<int> lens((size_t)n);
      for (int64_t i = 0; i < n; i++) lens[(size_t)i] = (int)read_itf8(pb);
      if (n == 1 && lens[0] == 0) {
        c.is_const = true;
        c.const_val = syms[0];
        break;
      }
      std::vector<std::pair<int, int64_t>> order;
      order.reserve((size_t)n);
      for (int64_t i = 0; i < n; i++)
        order.push_back({lens[(size_t)i], syms[(size_t)i]});
      std::sort(order.begin(), order.end());
      c.max_hlen = order.empty() ? 0 : order.back().first;
      if (c.max_hlen > 31) throw DecodeError{};
      c.by_len.assign((size_t)c.max_hlen + 1, {});
      uint32_t code = 0;
      int prev_len = 0;
      for (const auto& ls : order) {
        code <<= (ls.first - prev_len);
        c.by_len[(size_t)ls.first].push_back({code, ls.second});
        code += 1;
        prev_len = ls.first;
      }
      break;
    }
    case 6:
      c.offset = read_itf8(pb);
      c.nbits = (int32_t)read_itf8(pb);
      if (c.nbits < 0 || c.nbits > 62) throw DecodeError{};
      break;
    case 9:
      c.offset = read_itf8(pb);
      break;
    case 7:
      c.offset = read_itf8(pb);
      c.k = (int32_t)read_itf8(pb);
      if (c.k < 0 || c.k > 62) throw DecodeError{};
      break;
    case 4: {
      c.len_enc.reset(new Codec());
      c.val_enc.reset(new Codec());
      parse_encoding(pb, *c.len_enc);
      parse_encoding(pb, *c.val_enc);
      break;
    }
    case 5: {
      c.stop = rd_u8(pb);
      c.cid = (int32_t)read_itf8(pb);
      break;
    }
    default:
      throw DecodeError{};  // GOLOMB etc.: python falls back too
  }
}

// -------------------------------------------------- compression header ----

struct CompHeader {
  bool rn_preserved = true;
  bool ap_delta = true;
  bool ref_required = true;
  uint8_t sub_matrix[5] = {0, 0, 0, 0, 0};
  std::vector<std::vector<std::pair<std::string, char>>> tag_dict;
  std::map<uint16_t, Codec> series;
  std::map<uint32_t, Codec> tags;
};

static inline uint16_t skey(const char* k) {
  return ((uint16_t)(uint8_t)k[0] << 8) | (uint8_t)k[1];
}

static void parse_comp_header(Buf& b, CompHeader& h) {
  h.tag_dict.assign(1, {});
  read_itf8(b);  // preservation map size
  int64_t n = read_itf8(b);
  for (int64_t i = 0; i < n; i++) {
    if (b.p + 2 > b.n) throw DecodeError{};
    char k0 = (char)b.d[b.p], k1 = (char)b.d[b.p + 1];
    b.p += 2;
    if (k0 == 'R' && k1 == 'N') {
      h.rn_preserved = rd_u8(b) != 0;
    } else if (k0 == 'A' && k1 == 'P') {
      h.ap_delta = rd_u8(b) != 0;
    } else if (k0 == 'R' && k1 == 'R') {
      h.ref_required = rd_u8(b) != 0;
    } else if (k0 == 'S' && k1 == 'M') {
      for (int j = 0; j < 5; j++) h.sub_matrix[j] = rd_u8(b);
    } else if (k0 == 'T' && k1 == 'D') {
      int64_t tdlen = read_itf8(b);
      if (b.p + tdlen > b.n) throw DecodeError{};
      const uint8_t* blob = b.d + b.p;
      b.p += tdlen;
      h.tag_dict.clear();
      int64_t q = 0;
      if (tdlen == 0) {
        h.tag_dict.assign(1, {});
      } else {
        while (q < tdlen) {
          int64_t e = q;
          while (e < tdlen && blob[e] != 0) e++;
          std::vector<std::pair<std::string, char>> line;
          for (int64_t t = q; t + 2 < e; t += 3)
            line.push_back({std::string((const char*)blob + t, 2),
                            (char)blob[t + 2]});
          h.tag_dict.push_back(std::move(line));
          if (e >= tdlen) break;  // malformed tail: mirror split()[:-1]
          q = e + 1;
        }
        if (h.tag_dict.empty()) h.tag_dict.assign(1, {});
      }
    } else {
      throw DecodeError{};  // unknown preservation key
    }
  }
  read_itf8(b);  // data-series block size
  n = read_itf8(b);
  for (int64_t i = 0; i < n; i++) {
    if (b.p + 2 > b.n) throw DecodeError{};
    uint16_t key = skey((const char*)b.d + b.p);
    b.p += 2;
    parse_encoding(b, h.series[key]);
  }
  read_itf8(b);  // tag-encoding block size
  n = read_itf8(b);
  for (int64_t i = 0; i < n; i++) {
    int64_t key = read_itf8(b);
    parse_encoding(b, h.tags[(uint32_t)key]);
  }
}

// --------------------------------------------------------- slice header ----

struct SliceHeader {
  int64_t ref_id, start, span, n_records, record_counter, n_blocks;
  int64_t embedded_ref_id;
};

static void parse_slice_header(Buf& b, SliceHeader& s) {
  s.ref_id = read_itf8(b);
  s.start = read_itf8(b);
  s.span = read_itf8(b);
  s.n_records = read_itf8(b);
  s.record_counter = read_ltf8(b);
  s.n_blocks = read_itf8(b);
  int64_t nc = read_itf8(b);
  for (int64_t i = 0; i < nc; i++) read_itf8(b);
  s.embedded_ref_id = read_itf8(b);
}

// ------------------------------------------------------------- records ----

constexpr int32_t CF_QS_STORED = 0x1, CF_DETACHED = 0x2;
constexpr int32_t CF_MATE_DOWNSTREAM = 0x4, CF_NO_SEQ = 0x8;
constexpr int32_t F_UNMAP = 0x4, F_REVERSE = 0x10;
constexpr int32_t F_MREVERSE = 0x20, F_MUNMAP = 0x8;
constexpr uint8_t REF_CONSUME_MASK[16] = {1, 0, 1, 1, 0, 0, 0, 1, 1,
                                          0, 0, 0, 0, 0, 0, 0};

struct Rec {
  int32_t flag = 0, cf = 0, tid = -1, rg = -1, mapq = 0;
  int64_t pos = 0, rl = 0;
  int32_t mate_tid = -1;
  int64_t mate_pos = -1, tlen = 0, nf = -1;
  bool has_nf = false;
  std::string name;
  bool named = false;
  std::vector<std::pair<uint8_t, int64_t>> cigar;
  std::string seq, qual;
  std::vector<uint8_t> tags;
  bool has_rg_tag = false;
  int64_t end = 0;
  bool seq_incomplete = false;
  int64_t nm = -1;  // stats mode: NM tag value (-1 = absent)
  // block-sink mode: this record's coverage blocks live at
  // [blk_lo, blk_hi) of the sink arrays; CIGAR-derived sums
  int64_t a_cov = 0, ind = 0;
  int32_t blk_lo = 0, blk_hi = 0;
};

struct SubTable {
  uint8_t tab[5][4];  // [ref base idx][code] -> substituted base
};

static const char* BASES = "ACGTN";

static void build_sub_table(const uint8_t sm[5], SubTable& t) {
  for (int ri = 0; ri < 5; ri++) {
    char others[4];
    int oi = 0;
    for (int j = 0; j < 5; j++)
      if (j != ri) others[oi++] = BASES[j];
    uint8_t byte = sm[ri];
    for (int c = 0; c < 4; c++) t.tab[ri][c] = 'N';
    for (int k = 0; k < 4; k++) {
      int code = (byte >> (6 - 2 * k)) & 3;
      t.tab[ri][code] = (uint8_t)others[k];
    }
  }
}

static inline int base_index(uint8_t b) {
  switch (b) {
    case 'A': return 0;
    case 'C': return 1;
    case 'G': return 2;
    case 'T': return 3;
    default: return 4;
  }
}

// BAM-typed integer tag payload -> value; -1 for non-integer types
// (the BAM aux scanner treats a non-integer NM as absent, matching
// bamdecode.cpp scan_aux_tags' has_val gating)
static int64_t parse_int_payload(char typ, const std::string& v) {
  switch (typ) {
    case 'A':
    case 'C':
      if (v.size() < 1) throw DecodeError{};
      return (uint8_t)v[0];
    case 'c':
      if (v.size() < 1) throw DecodeError{};
      return (int8_t)v[0];
    case 'S': {
      if (v.size() < 2) throw DecodeError{};
      uint16_t x;
      memcpy(&x, v.data(), 2);
      return x;
    }
    case 's': {
      if (v.size() < 2) throw DecodeError{};
      int16_t x;
      memcpy(&x, v.data(), 2);
      return x;
    }
    case 'I': {
      if (v.size() < 4) throw DecodeError{};
      uint32_t x;
      memcpy(&x, v.data(), 4);
      return x;
    }
    case 'i': {
      if (v.size() < 4) throw DecodeError{};
      int32_t x;
      memcpy(&x, v.data(), 4);
      return x;
    }
    default:
      return -1;
  }
}

struct SliceDecoder {
  const CompHeader& h;
  const SliceHeader& sl;
  Ctx& ctx;
  const uint8_t* eref;  // embedded reference (or null)
  int64_t eref_len;
  bool stats_only = false;  // skip seq/qual/name materialisation
  // block-sink mode (stats only): emit each maximal M/=/X run straight
  // into these arrays during the feature walk — no CIGAR vector is
  // built at all.  Valid only when the flag gate does not read the
  // mate bits resolved after decode (the caller checks).
  std::vector<int32_t>* blk_tid = nullptr;
  std::vector<int32_t>* blk_start = nullptr;
  std::vector<int32_t>* blk_end = nullptr;
  SubTable sub;

  // flat open-addressing cache over the series map: S() runs ~10 times
  // per record, and a std::map lookup per call dominated the stats
  // decode (measured ~470 ns/record before caching)
  uint16_t skeys_[64];
  const Codec* sptr_[64] = {};
  bool scache_ok_ = false;
  // per-tag-line resolved codecs: (tag0, tag1, typ, codec)
  struct TagRef {
    char t0, t1, typ;
    const Codec* c;
  };
  std::vector<std::vector<TagRef>> tl_cache_;

  void build_caches() {
    if (h.series.size() <= 48) {
      for (const auto& kv : h.series) {
        int i = kv.first & 63;
        while (sptr_[i]) i = (i + 1) & 63;
        skeys_[i] = kv.first;
        sptr_[i] = &kv.second;
      }
      scache_ok_ = true;
    }
    tl_cache_.resize(h.tag_dict.size());
    for (size_t li = 0; li < h.tag_dict.size(); li++) {
      for (const auto& tt : h.tag_dict[li]) {
        uint32_t key = ((uint32_t)(uint8_t)tt.first[0] << 16) |
                       ((uint32_t)(uint8_t)tt.first[1] << 8) |
                       (uint8_t)tt.second;
        auto it = h.tags.find(key);
        tl_cache_[li].push_back(
            {tt.first[0], tt.first[1], tt.second,
             it == h.tags.end() ? nullptr : &it->second});
      }
    }
  }

  const Codec& S(const char* key) {
    uint16_t k = skey(key);
    if (scache_ok_) {
      int i = k & 63;
      while (sptr_[i]) {
        if (skeys_[i] == k) return *sptr_[i];
        i = (i + 1) & 63;
      }
      throw DecodeError{};
    }
    auto it = h.series.find(k);
    if (it == h.series.end()) throw DecodeError{};
    return it->second;
  }

  int64_t dint(const char* key) { return decode_int(S(key), ctx); }
  uint8_t dbyte(const char* key) { return decode_byte(S(key), ctx); }
  void dbytes(const char* key, std::string& out) {
    decode_bytes(S(key), ctx, out);
  }

  inline int rbase(int64_t g) {  // 1-based ref position -> base or -1
    if (!eref) return -1;
    int64_t idx = g - sl.start;
    if (idx >= 0 && idx < eref_len) return eref[idx];
    return -1;
  }

  void decode_records(std::vector<Rec>& recs) {
    build_sub_table(h.sub_matrix, sub);
    build_caches();
    int64_t last_pos = sl.start;
    // corrupt slice headers must not allocate gigabytes (the python
    // decoder bounds RL/FN identically)
    if (sl.n_records < 0 || sl.n_records > (1 << 24)) throw DecodeError{};
    recs.resize((size_t)sl.n_records);
    std::string tmp;
    for (int64_t i = 0; i < sl.n_records; i++) {
      Rec& r = recs[(size_t)i];
      r.flag = (int32_t)dint("BF");
      r.cf = (int32_t)dint("CF");
      r.tid = sl.ref_id == -2 ? (int32_t)dint("RI") : (int32_t)sl.ref_id;
      r.rl = dint("RL");
      if (r.rl < 0 || r.rl > (1 << 28)) throw DecodeError{};
      int64_t ap = dint("AP");
      if (h.ap_delta) {
        r.pos = last_pos + ap;
        last_pos = r.pos;
      } else {
        r.pos = ap;
      }
      r.rg = (int32_t)dint("RG");
      if (h.rn_preserved) {
        if (stats_only) {
          skip_name(S("RN"), ctx);
        } else {
          dbytes("RN", r.name);
        }
        r.named = true;
      }
      if (r.cf & CF_DETACHED) {
        int64_t mf = dint("MF");
        if (!h.rn_preserved) {
          if (stats_only) {
            skip_name(S("RN"), ctx);
          } else {
            dbytes("RN", r.name);
          }
          r.named = true;
        }
        r.mate_tid = (int32_t)dint("NS");
        r.mate_pos = dint("NP");
        r.tlen = dint("TS");
        if (mf & 1) r.flag |= F_MREVERSE;
        if (mf & 2) r.flag |= F_MUNMAP;
      } else if (r.cf & CF_MATE_DOWNSTREAM) {
        r.nf = dint("NF");
        r.has_nf = true;
      }
      int64_t tl = dint("TL");
      if (tl < 0 || (size_t)tl >= tl_cache_.size()) throw DecodeError{};
      for (const TagRef& tt : tl_cache_[(size_t)tl]) {
        if (!tt.c) throw DecodeError{};
        if (stats_only) {
          // only NM's VALUE is consumed by the coverage scan; every
          // other tag just advances its stream
          if (tt.t0 == 'N' && tt.t1 == 'M') {
            decode_bytes(*tt.c, ctx, tmp);
            r.nm = parse_int_payload(tt.typ, tmp);
          } else {
            skip_bytes(*tt.c, ctx);
          }
          continue;
        }
        decode_bytes(*tt.c, ctx, tmp);
        r.tags.push_back((uint8_t)tt.t0);
        r.tags.push_back((uint8_t)tt.t1);
        r.tags.push_back((uint8_t)tt.typ);
        r.tags.insert(r.tags.end(), tmp.begin(), tmp.end());
        if (tt.t0 == 'R' && tt.t1 == 'G') r.has_rg_tag = true;
      }

      if (!stats_only) {
        r.seq.assign((size_t)r.rl, 'N');
        r.qual.assign((size_t)r.rl, (char)0xff);
      }
      r.end = r.pos;
      if (!(r.flag & F_UNMAP)) {
        int64_t fn = dint("FN");
        if (fn < 0 || fn > (1 << 24)) throw DecodeError{};
        if (blk_tid) {
          if ((int64_t)blk_tid->size() > INT32_MAX) throw DecodeError{};
          // the open-run sentinel is blk_open < 0: a negative mapped
          // position cannot use the sink (pathological input -> the
          // caller falls back to the python record model)
          if (r.pos < 0) throw DecodeError{};
          r.blk_lo = (int32_t)blk_tid->size();
        }
        int64_t read_cur = 0, ref_cur = r.pos, fpos = 0;
        auto fill_match = [&](int64_t n) {
          // implicit match run (RR=1): bases from the reference
          if (stats_only) {
            // coverage never reads base identity: cursors only
          } else if (eref) {
            for (int64_t t = 0; t < n; t++) {
              int b = rbase(ref_cur + t);
              if (b >= 0)
                r.seq[(size_t)(read_cur + t)] = (char)b;
              else
                r.seq_incomplete = true;
            }
          } else if (h.ref_required) {
            r.seq_incomplete = true;
          }
          read_cur += n;
          ref_cur += n;
        };
        bool sink = blk_tid != nullptr;
        int64_t blk_open = -1;  // 1-based ref pos of the open M-run
        auto close_run = [&]() {
          if (blk_open >= 0) {
            if (ref_cur - 1 > INT32_MAX || blk_open - 1 < INT32_MIN)
              throw DecodeError{};
            blk_tid->push_back(r.tid);
            blk_start->push_back((int32_t)(blk_open - 1));
            blk_end->push_back((int32_t)(ref_cur - 1));
            blk_open = -1;
          }
        };
        auto push = [&](uint8_t op, int64_t ln) {
          if (sink) {
            // blocks are maximal M/=/X runs; any other op (even a
            // zero-length one, matching the CIGAR-merge semantics of
            // the emission path) closes the open run.  push is always
            // called BEFORE the op's ref_cur advance, so ref_cur here
            // is the run end / the next run start.
            if (op == 0 || op == 7 || op == 8) {
              if (ln > 0) {
                if (blk_open < 0) blk_open = ref_cur;
                r.a_cov += ln;
              }
            } else {
              close_run();
              if (op == 1 || op == 2) {
                r.a_cov += ln;
                r.ind += ln;
              }
            }
            return;
          }
          if (!r.cigar.empty() && r.cigar.back().first == op)
            r.cigar.back().second += ln;
          else
            r.cigar.push_back({op, ln});
        };
        for (int64_t f = 0; f < fn; f++) {
          char fc = (char)dbyte("FC");
          fpos += dint("FP");
          int64_t gap = (fpos - 1) - read_cur;
          if (gap < 0 || fpos > r.rl + 1) throw DecodeError{};
          if (gap > 0) {
            push(0, gap);
            fill_match(gap);
          }
          switch (fc) {
            case 'B':
              if (read_cur >= r.rl) throw DecodeError{};
              if (stats_only) {
                dbyte("BA");
                dbyte("QS");
              } else {
                r.seq[(size_t)read_cur] = (char)dbyte("BA");
                r.qual[(size_t)read_cur] = (char)dbyte("QS");
              }
              push(0, 1);
              read_cur++;
              ref_cur++;
              break;
            case 'X': {
              if (read_cur >= r.rl) throw DecodeError{};
              int64_t code = dint("BS");
              if (!stats_only) {
                int rb = rbase(ref_cur);
                if (rb >= 0) {
                  r.seq[(size_t)read_cur] =
                      (code >= 0 && code < 4)
                          ? (char)sub.tab[base_index((uint8_t)rb)][code]
                          : 'N';
                } else {
                  r.seq_incomplete = true;
                }
              }
              push(0, 1);
              read_cur++;
              ref_cur++;
              break;
            }
            case 'D': {
              int64_t dl = dint("DL");
              if (dl < 0) throw DecodeError{};
              push(2, dl);
              ref_cur += dl;
              break;
            }
            case 'I': {
              int64_t ln;
              if (stats_only) {
                ln = skip_bytes(S("IN"), ctx);
                if (read_cur + ln > r.rl) throw DecodeError{};
              } else {
                dbytes("IN", tmp);
                ln = (int64_t)tmp.size();
                if (read_cur + ln > r.rl) throw DecodeError{};
                memcpy(&r.seq[(size_t)read_cur], tmp.data(), tmp.size());
              }
              push(1, ln);
              read_cur += ln;
              break;
            }
            case 'i':
              if (read_cur >= r.rl) throw DecodeError{};
              if (stats_only) {
                dbyte("BA");
              } else {
                r.seq[(size_t)read_cur] = (char)dbyte("BA");
              }
              push(1, 1);
              read_cur++;
              break;
            case 'S': {
              int64_t ln;
              if (stats_only) {
                ln = skip_bytes(S("SC"), ctx);
                if (read_cur + ln > r.rl) throw DecodeError{};
              } else {
                dbytes("SC", tmp);
                ln = (int64_t)tmp.size();
                if (read_cur + ln > r.rl) throw DecodeError{};
                memcpy(&r.seq[(size_t)read_cur], tmp.data(), tmp.size());
              }
              push(4, ln);
              read_cur += ln;
              break;
            }
            case 'H':
              push(5, dint("HC"));
              break;
            case 'P':
              push(6, dint("PD"));
              break;
            case 'N': {
              int64_t rs = dint("RS");
              push(3, rs);
              ref_cur += rs;
              break;
            }
            case 'Q':
              if (read_cur >= r.rl) throw DecodeError{};
              if (stats_only) {
                dbyte("QS");
              } else {
                r.qual[(size_t)read_cur] = (char)dbyte("QS");
              }
              break;
            case 'b': {
              int64_t ln;
              if (stats_only) {
                ln = skip_bytes(S("BB"), ctx);
                if (read_cur + ln > r.rl) throw DecodeError{};
              } else {
                dbytes("BB", tmp);
                ln = (int64_t)tmp.size();
                if (read_cur + ln > r.rl) throw DecodeError{};
                memcpy(&r.seq[(size_t)read_cur], tmp.data(), tmp.size());
              }
              push(0, ln);
              read_cur += ln;
              ref_cur += ln;
              break;
            }
            case 'q': {
              if (stats_only) {
                int64_t ln = skip_bytes(S("QQ"), ctx);
                if (read_cur + ln > r.rl) throw DecodeError{};
              } else {
                dbytes("QQ", tmp);
                if (read_cur + (int64_t)tmp.size() > r.rl)
                  throw DecodeError{};
                memcpy(&r.qual[(size_t)read_cur], tmp.data(), tmp.size());
              }
              // q does not advance the read cursor
              break;
            }
            default:
              throw DecodeError{};
          }
        }
        int64_t tail = r.rl - read_cur;
        if (tail > 0) {
          push(0, tail);
          fill_match(tail);
        }
        if (sink) {
          close_run();
          r.blk_hi = (int32_t)blk_tid->size();
          r.end = ref_cur - 1;  // 0-based inclusive end (mates/tlen)
        }
        // drop zero-length ops (python filters ln > 0)
        size_t w = 0;
        for (size_t k2 = 0; k2 < r.cigar.size(); k2++)
          if (r.cigar[k2].second > 0) r.cigar[w++] = r.cigar[k2];
        r.cigar.resize(w);
        r.mapq = (int32_t)dint("MQ");
      } else {
        if (!(r.cf & CF_NO_SEQ)) {
          const Codec& ba = S("BA");
          if (stats_only && ba.kind == 1) {
            ctx.stream(ba.cid).skip_n(r.rl);  // pointer bump, no copy
          } else if (stats_only) {
            for (int64_t k2 = 0; k2 < r.rl; k2++) decode_byte(ba, ctx);
          } else {
            for (int64_t k2 = 0; k2 < r.rl; k2++)
              r.seq[(size_t)k2] = (char)dbyte("BA");
          }
        }
      }
      if (r.cf & CF_QS_STORED) {
        const Codec& qs = S("QS");
        if (stats_only && qs.kind == 1) {
          ctx.stream(qs.cid).skip_n(r.rl);  // the big one: rl bytes/rec
        } else if (stats_only) {
          for (int64_t k2 = 0; k2 < r.rl; k2++) decode_byte(qs, ctx);
        } else if (qs.kind == 1) {
          ctx.stream(qs.cid).read_n(r.rl, tmp);
          r.qual.assign(tmp);
        } else {
          for (int64_t k2 = 0; k2 < r.rl; k2++)
            r.qual[(size_t)k2] = (char)decode_byte(qs, ctx);
        }
      }
      if (!stats_only && (r.cf & CF_NO_SEQ))
        r.seq.assign((size_t)r.rl, 'N');
      if (!(blk_tid && !(r.flag & F_UNMAP))) {
        // sink mode computed r.end from ref_cur during the walk
        int64_t consumed = 0;
        for (const auto& ol : r.cigar)
          if (REF_CONSUME_MASK[ol.first]) consumed += ol.second;
        r.end = r.pos - 1 + consumed;  // 0-based inclusive end (mapped)
      }
    }
  }
};

// mirror of io/cram.py _resolve_mates; stats_only skips name synthesis
// (the coverage scan never reads names — only the mate FLAG bits and
// positions matter there)
static void resolve_mates(std::vector<Rec>& recs, const SliceHeader& sl,
                          bool stats_only = false) {
  char buf[32];
  if (!stats_only) {
    for (size_t i = 0; i < recs.size(); i++) {
      // generate only for truly unnamed records (python: `name is
      // None`; an RN-decoded EMPTY name stays empty for byte parity)
      if (!recs[i].named) {
        int n = snprintf(buf, sizeof(buf), "cr%lld",
                         (long long)(sl.record_counter + (int64_t)i));
        recs[i].name.assign(buf, (size_t)n);
      }
    }
  }
  for (size_t i = 0; i < recs.size(); i++) {
    Rec& r = recs[i];
    if (!r.has_nf) continue;
    size_t j = i + (size_t)r.nf + 1;
    if (j >= recs.size()) throw DecodeError{};
    Rec& m = recs[j];
    m.name = r.name;
    r.mate_tid = m.tid;
    r.mate_pos = m.pos;
    m.mate_tid = r.tid;
    m.mate_pos = r.pos;
    if (m.flag & F_REVERSE) r.flag |= F_MREVERSE;
    if (m.flag & F_UNMAP) r.flag |= F_MUNMAP;
    if (r.flag & F_REVERSE) m.flag |= F_MREVERSE;
    if (r.flag & F_UNMAP) m.flag |= F_MUNMAP;
    int64_t left = r.pos < m.pos ? r.pos : m.pos;
    int64_t re = (r.flag & F_UNMAP) ? r.pos : r.end;
    int64_t me = (m.flag & F_UNMAP) ? m.pos : m.end;
    int64_t right = re > me ? re : me;
    int64_t tlen = right - left + 1;
    if (r.pos <= m.pos) {
      r.tlen = tlen;
      m.tlen = -tlen;
    } else {
      r.tlen = -tlen;
      m.tlen = tlen;
    }
  }
}

// mirror of io/cram.py _bam_record_bytes (+ RG:Z reconstruction)
static uint8_t SEQ_NYB[256];
static bool seq_nyb_init = false;

static void init_seq_nyb() {
  const char* order = "=ACMGRSVTWYHKDBN";
  memset(SEQ_NYB, 15, sizeof(SEQ_NYB));
  for (int i = 0; i < 16; i++) SEQ_NYB[(uint8_t)order[i]] = (uint8_t)i;
  seq_nyb_init = true;
}

static void emit_record(const Rec& r, const std::vector<std::string>& rgs,
                        std::vector<uint8_t>& out) {
  // BAM int32 field bounds: corrupt AP deltas / TLEN spans must reject
  // (matching the python decoder's CramFormatError), not wrap silently
  if (r.pos - 1 < INT32_MIN || r.pos - 1 > INT32_MAX ||
      r.mate_pos - 1 > INT32_MAX || r.tlen < INT32_MIN ||
      r.tlen > INT32_MAX)
    throw DecodeError{};
  size_t name_n = r.name.size() + 1;
  size_t ncig = r.cigar.size();
  // BAM narrow-field bounds: l_read_name is u8, n_cigar u16, mapq u8.
  // Silently wrapping them would emit a record whose block_size counts
  // the full name/cigar but whose length fields truncate — downstream
  // walks would misread offsets (ADVICE r4).  Reject so the slice falls
  // back to the python decoder, which raises CramFormatError loudly.
  if (name_n > 255 || ncig > 65535 || r.mapq < 0 || r.mapq > 255)
    throw DecodeError{};
  size_t seq_b = ((size_t)r.rl + 1) / 2;
  size_t rg_extra = 0;
  std::string rg_id;
  if (r.rg >= 0 && (size_t)r.rg < rgs.size() && !r.has_rg_tag) {
    rg_id = rgs[(size_t)r.rg];
    rg_extra = 3 + rg_id.size() + 1;
  }
  size_t body = 32 + name_n + 4 * ncig + seq_b + (size_t)r.rl +
                r.tags.size() + rg_extra;
  uint32_t bs = (uint32_t)body;
  size_t base = out.size();
  out.resize(base + 4 + body);
  uint8_t* p = out.data() + base;
  memcpy(p, &bs, 4);
  p += 4;
  int32_t pos0 = (int32_t)(r.pos - 1);
  int32_t mate_pos0 = r.mate_pos > 0 ? (int32_t)(r.mate_pos - 1) : -1;
  memcpy(p, &r.tid, 4);
  memcpy(p + 4, &pos0, 4);
  p[8] = (uint8_t)name_n;
  p[9] = (uint8_t)r.mapq;
  uint16_t bin = 4680, nc16 = (uint16_t)ncig,
           flag16 = (uint16_t)(r.flag & 0xFFFF);
  memcpy(p + 10, &bin, 2);
  memcpy(p + 12, &nc16, 2);
  memcpy(p + 14, &flag16, 2);
  int32_t rl32 = (int32_t)r.rl;
  memcpy(p + 16, &rl32, 4);
  memcpy(p + 20, &r.mate_tid, 4);
  memcpy(p + 24, &mate_pos0, 4);
  int32_t tlen32 = (int32_t)r.tlen;
  memcpy(p + 28, &tlen32, 4);
  p += 32;
  memcpy(p, r.name.data(), r.name.size());
  p[r.name.size()] = 0;
  p += name_n;
  for (const auto& ol : r.cigar) {
    uint32_t c = ((uint32_t)ol.second << 4) | ol.first;
    memcpy(p, &c, 4);
    p += 4;
  }
  if (r.rl) {
    for (int64_t i = 0; i + 1 < r.rl; i += 2) {
      *p++ = (uint8_t)((SEQ_NYB[(uint8_t)r.seq[(size_t)i]] << 4) |
                       SEQ_NYB[(uint8_t)r.seq[(size_t)i + 1]]);
    }
    if (r.rl & 1)
      *p++ = (uint8_t)(SEQ_NYB[(uint8_t)r.seq[(size_t)r.rl - 1]] << 4);
    memcpy(p, r.qual.data(), (size_t)r.rl);
    p += r.rl;
  }
  if (!r.tags.empty()) {
    memcpy(p, r.tags.data(), r.tags.size());
    p += r.tags.size();
  }
  if (rg_extra) {
    *p++ = 'R';
    *p++ = 'G';
    *p++ = 'Z';
    memcpy(p, rg_id.data(), rg_id.size());
    p += rg_id.size();
    *p++ = 0;
  }
}

struct Result {
  std::vector<uint8_t> out;
};

}  // namespace cram

extern "C" {

// Decode one slice's records to uncompressed BAM record bytes.
// Returns a handle (ct_cram_free) or null; scalars[0..3]: n_records,
// out_len, err (nonzero -> caller falls back to the python decoder),
// seq_incomplete (count of records whose bases need a missing
// reference — the require_seq error is raised python-side).
void* ct_cram_decode_slice(const uint8_t* comp_hdr, int64_t comp_len,
                           const uint8_t* slice_hdr, int64_t slice_len,
                           const uint8_t* core, int64_t core_len,
                           const uint8_t* ext_buf, const int64_t* ext_off,
                           const int64_t* ext_ids, int64_t n_ext,
                           const uint8_t* rg_blob, int64_t rg_len,
                           int64_t* scalars) {
  using namespace cram;
  if (!seq_nyb_init) init_seq_nyb();
  auto* res = new Result();
  scalars[0] = scalars[1] = scalars[2] = scalars[3] = 0;
  try {
    CompHeader h;
    Buf cb{comp_hdr, comp_len, 0};
    parse_comp_header(cb, h);
    SliceHeader sl;
    Buf sb{slice_hdr, slice_len, 0};
    parse_slice_header(sb, sl);

    Ctx ctx;
    ctx.core.d = core;
    ctx.core.n = core_len;
    const uint8_t* eref = nullptr;
    int64_t eref_len = 0;
    for (int64_t i = 0; i < n_ext; i++) {
      ExtStream es;
      es.d = ext_buf + ext_off[i];
      es.n = ext_off[i + 1] - ext_off[i];
      ctx.ext[(int32_t)ext_ids[i]] = es;
      if (sl.embedded_ref_id >= 0 && ext_ids[i] == sl.embedded_ref_id) {
        eref = es.d;
        eref_len = es.n;
      }
    }

    std::vector<std::string> rgs;
    {
      int64_t q = 0;
      while (q < rg_len) {
        int64_t e = q;
        while (e < rg_len && rg_blob[e] != 0) e++;
        rgs.emplace_back((const char*)rg_blob + q, (size_t)(e - q));
        q = e + 1;
      }
    }

    SliceDecoder dec{h, sl, ctx, eref, eref_len};
    std::vector<Rec> recs;
    dec.decode_records(recs);
    resolve_mates(recs, sl);

    int64_t incomplete = 0;
    res->out.reserve((size_t)sl.n_records * 96);
    for (const Rec& r : recs) {
      incomplete += r.seq_incomplete;
      emit_record(r, rgs, res->out);
    }
    scalars[0] = (int64_t)recs.size();
    scalars[1] = (int64_t)res->out.size();
    scalars[3] = incomplete;
  } catch (...) {
    scalars[2] = 1;
  }
  return res;
}

void ct_cram_out(void* handle, uint8_t* dst) {
  auto* res = (cram::Result*)handle;
  if (!res->out.empty()) memcpy(dst, res->out.data(), res->out.size());
}

void ct_cram_free(void* handle) { delete (cram::Result*)handle; }

// Decode one slice DIRECTLY into the fused-scan stats model (VERDICT r4
// #2): no BAM wire bytes, no re-scan — names/bases/qualities are stream
// skips, only flags/positions/CIGAR/NM are decoded, and the result is a
// StatsScanState handle identical to ct_stats_scan's, consumed by
// ct_stats_fill / ct_stats_free.  scalars match ct_stats_scan's layout
// ([0] n_records, [2] n_blocks, [3] n_primary, [4] nm_missing,
// [5] sorted, [6] first_tid, [7] last_tid).  Returns null on ANY decode
// problem — the caller falls back to the python record model for the
// slice, which raises CramFormatError loudly on real corruption.
void* ct_cram_stats_slice(const uint8_t* comp_hdr, int64_t comp_len,
                          const uint8_t* slice_hdr, int64_t slice_len,
                          const uint8_t* core, int64_t core_len,
                          const uint8_t* ext_buf, const int64_t* ext_off,
                          const int64_t* ext_sizes,
                          const int64_t* ext_ids, int64_t n_ext,
                          int32_t n_ref, int32_t skip_mask,
                          int32_t req_mask, int64_t* scalars) {
  using namespace cram;
  auto* st = new covermio::StatsScanState();
  for (int i = 0; i < 11; i++) scalars[i] = 0;
  try {
    CompHeader h;
    Buf cb{comp_hdr, comp_len, 0};
    parse_comp_header(cb, h);
    SliceHeader sl;
    Buf sb{slice_hdr, slice_len, 0};
    parse_slice_header(sb, sl);

    Ctx ctx;
    ctx.core.d = core;
    ctx.core.n = core_len;
    for (int64_t i = 0; i < n_ext; i++) {
      ExtStream es;
      int64_t present = ext_off[i + 1] - ext_off[i];
      // size-only stream (never-read block left compressed): d null,
      // n = the uncompressed size so skip_n stays in lockstep
      es.d = present > 0 ? ext_buf + ext_off[i] : nullptr;
      es.n = ext_sizes[i];
      ctx.ext[(int32_t)ext_ids[i]] = es;
    }

    st->chunks.resize(1);
    covermio::ChunkOut& out = st->chunks[0];

    SliceDecoder dec{h, sl, ctx, nullptr, 0};
    dec.stats_only = true;
    // block-sink fast path: blocks land in the output arrays DURING
    // decode (no CIGAR vectors).  Invalid when the flag gate reads the
    // mate bits (0x8/0x20) resolved only after decode — no FlagFilter
    // does today, but stay correct for direct callers.
    bool fast = ((skip_mask | req_mask) & (F_MREVERSE | F_MUNMAP)) == 0;
    if (fast) {
      dec.blk_tid = &out.btid;
      dec.blk_start = &out.bstart;
      dec.blk_end = &out.bend;
    }
    std::vector<Rec> recs;
    dec.decode_records(recs);  // validates sl.n_records <= 2^24
    resolve_mates(recs, sl, /*stats_only=*/true);
    if (!fast) {
      // reserve only AFTER the record-count bound held (a corrupt
      // header must not drive multi-GB reserves)
      out.btid.reserve(recs.size());
      out.bstart.reserve(recs.size());
      out.bend.reserve(recs.size());
    }

    covermio::StatsRun run{};
    int32_t cur_tid = -2, prev_tid = -1;
    int64_t wblk = 0;  // fast path: compaction write cursor
    auto flush = [&]() {
      if (cur_tid >= 0) out.runs.push_back(run);
    };
    for (const Rec& r : recs) {
      bool primary = (r.flag & 0x900) == 0;
      out.n_primary += primary;
      bool mapped = (r.flag & 0x4) == 0;
      bool pass = ((r.flag & skip_mask) == 0) &&
                  ((r.flag & req_mask) == req_mask);
      if (!(pass && mapped)) continue;
      if (r.tid < 0 || r.tid >= n_ref) throw DecodeError{};
      int64_t pos0 = r.pos - 1;
      if (pos0 < INT32_MIN || pos0 > INT32_MAX) throw DecodeError{};
      if (out.first_tid < 0) out.first_tid = r.tid;
      if (r.tid < prev_tid) out.sorted = false;
      prev_tid = r.tid;
      out.last_tid = r.tid;
      if (r.tid != cur_tid) {
        flush();
        run = covermio::StatsRun{};
        run.tid = r.tid;
        cur_tid = r.tid;
      }
      bool nonsupp = (r.flag & 0x800) == 0;
      run.reads_all++;
      run.reads_primary += primary;
      run.reads_nonsupp += nonsupp;

      int64_t a_cov, ind;
      if (fast) {
        // blocks already in the sink; keep-copy this (passing)
        // record's range over the dropped ones
        int64_t lo = r.blk_lo, n = (int64_t)r.blk_hi - r.blk_lo;
        if (wblk != lo && n) {
          memmove(out.btid.data() + wblk, out.btid.data() + lo, n * 4);
          memmove(out.bstart.data() + wblk, out.bstart.data() + lo,
                  n * 4);
          memmove(out.bend.data() + wblk, out.bend.data() + lo, n * 4);
        }
        wblk += n;
        run.block_count += n;
        a_cov = r.a_cov;
        ind = r.ind;
      } else {
        a_cov = ind = 0;
        int64_t cursor = pos0;
        for (const auto& ol : r.cigar) {
          int64_t ln = ol.second;
          switch (ol.first) {
            case 0:
            case 7:
            case 8:  // M / = / X
              out.btid.push_back(r.tid);
              out.bstart.push_back((int32_t)cursor);
              out.bend.push_back((int32_t)(cursor + ln));
              run.block_count++;
              a_cov += ln;
              cursor += ln;
              break;
            case 1:  // I
              a_cov += ln;
              ind += ln;
              break;
            case 2:  // D
              a_cov += ln;
              ind += ln;
              cursor += ln;
              break;
            case 3:  // N
              cursor += ln;
              break;
            default:  // S/H/P
              break;
          }
          if (cursor > INT32_MAX) throw DecodeError{};
        }
      }
      run.indel_sum += ind;
      if (r.nm < 0) {
        out.nm_missing++;  // the caller raises before any result is used
      } else {
        run.nm_sum += r.nm;
        if (a_cov > 0) {
          double idv = (double)(a_cov - r.nm) / (double)a_cov;
          run.ident_primary += primary ? idv : 0.0;
          run.ident_nonsupp += nonsupp ? idv : 0.0;
        }
      }
    }
    flush();
    if (fast) {
      out.btid.resize((size_t)wblk);
      out.bstart.resize((size_t)wblk);
      out.bend.resize((size_t)wblk);
    }

    st->n_chunks = 1;
    st->n_records = (int64_t)recs.size();
    st->n_blocks = (int64_t)out.btid.size();
    scalars[0] = st->n_records;
    scalars[2] = st->n_blocks;
    scalars[3] = out.n_primary;
    scalars[4] = out.nm_missing;
    scalars[5] = out.sorted ? 1 : 0;
    scalars[6] = out.first_tid;
    scalars[7] = out.last_tid;
    return st;
  } catch (...) {
    delete st;
    return nullptr;
  }
}

}  // extern "C"
