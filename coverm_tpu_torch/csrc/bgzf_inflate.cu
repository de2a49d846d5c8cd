// BGZF inflate for Hopper (sm_90a): a raw-DEFLATE (RFC 1951) decoder for a
// batch of independent BGZF blocks, one CTA a block.
//
// It replaces no TPU kernel: the JAX package inflates on the host too. It
// takes over the inflate of the fused BAM ingest from the host
// (coverm_tpu_torch/native/bamdecode.cpp:839, ct_ingest_scan's
// inflate_drain: libdeflate or zlib, one 64 KiB block at a time on 8
// threads).
//
// Input, per block b of the batch, table[4b .. 4b+3] (int64): the offset of
// the block's DEFLATE payload in `comp` (after the 12 + XLEN byte gzip
// header), its length (before the 8-byte CRC32/ISIZE trailer), the offset
// of its output in `out` and its size (ISIZE). Output: the inflated bytes
// at out[offset, offset + ISIZE) and status[b]: 0, or one of the errors
// below. Like the host's inflate_drain, a block fails when its code is
// bad, a distance reaches before its start, its output would pass ISIZE
// or its input runs out, or it ends short of ISIZE; the CRC is not
// checked. BGZF caps ISIZE at 65,536 (SAM specification §4.1; htslib's
// BGZF_MAX_BLOCK_SIZE): a larger block is an overrun here.
//
// `comp`, `table`, `out` and `status` are pinned host memory that the card
// reaches through its mapped addresses (UVA): the card reads the
// compressed bytes and writes the inflated ones across the host link, and
// allocates no device memory, not even a counter.
//
// Bound: each byte of the payloads is read once and each inflated byte
// written once, over the host link (PCIe Gen5 x16, about 63 GB/s each way,
// published): 5.50 GB out a pass of the benchmark's 20 M-read BAM is
// about 0.09 s (0.10 s at the 55 GB/s a pinned copy reaches). Within the
// card the decode is a chain of dependent Huffman lookups, so a decoder is
// latency-bound and the card's rate is the decoders in flight times the
// rate of one. Measured (chip_smoke.py phase 22, scripts/inflate_ab.py;
// NVIDIA H100 80GB HBM3, 700 W): 45,312 shared bytes a CTA, 5 CTAs an SM
// (the first version: 73,904 bytes, 3 CTAs). The
// decoding lane's chain sets the pace where symbols are dense: the
// unmapped reads' segments, whose random bases make short matches, take
// as long with their input and output in the card's own memory.
//
// Design (one CTA a BGZF block, the hardware's block scheduler handing out
// blocks, so no work counter in device memory):
//   - Decoders an SM. The history is a 32 KiB ring (DEFLATE's largest
//     distance), and the output streams to the pinned buffer in 16-byte
//     stores as its lines are finished, the rest at block end; a ring
//     line has the output's own alignment modulo 16. With a 2 KiB payload
//     ring, and the code lengths kept in the distance table's place, a CTA
//     takes 45,312 bytes, so five fit an SM (228 KiB, 1 KiB a CTA
//     reserved). The decoder never writes a ring slot whose byte is not
//     yet flushed or is the source of a match still queued: one limit,
//     `wlim`, folds both into the check against ISIZE.
//   - The symbol loop. One lookup of an 11-bit table of 32-bit entries
//     gives one literal, two literals whose codes fit the 11 bits
//     together, or a length with its base and extra-bit count
//     (libdeflate's layout); the distance table's entries carry base and
//     extra bits too, and longer codes fall to a canonical decode. The bit
//     buffer is 64 bits, topped up a 32-bit word at a time from a word
//     loaded ahead, so a lookup never waits for the ring; the next lookup
//     is issued before this symbol's bytes and bookkeeping. The input and
//     output limits are one compare each a symbol, off the lookups'
//     dependency chain; a limit, a long code or a distance before the
//     start falls to a careful decode of one symbol.
//   - Matches off the decoding lane. Lane 0 writes literals into the ring
//     and queues each match (position, length, distance) in one half of a
//     double-buffered queue of 32; the other half's matches are copied in
//     queue order (a match may read an earlier one's bytes), and its
//     finished lines flushed, a batch at a time, by a second warp: warp
//     specialisation, a decoder warp and a copy warp meeting at a CTA
//     barrier a batch (the form of RAPIDS cuDF's gpuinflate.cu). It took
//     0.76-0.94 of the time of one warp doing both in turn, BAM by BAM, in
//     every measurement of the two. The copy warp also refills the
//     payload ring with cp.async a batch ahead; a batch reads a quarter of
//     the ring at most.
//
// The same source builds for the host with g++ (no __CUDACC__): one thread
// runs each warp phase lane by lane, the copy phase after the decode
// phase, so the CPU tests hold this decoder against zlib:
// bgzf_inflate_host.

#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define BGZF_DEV __device__ __forceinline__
#define BGZF_CONST __constant__
#else
#define BGZF_DEV inline
#define BGZF_CONST static const
#endif

namespace {

constexpr int kMaxOut = 65536;   // BGZF's largest ISIZE
constexpr int kHist = 32768;     // history ring: DEFLATE's largest distance
constexpr int kRing = 2048;      // staged payload bytes (a power of two)
constexpr int kLitBits = 11;     // direct lookup of literal/length codes
constexpr int kDistBits = 8;     // direct lookup of distance codes
constexpr int kQueue = 32;       // matches a batch (each half of the queue)
constexpr int kBatchWords = kRing / 16;  // payload words a batch may take
constexpr int kHeaderAhead = 640;  // bytes a block header may take, at most
constexpr int kRefillMin = 256;    // the least refill but the last
constexpr int kFar = 1 << 28;      // no queued match

enum Status { kOk = 0, kBadCode = 1, kBadDist = 2, kOverrun = 3, kShort = 4 };
enum Cmd { kYield, kBuild, kCopy };
enum Mode { kHeader, kHuffman, kStored };
// literal/length entry: bits 0-4 bits taken, 5-7 kind, 8-12 the first
// code's length; literals at 16-23 and 24-31; a length's extra bits at
// 13-15, base at 16-24, symbol - 257 at 25-29; other symbols at 16-24
enum Kind { kLit = 0, kPair = 1, kLen = 2, kEob = 3, kSlow = 4, kInvalid = 5 };
// distance entry: bits 0-3 code length, 4-7 extra bits, 8-23 base, 24-28
// the symbol; bit 30 an invalid symbol (30, 31), bit 31 a longer code
constexpr uint32_t kDistSlow = 1u << 31;
constexpr uint32_t kDistInvalid = 1u << 30;

BGZF_CONST uint16_t kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 13,
                                    15, 17, 19, 23, 27, 31, 35, 43, 51, 59,
                                    67, 83, 99, 115, 131, 163, 195, 227, 258};
BGZF_CONST uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                                    1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
                                    4, 4, 4, 4, 5, 5, 5, 5, 0};
BGZF_CONST uint16_t kDistBase[30] = {
    1,    2,    3,    4,    5,    7,     9,     13,    17,  25,
    33,   49,   65,   97,   129,  193,   257,   385,   513, 769,
    1025, 1537, 2049, 3073, 4097, 6145,  8193,  12289, 16385, 24577};
BGZF_CONST uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2,  2,  3,  3,
                                     4, 4, 5, 5, 6, 6, 7,  7,  8,  8,
                                     9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
BGZF_CONST uint8_t kClOrder[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                   11, 4,  12, 3, 13, 2, 14, 1, 15};

struct Match {
  uint32_t a;     // position | length << 17
  uint32_t dist;
};

// One CTA's shared memory (45,312 bytes). Slots [2] hand a value from one
// phase to the next: a phase writes slot `half` and reads `half ^ 1`.
struct alignas(16) Smem {
  uint8_t hist[kHist];  // output position p at hist[(p + sh) % kHist]
  uint8_t ring[kRing];  // payload byte q at ring[q % kRing]
  uint32_t lit[1 << kLitBits];
  union {  // the code lengths are read only before the tables are filled
    uint32_t dist[1 << kDistBits];
    uint8_t lens[288 + 32];  // code lengths (distance after nlen)
  };
  Match queue[2][kQueue];
  uint16_t lcount[16], dcount[16];  // codes of each length
  uint16_t lsym[288], dsym[32];     // symbols in canonical order
  int cmd, a, b, c;                 // the decoding lane's command
  int qn[2], end[2], keep[2];       // decoder to copier: each batch's
                                    // matches, its end, its first unread
                                    // payload byte (relative)
  int staged[2], flushed[2];        // copier to decoder: payload bytes in
                                    // the ring, output lines flushed
  int status[2];                    // -1 running, then the block's
};

#ifdef __CUDACC__
struct Warp {  // warp 0 decodes, warp 1 copies
  int lane, warp;
  BGZF_DEV bool decoder() const { return warp == 0; }
  BGZF_DEV bool copier() const { return warp == 1; }
  BGZF_DEV bool leader() const { return lane == 0; }
  BGZF_DEV void sync() const { __syncwarp(); }
  BGZF_DEV void barrier() const { __syncthreads(); }
  template <class F>
  BGZF_DEV void each(F f) const { f(lane); }
};
typedef uint4 Vec16;
BGZF_DEV unsigned reverse_bits(unsigned code, int len) {
  return __brev(code) >> (32 - len);
}
// 16 payload bytes into the ring without waiting (cp.async)
BGZF_DEV void stage16(void* ring, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(ring);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}
BGZF_DEV void stage_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
BGZF_DEV void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
#else
struct Warp {  // the host build: one thread runs each phase lane by lane
  bool decoder() const { return true; }
  bool copier() const { return true; }
  bool leader() const { return true; }
  void sync() const {}
  void barrier() const {}
  template <class F>
  void each(F f) const {
    for (int lane = 0; lane < 32; lane++) f(lane);
  }
};
struct alignas(16) Vec16 { uint32_t x, y, z, w; };
inline unsigned reverse_bits(unsigned code, int len) {
  unsigned r = 0;
  for (int i = 0; i < len; i++) r |= ((code >> i) & 1u) << (len - 1 - i);
  return r;
}
inline void stage16(void* ring, const void* src) { memcpy(ring, src, 16); }
inline void stage_commit() {}
inline void stage_wait() {}
#endif

BGZF_DEV int imin(int a, int b) { return a < b ? a : b; }

// The decoding lane's state. Payload offsets are relative to the block's
// payload start rounded down to 16 bytes.
struct Dec {
  uint64_t bb;          // bit buffer, next bit lowest; 32 bits or more
                        // after a refill (zeros past the payload)
  int bc;               // bits in bb
  int k;                // the payload word after bb's
  uint32_t nw;          // word k as the ring holds it, loaded ahead
  int klim;             // the batch's last k; past it the ring needs bytes
  int staged;           // payload bytes in the ring this batch
  bool all;             // the whole payload is in the ring
  int pend;             // payload end
  int rb;               // ring slot of payload offset 0
  int sh;               // the output's alignment modulo 16
  int pos;              // bytes written
  int usz;              // ISIZE
  int wlim;             // bytes may be written below it this batch
  int mode, rem;        // rem: bytes left of a stored block
  bool last;            // the final block's header has been read
  int qn;               // matches queued this batch
  Match* q;
  int src_cur, src_pend;  // the least match source queued this batch and
                          // in the batch being copied
  int status;           // -1 running
};

// Payload word j as the ring holds it, and with the bytes past the
// payload's end zeroed: a word is loaded a step before it is masked, so
// that the load's latency is not in the way.
BGZF_DEV uint32_t ring_word(const Dec& d, const Smem& s, int j) {
  return *reinterpret_cast<const uint32_t*>(
      &s.ring[(d.rb + 4 * j) & (kRing - 1)]);
}

BGZF_DEV uint32_t masked(const Dec& d, uint32_t w, int j) {
  const int valid = d.pend - 4 * j;
  if (valid >= 4) return w;
  return valid <= 0 ? 0 : w & ((1u << (8 * valid)) - 1);
}

// Top bb up to more than 32 bits with the word loaded ahead, and load
// the next.
BGZF_DEV void refill(Dec& d, const Smem& s) {
  if (d.bc <= 32) {
    d.bb |= (uint64_t)masked(d, d.nw, d.k) << d.bc;
    d.bc += 32;
    d.k++;
    d.nw = ring_word(d, s, d.k);
  }
}

// Bit position (relative) of the next bit.
BGZF_DEV int bit_pos(const Dec& d) { return 32 * d.k - d.bc; }

// Read on from bit position p: bb rebuilt from the ring.
BGZF_DEV void seek(Dec& d, const Smem& s, int p) {
  d.k = p >> 5;
  d.bb = masked(d, ring_word(d, s, d.k), d.k) >> (p & 31);
  d.bc = 32 - (p & 31);
  d.k++;
  d.nw = ring_word(d, s, d.k);
  refill(d, s);
}

BGZF_DEV uint32_t peek(const Dec& d) { return (uint32_t)d.bb; }

// Take n bits (at most 48, and no more than bb holds).
BGZF_DEV void consume(Dec& d, const Smem& s, int n) {
  d.bb >>= n;
  d.bc -= n;
  refill(d, s);
}

BGZF_DEV unsigned bits(Dec& d, const Smem& s, int n) {
  const unsigned v = peek(d) & ((1u << n) - 1);
  consume(d, s, n);
  return v;
}

// One canonical Huffman symbol from the bits of v, one bit at a time
// (puff.c); n its length; -1 for a code that decodes to none.
BGZF_DEV int canonical(uint32_t v, const uint16_t* count,
                       const uint16_t* symbol, int* n) {
  int code = 0, first = 0, index = 0;
  for (int len = 1; len <= 15; len++) {
    code |= (int)(v & 1);
    v >>= 1;
    const int c = count[len];
    if (code - c < first) {
      *n = len;
      return symbol[index + (code - first)];
    }
    index += c;
    first = (first + c) << 1;
    code <<= 1;
  }
  return -1;
}

// The literal/length symbol at the bits v (one symbol, not a pair).
BGZF_DEV int lit_symbol(const Smem& s, uint32_t v, int* n) {
  const uint32_t e = s.lit[v & ((1u << kLitBits) - 1)];
  const uint32_t kind = (e >> 5) & 7;
  if (kind == kSlow) return canonical(v, s.lcount, s.lsym, n);
  *n = (int)((e >> 8) & 31);
  if (kind <= kPair) return (int)((e >> 16) & 255);
  if (kind == kLen) return 257 + (int)((e >> 25) & 31);
  return (int)((e >> 16) & 511);
}

BGZF_DEV int dist_symbol(const Smem& s, uint32_t v, int* n) {
  const uint32_t e = s.dist[v & ((1u << kDistBits) - 1)];
  if (e & kDistSlow) return canonical(v, s.dcount, s.dsym, n);
  *n = (int)(e & 15);
  return (int)((e >> 24) & 31);
}

// Counts and canonically ordered symbols for n code lengths, under zlib's
// rules (inflate_table): an over-subscribed set fails; an incomplete one
// fails unless it is a single code of length 1 (code-length codes: never),
// and no code at all is a table that decodes nothing.
BGZF_DEV bool build(const uint8_t* lens, int n, uint16_t* count,
                    uint16_t* symbol, bool cl_codes) {
  for (int l = 0; l < 16; l++) count[l] = 0;
  for (int s = 0; s < n; s++) count[lens[s]]++;
  int max = 15;
  while (max > 0 && count[max] == 0) max--;
  if (max == 0) return true;
  int left = 1;
  for (int l = 1; l < 16; l++) {
    left = (left << 1) - count[l];
    if (left < 0) return false;
  }
  if (left > 0 && (cl_codes || max != 1)) return false;
  uint16_t offs[16];
  offs[1] = 0;
  for (int l = 1; l < 15; l++) offs[l + 1] = offs[l] + count[l];
  for (int s = 0; s < n; s++)
    if (lens[s]) symbol[offs[lens[s]]++] = (uint16_t)s;
  return true;
}

BGZF_DEV void finish(Dec& d, Smem& s, int status) {
  d.status = status;
  s.cmd = kYield;
}

// A dynamic block's header (RFC 1951 §3.2.7) into s.lens; false when bad.
BGZF_DEV bool dynamic_lens(Dec& d, Smem& s, int* nlen, int* ndist) {
  *nlen = (int)bits(d, s, 5) + 257;
  *ndist = (int)bits(d, s, 5) + 1;
  const int ncode = (int)bits(d, s, 4) + 4;
  if (*nlen > 286 || *ndist > 30) return false;
  uint8_t cl[19];
  for (int i = 0; i < 19; i++) cl[i] = 0;
  for (int i = 0; i < ncode; i++) cl[kClOrder[i]] = (uint8_t)bits(d, s, 3);
  // the code-length code lives in the distance arrays until they are built
  if (!build(cl, 19, s.dcount, s.dsym, true)) return false;
  const int total = *nlen + *ndist;
  for (int i = 0; i < total;) {
    int n;
    const int sym = canonical(peek(d), s.dcount, s.dsym, &n);
    if (sym < 0) return false;
    consume(d, s, n);
    if (sym < 16) {
      s.lens[i++] = (uint8_t)sym;
      continue;
    }
    int val = 0, rep;
    if (sym == 16) {
      if (i == 0) return false;
      val = s.lens[i - 1];
      rep = 3 + (int)bits(d, s, 2);
    } else if (sym == 17) {
      rep = 3 + (int)bits(d, s, 3);
    } else {
      rep = 11 + (int)bits(d, s, 7);
    }
    if (i + rep > total) return false;
    while (rep--) s.lens[i++] = (uint8_t)val;
  }
  return s.lens[256] != 0;  // a block must be able to end
}

// Queue a match of len bytes from dist back at the current position; no
// byte is written again where its source is, until it is copied.
BGZF_DEV void queue_match(Dec& d, int len, int dist) {
  d.q[d.qn++] =
      Match{(uint32_t)d.pos | (uint32_t)len << 17, (uint32_t)dist};
  d.src_cur = imin(d.src_cur, d.pos - dist);
  d.wlim = imin(d.wlim, d.pos - dist + kHist);
  d.pos += len;
}

// One symbol under every check: 1 decoded, 0 the batch ends here (a
// limit), -1 the block failed.
BGZF_DEV int careful(Dec& d, Smem& s) {
  if (d.k > d.klim) {
    if (d.all) return finish(d, s, kOverrun), -1;
    return 0;
  }
  if (d.qn == kQueue) return 0;
  int n;
  const uint32_t v = peek(d);
  int sym = lit_symbol(s, v, &n);
  if (sym < 0) return finish(d, s, kBadCode), -1;
  if (sym < 256) {
    if (d.pos >= d.usz) return finish(d, s, kOverrun), -1;
    if (d.pos >= d.wlim) return 0;
    consume(d, s, n);
    s.hist[(d.pos + d.sh) & (kHist - 1)] = (uint8_t)sym;
    d.pos++;
    return 1;
  }
  if (sym == 256) {
    consume(d, s, n);
    d.mode = kHeader;
    return 1;
  }
  sym -= 257;
  if (sym >= 29) return finish(d, s, kBadCode), -1;
  const Dec at = d;
  const int x = kLenExtra[sym];
  const int len = kLenBase[sym] + (int)((v >> n) & ((1u << x) - 1));
  consume(d, s, n + x);
  const uint32_t v2 = peek(d);
  const int ds = dist_symbol(s, v2, &n);
  if (ds < 0 || ds >= 30) return finish(d, s, kBadCode), -1;
  const int dx = kDistExtra[ds];
  const int dist = kDistBase[ds] + (int)((v2 >> n) & ((1u << dx) - 1));
  if (dist > d.pos) return finish(d, s, kBadDist), -1;
  if (d.pos + len > d.usz) return finish(d, s, kOverrun), -1;
  if (d.pos + len > d.wlim) {
    d = at;
    return 0;
  }
  consume(d, s, n + dx);
  queue_match(d, len, dist);
  return 1;
}

// Huffman-coded symbols until the batch must end or the block does.
// Returns false when the batch ends (a limit or a failure).
BGZF_DEV bool huffman(Dec& d, Smem& s) {
  for (;;) {
    // the fast path: literals, literal pairs and matches from the
    // tables. The next lookup is issued as soon as its bits are known,
    // before the bytes and the bookkeeping of this one; the limits are
    // compares off the lookups' dependency chain.
    uint32_t e = s.lit[peek(d) & ((1u << kLitBits) - 1)];
    while (d.pos + 2 <= d.wlim && d.k <= d.klim && d.qn < kQueue) {
      const uint32_t kind = (e >> 5) & 7;
      if (kind <= kPair) {
        // at most 11 bits, so the next lookup's bits are in bb already
        d.bb >>= e & 31;
        d.bc -= (int)(e & 31);
        const uint32_t next = s.lit[peek(d) & ((1u << kLitBits) - 1)];
        refill(d, s);
        s.hist[(d.pos + d.sh) & (kHist - 1)] = (uint8_t)(e >> 16);
        // (not for a single literal: the slot holds the byte 32 KiB
        // back, which the next symbol may copy)
        if (kind)
          s.hist[(d.pos + 1 + d.sh) & (kHist - 1)] = (uint8_t)(e >> 24);
        d.pos += 1 + (int)kind;
        e = next;
        continue;
      }
      if (kind != kLen) break;
      // a match: its length and distance read from bb as it stands,
      // with no refill between them (a match whose bits run past bb's
      // goes to the careful decode), and taken once every check passed
      const int n = (int)(e & 31), x = (int)((e >> 13) & 7), lb = n + x;
      const uint32_t v = (uint32_t)(d.bb >> lb);
      const uint32_t de = s.dist[v & ((1u << kDistBits) - 1)];
      const int len = (int)((e >> 16) & 511) +
                      (int)((peek(d) >> n) & ((1u << x) - 1));
      const int dn = (int)(de & 15), dx = (int)((de >> 4) & 15);
      const int taken = lb + dn + dx;
      const int dist =
          (int)((de >> 8) & 0xffff) + (int)((v >> dn) & ((1u << dx) - 1));
      if ((de & (kDistSlow | kDistInvalid)) || taken > d.bc ||
          dist > d.pos || d.pos + len > d.wlim)
        break;
      consume(d, s, taken);
      e = s.lit[peek(d) & ((1u << kLitBits) - 1)];
      queue_match(d, len, dist);
    }
    const int r = careful(d, s);
    if (r <= 0) return false;
    if (d.mode == kHeader) return true;
  }
}

// Lane 0: decode until the warp has work (tables to fill, a stored run to
// copy) or the batch ends; the command goes to s.
BGZF_DEV void step(Dec& d, Smem& s) {
  s.cmd = kYield;
  if (d.status >= 0) return;
  for (;;) {
    if (d.mode == kHeader) {
      if (d.last) {
        // the bits taken must lie within the payload
        const int used = (bit_pos(d) + 7) >> 3;
        return finish(d, s, used > d.pend ? kOverrun
                          : d.pos == d.usz ? kOk : kShort);
      }
      if (!d.all && (bit_pos(d) >> 3) + kHeaderAhead > d.staged) return;
      d.last = bits(d, s, 1) != 0;
      const int type = (int)bits(d, s, 2);
      if (type == 0) {  // stored: byte-aligned LEN, NLEN, then the bytes
        consume(d, s, d.bc & 7);
        if ((bit_pos(d) >> 3) + 4 > d.pend) return finish(d, s, kOverrun);
        const unsigned n = bits(d, s, 16), nn = bits(d, s, 16);
        if (n != (~nn & 0xffffu)) return finish(d, s, kBadCode);
        if (d.pos + (int)n > d.usz || (bit_pos(d) >> 3) + (int)n > d.pend)
          return finish(d, s, kOverrun);
        d.rem = (int)n;
        if (n) d.mode = kStored;  // an empty stored block is only its header
        continue;
      }
      if (type == 3) return finish(d, s, kBadCode);
      int nlen = 288, ndist = 32;
      if (type == 1) {
        for (int i = 0; i < 144; i++) s.lens[i] = 8;
        for (int i = 144; i < 256; i++) s.lens[i] = 9;
        for (int i = 256; i < 280; i++) s.lens[i] = 7;
        for (int i = 280; i < 288; i++) s.lens[i] = 8;
        for (int i = 288; i < 320; i++) s.lens[i] = 5;
      } else if (!dynamic_lens(d, s, &nlen, &ndist)) {
        return finish(d, s, kBadCode);
      }
      if (!build(s.lens, nlen, s.lcount, s.lsym, false) ||
          !build(s.lens + nlen, ndist, s.dcount, s.dsym, false))
        return finish(d, s, kBadCode);
      d.mode = kHuffman;
      s.cmd = kBuild;
      return;
    }
    if (d.mode == kStored) {
      const int at = bit_pos(d) >> 3;
      int n = imin(d.rem, d.wlim - d.pos);
      if (!d.all) n = imin(n, d.staged - at);
      if (n <= 0) return;
      s.cmd = kCopy;
      s.a = d.pos + d.sh;
      s.b = d.rb + at;
      s.c = n;
      d.pos += n;
      d.rem -= n;
      seek(d, s, 8 * (at + n));
      if (d.rem == 0) d.mode = kHeader;
      return;
    }
    if (!huffman(d, s)) return;
  }
}

// The literal/length entry of symbol `sym`, its code `len` bits long.
BGZF_DEV uint32_t lit_entry(int sym, int len) {
  const uint32_t head = (uint32_t)len | (uint32_t)len << 8;
  if (sym < 256) return head | kLit << 5 | (uint32_t)sym << 16;
  if (sym == 256) return head | kEob << 5 | 256u << 16;
  if (sym < 286) {
    const int i = sym - 257;
    return head | kLen << 5 | (uint32_t)kLenExtra[i] << 13 |
           (uint32_t)kLenBase[i] << 16 | (uint32_t)i << 25;
  }
  return head | kInvalid << 5 | (uint32_t)sym << 16;
}

BGZF_DEV uint32_t dist_entry(int sym, int len) {
  if (sym >= 30) return kDistInvalid | (uint32_t)sym << 24 | (uint32_t)len;
  return (uint32_t)len | (uint32_t)kDistExtra[sym] << 4 |
         (uint32_t)kDistBase[sym] << 8 | (uint32_t)sym << 24;
}

// Fill a direct lookup table from a canonical code: the symbols lane,
// lane + 32, ... of its canonical order, each code's entry at every index
// whose low bits are the code, reversed.
template <bool kLitTable>
BGZF_DEV void fill(uint32_t* table, int table_bits, const uint16_t* count,
                   const uint16_t* symbol, int lane) {
  int offs[16], first[16];
  int o = 0, f = 0;
  for (int l = 1; l < 16; l++) {
    offs[l] = o;
    first[l] = f;
    o += count[l];
    f = (f + count[l]) << 1;
  }
  int l = 1;
  for (int i = lane; i < o; i += 32) {
    while (i >= offs[l] + count[l]) l++;
    if (l > table_bits) break;  // canonical order: longer codes follow
    const int sym = symbol[i];
    const uint32_t e = kLitTable ? lit_entry(sym, l) : dist_entry(sym, l);
    for (unsigned j = reverse_bits((unsigned)(first[l] + i - offs[l]), l);
         j < (1u << table_bits); j += 1u << l)
      table[j] = e;
  }
}

// The literal/length and distance tables of the codes in lcount/lsym and
// dcount/dsym, with the warp; then a literal whose code leaves room for a
// second literal's takes both.
template <class W>
BGZF_DEV void fill_tables(const W& w, Smem& s) {
  w.each([&](int lane) {
    for (int i = lane; i < (1 << kLitBits); i += 32) s.lit[i] = kSlow << 5;
    for (int i = lane; i < (1 << kDistBits); i += 32) s.dist[i] = kDistSlow;
  });
  w.sync();
  w.each([&](int lane) {
    fill<true>(s.lit, kLitBits, s.lcount, s.lsym, lane);
    fill<false>(s.dist, kDistBits, s.dcount, s.dsym, lane);
  });
  w.sync();
  // an entry read here may already be a pair: its first literal and that
  // code's length (bits 8-12) are those of the single entry it was
  w.each([&](int lane) {
    for (int j = lane; j < (1 << kLitBits); j += 32) {
      const uint32_t e = s.lit[j];
      const int l1 = (int)(e & 31);
      if (((e >> 5) & 7) != kLit || l1 >= kLitBits) continue;
      const uint32_t e2 = s.lit[j >> l1];
      const int l2 = (int)((e2 >> 8) & 31);
      if (((e2 >> 5) & 7) > kPair || l1 + l2 > kLitBits) continue;
      s.lit[j] = (uint32_t)(l1 + l2) | kPair << 5 | (uint32_t)l1 << 8 |
                 (e & 0xff0000u) | ((e2 >> 16) & 255) << 24;
    }
  });
  w.sync();
}

// Decoder warp: one batch of symbols into queue half `half`.
template <class W>
BGZF_DEV void decode_phase(const W& w, Smem& s, Dec& d, int half) {
  if (w.leader()) {
    d.q = s.queue[half];
    d.qn = 0;
    d.staged = s.staged[half ^ 1];
    d.all = d.staged >= ((d.pend + 15) & ~15);
    d.klim = d.all ? (d.pend >> 2) + 4
                   : imin(d.staged / 4 - 5, d.k + kBatchWords);
    d.src_pend = d.src_cur;
    d.src_cur = kFar;
    // a slot is written only once its byte is flushed and no queued match
    // reads it
    d.wlim = imin(d.usz, imin(16 * s.flushed[half ^ 1] - d.sh + kHist,
                              d.src_pend + kHist));
    // bb again from the ring: a word loaded ahead in the last batch may
    // have been loaded before the ring held it
    seek(d, s, bit_pos(d));
  }
  for (;;) {
    if (w.leader()) step(d, s);
    w.sync();
    const int cmd = s.cmd, a = s.a, b = s.b, c = s.c;
    if (cmd == kBuild) {
      fill_tables(w, s);
    } else if (cmd == kCopy) {  // a stored run of c bytes
      w.each([&](int lane) {
        for (int i = lane; i < c; i += 32)
          s.hist[(a + i) & (kHist - 1)] = s.ring[(b + i) & (kRing - 1)];
      });
    } else {
      break;
    }
    w.sync();
  }
  if (w.leader()) {
    s.qn[half] = d.qn;
    s.end[half] = d.pos;
    s.keep[half] = (bit_pos(d) >> 3) & ~3;
    s.status[half] = d.status;
  }
}

// The copy warp's registers (the same in every lane). Offsets as Dec's.
struct Cop {
  const uint8_t* src;  // payload offset 0 in comp
  uint8_t* dst;        // the block's output
  int rb, sh, usz;
  int end16;           // payload end rounded up to 16
  int issued;          // payload bytes asked of the host
  int lines;           // output lines flushed
};

// Flush output lines [lo, hi) of the ring: 16-byte stores where a whole
// line lies in the block, bytes at its two ends.
template <class W>
BGZF_DEV void flush(const W& w, const Smem& s, const Cop& c, int lo, int hi) {
  w.each([&](int lane) {
    for (int l = lo + lane; l < hi; l += 32) {
      const int u = 16 * l;
      if (u >= c.sh && u + 16 <= c.sh + c.usz) {
        *reinterpret_cast<Vec16*>(c.dst + (u - c.sh)) =
            *reinterpret_cast<const Vec16*>(&s.hist[u & (kHist - 1)]);
      } else {
        const int e = imin(u + 16, c.sh + c.usz);
        for (int i = u < c.sh ? c.sh : u; i < e; i++)
          c.dst[i - c.sh] = s.hist[i & (kHist - 1)];
      }
    }
  });
}

// Stage payload bytes [c.issued, lim) into the ring, 16 at a time.
template <class W>
BGZF_DEV void refill(const W& w, Smem& s, Cop& c, int lim) {
  const int from = c.issued;
  w.each([&](int lane) {
    for (int q = from + 16 * lane; q < lim; q += 16 * 32)
      stage16(&s.ring[(c.rb + q) & (kRing - 1)], c.src + q);
    stage_commit();
  });
  c.issued = lim;
}

// Copy warp: the last batch's matches in queue order, its finished lines
// out, and the payload the decoder has released refilled.
template <class W>
BGZF_DEV void copy_phase(const W& w, Smem& s, Cop& c, int half) {
  stage_wait();  // the refill of the last phase
  w.sync();
  const int staged = c.issued;
  const int lim = imin(c.end16, (s.keep[half ^ 1] & ~15) + kRing);
  if (lim > c.issued && (lim - c.issued >= kRefillMin || lim == c.end16))
    refill(w, s, c, lim);
  const int n = s.qn[half ^ 1];
  const Match* q = s.queue[half ^ 1];
  Match next = q[0];
  for (int i = 0; i < n; i++) {
    const Match m = next;
    if (i + 1 < n) next = q[i + 1];  // loaded ahead of the copy
    const int to = (int)(m.a & 0x1ffff) + c.sh, len = (int)(m.a >> 17);
    const int dist = (int)m.dist;
    if (dist > kHist - len) {
      // the ring's wrap: byte j lands where byte j - (kHist - dist) of
      // the source was, so one lane copies them in order
      if (w.leader())
        for (int j = 0; j < len; j++)
          s.hist[(to + j) & (kHist - 1)] =
              s.hist[(to - dist + j) & (kHist - 1)];
    } else {
      w.each([&](int lane) {
        if (dist >= len) {  // two bytes a lane in flight at once
          for (int j = lane; j < len; j += 64) {
            const uint8_t b0 = s.hist[(to - dist + j) & (kHist - 1)];
            const uint8_t b1 = j + 32 < len
                                   ? s.hist[(to - dist + j + 32) & (kHist - 1)]
                                   : 0;
            s.hist[(to + j) & (kHist - 1)] = b0;
            if (j + 32 < len) s.hist[(to + j + 32) & (kHist - 1)] = b1;
          }
        } else {  // overlapping: the pattern of the last dist bytes repeats
          for (int j = lane; j < len; j += 32)
            s.hist[(to + j) & (kHist - 1)] =
                s.hist[(to - dist + j % dist) & (kHist - 1)];
        }
      });
    }
    w.sync();
  }
  const int lines = (s.end[half ^ 1] + c.sh) >> 4;
  flush(w, s, c, c.lines, lines);
  c.lines = lines;
  w.sync();
  if (w.leader()) {
    s.staged[half] = staged;
    s.flushed[half] = lines;
  }
}

// Inflate one BGZF block, t = its table row, with the CTA's warps w.
template <class W>
BGZF_DEV void inflate_block(const W& w, Smem& s, const uint8_t* comp,
                            const long long* t, uint8_t* out, int* status) {
  const long long p0 = t[0], plen = t[1], usz = t[3];
  uint8_t* dst = out + t[2];
  if (plen < 0 || plen > kMaxOut || usz < 0 || usz > kMaxOut) {
    if (w.decoder() && w.leader()) *status = kOverrun;
    return;
  }
  const long long base = p0 & ~15ll;
  const int start = (int)(p0 - base), pend = start + (int)plen;
  const int rb = (int)(base & (kRing - 1));
  const int sh = (int)((uintptr_t)dst & 15);
  Cop c;
  Dec d;
  if (w.copier()) {
    c.src = comp + base;
    c.dst = dst;
    c.rb = rb;
    c.sh = sh;
    c.usz = (int)usz;
    c.end16 = (pend + 15) & ~15;
    c.issued = 0;
    c.lines = 0;
    refill(w, s, c, imin(c.end16, kRing));
    stage_wait();
    if (w.leader()) {
      s.staged[1] = c.issued;
      s.flushed[1] = 0;
      s.keep[1] = start & ~3;
      s.qn[1] = 0;
      s.end[1] = 0;
    }
  }
  if (w.decoder() && w.leader()) {
    d.k = start >> 2;  // bit_pos 8 * start: the first batch seeks there
    d.bc = 32 * d.k - 8 * start;
    d.pend = pend;
    d.rb = rb;
    d.sh = sh;
    d.pos = 0;
    d.usz = (int)usz;
    d.mode = kHeader;
    d.rem = 0;
    d.last = false;
    d.src_cur = kFar;
    d.status = -1;
  }
  w.barrier();
  int half = 0, st, tail = 0;
  for (;;) {
    if (w.decoder()) decode_phase(w, s, d, half);
    if (w.copier()) copy_phase(w, s, c, half);
    w.barrier();
    // (a slot of its own: the decoder may write the next before the copy
    // warp reads this one)
    st = s.status[half];
    // a block that inflated ends after one more copy phase
    if (st > kOk || (st == kOk && ++tail == 2)) break;
    half ^= 1;
  }
  if (w.copier()) {
    if (st == kOk) flush(w, s, c, c.lines, (c.sh + c.usz + 15) >> 4);
    stage_wait();
  }
  if (w.decoder() && w.leader()) *status = st;
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(64)
    bgzf_inflate_kernel(const uint8_t* comp, const long long* table,
                        uint8_t* out, int* status) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem& s = *reinterpret_cast<Smem*>(smem);
  const Warp w{(int)threadIdx.x & 31, (int)threadIdx.x >> 5};
  inflate_block(w, s, comp, table + 4 * (long long)blockIdx.x, out,
                status + blockIdx.x);
}

// The kernel's shared memory and carveout.
cudaError_t configure() {
  cudaError_t err = cudaFuncSetAttribute(
      bgzf_inflate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(bgzf_inflate_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}
#endif

}  // namespace

extern "C" {

// Shared memory one block's CTA takes.
int bgzf_inflate_smem_bytes() { return (int)sizeof(Smem); }

#ifdef __CUDACC__
// CTAs that fit on an SM of card `device`, or minus (the CUDA error plus
// 1000 times the step: 1 the card, 6 the shared-memory attributes, 8 the
// occupancy query).
int bgzf_inflate_occupancy(int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(1000 + (int)err);
  err = configure();
  if (err != cudaSuccess) return -(6000 + (int)err);
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, bgzf_inflate_kernel, 64, sizeof(Smem));
  if (err != cudaSuccess) return -(8000 + (int)err);
  return ctas;
}

// Launch the inflate of n blocks on card `device`, on `stream` (a stream
// of that card); returns 0, or the first CUDA error plus 1000 times the
// step that met it (1 the card, 2-5 the mapped addresses of comp, table,
// out and status, 6 the shared-memory attributes, 7 the launch). comp,
// table, out and status are pinned host memory, whose mapped addresses
// the card takes (out may be null when every ISIZE is 0), or the card's
// own memory (scripts/inflate_ab.py times the kernel so, without the host
// link). comp must be 16-byte aligned and readable 16 bytes past the last
// payload. The library links its own static runtime, so the caller names
// the card, as for sweep_scan_launch.
int bgzf_inflate_launch(const void* comp, const void* table, void* out,
                        void* status, long long n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return 1000 + (int)err;
  if (n <= 0) return 0;
  void* host[4] = {const_cast<void*>(comp), const_cast<void*>(table), out,
                   status};
  void* mapped[4] = {nullptr, nullptr, nullptr, nullptr};
  for (int i = 0; i < 4; i++) {
    if (!host[i]) continue;
    cudaPointerAttributes at;
    err = cudaPointerGetAttributes(&at, host[i]);
    if (err != cudaSuccess) return 1000 * (2 + i) + (int)err;
    if (at.type == cudaMemoryTypeDevice) {  // the card's own memory
      mapped[i] = host[i];
      continue;
    }
    err = cudaHostGetDevicePointer(&mapped[i], host[i], 0);
    if (err != cudaSuccess) return 1000 * (2 + i) + (int)err;
  }
  err = configure();
  if (err != cudaSuccess) return 6000 + (int)err;
  bgzf_inflate_kernel<<<(unsigned)n, 64, sizeof(Smem),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mapped[0]),
      static_cast<const long long*>(mapped[1]),
      static_cast<uint8_t*>(mapped[2]), static_cast<int*>(mapped[3]));
  err = cudaGetLastError();
  return err == cudaSuccess ? 0 : 7000 + (int)err;
}
#else
// The same decoder on the host, one block after another (tests only).
int bgzf_inflate_host(const uint8_t* comp, const long long* table,
                      uint8_t* out, int* status, long long n) {
  Smem* s = new Smem;
  const Warp w{};
  for (long long b = 0; b < n; b++)
    inflate_block(w, *s, comp, table + 4 * b, out, status + b);
  delete s;
  return 0;
}
#endif

}  // extern "C"
