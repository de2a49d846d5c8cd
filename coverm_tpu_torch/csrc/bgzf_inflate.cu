// BGZF inflate for Hopper (sm_90a): a raw-DEFLATE (RFC 1951) decoder for a
// batch of independent BGZF blocks, one warp a block.
//
// Takes over the inflate of the fused BAM ingest from the host
// (coverm_tpu_torch/native/bamdecode.cpp, ct_ingest_scan's inflate_drain:
// libdeflate or zlib, one 64 KiB block at a time on 8 threads). It is not
// the port of a TPU kernel: the JAX package inflates on the host too.
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
// allocates no device memory.
//
// Bound: each byte of the payloads is read once and each inflated byte
// written once, over the host link (PCIe Gen5 x16, about 63 GB/s each way,
// published): 5.50 GB out a pass of the benchmark's 20 M-read BAM is
// about 0.09 s. Within the card, the decode is a chain of dependent
// Huffman lookups, one symbol at a time.
//
// Design:
//   - one CTA of one warp a BGZF block: the whole output window (at most
//     64 KiB) in shared memory, so every back-reference is a shared-memory
//     read; three CTAs fit on an SM;
//   - the payload streams through a 4 KiB ring in shared memory, refilled
//     by the warp with 16-byte loads whenever less than half of it is
//     ahead of the decoder;
//   - lane 0 decodes the bit stream, its 64-bit buffer refilled from
//     three aligned ring words at a time: literals straight into the
//     window, stopping at each match (length, distance), stored run or
//     new Huffman table, which the warp then copies or builds together;
//   - the decode tables: a 10-bit (literal/length) and an 8-bit
//     (distance) direct lookup filled by the warp, and puff's canonical
//     count/symbol decode for the longer codes;
//   - the finished window goes out with 16-byte stores: it sits in shared
//     memory at the output's own alignment modulo 16.
//
// The same source builds for the host with g++ (no __CUDACC__), each warp
// phase run lane by lane, so the CPU tests can hold this decoder against
// zlib: bgzf_inflate_host.

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

constexpr int kMaxOut = 65536;  // BGZF's largest ISIZE
constexpr int kRing = 4096;     // staged payload bytes (a power of two)
constexpr int kLitBits = 10;    // direct lookup of literal/length codes
constexpr int kDistBits = 8;    // direct lookup of distance codes
constexpr int kHeaderAhead = 640;  // bytes a block header may take, at most

enum Status { kOk = 0, kBadCode = 1, kBadDist = 2, kOverrun = 3, kShort = 4 };
enum Cmd { kDone, kRefill, kMatch, kCopy, kBuild };
enum Mode { kHeader, kHuffman, kStored };

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

// One CTA's shared memory (73,904 bytes).
struct alignas(16) Smem {
  uint8_t out[kMaxOut + 16];  // the output window, shifted to its alignment
  uint8_t ring[kRing];        // payload byte q at ring[q % kRing]
  uint16_t lfast[1 << kLitBits];   // (length << 9) | symbol, 0: slow path
  uint16_t dfast[1 << kDistBits];
  uint16_t lcount[16], dcount[16];  // codes of each length
  uint16_t lsym[288], dsym[32];     // symbols in canonical order
  uint16_t code[288 + 32];          // each symbol's code (distance at 288)
  uint8_t lens[288 + 32];           // code lengths (distance after nlen)
  long long keep;  // the lowest payload byte (absolute) still to be read
  long long src;   // kCopy: the first ring byte (absolute)
  int cmd, a, b, c;
};

#ifdef __CUDACC__
struct Warp {
  int lane;
  BGZF_DEV bool leader() const { return lane == 0; }
  BGZF_DEV void sync() const { __syncwarp(); }
  template <class F>
  BGZF_DEV void each(F f) const { f(lane); }
};
typedef uint4 Vec16;
BGZF_DEV unsigned reverse_bits(unsigned code, int len) {
  return __brev(code) >> (32 - len);
}
#else
struct Warp {  // the host build: one thread runs each phase lane by lane
  bool leader() const { return true; }
  void sync() const {}
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
#endif

// The decoding lane's state.
struct Dec {
  uint64_t bb;     // bit buffer, next bit lowest
  int bc;          // bits in bb
  int ip;          // payload bytes pulled into bb (zeros past the end)
  int len;         // payload length (at most 64 KiB)
  int r0;          // the payload's first byte's place in the ring
  long long p0;    // payload start (absolute offset in comp)
  int pos;         // bytes written
  int usz;         // ISIZE
  int mode;
  int rem;         // bytes left of a stored block
  bool last;       // the final block's header has been read
};

// Top the bit buffer up to 57-64 bits. Where 12 payload bytes lie
// ahead within the ring's span, in one go from three aligned 32-bit
// words, taking the whole bytes that fit; else a byte at a time, zeros
// past the payload's end.
BGZF_DEV void pull(Dec& d, const Smem& s) {
  if (d.bc > 56) return;
  const int r = (d.r0 + d.ip) & (kRing - 1);
  if (d.ip + 12 <= d.len && r <= kRing - 12) {
    const uint32_t* w =
        reinterpret_cast<const uint32_t*>(&s.ring[r & ~3]);
    const uint64_t lo = (uint64_t)w[1] << 32 | w[0];
    const int sh = (r & 3) * 8;
    const uint64_t v = sh ? lo >> sh | (uint64_t)w[2] << (64 - sh) : lo;
    const int k = (63 - d.bc) >> 3;  // whole bytes that fit, 1 to 7
    d.bb |= (v & ((1ull << (8 * k)) - 1)) << d.bc;
    d.ip += k;
    d.bc += 8 * k;
    return;
  }
  while (d.bc <= 56) {
    uint64_t byte = d.ip < d.len ? s.ring[(d.r0 + d.ip) & (kRing - 1)] : 0;
    d.bb |= byte << d.bc;
    d.ip++;
    d.bc += 8;
  }
}

BGZF_DEV unsigned bits(Dec& d, int n) {
  unsigned v = (unsigned)(d.bb & ((1ull << n) - 1));
  d.bb >>= n;
  d.bc -= n;
  return v;
}

// One Huffman symbol, or -1 for a code that decodes to none; bc >= 15.
BGZF_DEV int decode(Dec& d, const uint16_t* fast, int fast_bits,
                    const uint16_t* count, const uint16_t* symbol) {
  if (fast) {
    unsigned e = fast[d.bb & ((1u << fast_bits) - 1)];
    if (e) {
      int n = (int)(e >> 9);
      d.bb >>= n;
      d.bc -= n;
      return (int)(e & 511);
    }
  }
  // canonical decode, one bit at a time (puff.c)
  int code = 0, first = 0, index = 0;
  uint64_t b = d.bb;
  for (int len = 1; len <= 15; len++) {
    code |= (int)(b & 1);
    b >>= 1;
    int n = count[len];
    if (code - n < first) {
      d.bb = b;
      d.bc -= len;
      return symbol[index + (code - first)];
    }
    index += n;
    first = (first + n) << 1;
    code <<= 1;
  }
  return -1;
}

// Counts, canonically ordered symbols and each symbol's code for n code
// lengths, under zlib's rules (inflate_table): an over-subscribed set
// fails; an incomplete one fails unless it is a single code of length 1
// (code-length codes: never), and no code at all is a table that decodes
// nothing.
BGZF_DEV bool build(const uint8_t* lens, int n, uint16_t* count,
                    uint16_t* symbol, uint16_t* code, bool cl_codes) {
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
  uint16_t offs[16], next[16];
  offs[1] = 0;
  for (int l = 1; l < 15; l++) offs[l + 1] = offs[l] + count[l];
  unsigned c = 0;
  next[0] = 0;
  for (int l = 1; l < 16; l++) {
    c = (c + (l > 1 ? count[l - 1] : 0)) << 1;
    next[l] = (uint16_t)c;
  }
  for (int s = 0; s < n; s++) {
    int l = lens[s];
    if (l) {
      symbol[offs[l]++] = (uint16_t)s;
      if (code) code[s] = next[l]++;
    }
  }
  return true;
}

BGZF_DEV void done(Smem& s, int status) {
  s.cmd = kDone;
  s.a = status;
}

// A dynamic block's header (RFC 1951 §3.2.7) into s.lens; false when bad.
BGZF_DEV bool dynamic_lens(Dec& d, Smem& s, int* nlen, int* ndist) {
  pull(d, s);
  *nlen = (int)bits(d, 5) + 257;
  *ndist = (int)bits(d, 5) + 1;
  int ncode = (int)bits(d, 4) + 4;
  if (*nlen > 286 || *ndist > 30) return false;
  uint8_t cl[19];
  for (int i = 0; i < 19; i++) cl[i] = 0;
  for (int i = 0; i < ncode; i++) {
    if (d.bc < 3) pull(d, s);
    cl[kClOrder[i]] = (uint8_t)bits(d, 3);
  }
  // the code-length code lives in the distance arrays until they are built
  if (!build(cl, 19, s.dcount, s.dsym, nullptr, true)) return false;
  int total = *nlen + *ndist;
  for (int i = 0; i < total;) {
    pull(d, s);
    int sym = decode(d, nullptr, 0, s.dcount, s.dsym);
    if (sym < 0) return false;
    if (sym < 16) {
      s.lens[i++] = (uint8_t)sym;
      continue;
    }
    int val = 0, rep;
    if (sym == 16) {
      if (i == 0) return false;
      val = s.lens[i - 1];
      rep = 3 + (int)bits(d, 2);
    } else if (sym == 17) {
      rep = 3 + (int)bits(d, 3);
    } else {
      rep = 11 + (int)bits(d, 7);
    }
    if (i + rep > total) return false;
    while (rep--) s.lens[i++] = (uint8_t)val;
  }
  return s.lens[256] != 0;  // a block must be able to end
}

// Lane 0: decode until the warp has work (a match, a stored run, tables to
// fill), the ring runs low, or the block is done; the command goes to s.
// `hi` is the absolute end of the staged payload bytes.
BGZF_DEV void step(Dec& d, Smem& s, uint8_t* win, long long hi) {
  const bool all = hi >= d.p0 + d.len;
  for (;;) {
    if (d.mode == kHeader) {
      if (d.last) {
        if (d.ip * 8 - d.bc > d.len * 8) return done(s, kOverrun);
        return done(s, d.pos == d.usz ? kOk : kShort);
      }
      if (!all && d.p0 + d.ip + kHeaderAhead > hi) {
        s.cmd = kRefill;
        break;
      }
      pull(d, s);
      d.last = bits(d, 1) != 0;
      int type = (int)bits(d, 2);
      if (type == 0) {  // stored: byte-aligned LEN, NLEN, then the bytes
        bits(d, d.bc & 7);
        d.ip -= d.bc >> 3;
        d.bb = 0;
        d.bc = 0;
        if (d.ip + 4 > d.len) return done(s, kOverrun);
        long long q = d.p0 + d.ip;
        unsigned n = s.ring[q & (kRing - 1)] |
                     (s.ring[(q + 1) & (kRing - 1)] << 8);
        unsigned nn = s.ring[(q + 2) & (kRing - 1)] |
                      (s.ring[(q + 3) & (kRing - 1)] << 8);
        d.ip += 4;
        if (n != (~nn & 0xffffu)) return done(s, kBadCode);
        if (d.pos + (int)n > d.usz || d.ip + (int)n > d.len)
          return done(s, kOverrun);
        d.rem = (int)n;
        if (n) d.mode = kStored;  // an empty stored block is only its header
        continue;
      }
      if (type == 3) return done(s, kBadCode);
      int nlen = 288, ndist = 32;
      if (type == 1) {
        for (int i = 0; i < 144; i++) s.lens[i] = 8;
        for (int i = 144; i < 256; i++) s.lens[i] = 9;
        for (int i = 256; i < 280; i++) s.lens[i] = 7;
        for (int i = 280; i < 288; i++) s.lens[i] = 8;
        for (int i = 288; i < 320; i++) s.lens[i] = 5;
      } else if (!dynamic_lens(d, s, &nlen, &ndist)) {
        return done(s, kBadCode);
      }
      if (!build(s.lens, nlen, s.lcount, s.lsym, s.code, false) ||
          !build(s.lens + nlen, ndist, s.dcount, s.dsym, s.code + 288,
                 false))
        return done(s, kBadCode);
      d.mode = kHuffman;
      s.cmd = kBuild;
      s.a = nlen;
      s.b = ndist;
      break;
    }
    if (d.mode == kStored) {
      long long avail = hi - (d.p0 + d.ip);
      int n = avail < d.rem ? (int)(avail > 0 ? avail : 0) : d.rem;
      if (n == 0) {
        s.cmd = kRefill;
        break;
      }
      s.cmd = kCopy;
      s.a = d.pos;
      s.src = d.p0 + d.ip;
      s.c = n;
      d.ip += n;
      d.pos += n;
      d.rem -= n;
      if (d.rem == 0) d.mode = kHeader;
      break;
    }
    // Huffman-coded symbols: literals here, a match to the warp. Past
    // ip_max either the ring needs bytes (16 a symbol at most) or the
    // stream has read beyond its payload.
    const int ip_max = all ? d.len + 8 : (int)(hi - d.p0) - 16;
    bool to_warp = false;
    for (;;) {
      if (d.ip > ip_max) {
        if (all) return done(s, kOverrun);
        s.cmd = kRefill;
        to_warp = true;
        break;
      }
      pull(d, s);
      int sym = decode(d, s.lfast, kLitBits, s.lcount, s.lsym);
      if (sym < 256) {
        if (sym < 0) return done(s, kBadCode);
        if (d.pos >= d.usz) return done(s, kOverrun);
        win[d.pos++] = (uint8_t)sym;
        continue;
      }
      if (sym == 256) {
        d.mode = kHeader;
        break;
      }
      sym -= 257;
      if (sym >= 29) return done(s, kBadCode);
      int len = kLenBase[sym] + (int)bits(d, kLenExtra[sym]);
      int ds = decode(d, s.dfast, kDistBits, s.dcount, s.dsym);
      if (ds < 0 || ds >= 30) return done(s, kBadCode);
      int dist = kDistBase[ds] + (int)bits(d, kDistExtra[ds]);
      if (dist > d.pos) return done(s, kBadDist);
      if (d.pos + len > d.usz) return done(s, kOverrun);
      s.cmd = kMatch;
      s.a = d.pos;
      s.b = dist;
      s.c = len;
      d.pos += len;
      to_warp = true;
      break;
    }
    if (to_warp) break;
  }
  // the bytes still in the bit buffer count as unread: a stored block's
  // header rewinds to them and reads them from the ring again
  s.keep = d.p0 + d.ip - ((d.bc + 7) >> 3);
}

// Fill a direct lookup table for the symbols lane, lane + 32, ...
BGZF_DEV void fill(uint16_t* fast, int fast_bits, const uint8_t* lens,
                   const uint16_t* code, int n, int lane) {
  for (int s = lane; s < n; s += 32) {
    int l = lens[s];
    if (l == 0 || l > fast_bits) continue;
    uint16_t e = (uint16_t)((l << 9) | s);
    for (unsigned j = reverse_bits(code[s], l); j < (1u << fast_bits);
         j += 1u << l)
      fast[j] = e;
  }
}

// Inflate one BGZF block, t = its table row, with the warp w.
template <class W>
BGZF_DEV void inflate_block(const W& w, Smem& s, const uint8_t* comp,
                            const long long* t, uint8_t* out, int* status) {
  const long long p0 = t[0], plen = t[1], usz = t[3];
  uint8_t* dst = out + t[2];
  if (plen < 0 || plen > kMaxOut || usz < 0 || usz > kMaxOut) {
    if (w.leader()) *status = kOverrun;
    return;
  }
  uint8_t* win = s.out + ((uintptr_t)dst & 15);
  const long long end = p0 + plen;
  const long long end16 = (end + 15) & ~15ll;
  long long hi = p0 & ~15ll;  // staged payload bytes end here (absolute)
  long long keep = p0;
  Dec d;
  if (w.leader()) {
    d.bb = 0;
    d.bc = 0;
    d.ip = 0;
    d.p0 = p0;
    d.r0 = (int)(p0 & (kRing - 1));
    d.len = (int)plen;
    d.pos = 0;
    d.usz = (int)usz;
    d.mode = kHeader;
    d.rem = 0;
    d.last = false;
  }
  int st;
  for (;;) {
    // top the ring up when less than half of it is ahead of the reader;
    // it never overwrites a byte at or after `keep`
    if (hi < end && hi - keep < kRing / 2) {
      const long long lim =
          end16 < (keep & ~15ll) + kRing ? end16 : (keep & ~15ll) + kRing;
      const long long from = hi;
      w.each([&](int lane) {
        for (long long q = from + 16 * lane; q < lim; q += 16 * 32)
          *reinterpret_cast<Vec16*>(&s.ring[q & (kRing - 1)]) =
              *reinterpret_cast<const Vec16*>(comp + q);
      });
      hi = lim;
      w.sync();
    }
    if (w.leader()) step(d, s, win, hi);
    w.sync();
    const int cmd = s.cmd, a = s.a, b = s.b, c = s.c;
    const long long src = s.src;
    keep = s.keep;
    if (cmd == kDone) {
      st = a;
      break;
    }
    if (cmd == kMatch) {  // c bytes at a from distance b back
      w.each([&](int lane) {
        if (b >= c) {
          for (int i = lane; i < c; i += 32) win[a + i] = win[a - b + i];
        } else {  // overlapping: the pattern of the last b bytes repeats
          for (int i = lane; i < c; i += 32) win[a + i] = win[a - b + i % b];
        }
      });
    } else if (cmd == kCopy) {  // a stored run of c bytes
      w.each([&](int lane) {
        for (int i = lane; i < c; i += 32)
          win[a + i] = s.ring[(src + i) & (kRing - 1)];
      });
    } else if (cmd == kBuild) {  // a literal/length and b distance codes
      w.each([&](int lane) {
        for (int i = lane; i < (1 << kLitBits); i += 32) s.lfast[i] = 0;
        for (int i = lane; i < (1 << kDistBits); i += 32) s.dfast[i] = 0;
      });
      w.sync();
      w.each([&](int lane) {
        fill(s.lfast, kLitBits, s.lens, s.code, a, lane);
        fill(s.dfast, kDistBits, s.lens + a, s.code + 288, b, lane);
      });
    }
    w.sync();
  }
  if (st == kOk) {
    // 16-byte stores where a whole aligned 16 bytes of the output lie in
    // this block, bytes at its two ends
    const uintptr_t d0 = (uintptr_t)dst, a0 = d0 & ~(uintptr_t)15;
    const long long chunks = (long long)((d0 + usz + 15 - a0) >> 4);
    w.each([&](int lane) {
      for (long long k = lane; k < chunks; k += 32) {
        const long long lo = (long long)(a0 + 16 * k - d0), hi16 = lo + 16;
        if (lo >= 0 && hi16 <= usz) {
          *reinterpret_cast<Vec16*>(dst + lo) =
              *reinterpret_cast<const Vec16*>(win + lo);
        } else {
          for (long long i = lo < 0 ? 0 : lo; i < hi16 && i < usz; i++)
            dst[i] = win[i];
        }
      }
    });
  }
  if (w.leader()) *status = st;
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(32)
    bgzf_inflate_kernel(const uint8_t* comp, const long long* table,
                        uint8_t* out, int* status) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem& s = *reinterpret_cast<Smem*>(smem);
  const Warp w{(int)threadIdx.x};
  inflate_block(w, s, comp, table + 4 * (long long)blockIdx.x, out,
                status + blockIdx.x);
}
#endif

}  // namespace

extern "C" {

// Shared memory one block's CTA takes.
int bgzf_inflate_smem_bytes() { return (int)sizeof(Smem); }

#ifdef __CUDACC__
// Launch the inflate of n blocks on card `device`, on `stream` (a stream
// of that card); returns 0, or the first CUDA error plus 1000 times the
// step that met it (1 the card, 2-5 the mapped addresses of comp, table,
// out and status, 6 the shared-memory size, 7 the launch). comp, table,
// out and status are pinned host memory; the card takes their mapped
// addresses (out may be null when every ISIZE is 0). comp must be
// 16-byte aligned and readable 16 bytes past the last payload. The
// library links its own static runtime, so the caller names the card,
// as for sweep_scan_launch.
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
    err = cudaHostGetDevicePointer(&mapped[i], host[i], 0);
    if (err != cudaSuccess) return 1000 * (2 + i) + (int)err;
  }
  err = cudaFuncSetAttribute(bgzf_inflate_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sizeof(Smem));
  if (err != cudaSuccess) return 6000 + (int)err;
  bgzf_inflate_kernel<<<(unsigned)n, 32, sizeof(Smem),
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
