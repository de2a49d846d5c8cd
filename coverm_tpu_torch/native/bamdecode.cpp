// Native host-side BAM ingestion for coverm-tpu.
//
// Replaces the engine's hottest host loops (the analogue of htslib's role
// in the reference, SURVEY.md §2.2):
//   1. multi-threaded BGZF decompression (each gzip member's output offset
//      is the prefix sum of the ISIZE fields, so blocks inflate in
//      parallel into one buffer);
//   2. the sequential record-offset walk;
//   3. the per-record aux-tag scan (NM / AS) and FNV-1a qname hashing.
//
// Exposed as a plain C ABI consumed via ctypes (io/native.py).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libcovermio.so bamdecode.cpp -lz -lpthread

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#include <zlib.h>

#if defined(USE_LIBDEFLATE) && __has_include(<libdeflate.h>)
#include <libdeflate.h>
#define HAVE_LIBDEFLATE 1
#endif

// Shared bounded aux-tag scanner: walks the aux region [aux, rec_len)
// collecting NM (and AS when want_as).  Returns 0, or -1 on a malformed
// / truncated tag.  *nm stays -1 when absent; *as_score stays
// INT64_MIN.  Every fixed-size value read is bounds-checked against the
// record (fuzz-hardening: a corrupt type byte must not read past it).
static int scan_aux_tags(const uint8_t* rec, int64_t aux, int64_t rec_len,
                         int64_t* nm, int64_t* as_score, bool want_as) {
  *nm = -1;
  *as_score = INT64_MIN;
  if (aux < 0 || aux > rec_len) aux = rec_len;  // corrupt: no aux region
  int found = 0, want = want_as ? 2 : 1;
  while (aux + 3 <= rec_len && found < want) {
    uint8_t t0 = rec[aux], t1 = rec[aux + 1], typ = rec[aux + 2];
    aux += 3;
    int64_t val = 0;
    int has_val = 1;
    switch (typ) {
      case 'A':
      case 'C':
      case 'c': {
        if (aux + 1 > rec_len) return -1;
        val = typ == 'c' ? (int8_t)rec[aux] : rec[aux];
        aux += 1;
        break;
      }
      case 'S':
      case 's': {
        if (aux + 2 > rec_len) return -1;
        uint16_t v = rec[aux] | (rec[aux + 1] << 8);
        val = typ == 's' ? (int16_t)v : v;
        aux += 2;
        break;
      }
      case 'I': {
        if (aux + 4 > rec_len) return -1;
        uint32_t v; memcpy(&v, rec + aux, 4); val = v; aux += 4; break;
      }
      case 'i': {
        if (aux + 4 > rec_len) return -1;
        int32_t v; memcpy(&v, rec + aux, 4); val = v; aux += 4; break;
      }
      case 'f': aux += 4; has_val = 0; break;
      case 'Z':
      case 'H': {
        while (aux < rec_len && rec[aux] != 0) aux++;
        aux++;
        has_val = 0;
        break;
      }
      case 'B': {
        if (aux + 5 > rec_len) return -1;
        uint8_t sub = rec[aux];
        uint32_t cnt; memcpy(&cnt, rec + aux + 1, 4);
        int esz = (sub == 'c' || sub == 'C') ? 1
                  : (sub == 's' || sub == 'S') ? 2 : 4;
        aux += 5 + (int64_t)cnt * esz;
        has_val = 0;
        break;
      }
      default:
        return -1;  // malformed
    }
    if (has_val) {
      if (t0 == 'N' && t1 == 'M') { *nm = val; found++; }
      else if (want_as && t0 == 'A' && t1 == 'S') { *as_score = val; found++; }
    }
  }
  return 0;
}

static int scan_aux_tags(const uint8_t* rec, int64_t aux, int64_t rec_len,
                         int64_t* nm, int64_t* as_score, bool want_as);

extern "C" {

// ---------------------------------------------------------------- BGZF ----

// Scan BGZF blocks: returns number of blocks, fills (when non-null)
// per-block compressed offset/size and uncompressed size. Returns -1 on
// malformed input.
int64_t ct_bgzf_scan(const uint8_t* data, int64_t len, int64_t* block_off,
                     int64_t* block_csize, int64_t* block_usize) {
  int64_t n = 0;
  int64_t pos = 0;
  while (pos + 18 <= len) {
    if (data[pos] != 0x1f || data[pos + 1] != 0x8b) return -1;
    uint16_t xlen = (uint16_t)(data[pos + 10] | (data[pos + 11] << 8));
    // find BC subfield for BSIZE
    int64_t xp = pos + 12;
    int64_t xend = xp + xlen;
    int64_t bsize = -1;
    while (xp + 4 <= xend) {
      uint8_t s1 = data[xp], s2 = data[xp + 1];
      uint16_t slen = (uint16_t)(data[xp + 2] | (data[xp + 3] << 8));
      if (s1 == 'B' && s2 == 'C' && slen == 2) {
        bsize = (int64_t)(data[xp + 4] | (data[xp + 5] << 8)) + 1;
      }
      xp += 4 + slen;
    }
    if (bsize < 0) return -1;
    if (pos + bsize > len) break;
    uint32_t isize;
    memcpy(&isize, data + pos + bsize - 4, 4);
    if (block_off) {
      block_off[n] = pos;
      block_csize[n] = bsize;
      block_usize[n] = isize;
    }
    n++;
    pos += bsize;
  }
  return n;
}

// Inflate all blocks in parallel into out (caller sized from Σ usize).
int ct_bgzf_inflate(const uint8_t* data, int64_t n_blocks,
                    const int64_t* block_off, const int64_t* block_csize,
                    const int64_t* block_usize, const int64_t* out_off,
                    uint8_t* out, int32_t n_threads) {
  std::atomic<int64_t> next(0);
  std::atomic<int> err(0);
  // Blocks are claimed in contiguous runs so each worker writes a mostly
  // sequential output range (better store locality than round-robin).
  const int64_t CHUNK = 16;
  auto worker = [&]() {
#ifdef HAVE_LIBDEFLATE
    // one decompressor per worker, reused across blocks (libdeflate's
    // raw-deflate decode is ~2-3x zlib's and has no per-block init cost)
    libdeflate_decompressor* dec = libdeflate_alloc_decompressor();
    if (!dec) { err.store(1); return; }
#endif
    while (true) {
      int64_t lo = next.fetch_add(CHUNK);
      if (lo >= n_blocks || err.load()) break;
      int64_t hi = lo + CHUNK < n_blocks ? lo + CHUNK : n_blocks;
      for (int64_t i = lo; i < hi; i++) {
        // skip the gzip header: 12 fixed + xlen
        uint16_t xlen = (uint16_t)(data[block_off[i] + 10] |
                                   (data[block_off[i] + 11] << 8));
        int64_t payload_off = block_off[i] + 12 + xlen;
        int64_t payload_len = block_csize[i] - 12 - xlen - 8;
#ifdef HAVE_LIBDEFLATE
        size_t actual = 0;
        libdeflate_result r = libdeflate_deflate_decompress(
            dec, data + payload_off, (size_t)payload_len, out + out_off[i],
            (size_t)block_usize[i], &actual);
        if (r != LIBDEFLATE_SUCCESS || actual != (size_t)block_usize[i]) {
          if (!(block_usize[i] == 0 && r == LIBDEFLATE_SUCCESS)) {
            err.store(2);
            break;
          }
        }
#else
        z_stream zs;
        memset(&zs, 0, sizeof(zs));
        if (inflateInit2(&zs, -15) != Z_OK) { err.store(1); break; }
        zs.next_in = const_cast<uint8_t*>(data + payload_off);
        zs.avail_in = (uInt)payload_len;
        zs.next_out = out + out_off[i];
        zs.avail_out = (uInt)block_usize[i];
        int r = inflate(&zs, Z_FINISH);
        inflateEnd(&zs);
        if (r != Z_STREAM_END && !(r == Z_OK && zs.avail_out == 0) &&
            !(r == Z_BUF_ERROR && block_usize[i] == 0)) {
          err.store(2);
          break;
        }
#endif
      }
    }
#ifdef HAVE_LIBDEFLATE
    libdeflate_free_decompressor(dec);
#endif
  };
  int nt = n_threads < 1 ? 1 : n_threads;
  std::vector<std::thread> threads;
  for (int t = 1; t < nt; t++) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
  return err.load();
}

// -------------------------------------------------------------- records ----

// Walk records from `start`, counting only records FULLY contained in
// [start, len); writes the end offset of the last complete record to
// *end_off. Used by the streaming reader to cut segment buffers at
// record boundaries before the aux scan (which reads up to block_size
// bytes of each record and must never cross the buffer end).
int64_t ct_walk_complete(const uint8_t* data, int64_t len, int64_t start,
                         int64_t* end_off) {
  int64_t n = 0;
  int64_t pos = start;
  while (pos + 4 <= len) {
    uint32_t bs;
    memcpy(&bs, data + pos, 4);
    if (bs == 0 || pos + 4 + (int64_t)bs > len) break;
    n++;
    pos += 4 + (int64_t)bs;
  }
  if (end_off) *end_off = pos;
  return n;
}

// Count records from `start` (end of header block) to `len`.
int64_t ct_count_records(const uint8_t* data, int64_t len, int64_t start) {
  int64_t n = 0;
  int64_t pos = start;
  while (pos + 4 <= len) {
    uint32_t bs;
    memcpy(&bs, data + pos, 4);
    if (bs == 0) break;
    n++;
    pos += 4 + (int64_t)bs;
  }
  return n;
}

// Fill per-record arrays: offsets, NM, AS, qname hash. Caller allocates
// n-sized arrays. Returns number filled, or -(record index+1) on a
// malformed aux region.
int64_t ct_scan_records(const uint8_t* data, int64_t len, int64_t start,
                        int64_t n, int64_t* rec_off, int64_t* nm,
                        int64_t* as_score, uint64_t* qname_hash) {
  const int64_t AS_MISSING = INT64_MIN;
  int64_t pos = start;
  for (int64_t r = 0; r < n; r++) {
    if (pos + 4 > len) return r;
    uint32_t bs;
    memcpy(&bs, data + pos, 4);
    if (bs == 0) return r;
    rec_off[r] = pos;
    const uint8_t* rec = data + pos + 4;
    int64_t rec_len = bs;

    uint8_t l_read_name = rec[8];
    uint16_t n_cigar;
    memcpy(&n_cigar, rec + 12, 2);
    int32_t l_seq;
    memcpy(&l_seq, rec + 16, 4);
    if (l_seq < 0 ||
        32 + (int64_t)l_read_name + 4ll * n_cigar > rec_len)
      return -(r + 1);  // corrupt geometry (fuzz-hardening)

    // FNV-1a over the qname (excluding NUL)
    uint64_t h = 0xcbf29ce484222325ULL;
    const uint8_t* q = rec + 32;
    for (int i = 0; i < l_read_name - 1; i++) {
      h ^= q[i];
      h *= 0x100000001b3ULL;
    }
    qname_hash[r] = h;

    int64_t aux = 32 + l_read_name + 4LL * n_cigar + (l_seq + 1) / 2 + l_seq;
    int64_t nm_v, as_v;
    if (scan_aux_tags(rec, aux, rec_len, &nm_v, &as_v, true) != 0)
      return -(r + 1);
    nm[r] = nm_v;
    as_score[r] = as_v;
    pos += 4 + (int64_t)bs;
  }
  return n;
}

// Full single-pass record parse (the C++ form of the numpy gather parse
// in io/bam.py parse_records, itself the analogue of htslib's record
// accessors + the CIGAR walks of contig.rs:168-202).  Two phases:
//   phase 1 (sequential): record offsets + per-record coverage-block
//     counts (M/=/X CIGAR runs) -> caller prefix-sums for block offsets;
//   phase 2 (parallel over records): fixed fields, CIGAR-derived
//     aligned lengths / indels / blocks, aux NM+AS, FNV-1a qname hash.

// Phase 1: fills rec_off[n] and nblocks[n]; returns records filled
// (records must already be counted/cut via ct_count_records or
// ct_walk_complete).
int64_t ct_parse_phase1(const uint8_t* data, int64_t len, int64_t start,
                        int64_t n, int64_t* rec_off, int64_t* nblocks) {
  int64_t pos = start;
  for (int64_t r = 0; r < n; r++) {
    if (pos + 4 > len) return r;
    uint32_t bs;
    memcpy(&bs, data + pos, 4);
    if (bs == 0 || pos + 4 + (int64_t)bs > len) return r;
    rec_off[r] = pos;
    const uint8_t* rec = data + pos + 4;
    uint8_t l_read_name = rec[8];
    uint16_t n_cigar;
    memcpy(&n_cigar, rec + 12, 2);
    if (32 + (int64_t)l_read_name + 4ll * n_cigar > (int64_t)bs)
      return r;  // corrupt geometry: stop; caller falls back
    const uint8_t* cig = rec + 32 + l_read_name;
    int64_t nb = 0;
    for (int64_t k = 0; k < n_cigar; k++) {
      uint32_t c;
      memcpy(&c, cig + 4 * k, 4);
      uint32_t op = c & 0xF;
      nb += (op == 0 || op == 7 || op == 8);  // M, =, X
    }
    nblocks[r] = nb;
    pos += 4 + (int64_t)bs;
  }
  return n;
}

// Phase 2: parallel per-record decode.  block_base[r] is the exclusive
// prefix sum of nblocks.  Returns 0, or -(record index+1) on a malformed
// aux region.
int ct_parse_phase2(const uint8_t* data, int64_t n, const int64_t* rec_off,
                    const int64_t* block_base, int32_t* tid, int32_t* pos_out,
                    uint16_t* flag, uint8_t* mapq, int32_t* l_seq_out,
                    int64_t* nm, int64_t* as_score, uint64_t* qname_hash,
                    int64_t* aligned_cov, int64_t* aligned_pair,
                    int64_t* indels, int32_t* read_end, int64_t* rec_end,
                    int32_t* block_read, int32_t* block_start,
                    int32_t* block_end, int32_t n_threads) {
  const int64_t AS_MISSING = INT64_MIN;
  std::atomic<int64_t> next(0);
  std::atomic<int64_t> err(0);
  const int64_t CHUNK = 4096;
  auto worker = [&]() {
    while (true) {
      int64_t lo = next.fetch_add(CHUNK);
      if (lo >= n || err.load()) return;
      int64_t hi = lo + CHUNK < n ? lo + CHUNK : n;
      for (int64_t r = lo; r < hi; r++) {
        const uint8_t* rec = data + rec_off[r] + 4;
        uint32_t bs;
        memcpy(&bs, data + rec_off[r], 4);
        int64_t rec_len = bs;
        rec_end[r] = rec_off[r] + 4 + rec_len;

        memcpy(&tid[r], rec, 4);
        memcpy(&pos_out[r], rec + 4, 4);
        uint8_t l_read_name = rec[8];
        mapq[r] = rec[9];
        uint16_t n_cigar;
        memcpy(&n_cigar, rec + 12, 2);
        memcpy(&flag[r], rec + 14, 2);
        int32_t l_seq;
        memcpy(&l_seq, rec + 16, 4);
        l_seq_out[r] = l_seq;
        if (l_seq < 0 ||
            32 + (int64_t)l_read_name + 4ll * n_cigar > rec_len) {
          err.store(r + 1);
          return;  // corrupt geometry (fuzz-hardening)
        }

        // FNV-1a qname hash
        uint64_t h = 0xcbf29ce484222325ULL;
        const uint8_t* q = rec + 32;
        for (int i = 0; i < l_read_name - 1; i++) {
          h ^= q[i];
          h *= 0x100000001b3ULL;
        }
        qname_hash[r] = h;

        // CIGAR walk: coverage blocks + aligned lengths
        const uint8_t* cig = rec + 32 + l_read_name;
        int64_t cursor = pos_out[r];
        int64_t a_cov = 0, a_pair = 0, ind = 0;
        int64_t b = block_base[r];
        for (int64_t k = 0; k < n_cigar; k++) {
          uint32_t c;
          memcpy(&c, cig + 4 * k, 4);
          uint32_t op = c & 0xF;
          int64_t ln = c >> 4;
          switch (op) {
            case 0:  // M
            case 7:  // =
            case 8:  // X
              block_read[b] = (int32_t)r;
              block_start[b] = (int32_t)cursor;
              block_end[b] = (int32_t)(cursor + ln);
              b++;
              a_cov += ln;
              a_pair += ln;
              cursor += ln;
              break;
            case 1:  // I: aligned, no cursor move
              a_cov += ln;
              a_pair += ln;
              ind += ln;
              break;
            case 2:  // D: aligned (cov/single only), cursor moves
              a_cov += ln;
              ind += ln;
              cursor += ln;
              break;
            case 3:  // N: cursor only
              cursor += ln;
              break;
            default:  // S/H/P: ignored
              break;
          }
        }
        aligned_cov[r] = a_cov;
        aligned_pair[r] = a_pair;
        indels[r] = ind;
        read_end[r] = (int32_t)cursor;

        // aux scan: NM + AS (shared bounded scanner)
        int64_t aux = 32 + l_read_name + 4LL * n_cigar + (l_seq + 1) / 2 + l_seq;
        int64_t nm_v, as_v;
        if (scan_aux_tags(rec, aux, rec_len, &nm_v, &as_v, true) != 0) {
          err.store(r + 1);
          return;
        }
        nm[r] = nm_v;
        as_score[r] = as_v;
      }
    }
  };
  int nt = n_threads < 1 ? 1 : n_threads;
  std::vector<std::thread> threads;
  for (int t = 1; t < nt; t++) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
  return err.load() ? -(int)err.load() : 0;
}

// Walk the reference-sequence list of a BAM header (the block after the
// SAM text, SAM spec §4.2): n_ref entries of {l_name, name, l_ref}.
// Fills name_off/name_len (name byte ranges, NUL excluded) and tlen.
// Returns the end offset of the list, or -1 when the buffer is
// truncated mid-list.  Replaces the per-record Python loop that made
// multi-GB headers take minutes (io/bam.py).
int64_t ct_walk_refs(const uint8_t* data, int64_t size, int64_t off,
                     int64_t n_ref, int64_t* name_off, int64_t* name_len,
                     int64_t* tlen) {
  for (int64_t i = 0; i < n_ref; i++) {
    if (off + 4 > size) return -1;
    uint32_t l_name;
    memcpy(&l_name, data + off, 4);
    off += 4;
    if (off + (int64_t)l_name + 4 > size) return -1;
    name_off[i] = off;
    name_len[i] = (int64_t)l_name - 1;
    off += l_name;
    uint32_t l_ref;
    memcpy(&l_ref, data + off, 4);
    tlen[i] = l_ref;
    off += 4;
  }
  return off;
}

// ---------------------------------------------------------------- rANS ----
// rANS 4x8 decode (CRAM spec section 13): 12-bit normalised
// frequencies, lower bound 1<<23, 4 states.  Order-0 interleaves the
// states positionally (i & 3); order-1 gives each state a contiguous
// quarter with previous-byte contexts.  Mirrors io/cram.py's Python
// reference implementation (kept as the portable fallback).

namespace {

struct RansTable {
  uint32_t freq[256];
  uint32_t cum[257];
  uint8_t lookup[1 << 12];
};

// Parse the RLE symbol list + 1-2 byte frequencies; returns new offset
// or -1 on malformed input.
int64_t rans_read_freqs(const uint8_t* in, int64_t len, int64_t p,
                        RansTable* t) {
  memset(t->freq, 0, sizeof(t->freq));
  if (p >= len) return -1;
  int sym = in[p++];
  int rle = 0;
  while (true) {
    if (p >= len) return -1;
    uint32_t f = in[p++];
    if (f >= 128) {
      if (p >= len) return -1;
      f = ((f & 0x7F) << 8) | in[p++];
    }
    t->freq[sym] = f;
    if (rle > 0) {
      rle--;
      sym++;
    } else {
      if (p >= len) return -1;
      int nxt = in[p++];
      if (nxt == sym + 1) {
        if (p >= len) return -1;
        rle = in[p++];
        sym = nxt;
      } else {
        sym = nxt;
        if (sym == 0) break;
      }
    }
    if (sym > 255) return -1;
  }
  uint32_t c = 0;
  for (int s = 0; s < 256; s++) {
    t->cum[s] = c;
    for (uint32_t k = 0; k < t->freq[s]; k++) {
      if (c + k >= (1u << 12)) return -1;
      t->lookup[c + k] = (uint8_t)s;
    }
    c += t->freq[s];
  }
  t->cum[256] = c;
  if (c != (1u << 12)) return -1;
  return p;
}

}  // namespace

// Decode one rANS 4x8 block (including the 9-byte header: order u8,
// comp_len u32, out_len u32).  out must hold out_cap bytes; returns the
// number of bytes written, or a negative error.
int64_t ct_rans_decode(const uint8_t* in, int64_t in_len, uint8_t* out,
                       int64_t out_cap) {
  if (in_len < 9) return -1;
  int order = in[0];
  uint32_t out_len;
  memcpy(&out_len, in + 5, 4);
  if ((int64_t)out_len > out_cap) return -2;
  int64_t p = 9;
  const uint32_t LOW = 1u << 23;
  if (order == 0) {
    static thread_local RansTable t;
    p = rans_read_freqs(in, in_len, p, &t);
    if (p < 0 || p + 16 > in_len) return -3;
    uint32_t R[4];
    memcpy(R, in + p, 16);
    p += 16;
    for (int64_t i = 0; i < (int64_t)out_len; i++) {
      uint32_t& x = R[i & 3];
      uint32_t f = x & 0xFFF;
      uint8_t s = t.lookup[f];
      out[i] = s;
      x = t.freq[s] * (x >> 12) + f - t.cum[s];
      while (x < LOW) {
        if (p >= in_len) return -4;
        x = (x << 8) | in[p++];
      }
    }
    return out_len;
  }
  if (order != 1) return -5;
  // order-1: per-context tables, outer RLE over contexts
  static thread_local std::vector<RansTable> tabs;
  static thread_local std::vector<int16_t> tab_of;
  tabs.clear();
  tab_of.assign(256, -1);
  {
    if (p >= in_len) return -6;
    int sym = in[p++];
    int rle = 0;
    while (true) {
      tabs.emplace_back();
      p = rans_read_freqs(in, in_len, p, &tabs.back());
      if (p < 0) return -7;
      tab_of[sym] = (int16_t)(tabs.size() - 1);
      if (rle > 0) {
        rle--;
        sym++;
      } else {
        if (p >= in_len) return -8;
        int nxt = in[p++];
        if (nxt == sym + 1) {
          if (p >= in_len) return -9;
          rle = in[p++];
          sym = nxt;
        } else {
          sym = nxt;
          if (sym == 0) break;
        }
      }
      if (sym > 255) return -10;
    }
  }
  if (p + 16 > in_len) return -11;
  uint32_t R[4];
  memcpy(R, in + p, 16);
  p += 16;
  int64_t q = (int64_t)out_len >> 2;
  uint8_t last[4] = {0, 0, 0, 0};
  auto dec = [&](int j, int64_t pos) -> int {
    int16_t ti = tab_of[last[j]];
    if (ti < 0) return -12;
    RansTable& t = tabs[ti];
    uint32_t& x = R[j];
    uint32_t f = x & 0xFFF;
    uint8_t s = t.lookup[f];
    out[pos] = s;
    x = t.freq[s] * (x >> 12) + f - t.cum[s];
    while (x < LOW) {
      if (p >= in_len) return -13;
      x = (x << 8) | in[p++];
    }
    last[j] = s;
    return 0;
  };
  for (int64_t i = 0; i < q; i++)
    for (int j = 0; j < 4; j++)
      if (dec(j, (int64_t)j * q + i)) return -14;
  for (int64_t pos = 4 * q; pos < (int64_t)out_len; pos++)
    if (dec(3, pos)) return -15;
  return out_len;
}

}  // extern "C"

// ---------------------------------------------------- fused stats scan ----
// The host-ingestion fast path: ONE pass over decoded BAM bytes that
// computes everything the coverage scan layer needs (the per-record
// work of contig.rs:107-215 + the per-contig bincounts of genome.rs)
// WITHOUT materialising per-record arrays:
//   - per-contig read counts (primary / non-supplementary / all passing)
//   - per-contig NM and indel sums + identity sums (primary / nonsupp)
//   - the filtered coverage-block arrays (tid, start, end), record order
//   - sortedness, NM-missing and total-primary-alignment bookkeeping
// A chain thread walks record offsets publishing 32k-record chunks;
// scan workers chase the chain.  Per-chunk results merge in chunk order
// so every statistic (including the f64 identity sums) is deterministic
// run to run.

#include "stats_state.h"

using covermio::ChunkOut;
using covermio::ReadFilter;
using covermio::StatsRun;
using covermio::StatsScanState;

namespace {

constexpr int64_t kChunkShift = 15;  // 32768 records per chunk
constexpr int64_t kChunkRecs = 1ll << kChunkShift;
constexpr int64_t kChainAhead = 4096;  // the chain walk's prefetch distance

}  // namespace

namespace {

// The single-read filter of readfilter.single_read_passes
// (filter.rs:243-279), bit for bit: the thresholds arrive as the float32
// values numpy compares against, the quotients are IEEE float32 as numpy
// computes them (no -ffast-math), so 0/0 is NaN and fails every test and
// x/0 is +inf and passes.  min_mapq 255 means no mapq test.
inline bool single_read_passes(const ReadFilter& f, uint8_t mapq,
                               int64_t aligned, int32_t l_seq, int64_t nm) {
  if (f.min_mapq != 255 && (mapq < f.min_mapq || mapq == 255)) return false;
  float frac = (float)aligned / (float)l_seq;
  float identity = 1.0f - (float)nm / (float)aligned;
  return aligned >= f.min_aligned_length && frac >= f.min_aligned_percent &&
         identity >= f.min_identity;
}

// One chunk's per-record scan: stats + filtered blocks (shared by the
// pre-decoded and inflate-fused entry points).  With kFilter a mapped
// record that passes the flag masks must also pass the single-read
// filter, or it leaves no trace but its count in n_primary; the two
// instantiations keep the test out of the unfiltered loop.
template <bool kFilter>
void scan_chunk_records(const uint8_t* data, int64_t pos, int64_t count,
                        int32_t n_ref, int32_t skip_mask, int32_t req_mask,
                        const ReadFilter& rf, ChunkOut& out) {
  out.runs.reserve(8);
  out.btid.reserve((size_t)count + count / 8);
  out.bstart.reserve((size_t)count + count / 8);
  out.bend.reserve((size_t)count + count / 8);
  StatsRun run{};
  int32_t cur_tid = -2;
  int32_t prev_tid = -1;
  auto flush = [&]() {
    if (cur_tid >= 0) out.runs.push_back(run);
  };
  for (int64_t r = 0; r < count; r++) {
    uint32_t bs;
    memcpy(&bs, data + pos, 4);
    const uint8_t* rec = data + pos + 4;
    int64_t rec_len = bs;
    pos += 4 + (int64_t)bs;

    int32_t tid, posr;
    memcpy(&tid, rec, 4);
    memcpy(&posr, rec + 4, 4);
    uint8_t l_read_name = rec[8];
    uint16_t n_cigar, flag;
    memcpy(&n_cigar, rec + 12, 2);
    memcpy(&flag, rec + 14, 2);

    bool primary = (flag & 0x900) == 0;
    out.n_primary += primary;
    bool mapped = (flag & 0x4) == 0;
    bool pass = ((flag & skip_mask) == 0) &&
                ((flag & req_mask) == req_mask);
    if (!(pass && mapped)) continue;

    // in-record geometry must fit before any region is walked
    // (corrupt l_read_name/n_cigar/l_seq would otherwise read out of
    // the buffer -- found by tests/test_native_fuzz.py)
    int32_t l_seq;
    memcpy(&l_seq, rec + 16, 4);
    if (l_seq < 0 || 32 + (int64_t)l_read_name + 4ll * n_cigar > rec_len) {
      out.err = r + 1;
      flush();
      return;
    }

    // CIGAR walk: coverage blocks + aligned length + indels
    // (contig.rs:168-202 semantics)
    const size_t nb0 = out.btid.size();
    const uint8_t* cig = rec + 32 + l_read_name;
    int64_t cursor = posr, a_cov = 0, ind = 0;
    for (int64_t k = 0; k < n_cigar; k++) {
      uint32_t c;
      memcpy(&c, cig + 4 * k, 4);
      uint32_t op = c & 0xF;
      int64_t ln = c >> 4;
      switch (op) {
        case 0:
        case 7:
        case 8:  // M / = / X
          out.btid.push_back(tid);
          out.bstart.push_back((int32_t)cursor);
          out.bend.push_back((int32_t)(cursor + ln));
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
    }
    int64_t aux = 32 + l_read_name + 4ll * n_cigar + (l_seq + 1) / 2 + l_seq;
    int64_t nm, as_unused;
    if (scan_aux_tags(rec, aux, rec_len, &nm, &as_unused, false) != 0) {
      out.err = r + 1;
      flush();
      return;
    }
    if constexpr (kFilter) {
      // a_cov is the filter's M+I+D+=+X; the mapq byte is rec[9]
      if (!single_read_passes(rf, rec[9], a_cov, l_seq, nm)) {
        out.btid.resize(nb0);
        out.bstart.resize(nb0);
        out.bend.resize(nb0);
        continue;
      }
    }
    if (tid < 0 || tid >= n_ref) {
      out.err = r + 1;
      flush();
      return;
    }
    if (out.first_tid < 0) out.first_tid = tid;
    if (tid < prev_tid) out.sorted = false;
    prev_tid = tid;
    out.last_tid = tid;

    if (tid != cur_tid) {
      flush();
      run = StatsRun{};
      run.tid = tid;
      cur_tid = tid;
    }
    bool nonsupp = (flag & 0x800) == 0;
    run.reads_all++;
    run.reads_primary += primary;
    run.reads_nonsupp += nonsupp;
    run.block_count += (int64_t)(out.btid.size() - nb0);
    run.indel_sum += ind;
    if (nm < 0) {
      out.nm_missing++;  // the caller raises before any result is used
    } else {
      run.nm_sum += nm;
      if (a_cov > 0) {
        double idv = (double)(a_cov - nm) / (double)a_cov;
        run.ident_primary += primary ? idv : 0.0;
        run.ident_nonsupp += nonsupp ? idv : 0.0;
      }
    }
  }
  flush();
}

// Optional inflate stage for the fused pipeline: workers drain BGZF
// blocks first; the chain walker chases the contiguous inflated prefix.
struct InflateWork {
  const uint8_t* comp = nullptr;
  int64_t n_blocks = 0;
  const int64_t* b_off = nullptr;
  const int64_t* b_csz = nullptr;
  std::vector<int64_t> cum_out;  // [n_blocks+1] output offsets (after base)
  uint8_t* dest = nullptr;       // buffer base (carry occupies [0, base))
  int64_t base = 0;
  int64_t n_ichunks = 0;
  std::unique_ptr<std::atomic<uint8_t>[]> done;
  std::atomic<int64_t> next{0};
  std::atomic<int> err{0};
  static const int64_t BCHUNK = 16;
};

void inflate_drain(InflateWork* inf) {
#ifdef HAVE_LIBDEFLATE
  libdeflate_decompressor* dec = libdeflate_alloc_decompressor();
  if (!dec) {
    inf->err.store(1);
    return;
  }
#endif
  while (true) {
    int64_t ic = inf->next.fetch_add(1);
    if (ic >= inf->n_ichunks || inf->err.load()) break;
    int64_t lo = ic * InflateWork::BCHUNK;
    int64_t hi = lo + InflateWork::BCHUNK < inf->n_blocks
                     ? lo + InflateWork::BCHUNK
                     : inf->n_blocks;
    for (int64_t i = lo; i < hi; i++) {
      uint16_t xlen = (uint16_t)(inf->comp[inf->b_off[i] + 10] |
                                 (inf->comp[inf->b_off[i] + 11] << 8));
      int64_t payload_off = inf->b_off[i] + 12 + xlen;
      int64_t payload_len = inf->b_csz[i] - 12 - xlen - 8;
      int64_t usz = inf->cum_out[i + 1] - inf->cum_out[i];
      uint8_t* dst = inf->dest + inf->base + inf->cum_out[i];
#ifdef HAVE_LIBDEFLATE
      size_t actual = 0;
      libdeflate_result r = libdeflate_deflate_decompress(
          dec, inf->comp + payload_off, (size_t)payload_len, dst,
          (size_t)usz, &actual);
      if ((r != LIBDEFLATE_SUCCESS || actual != (size_t)usz) &&
          !(usz == 0 && r == LIBDEFLATE_SUCCESS)) {
        inf->err.store(2);
        break;
      }
#else
      z_stream zs;
      memset(&zs, 0, sizeof(zs));
      if (inflateInit2(&zs, -15) != Z_OK) {
        inf->err.store(1);
        break;
      }
      zs.next_in = const_cast<uint8_t*>(inf->comp + payload_off);
      zs.avail_in = (uInt)payload_len;
      zs.next_out = dst;
      zs.avail_out = (uInt)usz;
      int r = inflate(&zs, Z_FINISH);
      inflateEnd(&zs);
      if (r != Z_STREAM_END && !(r == Z_OK && zs.avail_out == 0) &&
          !(r == Z_BUF_ERROR && usz == 0)) {
        inf->err.store(2);
        break;
      }
#endif
    }
    inf->done[(size_t)ic].store(1, std::memory_order_release);
  }
#ifdef HAVE_LIBDEFLATE
  libdeflate_free_decompressor(dec);
#endif
}

// The shared fused pipeline.  With inf == nullptr the buffer is fully
// decoded up front (ct_stats_scan); with inf set, workers inflate
// first and the chain walker chases the inflated frontier, so the
// sequential record walk costs no extra wall time (it hides behind
// the inflate) and scan chunks start while later blocks still inflate.
void run_stats_pipeline(const uint8_t* data, int64_t end, int64_t start,
                        int32_t n_ref, int32_t skip_mask, int32_t req_mask,
                        const ReadFilter* rf, int32_t n_threads,
                        int64_t* scalars, StatsScanState* st,
                        InflateWork* inf) {
  int64_t max_chunks = (end - start) / (kChunkRecs * 36) + 2;
  std::vector<int64_t> chunk_off((size_t)max_chunks, 0);
  st->chunks.resize((size_t)max_chunks);

  std::atomic<int64_t> published(0);   // chunks whose END is known
  std::atomic<int64_t> total_chunks(INT64_MAX);  // set when the chain ends
  std::atomic<int64_t> next_chunk(0);
  std::atomic<int64_t> scan_ns(0);  // the chunk workers' thread time
  int64_t chain_err = 0;
  auto now = [] { return std::chrono::steady_clock::now(); };
  const auto t_start = now();
  int64_t chain_ns = 0;

  auto chain = [&]() {
    int64_t pos = start, nrec = 0;
    int64_t avail = inf ? inf->base : end;  // inflated frontier (bytes)
    int64_t fr = 0;                          // confirmed inflate chunks
    // Over a buffer decoded before the call (ct_stats_scan) the bytes are
    // cold, and each record's length field is a load that waits on the
    // last: prefetch every line kChainAhead bytes ahead of the walk. With
    // an inflate stage the walk reads bytes just written and needs none.
    int64_t pf = inf ? end : start;  // the next line to prefetch
    auto ensure = [&](int64_t need) -> bool {
      while (avail < need) {
        if (!inf) return false;
        if (inf->err.load()) return false;
        bool moved = false;
        while (fr < inf->n_ichunks &&
               inf->done[(size_t)fr].load(std::memory_order_acquire)) {
          fr++;
          moved = true;
        }
        if (moved) {
          int64_t blk = fr * InflateWork::BCHUNK;
          if (blk > inf->n_blocks) blk = inf->n_blocks;
          avail = inf->base + inf->cum_out[blk];
        } else if (fr >= inf->n_ichunks) {
          avail = end;
        } else {
          std::this_thread::yield();
        }
      }
      return true;
    };
    while (pos + 4 <= end && ensure(pos + 4)) {
      uint32_t bs;
      memcpy(&bs, data + pos, 4);
      if (bs == 0 || pos + 4 + (int64_t)bs > end) break;
      if (bs < 33) {  // below the BAM fixed-block minimum: corrupt
        chain_err = nrec + 1;
        break;
      }
      if (!ensure(pos + 4 + (int64_t)bs)) break;
      if ((nrec & (kChunkRecs - 1)) == 0) {
        int64_t ci = nrec >> kChunkShift;
        chunk_off[(size_t)ci] = pos;
        if (ci > 0) published.store(ci, std::memory_order_release);
      }
      pos += 4 + (int64_t)bs;
      __builtin_prefetch(data + pos);
      for (int64_t lim = pos + kChainAhead < end ? pos + kChainAhead : end;
           pf < lim; pf += 64)
        __builtin_prefetch(data + pf);
      nrec++;
    }
    st->n_records = nrec;
    st->end_off = pos;
    st->n_chunks = (nrec + kChunkRecs - 1) >> kChunkShift;
    // total_chunks (release) is the signal that n_records/n_chunks are
    // final; published then opens the last (partial) chunk for scanning
    total_chunks.store(st->n_chunks, std::memory_order_release);
    published.store(st->n_chunks, std::memory_order_release);
    chain_ns = std::chrono::duration_cast<std::chrono::nanoseconds>(
                   now() - t_start).count();
  };

  auto scan_chunk = [&](int64_t ci) {
    const auto t0 = now();
    int64_t count = kChunkRecs;
    // ci == total-1 is only observable after the chain's release store,
    // which orders the n_records write before this read
    if (ci == total_chunks.load(std::memory_order_acquire) - 1)
      count = st->n_records - (ci << kChunkShift);
    if (rf)
      scan_chunk_records<true>(data, chunk_off[(size_t)ci], count, n_ref,
                               skip_mask, req_mask, *rf,
                               st->chunks[(size_t)ci]);
    else
      scan_chunk_records<false>(data, chunk_off[(size_t)ci], count, n_ref,
                                skip_mask, req_mask, ReadFilter{},
                                st->chunks[(size_t)ci]);
    scan_ns.fetch_add(std::chrono::duration_cast<std::chrono::nanoseconds>(
                          now() - t0).count(),
                      std::memory_order_relaxed);
  };

  auto worker = [&]() {
    if (inf) inflate_drain(inf);  // drain all blocks before scanning
    while (true) {
      int64_t ci = next_chunk.fetch_add(1);
      while (true) {
        if (ci >= total_chunks.load(std::memory_order_acquire)) return;
        if (ci < published.load(std::memory_order_acquire)) break;
        std::this_thread::yield();
      }
      scan_chunk(ci);
    }
  };

  int nt = n_threads < 1 ? 1 : n_threads;
  std::vector<std::thread> pool;
  // with an inflate stage all nt workers inflate while the caller
  // chains behind the frontier; otherwise the caller chains then scans
  for (int t = inf ? 0 : 1; t < nt; t++) pool.emplace_back(worker);
  chain();   // the calling thread chains, then joins the scan pool
  if (!inf) worker();
  for (auto& th : pool) th.join();

  // merge chunk summaries (chunk order -> deterministic)
  int64_t n_primary = 0, nm_missing = 0, n_blocks = 0, err = 0;
  int32_t first_tid = -1, last_tid = -1;
  bool sorted = true;
  for (int64_t ci = 0; ci < st->n_chunks; ci++) {
    ChunkOut& c = st->chunks[(size_t)ci];
    n_primary += c.n_primary;
    nm_missing += c.nm_missing;
    n_blocks += (int64_t)c.btid.size();
    if (c.err && !err) err = (ci << kChunkShift) + c.err;
    if (!c.sorted) sorted = false;
    if (c.first_tid >= 0) {
      if (last_tid >= 0 && c.first_tid < last_tid) sorted = false;
      if (first_tid < 0) first_tid = c.first_tid;
      last_tid = c.last_tid;
    }
  }
  if (chain_err && !err) err = chain_err;
  st->n_blocks = n_blocks;
  scalars[0] = st->n_records;
  scalars[1] = st->end_off;
  scalars[2] = n_blocks;
  scalars[3] = n_primary;
  scalars[4] = nm_missing;
  scalars[5] = sorted ? 1 : 0;
  scalars[6] = first_tid;
  scalars[7] = last_tid;
  scalars[8] = err;
  scalars[9] = inf ? inf->err.load() : 0;
  // scalars[10] is the caller's; the chain walk's wall time from the
  // call's start (it chases the inflate on the ingest route) and the
  // chunk workers' thread time, nanoseconds
  scalars[11] = chain_ns;
  scalars[12] = scan_ns.load();
}

}  // namespace

extern "C" {

// Run the fused scan over the COMPLETE records in [start, end) of a
// pre-decoded buffer.  Returns an opaque handle (free with
// ct_stats_free) or null on alloc failure.  scalars[0..9]: n_records,
// end_off, n_blocks, n_primary, nm_missing, sorted(1 ok), first_tid,
// last_tid, err(record idx+1), inflate_err(always 0 here); [11] the
// chain walk's nanoseconds, [12] the chunk workers' (thread time).  `rf` (null:
// none) is the single-read filter a passing mapped record must pass too.
void* ct_stats_scan(const uint8_t* data, int64_t end, int64_t start,
                    int32_t n_ref, int32_t skip_mask, int32_t req_mask,
                    int32_t n_threads, int64_t* scalars,
                    const ReadFilter* rf) {
  auto* st = new StatsScanState();
  run_stats_pipeline(data, end, start, n_ref, skip_mask, req_mask, rf,
                     n_threads, scalars, st, nullptr);
  return st;
}

// Fully fused segment ingest: threaded BGZF inflate + frontier-chasing
// record chain + stats/block scan in ONE call.  `carry` (the previous
// segment's incomplete tail record) is copied to the head of the
// malloc'd decode buffer; `start` is the parse offset within the
// assembled buffer (normally 0).  The handle owns the decode buffer —
// read the leftover tail with ct_stats_leftover before freeing.  `rf`
// as in ct_stats_scan.
void* ct_ingest_scan(const uint8_t* comp, int64_t n_blocks,
                     const int64_t* b_off, const int64_t* b_csz,
                     const int64_t* b_usz, const uint8_t* carry,
                     int64_t carry_len, int64_t start, int32_t n_ref,
                     int32_t skip_mask, int32_t req_mask,
                     int32_t n_threads, int64_t* scalars,
                     const ReadFilter* rf) {
  auto* inf = new InflateWork();
  inf->comp = comp;
  inf->n_blocks = n_blocks;
  inf->b_off = b_off;
  inf->b_csz = b_csz;
  inf->cum_out.resize((size_t)n_blocks + 1);
  inf->cum_out[0] = 0;
  for (int64_t i = 0; i < n_blocks; i++)
    inf->cum_out[(size_t)i + 1] = inf->cum_out[(size_t)i] + b_usz[i];
  int64_t total = carry_len + inf->cum_out[(size_t)n_blocks];
  uint8_t* buf = (uint8_t*)malloc((size_t)(total > 0 ? total : 1));
  if (!buf) {
    delete inf;
    return nullptr;
  }
  if (carry_len) memcpy(buf, carry, (size_t)carry_len);
  inf->dest = buf;
  inf->base = carry_len;
  inf->n_ichunks =
      (n_blocks + InflateWork::BCHUNK - 1) / InflateWork::BCHUNK;
  inf->done.reset(new std::atomic<uint8_t>[(size_t)(inf->n_ichunks > 0
                                                    ? inf->n_ichunks
                                                    : 1)]);
  for (int64_t i = 0; i < inf->n_ichunks; i++) inf->done[(size_t)i] = 0;

  auto* st = new StatsScanState();
  st->buf = buf;
  st->buf_len = total;
  run_stats_pipeline(buf, total, start, n_ref, skip_mask, req_mask, rf,
                     n_threads, scalars, st, inf);
  delete inf;
  return st;
}

// Copy the unconsumed tail bytes [end_off, buf_len) out of an ingest
// handle's decode buffer (the next segment's carry).
void ct_stats_leftover(void* handle, uint8_t* dst) {
  auto* st = (StatsScanState*)handle;
  int64_t n = st->buf_len - st->end_off;
  if (n > 0 && st->buf) memcpy(dst, st->buf + st->end_off, (size_t)n);
}

// Accumulate the per-contig statistics (+=) into caller arrays (length
// n_ref each, caller-initialised) and copy the block arrays out in
// record order.  Returns 0, or -1 on a tid out of range (cannot happen
// when ct_stats_scan returned err=0 with the same n_ref).
int ct_stats_fill(void* handle, int32_t n_ref, int64_t* reads_primary,
                  int64_t* reads_nonsupp, int64_t* reads_all,
                  int64_t* nm_sum, int64_t* indel_sum,
                  double* ident_primary, double* ident_nonsupp,
                  uint8_t* observed, int32_t* btid, int32_t* bstart,
                  int32_t* bend, int64_t* block_counts) {
  auto* st = (StatsScanState*)handle;
  int64_t b = 0;
  for (int64_t ci = 0; ci < st->n_chunks; ci++) {
    ChunkOut& c = st->chunks[(size_t)ci];
    for (const StatsRun& r : c.runs) {
      if (r.tid < 0 || r.tid >= n_ref) return -1;
      reads_primary[r.tid] += r.reads_primary;
      reads_nonsupp[r.tid] += r.reads_nonsupp;
      reads_all[r.tid] += r.reads_all;
      nm_sum[r.tid] += r.nm_sum;
      indel_sum[r.tid] += r.indel_sum;
      ident_primary[r.tid] += r.ident_primary;
      ident_nonsupp[r.tid] += r.ident_nonsupp;
      if (block_counts) block_counts[r.tid] += r.block_count;
      observed[r.tid] = 1;
    }
    size_t nb = c.btid.size();
    if (nb) {
      memcpy(btid + b, c.btid.data(), nb * 4);
      memcpy(bstart + b, c.bstart.data(), nb * 4);
      memcpy(bend + b, c.bend.data(), nb * 4);
      b += (int64_t)nb;
    }
  }
  return 0;
}

void ct_stats_free(void* handle) {
  auto* st = (StatsScanState*)handle;
  if (st->buf) free(st->buf);
  delete st;
}

}  // extern "C"

// Threaded batch rANS 4x8 decode: n independent blocks (each with the
// 9-byte rANS header) decoded in parallel.  in_off/out_off are n+1
// prefix arrays into in/out.  Returns 0, or (block index+1) of the
// first failure.
extern "C" int64_t ct_rans_decode_batch(const uint8_t* in,
                                        const int64_t* in_off, uint8_t* out,
                                        const int64_t* out_off, int64_t n,
                                        int32_t n_threads) {
  std::atomic<int64_t> next(0);
  std::atomic<int64_t> err(0);
  auto worker = [&]() {
    while (true) {
      int64_t i = next.fetch_add(1);
      if (i >= n || err.load()) return;
      int64_t in_len = in_off[i + 1] - in_off[i];
      int64_t out_len = out_off[i + 1] - out_off[i];
      int64_t r = ct_rans_decode(in + in_off[i], in_len, out + out_off[i],
                                 out_len);
      if (r != out_len) err.store(i + 1);
    }
  };
  int nt = n_threads < 1 ? 1 : n_threads;
  std::vector<std::thread> pool;
  for (int t = 1; t < nt; t++) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return err.load();
}
