// BAM record scan for Hopper (sm_90a): the fused ingest's record chain and
// per-record scan, over the inflated bytes that the inflate kernel
// (csrc/bgzf_inflate.cu) leaves in card memory.
//
// It replaces no TPU kernel: the JAX package scans records on the host
// (coverm_tpu/native/bamdecode.cpp:668 scan_chunk_records, :1009
// ct_stats_scan). It takes over the port's copy of that host scan,
// coverm_tpu_torch/native/bamdecode.cpp:687-820 (scan_chunk_records, with
// the single-read filter) and :903-1045 (run_stats_pipeline's chain walk
// and chunk merge), and gives the same outputs bit for bit: the filtered
// coverage blocks (tid, start, end) in record order, per-contig statistic
// runs chunked as the host chunks them (32,768 records a chunk from the
// segment's first record, each run's float64 identity sums added in
// record order from 0.0), each chunk's scalars, and the chain's end
// (end_off), its stop and its error.
//
// Bound: the 32-byte sectors that hold what the scan has to read, read
// once over HBM (3.35 TB/s), and the blocks, runs and chunk words written
// once. A record's fixed fields from block_size to l_seq, and of a record
// the flags let through its CIGAR and its aux tags up to NM; never the read
// name, the sequence or the qualities, so on short reads about a third of
// the inflated bytes (ops/bam_scan.bytes_read counts them; chip_smoke.py
// reports the bound, PERF.md §6 keeps it). The chain is a walk of
// dependent loads (each record's length gives the next record's start), so
// the design is about latency, not bandwidth:
//   (a) speculate: one warp per 64 KiB region of the segment. The lanes
//       test 32 offsets at a time for a plausible record header and lane 0
//       walks the chain from the first one to the region's end, keeping
//       the starts it meets (sorted, as offsets in the region) and where
//       the chain leaves the region. All regions walk at once.
//   (b) stitch: one thread walks the regions in order from the segment's
//       anchor (the carried record's start, known exactly). Where the true
//       entry of a region is its speculative chain's first start, or one
//       of its starts (a binary search), the region's records and exit are
//       known; otherwise the thread walks the region itself from the true
//       entry, until it meets the speculative chain or leaves the region.
//       A missed speculation costs time, never correctness: a false
//       candidate (quality or aux bytes that look like a header) only
//       sends the speculation down a chain that the stitch does not take.
//       The stitch reproduces run_stats_pipeline's chain: it stops at
//       block_size 0 or at a record that runs past the end (the carry) and
//       raises the chain error at block_size < 33 with the same record
//       index. The regions' speculation is staged in shared memory a tile
//       at a time, so the common step reads no device memory.
//   (c) records, launched twice. Analyse: a warp per region, a lane per
//       record, does scan_chunk_records' per-record work (flag masks, the
//       geometry check, the CIGAR walk, the NM search of scan_aux_tags,
//       the single-read filter, the tid range check) and writes a count of
//       blocks a record. Between the launches the caller takes the
//       exclusive scan of the counts. Emit and fold: the region warps
//       write each record's blocks at its offset, and one block a chunk
//       folds the chunk's records in order into runs and the chunk's
//       scalars, its thread 0 adding from tiles its other threads stage in
//       shared memory.
// The float32 quotients of the single-read filter must round as numpy's
// do: the library is built without fast math, with -prec-div=true
// -ftz=false -fmad=false (ops/cuda_build.py).
//
// The same source builds for the host with g++ (no __CUDACC__): each step
// runs region by region and record by record in one thread, through the
// same functions (bam_scan_host), so the CPU tests hold this code against
// the host scan.

#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define SCAN_HD __host__ __device__ __forceinline__
#else
#define SCAN_HD inline
#endif

namespace {

constexpr int kLogRegion = 16;
constexpr long long kRegion = 1ll << kLogRegion;  // bytes a region
// record starts a region can hold: a record takes 4 + 33 bytes or more
constexpr int kCap = (int)((kRegion - 1) / 37 + 1);
constexpr int kChunkShift = 15;
constexpr long long kChunk = 1ll << kChunkShift;  // the host's chunk
constexpr int kRunWords = 9;    // tid, 6 integer sums, 2 float64 sums
constexpr int kChunkWords = 8;  // n_primary, nm_missing, sorted, first and
                                // last tid, err, runs, 0
constexpr int kStitchWords = 8;  // records, end_off, err, stop, slow, 0...
constexpr int kWarps = 4;        // warps a block of the region kernels
constexpr int kTile = 2048;      // regions the stitch stages at a time
constexpr int kFoldTile = 512;   // records a fold tile stages
constexpr int kFoldThreads = 128;

// a record's flags (analyse -> fold)
constexpr uint8_t kPrimary = 1, kNonsupp = 2, kHasIdv = 4, kCounted = 8,
                  kError = 16;
// how the chain stopped
enum Stop { kEnd = 0, kZero = 1, kPastEnd = 2, kTooShort = 3 };

}  // namespace

// Every buffer of one segment's scan (device memory on the card, host
// memory in the host build); ops/bam_scan.py's ScanArgs has this layout.
struct ScanArgs {
  const uint8_t* data;  // the slot: records from `start`, bytes to `end`
  long long start, end, n_regions;
  int n_ref, skip_mask, req_mask, use_filter, min_mapq;
  long long min_aligned_length;
  float min_aligned_percent, min_identity;
  // speculate
  int* list;           // [n_regions][kCap] starts, offsets in the region
  long long* first;    // [n_regions] the chain's first start, or -1
  long long* exit_;    // [n_regions] where it left the region or stopped
  int* cnt;            // [n_regions] its starts in the region
  // stitch
  long long* entry;    // [n_regions] the true chain's entry
  int* rank;           // [n_regions] its index in list, or -1: walk it
  int* count;          // [n_regions] the true chain's records there
  long long* base;     // [n_regions] the index of the first of them
  long long* stitch;   // [kStitchWords]
  // records
  long long n_records;
  long long* rec_off;  // [n_records]
  uint8_t* flags;
  int* tid;
  int* nblk;           // blocks a record leaves (0 unless counted)
  long long* nm;
  long long* ind;
  double* idv;
  const long long* blk_off;  // [n_records] exclusive scan of nblk
  int* btid;
  int* bstart;
  int* bend;
  long long* runs;     // [chunks * kChunk][kRunWords], a chunk's from its
                       // first record's slot
  long long* chunks;   // [chunks][kChunkWords]
};

namespace {

SCAN_HD long long min_ll(long long a, long long b) { return a < b ? a : b; }

SCAN_HD uint32_t ld_u32(const uint8_t* p) {
  return (uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 |
         (uint32_t)p[3] << 24;
}

SCAN_HD uint32_t ld_u16(const uint8_t* p) {
  return (uint32_t)p[0] | (uint32_t)p[1] << 8;
}

SCAN_HD long long f64_bits(double d) {
#ifdef __CUDA_ARCH__
  return __double_as_longlong(d);
#else
  long long w;
  memcpy(&w, &d, 8);
  return w;
#endif
}

// A record header at q that a true record would have: a block_size of 33
// or more inside the bytes, refID and next_refID in [-1, n_ref), a read
// name of one byte or more ending in NUL, and the fixed, name, CIGAR,
// sequence and quality lengths within block_size.
SCAN_HD bool plausible(const uint8_t* d, long long q, long long end,
                       int n_ref) {
  if (q + 36 > end) return false;
  const uint8_t* p = d + q;
  uint32_t bs = ld_u32(p);
  if (bs < 33 || q + 4 + (long long)bs > end) return false;
  int32_t ref = (int32_t)ld_u32(p + 4);
  int32_t next_ref = (int32_t)ld_u32(p + 24);
  if (ref < -1 || ref >= n_ref || next_ref < -1 || next_ref >= n_ref)
    return false;
  int l_rn = p[12];
  int32_t l_seq = (int32_t)ld_u32(p + 20);
  if (l_rn < 1 || l_seq < 0) return false;
  long long need = 32 + (long long)l_rn + 4ll * ld_u16(p + 16) +
                   ((long long)l_seq + 1) / 2 + l_seq;
  return need <= (long long)bs && p[36 + l_rn - 1] == 0;
}

// The chain from p to the end of region b: its starts into list, where it
// left the region (or stopped before), and how many.
SCAN_HD void speculate_walk(const ScanArgs& a, long long b, long long p) {
  long long r0 = a.start + (b << kLogRegion);
  long long r1 = min_ll(r0 + kRegion, a.end);
  int* list = a.list + b * kCap;
  long long pos = p;
  int n = 0;
  while (pos < r1 && pos + 4 <= a.end) {
    uint32_t bs = ld_u32(a.data + pos);
    if (bs == 0 || pos + 4 + (long long)bs > a.end || bs < 33) break;
    list[n++] = (int)(pos - r0);
    pos += 4 + (long long)bs;
  }
  a.first[b] = p;
  a.exit_[b] = pos;
  a.cnt[b] = n;
}

SCAN_HD int find(const int* list, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (list[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo < n && list[lo] == v ? lo : -1;
}

struct StitchState {
  long long e, nrec, slow, end_off, err;
  int stop;
  bool done;
};

// The true chain over regions [t0, t1), whose speculation is f_, x_, c_
// (indexed from t0), from s.e on.
SCAN_HD void stitch_tile(const ScanArgs& a, const long long* f_,
                         const long long* x_, const int* c_, long long t0,
                         long long t1, StitchState& s) {
  while (!s.done) {
    long long e = s.e;
    if (e + 4 > a.end) {
      s.done = true;
      s.end_off = e;
      s.stop = kEnd;
      return;
    }
    long long b = (e - a.start) >> kLogRegion;
    if (b >= t1) return;
    long long r0 = a.start + (b << kLogRegion);
    long long r1 = min_ll(r0 + kRegion, a.end);
    long long f = f_[b - t0];
    int sc = c_[b - t0];
    const int* list = a.list + b * kCap;
    int k = -1;
    if (f == e)
      k = 0;
    else if (f >= 0 && f < e)
      k = find(list, sc, (int)(e - r0));
    long long c, x;
    if (k >= 0) {
      c = sc - k;
      x = x_[b - t0];
    } else {
      s.slow++;
      long long pos = e;
      c = 0;
      while (pos < r1 && pos + 4 <= a.end) {
        uint32_t bs = ld_u32(a.data + pos);
        if (bs == 0 || pos + 4 + (long long)bs > a.end || bs < 33) break;
        c++;
        pos += 4 + (long long)bs;
        if (pos < r1 && f >= 0 && pos > f) {
          int j = find(list, sc, (int)(pos - r0));
          if (j >= 0) {
            c += sc - j;
            pos = x_[b - t0];
            break;
          }
        }
      }
      x = pos;
    }
    a.entry[b] = e;
    a.rank[b] = k;
    a.count[b] = (int)c;
    a.base[b] = s.nrec;
    s.nrec += c;
    s.e = x;
    if (x < r1) {  // the chain stops in this region
      s.done = true;
      s.end_off = x;
      if (x + 4 > a.end) {
        s.stop = kEnd;
      } else {
        uint32_t bs = ld_u32(a.data + x);
        if (bs == 0) {
          s.stop = kZero;
        } else if (x + 4 + (long long)bs > a.end) {
          s.stop = kPastEnd;
        } else {
          s.stop = kTooShort;  // below the BAM fixed-block minimum
          s.err = s.nrec + 1;
        }
      }
      return;
    }
  }
}

SCAN_HD void stitch_finish(const ScanArgs& a, const StitchState& s) {
  a.stitch[0] = s.nrec;
  a.stitch[1] = s.end_off;
  a.stitch[2] = s.err;
  a.stitch[3] = s.stop;
  a.stitch[4] = s.slow;
  for (int i = 5; i < kStitchWords; i++) a.stitch[i] = 0;
}

// The single-read filter of native/bamdecode.cpp single_read_passes
// (readfilter.single_read_passes), bit for bit: IEEE float32 quotients, so
// 0/0 is NaN and fails every test and x/0 is +inf and passes.
SCAN_HD bool single_read_passes(const ScanArgs& a, uint8_t mapq,
                                long long aligned, int32_t l_seq,
                                long long nm) {
  if (a.min_mapq != 255 && (mapq < a.min_mapq || mapq == 255)) return false;
  float frac = (float)aligned / (float)l_seq;
  float identity = 1.0f - (float)nm / (float)aligned;
  return aligned >= a.min_aligned_length && frac >= a.min_aligned_percent &&
         identity >= a.min_identity;
}

// scan_aux_tags of native/bamdecode.cpp for NM alone: 0 (nm -1 when
// absent) or -1 on a malformed or truncated tag.
SCAN_HD int scan_aux_nm(const uint8_t* rec, long long aux, long long rec_len,
                        long long* nm) {
  *nm = -1;
  if (aux < 0 || aux > rec_len) aux = rec_len;  // corrupt: no aux region
  while (aux + 3 <= rec_len) {
    uint8_t t0 = rec[aux], t1 = rec[aux + 1], typ = rec[aux + 2];
    aux += 3;
    long long val = 0;
    bool has_val = true;
    switch (typ) {
      case 'A':
      case 'C':
      case 'c':
        if (aux + 1 > rec_len) return -1;
        val = typ == 'c' ? (long long)(int8_t)rec[aux] : (long long)rec[aux];
        aux += 1;
        break;
      case 'S':
      case 's': {
        if (aux + 2 > rec_len) return -1;
        uint32_t v = ld_u16(rec + aux);
        val = typ == 's' ? (long long)(int16_t)v : (long long)v;
        aux += 2;
        break;
      }
      case 'I':
        if (aux + 4 > rec_len) return -1;
        val = (long long)ld_u32(rec + aux);
        aux += 4;
        break;
      case 'i':
        if (aux + 4 > rec_len) return -1;
        val = (long long)(int32_t)ld_u32(rec + aux);
        aux += 4;
        break;
      case 'f':
        aux += 4;
        has_val = false;
        break;
      case 'Z':
      case 'H':
        while (aux < rec_len && rec[aux] != 0) aux++;
        aux++;
        has_val = false;
        break;
      case 'B': {
        if (aux + 5 > rec_len) return -1;
        uint8_t sub = rec[aux];
        uint32_t cnt = ld_u32(rec + aux + 1);
        int esz = (sub == 'c' || sub == 'C')   ? 1
                  : (sub == 's' || sub == 'S') ? 2
                                               : 4;
        aux += 5 + (long long)cnt * esz;
        has_val = false;
        break;
      }
      default:
        return -1;
    }
    if (has_val && t0 == 'N' && t1 == 'M') {
      *nm = val;
      return 0;
    }
  }
  return 0;
}

// scan_chunk_records' work on record g at off, less the fold: its flags,
// tid, block count, NM, indels and identity.
SCAN_HD void analyse(const ScanArgs& a, long long off, long long g) {
  const uint8_t* rec = a.data + off + 4;
  long long rec_len = ld_u32(a.data + off);
  int32_t tid = (int32_t)ld_u32(rec);
  int l_rn = rec[8];
  uint32_t n_cigar = ld_u16(rec + 12);
  uint32_t flag = ld_u16(rec + 14);
  bool primary = (flag & 0x900) == 0;
  bool nonsupp = (flag & 0x800) == 0;
  uint8_t fl = (primary ? kPrimary : 0) | (nonsupp ? kNonsupp : 0);
  int nb = 0;
  long long nm = -1, ind = 0;
  double idv = 0.0;
  bool mapped = (flag & 0x4) == 0;
  bool pass = ((flag & (uint32_t)a.skip_mask) == 0) &&
              ((flag & (uint32_t)a.req_mask) == (uint32_t)a.req_mask);
  if (pass && mapped) {
    int32_t l_seq = (int32_t)ld_u32(rec + 16);
    if (l_seq < 0 || 32 + (long long)l_rn + 4ll * n_cigar > rec_len) {
      fl |= kError;
    } else {
      const uint8_t* cig = rec + 32 + l_rn;
      long long a_cov = 0;
      for (uint32_t k = 0; k < n_cigar; k++) {
        uint32_t c = ld_u32(cig + 4 * k);
        uint32_t op = c & 0xF;
        long long ln = c >> 4;
        if (op == 0 || op == 7 || op == 8) {
          nb++;
          a_cov += ln;
        } else if (op == 1 || op == 2) {
          a_cov += ln;
          ind += ln;
        }
      }
      // (l_seq + 1) / 2 in int32, as the host computes it
      long long aux = 32 + (long long)l_rn + 4ll * n_cigar +
                      (int32_t)((uint32_t)l_seq + 1u) / 2 + l_seq;
      if (scan_aux_nm(rec, aux, rec_len, &nm) != 0) {
        fl |= kError;
      } else if (a.use_filter &&
                 !single_read_passes(a, rec[9], a_cov, l_seq, nm)) {
        // dropped by the filter: only its primary flag counts
      } else if (tid < 0 || tid >= a.n_ref) {
        fl |= kError;
      } else {
        fl |= kCounted;
        if (nm >= 0 && a_cov > 0) {
          fl |= kHasIdv;
          idv = (double)(a_cov - nm) / (double)a_cov;
        }
      }
    }
  }
  a.flags[g] = fl;
  a.tid[g] = tid;
  a.nblk[g] = (fl & kCounted) ? nb : 0;
  a.nm[g] = nm;
  a.ind[g] = ind;
  a.idv[g] = idv;
}

// Record g's blocks at its offset of the exclusive scan.
SCAN_HD void emit(const ScanArgs& a, long long g) {
  long long off = a.rec_off[g];
  const uint8_t* rec = a.data + off + 4;
  int l_rn = rec[8];
  uint32_t n_cigar = ld_u16(rec + 12);
  const uint8_t* cig = rec + 32 + l_rn;
  long long cursor = (int32_t)ld_u32(rec + 4);
  long long o = a.blk_off[g];
  int tid = a.tid[g];
  for (uint32_t k = 0; k < n_cigar; k++) {
    uint32_t c = ld_u32(cig + 4 * k);
    uint32_t op = c & 0xF;
    long long ln = c >> 4;
    if (op == 0 || op == 7 || op == 8) {
      a.btid[o] = tid;
      a.bstart[o] = (int32_t)cursor;
      a.bend[o] = (int32_t)(cursor + ln);
      o++;
      cursor += ln;
    } else if (op == 2 || op == 3) {
      cursor += ln;
    }
  }
}

struct Run {
  long long tid, primary, nonsupp, all, nm, indel, blocks;
  double ident_primary, ident_nonsupp;
};

struct FoldState {
  long long n_primary, nm_missing, err, n_runs;
  int first_tid, last_tid, prev_tid, cur_tid;
  bool sorted, stop;
  Run run;
};

SCAN_HD void fold_init(FoldState& s) {
  s.n_primary = s.nm_missing = s.err = s.n_runs = 0;
  s.first_tid = s.last_tid = s.prev_tid = -1;
  s.cur_tid = -2;
  s.sorted = true;
  s.stop = false;
  s.run = Run{};
}

SCAN_HD void fold_flush(FoldState& s, long long* runs) {
  if (s.cur_tid < 0) return;
  long long* w = runs + s.n_runs * kRunWords;
  w[0] = s.run.tid;
  w[1] = s.run.primary;
  w[2] = s.run.nonsupp;
  w[3] = s.run.all;
  w[4] = s.run.nm;
  w[5] = s.run.indel;
  w[6] = s.run.blocks;
  w[7] = f64_bits(s.run.ident_primary);
  w[8] = f64_bits(s.run.ident_nonsupp);
  s.n_runs++;
}

// scan_chunk_records' fold of record r of the chunk (runs: the chunk's).
SCAN_HD void fold_one(FoldState& s, long long r, uint8_t fl, int tid, int nb,
                      long long nm, long long ind, double idv,
                      long long* runs) {
  bool primary = fl & kPrimary;
  s.n_primary += primary;
  if (fl & kError) {
    s.err = r + 1;
    fold_flush(s, runs);
    s.stop = true;
    return;
  }
  if (!(fl & kCounted)) return;
  if (s.first_tid < 0) s.first_tid = tid;
  if (tid < s.prev_tid) s.sorted = false;
  s.prev_tid = tid;
  s.last_tid = tid;
  if (tid != s.cur_tid) {
    fold_flush(s, runs);
    s.run = Run{};
    s.run.tid = tid;
    s.cur_tid = tid;
  }
  bool nonsupp = fl & kNonsupp;
  s.run.all++;
  s.run.primary += primary;
  s.run.nonsupp += nonsupp;
  s.run.blocks += nb;
  s.run.indel += ind;
  if (nm < 0) {
    s.nm_missing++;  // the caller raises before any result is used
  } else {
    s.run.nm += nm;
    if (fl & kHasIdv) {
      s.run.ident_primary += primary ? idv : 0.0;
      s.run.ident_nonsupp += nonsupp ? idv : 0.0;
    }
  }
}

SCAN_HD void fold_finish(const ScanArgs& a, FoldState& s, long long c) {
  if (!s.stop) fold_flush(s, a.runs + c * kChunk * kRunWords);
  long long* w = a.chunks + c * kChunkWords;
  w[0] = s.n_primary;
  w[1] = s.nm_missing;
  w[2] = s.sorted ? 1 : 0;
  w[3] = s.first_tid;
  w[4] = s.last_tid;
  w[5] = s.err;
  w[6] = s.n_runs;
  w[7] = 0;
}

SCAN_HD long long n_chunks(const ScanArgs& a) {
  return (a.n_records + kChunk - 1) >> kChunkShift;
}

}  // namespace

#ifdef __CUDACC__

namespace {

__global__ void __launch_bounds__(32 * kWarps)
    bam_scan_speculate(ScanArgs a) {
  int lane = threadIdx.x & 31;
  long long b = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= a.n_regions) return;  // the whole warp
  long long r0 = a.start + (b << kLogRegion);
  long long r1 = min_ll(r0 + kRegion, a.end);
  long long p = -1;
  if (b == 0) {
    p = a.start;  // the anchor
  } else {
    for (long long q0 = r0; q0 < r1; q0 += 32) {
      long long q = q0 + lane;
      unsigned m = __ballot_sync(
          0xffffffffu, q < r1 && plausible(a.data, q, a.end, a.n_ref));
      if (m) {
        p = q0 + __ffs(m) - 1;
        break;
      }
    }
  }
  if (lane != 0) return;
  if (p < 0) {
    a.first[b] = -1;
    a.exit_[b] = -1;
    a.cnt[b] = 0;
  } else {
    speculate_walk(a, b, p);
  }
}

__global__ void __launch_bounds__(256) bam_scan_stitch(ScanArgs a) {
  __shared__ long long sf[kTile], sx[kTile];
  __shared__ int sc[kTile];
  StitchState s{a.start, 0, 0, a.start, 0, kEnd, false};
  for (long long t0 = 0; t0 < a.n_regions; t0 += kTile) {
    long long t1 = min_ll(t0 + kTile, a.n_regions);
    for (long long i = t0 + threadIdx.x; i < t1; i += blockDim.x) {
      sf[i - t0] = a.first[i];
      sx[i - t0] = a.exit_[i];
      sc[i - t0] = a.cnt[i];
      a.count[i] = 0;
    }
    __syncthreads();
    if (threadIdx.x == 0) stitch_tile(a, sf, sx, sc, t0, t1, s);
    __syncthreads();
  }
  if (threadIdx.x == 0) stitch_finish(a, s);
}

// mode 0 analyse; mode 1 the region blocks emit and the blocks after them
// fold one chunk each
__global__ void __launch_bounds__(kFoldThreads)
    bam_scan_records(ScanArgs a, int mode) {
  extern __shared__ unsigned char smem[];
  long long region_blocks = (a.n_regions + kWarps - 1) / kWarps;
  if ((long long)blockIdx.x < region_blocks) {
    int lane = threadIdx.x & 31;
    long long b = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (b >= a.n_regions) return;
    int c = a.count[b];
    long long base = a.base[b];
    if (mode == 0) {
      int k = a.rank[b];
      if (k >= 0) {
        long long r0 = a.start + (b << kLogRegion);
        const int* list = a.list + b * kCap + k;
        for (int i = lane; i < c; i += 32) a.rec_off[base + i] = r0 + list[i];
      } else if (lane == 0) {
        long long pos = a.entry[b];
        for (int i = 0; i < c; i++) {
          a.rec_off[base + i] = pos;
          pos += 4 + (long long)ld_u32(a.data + pos);
        }
      }
      __syncwarp();
      for (int i = lane; i < c; i += 32)
        analyse(a, a.rec_off[base + i], base + i);
    } else {
      for (int i = lane; i < c; i += 32) {
        long long g = base + i;
        if (a.nblk[g]) emit(a, g);
      }
    }
    return;
  }
  // fold chunk ch: thread 0 adds, tile by tile, what the block stages
  long long ch = (long long)blockIdx.x - region_blocks;
  long long lo = ch << kChunkShift;
  long long hi = min_ll(lo + kChunk, a.n_records);
  double* t_idv = (double*)smem;
  long long* t_nm = (long long*)(t_idv + kFoldTile);
  long long* t_ind = t_nm + kFoldTile;
  int* t_tid = (int*)(t_ind + kFoldTile);
  int* t_nb = t_tid + kFoldTile;
  uint8_t* t_fl = (uint8_t*)(t_nb + kFoldTile);
  FoldState s;
  fold_init(s);
  long long* runs = a.runs + lo * kRunWords;
  for (long long t = lo; t < hi; t += kFoldTile) {
    long long n = min_ll(kFoldTile, hi - t);
    for (long long i = threadIdx.x; i < n; i += blockDim.x) {
      t_idv[i] = a.idv[t + i];
      t_nm[i] = a.nm[t + i];
      t_ind[i] = a.ind[t + i];
      t_tid[i] = a.tid[t + i];
      t_nb[i] = a.nblk[t + i];
      t_fl[i] = a.flags[t + i];
    }
    __syncthreads();
    if (threadIdx.x == 0)
      for (long long i = 0; i < n && !s.stop; i++)
        fold_one(s, t - lo + i, t_fl[i], t_tid[i], t_nb[i], t_nm[i],
                 t_ind[i], t_idv[i], runs);
    __syncthreads();
  }
  if (threadIdx.x == 0) fold_finish(a, s, ch);
}

constexpr int kFoldSmem = kFoldTile * (8 + 8 + 8 + 4 + 4 + 1);

}  // namespace

extern "C" {

// Step `step` of one segment's scan on card `device`, on `stream`: 0
// speculate, 1 stitch, 2 analyse, 3 emit and fold. Returns 0, or the CUDA
// error plus 1000 times the step that met it (1 the card, 2 the launch).
// Every pointer of *args is the card's memory. The library links its own
// static runtime, so the caller names the card, as for sweep_scan_launch.
int bam_scan_launch(int step, const ScanArgs* args, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return 1000 + (int)err;
  const ScanArgs a = *args;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned region_blocks = (unsigned)((a.n_regions + kWarps - 1) / kWarps);
  switch (step) {
    case 0:
      if (a.n_regions)
        bam_scan_speculate<<<region_blocks, 32 * kWarps, 0, st>>>(a);
      break;
    case 1:
      bam_scan_stitch<<<1, 256, 0, st>>>(a);
      break;
    case 2:
      if (a.n_regions)
        bam_scan_records<<<region_blocks, kFoldThreads, 0, st>>>(a, 0);
      break;
    case 3:
      if (region_blocks + n_chunks(a))
        bam_scan_records<<<region_blocks + (unsigned)n_chunks(a),
                           kFoldThreads, kFoldSmem, st>>>(a, 1);
      break;
    default:
      return 2000 + (int)cudaErrorInvalidValue;
  }
  err = cudaGetLastError();
  return err == cudaSuccess ? 0 : 2000 + (int)err;
}

}  // extern "C"

#else  // the host build

extern "C" {

// Step `step` of one segment's scan on the host, in one thread through the
// kernels' own functions; the CPU tests' view of the kernels.
int bam_scan_host(int step, const ScanArgs* args) {
  const ScanArgs& a = *args;
  switch (step) {
    case 0:
      for (long long b = 0; b < a.n_regions; b++) {
        long long r0 = a.start + (b << kLogRegion);
        long long r1 = min_ll(r0 + kRegion, a.end);
        long long p = b == 0 ? a.start : -1;
        for (long long q = r0; p < 0 && q < r1; q++)
          if (plausible(a.data, q, a.end, a.n_ref)) p = q;
        if (p < 0) {
          a.first[b] = -1;
          a.exit_[b] = -1;
          a.cnt[b] = 0;
        } else {
          speculate_walk(a, b, p);
        }
      }
      return 0;
    case 1: {
      StitchState s{a.start, 0, 0, a.start, 0, kEnd, false};
      for (long long b = 0; b < a.n_regions; b++) a.count[b] = 0;
      stitch_tile(a, a.first, a.exit_, a.cnt, 0, a.n_regions, s);
      stitch_finish(a, s);
      return 0;
    }
    case 2:
      for (long long b = 0; b < a.n_regions; b++) {
        int c = a.count[b];
        long long pos = a.entry[b];
        for (int i = 0; i < c; i++) {
          long long g = a.base[b] + i;
          if (a.rank[b] >= 0) {
            a.rec_off[g] = a.start + (b << kLogRegion) +
                           a.list[b * kCap + a.rank[b] + i];
          } else {
            a.rec_off[g] = pos;
            pos += 4 + (long long)ld_u32(a.data + pos);
          }
          analyse(a, a.rec_off[g], g);
        }
      }
      return 0;
    case 3:
      for (long long g = 0; g < a.n_records; g++)
        if (a.nblk[g]) emit(a, g);
      for (long long ch = 0; ch < n_chunks(a); ch++) {
        long long lo = ch << kChunkShift;
        long long hi = min_ll(lo + kChunk, a.n_records);
        FoldState s;
        fold_init(s);
        for (long long g = lo; g < hi && !s.stop; g++)
          fold_one(s, g - lo, a.flags[g], a.tid[g], a.nblk[g], a.nm[g],
                   a.ind[g], a.idv[g], a.runs + lo * kRunWords);
        fold_finish(a, s, ch);
      }
      return 0;
    default:
      return -1;
  }
}

}  // extern "C"

#endif

extern "C" {

// The layout constants the wrapper sizes its buffers by.
int bam_scan_region_bytes() { return (int)kRegion; }
int bam_scan_region_cap() { return kCap; }
int bam_scan_args_bytes() { return (int)sizeof(ScanArgs); }

}  // extern "C"
