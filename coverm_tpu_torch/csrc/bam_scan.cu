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
//   (b) stitch, launched twice. The check: one block tests every region at
//       once against the region before it. Region b is simple when the
//       speculative exit of region b-1 (the anchor, the carried record's
//       start, for b = 0) lies in region b and is its speculative chain's
//       first start, or one of its starts (a binary search), and every
//       region before it is simple. A min-reduce finds F, the first region
//       that is not simple, and the first region whose chain stops; before
//       those, each region's records are its speculation's, and their
//       index is an exclusive block scan of the counts. The walk: when F
//       comes first, one thread walks on in order from F's true entry (the
//       exit of region F-1), region by region, taking a region's
//       speculation where the entry meets it and walking the region itself
//       otherwise, until it meets the speculative chain or leaves the
//       region; the regions' speculation is staged in shared memory a tile
//       at a time. On the cells every speculation is right and the walk
//       has nothing to do. A missed speculation costs time, never
//       correctness: a false candidate (quality or aux bytes that look like
//       a header) or a record longer than a region only moves F forward.
//       The stitch reproduces run_stats_pipeline's chain: it stops at
//       block_size 0 or at a record that runs past the end (the carry) and
//       raises the chain error at block_size < 33 with the same record
//       index.
//   (c) records, launched twice. Analyse: a warp per region, a lane per
//       record, does scan_chunk_records' per-record work (flag masks, the
//       geometry check, the CIGAR walk, the NM search of scan_aux_tags,
//       the single-read filter, the tid range check) and writes a count of
//       blocks a record. Between the launches the caller takes the
//       exclusive scan of the counts. Emit: the region warps write each
//       record's blocks at its offset.
//   (d) fold: one block a 32,768-record chunk, every thread working, a
//       tile of 256 records at a time. A min-reduce finds the chunk's first
//       error. Block scans compact the counted records before it in record
//       order into shared memory, mark the runs (a counted record whose tid
//       differs from the counted record before it starts one), and sum the
//       runs' integer words and the chunk's counts; a run's integer sums
//       are differences of the scan at its ends, exact in any order. Only
//       the two float64 identity sums of a run need record order: one
//       thread a run adds them from the compacted tile, eight loads ahead of
//       its dependent adds, carrying the run in progress to the next tile.
//       Skipping the records that are not counted is exact: the host adds
//       nothing for them or +0.0, x + (+0.0) == x for every x the sum can
//       hold (it starts at +0.0 and never holds -0.0 under round-to-
//       nearest), and a record's identity is finite (its aligned length is
//       above 0).
// The float32 quotients of the single-read filter must round as numpy's
// do: the library is built without fast math, with -prec-div=true
// -ftz=false -fmad=false (ops/cuda_build.py).
//
// The same source builds for the host with g++ (no __CUDACC__): each step
// runs through the same functions (bam_scan_host), a block's threads one
// after another and its scans as loops, so the CPU tests hold this code
// against the host scan.

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
constexpr int kWarps = 4;       // warps a block of the region kernels
constexpr int kTile = 2048;     // regions the stitch's walk stages at a time
constexpr int kThreads = 256;   // threads a block of the stitch's check and
                                // of the fold, records a fold tile

// a record's flags (analyse -> fold); kRunHead only in the fold's tile
constexpr uint8_t kPrimary = 1, kNonsupp = 2, kHasIdv = 4, kCounted = 8,
                  kError = 16, kRunHead = 32;
// how the chain stopped
enum Stop { kEnd = 0, kZero = 1, kPastEnd = 2, kTooShort = 3 };
// the launches of one segment's scan, in order
enum Step {
  kSpeculate = 0,
  kStitchCheck = 1,
  kStitchWalk = 2,
  kAnalyse = 3,
  kFold = 4,
  kEmit = 5
};

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

// ---- one block's work, written once for the card and the host

// Runs f(t) for every thread t of the block, then waits for them all: on
// the card each thread runs its own f and meets the others at a
// __syncthreads(); the host runs the threads one after another. So f
// writes only shared or device memory and its own locals; what the
// block's threads all hold alike lives in the caller's locals.
template <class F>
SCAN_HD void each(F f) {
#ifdef __CUDA_ARCH__
  f((int)threadIdx.x);
  __syncthreads();
#else
  for (int t = 0; t < kThreads; t++) f(t);
#endif
}

// Exclusive scan over the block's threads of x[t * N + k], in place, for
// each k < N; the totals into tot[k]. warp: kThreads / 32 * N words of
// shared scratch. On the card every thread calls it: warp shuffles, then
// the warps' totals scanned by warp 0.
template <int N>
SCAN_HD void block_scan(long long* x, long long* warp, long long* tot) {
#ifdef __CUDA_ARCH__
  constexpr int kW = kThreads / 32;
  int t = threadIdx.x, lane = t & 31, w = t >> 5;
  long long v[N], s[N];
#pragma unroll
  for (int k = 0; k < N; k++) s[k] = v[k] = x[t * N + k];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1)
#pragma unroll
    for (int k = 0; k < N; k++) {
      long long o = __shfl_up_sync(0xffffffffu, s[k], d);
      if (lane >= d) s[k] += o;
    }
  if (lane == 31)
#pragma unroll
    for (int k = 0; k < N; k++) warp[w * N + k] = s[k];
  __syncthreads();
  if (w == 0) {
#pragma unroll
    for (int k = 0; k < N; k++) {
      long long u = lane < kW ? warp[lane * N + k] : 0, incl = u;
#pragma unroll
      for (int d = 1; d < kW; d <<= 1) {
        long long o = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += o;
      }
      if (lane < kW) warp[lane * N + k] = incl - u;
      if (lane == kW - 1) tot[k] = incl;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; k++) x[t * N + k] = s[k] - v[k] + warp[w * N + k];
  __syncthreads();
#else
  (void)warp;
  long long run[N] = {};
  for (int t = 0; t < kThreads; t++)
    for (int k = 0; k < N; k++) {
      long long v = x[t * N + k];
      x[t * N + k] = run[k];
      run[k] += v;
    }
  for (int k = 0; k < N; k++) tot[k] = run[k];
#endif
}

// *p = min(*p, v), *p in shared memory (an integer atomic on the card)
SCAN_HD void shared_min(long long* p, long long v) {
#ifdef __CUDA_ARCH__
  atomicMin(p, v);
#else
  if (v < *p) *p = v;
#endif
}

// ---- (a) speculate

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

// ---- (b) stitch

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

// The index of entry e (in the region from r0) among the starts of the
// region's speculative chain (first start f, n starts in list), or -1.
SCAN_HD int spec_rank(long long f, const int* list, int n, long long e,
                      long long r0) {
  if (f == e) return 0;
  if (f >= 0 && f < e) return find(list, n, (int)(e - r0));
  return -1;
}

struct StitchState {
  long long e, nrec, slow, seq, end_off, err;
  int stop;
  bool done;
};

// The chain stops at x, after s.nrec records: how, as the host's walk
// tells it.
SCAN_HD void stitch_end(const ScanArgs& a, long long x, StitchState& s) {
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
}

// The true chain over regions [t0, t1), whose speculation is f_, x_, c_
// (indexed from t0), from s.e on.
SCAN_HD void stitch_tile(const ScanArgs& a, const long long* f_,
                         const long long* x_, const int* c_, long long t0,
                         long long t1, StitchState& s) {
  while (!s.done) {
    long long e = s.e;
    if (e + 4 > a.end) {
      stitch_end(a, e, s);
      return;
    }
    long long b = (e - a.start) >> kLogRegion;
    if (b >= t1) return;
    long long r0 = a.start + (b << kLogRegion);
    long long r1 = min_ll(r0 + kRegion, a.end);
    long long f = f_[b - t0];
    int sc = c_[b - t0];
    const int* list = a.list + b * kCap;
    int k = spec_rank(f, list, sc, e, r0);
    long long c, x;
    s.seq++;
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
      stitch_end(a, x, s);
      return;
    }
  }
}

// The stitch's eight words: records, end_off, err, stop, regions walked
// again, regions walked in sequence, the first of those (`from`, 0: none),
// 0.
SCAN_HD void stitch_finish(const ScanArgs& a, const StitchState& s,
                           long long from) {
  a.stitch[0] = s.nrec;
  a.stitch[1] = s.end_off;
  a.stitch[2] = s.err;
  a.stitch[3] = s.stop;
  a.stitch[4] = s.slow;
  a.stitch[5] = s.seq;
  a.stitch[6] = from;
  a.stitch[7] = 0;
}

struct CheckShared {
  long long count[kThreads];
  long long warp[kThreads / 32];
  long long tot, first_bad, first_stop;
};

// The stitch's check, for every region at once (see (b) above). When the
// chain stops before the first region that is not simple, it writes the
// stitch words; otherwise it leaves F in word 6 for the walk. Region 0 is
// always simple (its speculation starts at the anchor), so F >= 1.
SCAN_HD void stitch_check(const ScanArgs& a, CheckShared& s) {
  long long n = a.n_regions;
  each([&](int t) {
    if (t == 0) s.first_bad = s.first_stop = n;
  });
  each([&](int t) {
    long long bad = n, stops = n;
    for (long long b = t; b < n; b += kThreads) {
      long long r0 = a.start + (b << kLogRegion);
      long long r1 = min_ll(r0 + kRegion, a.end);
      long long e = b ? a.exit_[b - 1] : a.start;  // the candidate entry
      int k = e >= r0 && e < r1 ? spec_rank(a.first[b], a.list + b * kCap,
                                            a.cnt[b], e, r0)
                                : -1;
      a.entry[b] = e;
      a.rank[b] = k;
      a.count[b] = k >= 0 ? a.cnt[b] - k : 0;
      if (k < 0 && bad == n) bad = b;  // b rises: the thread's first is
      long long x = a.exit_[b];        // its least
      if ((x < r1 || x + 4 > a.end) && stops == n) stops = b;
    }
    shared_min(&s.first_bad, bad);
    shared_min(&s.first_stop, stops);
  });
  // The check settles regions [0, F). A chain that stops in a simple
  // region S leaves region S + 1 no entry it can meet, so S < F means
  // F == S + 1.
  long long F = s.first_bad, S = s.first_stop;
  long long carry = 0;
  for (long long t0 = 0; t0 < n; t0 += kThreads) {
    each([&](int t) {
      long long b = t0 + t;
      s.count[t] = b < F ? a.count[b] : 0;
      if (b >= F && b < n) a.count[b] = 0;
    });
    block_scan<1>(s.count, s.warp, &s.tot);
    each([&](int t) {
      long long b = t0 + t;
      if (b < F) a.base[b] = carry + s.count[t];
    });
    carry += s.tot;
  }
  each([&](int t) {
    if (t) return;
    StitchState st{};
    if (S < F) {
      st.nrec = a.base[S] + a.count[S];
      stitch_end(a, a.exit_[S], st);
      stitch_finish(a, st, 0);
    } else {
      stitch_finish(a, st, F);
    }
  });
}

// Where the walk from region F (stitch word 6) starts: the exit of region
// F-1, which the check settled, and the records before it.
SCAN_HD StitchState walk_start(const ScanArgs& a, long long F) {
  StitchState s{};
  s.e = a.exit_[F - 1];
  s.nrec = a.base[F - 1] + a.count[F - 1];
  return s;
}

// ---- (c) records

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

// ---- (d) fold

// the fold's scan columns: whether a record starts a run; the run words
// 1-6; the chunk's counts
enum Col {
  kHeadCol = 0,
  kPrimaryCol = 1,
  kNonsuppCol = 2,
  kAllCol = 3,
  kNmCol = 4,
  kIndelCol = 5,
  kBlocksCol = 6,
  kNPrimaryCol = 7,
  kNmMissingCol = 8,
  kUnsortedCol = 9,
  kCols = 10
};

struct RunSums {
  long long w[7];  // tid, then run words 1-6
  double ident_primary, ident_nonsupp;
};

struct FoldShared {
  long long pos[kThreads];          // counted? then its place in the tile
  long long col[kThreads * kCols];  // the columns of the tile's records
  long long warp[kThreads / 32 * kCols];
  long long tot[kCols], n_counted;
  double sp[kThreads], sn[kThreads];  // the tile's counted records in
  int stid[kThreads];                 // order: identity terms and tids
  int seg[kThreads + 1];  // the thread whose record starts segment h >= 1
  int tid[kThreads];
  uint8_t fl[kThreads];  // a counted record's flags, else 0
  RunSums carry[2];      // the run in progress, by the tile's parity
  long long stop;
};
static_assert(sizeof(FoldShared) <= 48 * 1024, "static shared memory");

// The float64 sums of the tile's counted records [j, e), added in record
// order onto x and y: only dependent adds, their loads eight ahead.
SCAN_HD void fold_chain(const double* sp, const double* sn, int j, int e,
                        double& x, double& y) {
  for (; j + 8 <= e; j += 8) {
    double p[8], q[8];
#pragma unroll
    for (int u = 0; u < 8; u++) {
      p[u] = sp[j + u];
      q[u] = sn[j + u];
    }
#pragma unroll
    for (int u = 0; u < 8; u++) {
      x += p[u];
      y += q[u];
    }
  }
  for (; j < e; j++) {
    x += sp[j];
    y += sn[j];
  }
}

SCAN_HD void put_run(long long* runs, long long r, const RunSums& s) {
  long long* w = runs + r * kRunWords;
  for (int k = 0; k < 7; k++) w[k] = s.w[k];
  w[7] = f64_bits(s.ident_primary);
  w[8] = f64_bits(s.ident_nonsupp);
}

// Segment h of H + 1 of a tile whose scans are done: segment 0 goes on
// with the run in progress (run n_runs - 1), the h-th run head starts
// segment h (run n_runs - 1 + h). A segment before the last ends its run;
// the last carries its run to the next tile.
SCAN_HD void fold_segment(const ScanArgs& a, FoldShared& s, long long lo,
                          int h, int H, long long n_runs, int par) {
  int n = (int)s.n_counted;
  int j0 = h ? (int)s.pos[s.seg[h]] : 0;
  int j1 = h < H ? (int)s.pos[s.seg[h + 1]] : n;
  RunSums r;
  if (h == 0) {
    r = s.carry[par];
  } else {
    r = RunSums{};
    r.w[0] = s.stid[j0];
  }
  for (int k = 1; k < 7; k++)
    r.w[k] += (h < H ? s.col[s.seg[h + 1] * kCols + k] : s.tot[k]) -
              (h ? s.col[s.seg[h] * kCols + k] : 0);
  fold_chain(s.sp, s.sn, j0, j1, r.ident_primary, r.ident_nonsupp);
  if (h == H)
    s.carry[par ^ 1] = r;
  else if (n_runs - 1 + h >= 0)
    put_run(a.runs + lo * kRunWords, n_runs - 1 + h, r);
}

// scan_chunk_records' fold of chunk ch by one block (see (d) above).
SCAN_HD void fold_chunk(const ScanArgs& a, long long ch, FoldShared& s) {
  long long lo = ch << kChunkShift;
  long long hi = min_ll(lo + kChunk, a.n_records);
  each([&](int t) {
    if (t) return;
    s.stop = hi;
    s.carry[0] = RunSums{};
  });
  each([&](int t) {  // the first error: every load at once, no early exit
    long long m = hi;
    for (long long g = lo + t; g < hi; g += kThreads)
      if ((a.flags[g] & kError) && g < m) m = g;
    shared_min(&s.stop, m);
  });
  long long stop = s.stop;
  long long last = stop < hi ? stop + 1 : hi;  // the error's primary counts
  long long n_runs = 0, first_tid = -1, last_tid = -1;
  long long acc[kCols] = {};
  int par = 0;
  for (long long t0 = lo; t0 < last; t0 += kThreads, par ^= 1) {
    each([&](int t) {
      long long g = t0 + t;
      uint8_t fl = g < last ? a.flags[g] : 0;
      bool c = g < stop && (fl & kCounted);
      long long nm = c ? a.nm[g] : 0;
      long long* v = s.col + t * kCols;
      s.fl[t] = c ? fl : 0;
      s.tid[t] = c ? a.tid[g] : 0;
      s.pos[t] = c;
      v[kHeadCol] = 0;
      v[kPrimaryCol] = c && (fl & kPrimary);
      v[kNonsuppCol] = c && (fl & kNonsupp);
      v[kAllCol] = c;
      v[kNmCol] = nm >= 0 ? nm : 0;
      v[kIndelCol] = c ? a.ind[g] : 0;
      v[kBlocksCol] = c ? a.nblk[g] : 0;
      v[kNPrimaryCol] = (fl & kPrimary) != 0;
      v[kNmMissingCol] = nm < 0;
      v[kUnsortedCol] = 0;
    });
    block_scan<1>(s.pos, s.warp, &s.n_counted);
    each([&](int t) {  // the counted records, compacted in order
      uint8_t fl = s.fl[t];
      if (!fl) return;
      int p = (int)s.pos[t];
      double idv = a.idv[t0 + t];
      s.stid[p] = s.tid[t];
      s.sp[p] = (fl & kHasIdv) && (fl & kPrimary) ? idv : 0.0;
      s.sn[p] = (fl & kHasIdv) && (fl & kNonsupp) ? idv : 0.0;
    });
    each([&](int t) {  // a run starts where the tid changes
      if (!s.fl[t]) return;
      int p = (int)s.pos[t];
      int prev = p ? s.stid[p - 1] : (int)last_tid;  // -1: none yet
      bool head = s.tid[t] != prev;
      s.col[t * kCols + kHeadCol] = head;
      s.col[t * kCols + kUnsortedCol] = s.tid[t] < prev;
      if (head) s.fl[t] |= kRunHead;
    });
    block_scan<kCols>(s.col, s.warp, s.tot);
    int H = (int)s.tot[kHeadCol];
    each([&](int t) {
      if (s.fl[t] & kRunHead) s.seg[s.col[t * kCols + kHeadCol] + 1] = t;
    });
    each([&](int t) {
      for (int h = t; h <= H; h += kThreads)
        fold_segment(a, s, lo, h, H, n_runs, par);
    });
    n_runs += H;
    if (s.n_counted) {
      if (first_tid < 0) first_tid = s.stid[0];
      last_tid = s.stid[s.n_counted - 1];
    }
    for (int k = kNPrimaryCol; k < kCols; k++) acc[k] += s.tot[k];
  }
  each([&](int t) {
    if (t) return;
    if (n_runs) put_run(a.runs + lo * kRunWords, n_runs - 1, s.carry[par]);
    long long* w = a.chunks + ch * kChunkWords;
    w[0] = acc[kNPrimaryCol];
    w[1] = acc[kNmMissingCol];  // the caller raises before any result is
    w[2] = acc[kUnsortedCol] == 0;  // used
    w[3] = first_tid;
    w[4] = last_tid;
    w[5] = stop < hi ? stop - lo + 1 : 0;
    w[6] = n_runs;
    w[7] = 0;
  });
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

__global__ void __launch_bounds__(kThreads) bam_scan_stitch(ScanArgs a) {
  __shared__ CheckShared s;
  stitch_check(a, s);
}

__global__ void __launch_bounds__(256) bam_scan_stitch_walk(ScanArgs a) {
  __shared__ long long sf[kTile], sx[kTile];
  __shared__ int sc[kTile];
  long long from = a.stitch[6];
  if (from == 0) return;  // the check settled the chain
  StitchState s = walk_start(a, from);
  for (long long t0 = from / kTile * kTile; t0 < a.n_regions; t0 += kTile) {
    long long t1 = min_ll(t0 + kTile, a.n_regions);
    for (long long i = t0 + threadIdx.x; i < t1; i += blockDim.x) {
      sf[i - t0] = a.first[i];
      sx[i - t0] = a.exit_[i];
      sc[i - t0] = a.cnt[i];
    }
    __syncthreads();
    if (threadIdx.x == 0) stitch_tile(a, sf, sx, sc, t0, t1, s);
    __syncthreads();
  }
  if (threadIdx.x == 0) stitch_finish(a, s, from);
}

// mode 0 analyse, mode 1 emit: a warp a region
__global__ void __launch_bounds__(32 * kWarps)
    bam_scan_records(ScanArgs a, int mode) {
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
}

__global__ void __launch_bounds__(kThreads) bam_scan_fold(ScanArgs a) {
  __shared__ FoldShared s;
  fold_chunk(a, blockIdx.x, s);
}

}  // namespace

extern "C" {

// Launch `step` (enum Step) of one segment's scan on card `device`, on
// `stream`. Returns 0, or the CUDA error plus 1000 times the step that met
// it (1 the card, 2 the launch). Every pointer of *args is the card's
// memory. The library links its own static runtime, so the caller names
// the card, as for sweep_scan_launch.
int bam_scan_launch(int step, const ScanArgs* args, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return 1000 + (int)err;
  const ScanArgs a = *args;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned region_blocks = (unsigned)((a.n_regions + kWarps - 1) / kWarps);
  switch (step) {
    case kSpeculate:
      if (region_blocks)
        bam_scan_speculate<<<region_blocks, 32 * kWarps, 0, st>>>(a);
      break;
    case kStitchCheck:
      bam_scan_stitch<<<1, kThreads, 0, st>>>(a);
      break;
    case kStitchWalk:
      bam_scan_stitch_walk<<<1, 256, 0, st>>>(a);
      break;
    case kAnalyse:
    case kEmit:
      if (region_blocks)
        bam_scan_records<<<region_blocks, 32 * kWarps, 0, st>>>(
            a, step == kEmit);
      break;
    case kFold:
      if (n_chunks(a))
        bam_scan_fold<<<(unsigned)n_chunks(a), kThreads, 0, st>>>(a);
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

// `step` (enum Step) of one segment's scan on the host, through the
// kernels' own functions; the CPU tests' view of the kernels.
int bam_scan_host(int step, const ScanArgs* args) {
  const ScanArgs& a = *args;
  switch (step) {
    case kSpeculate:
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
    case kStitchCheck: {
      CheckShared s;
      stitch_check(a, s);
      return 0;
    }
    case kStitchWalk: {
      long long from = a.stitch[6];
      if (from) {
        StitchState s = walk_start(a, from);
        stitch_tile(a, a.first, a.exit_, a.cnt, 0, a.n_regions, s);
        stitch_finish(a, s, from);
      }
      return 0;
    }
    case kAnalyse:
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
    case kFold: {
      FoldShared* s = new FoldShared;
      for (long long ch = 0; ch < n_chunks(a); ch++) fold_chunk(a, ch, *s);
      delete s;
      return 0;
    }
    case kEmit:
      for (long long g = 0; g < a.n_records; g++)
        if (a.nblk[g]) emit(a, g);
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
