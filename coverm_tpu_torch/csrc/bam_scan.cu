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
//   (a) speculate: one warp per 64 KiB region of the segment, a lane per
//       8 KiB sub-range of it (kLogSub; 8 lanes work, 24 idle). Each lane
//       finds the first plausible record header in its sub-range (16
//       offsets from each 16-byte load, plausible() only where the
//       block_size and refID pass) and walks the chain from it to the
//       first position at or past its sub-range's end: about 30 dependent
//       loads, not the region's 235, and every lane's at once. Then one
//       lane joins the chains in order, as the stitch joins regions: the
//       region's chain starts at its first plausible header (the lowest
//       lane's; the anchor in region 0) and, wherever it enters a
//       sub-range, takes that lane's starts from there when the lane's
//       chain holds that position (a lookup the lanes make in parallel
//       before the join), else walks the sub-range again from there
//       (rare; time, never the answer). A running count places each
//       lane's starts; the lanes then write them (sorted, as offsets in
//       the region), and the region's first start, where its chain left
//       the region or stopped, and how many. A record longer than a
//       sub-range sends the chain past several lanes; a chain that stops
//       ends the region there. The walk reads about a 32-byte sector a
//       record, scattered, and its time follows the sectors, not the
//       chain's length: 2 KiB sub-ranges (32 lanes, each searching about
//       half a record) were slower than 4-16 KiB on the card (PERF.md §6).
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
//   (c) records, launched twice, a block of 256 threads a region and a
//       thread a record, 256 at a time. Analyse: the block writes its
//       records' starts (from the region's list, or walked from its entry
//       when the stitch walked the region), then does scan_chunk_records'
//       per-record work (flag masks, the geometry check, the CIGAR walk,
//       the NM search of scan_aux_tags, the single-read filter, the tid
//       range check), reading only the sectors it needs, and writes a
//       count of blocks a record; a block scan sums the region's. The last
//       block to finish (a counter in pwords[3]) scans the regions' sums
//       into each region's first block and the total (pwords[0]), which
//       the caller reads with the chunks' words to size the blocks: no
//       scan over records between the launches. Emit: a block scan of the
//       region's counts places each record's blocks after the region's
//       first, and each thread writes its record's.
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
// (e) The parse (steps kParse and kParseEmit) is the classic record
// reader's ingest on the card: it takes over the host's ct_walk_complete,
// ct_parse_phase1 and ct_parse_phase2 (native/bamdecode.cpp:220, 306, 338)
// and writes every RecordBatch column they write, bit for bit. It reuses
// steps (a) and (b) for the record starts, with the chain stopping at a
// block_size under 32 (min_bs) rather than 33: the host walks on there, and
// a record under 32 bytes always fails its geometry check, while one of 32
// can pass it. Bound: the sectors that hold each record's fixed fields,
// read name, CIGAR and aux tags up to NM and AS (never the sequence or the
// qualities), read once, and the columns and blocks written once
// (ops/bam_scan.parse_bytes_read). Two launches, a block of 256 threads a
// 64 KiB region, a thread a record (256 at a time):
//   parse_count: the block writes its records' starts (from the region's
//       list, or walked from its entry when the stitch walked the region)
//       as 16-bit offsets in the region, so that the caller can let the
//       lists go before the columns are made, then checks each record
//       (its geometry, its CIGAR's blocks, the aux search for NM and AS)
//       reading from device memory only the sectors that hold them, about
//       a third of the bytes (staging every byte, as the emit does, made
//       this launch about 1.6 times as long on the card). The first bad
//       record and the first of corrupt geometry are atomic minima
//       (pwords[1], pwords[2]); a block scan sums the region's blocks.
//       The last block to finish (a counter in
//       pwords[3]) scans the regions' sums, thousands and not millions,
//       into each region's first block and the total (pwords[0]), which
//       the caller reads with the error words to size the blocks exactly.
//   parse_emit: each record's fields are a chain of dependent loads (its
//       name's length places its CIGAR, the CIGAR and the sequence's
//       length its aux tags), and this launch reads most of them, so it
//       parses from shared memory: one thread copies the region and the
//       2 KiB after it (the window) into shared memory with one bulk copy
//       (cp.async.bulk, completed on an mbarrier; the few bytes before and
//       after its 16-byte aligned middle by the threads). Each record is
//       parsed from there, with the FNV-1a hash of its read name, and its
//       columns written, a thread a record, so that a warp's stores are 32
//       neighbouring elements; a block scan of the block counts places
//       each record's blocks after its region's first, staged in shared
//       memory and stored in order when the region's blocks fit
//       (kBlkStage), else stored where they go.
//   A record that runs past the window (a long read, a CIGAR of thousands
//   of operations) is read whole from device memory, never cut short. The
//   columns and blocks lie in one arena that the caller allocates once the
//   block count is known and copies back in one copy.
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
// record starts a region can hold: a record of the chain takes 4 + 32
// bytes or more (min_bs: 33 for the scan, 32 for the parse)
constexpr int kCap = (int)((kRegion - 1) / 36 + 1);
constexpr int kChunkShift = 15;
constexpr long long kChunk = 1ll << kChunkShift;  // the host's chunk
constexpr int kRunWords = 9;    // tid, 6 integer sums, 2 float64 sums
constexpr int kChunkWords = 8;  // n_primary, nm_missing, sorted, first and
                                // last tid, err, runs, 0
constexpr int kWarps = 4;       // warps (regions) a block of the speculate
// a lane's sub-range of a region in the speculate: 8 KiB, 8 a region (the
// other 24 lanes of the warp idle; chosen by measurement, PERF.md §6)
constexpr int kLogSub = 13;
constexpr long long kSub = 1ll << kLogSub;
constexpr int kSubs = (int)(kRegion >> kLogSub);
constexpr int kLaneCap = (int)((kSub - 1) / 36 + 1);  // starts a sub-range
static_assert(kSubs >= 1 && kSubs <= 32, "a lane a sub-range");
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
  kEmit = 5,
  kParse = 6,
  kParseEmit = 7
};
// FNV-1a over the read name, as the host hashes it
constexpr uint64_t kFnvOffset = 0xcbf29ce484222325ull;
constexpr uint64_t kFnvPrime = 0x100000001b3ull;
constexpr long long kAsMissing = -0x7fffffffffffffffll - 1;  // INT64_MIN
constexpr long long kNone = 1ll << 62;  // the parse's words: no record yet
constexpr int kStage = (int)kRegion + 2048;  // a parse window's bytes
constexpr int kBlkStage = 512;  // blocks of a region the emit stages

}  // namespace

// Every buffer of one segment's scan (device memory on the card, host
// memory in the host build); ops/bam_scan.py's ScanArgs has this layout.
struct ScanArgs {
  const uint8_t* data;  // the slot: records from `start`, bytes to `end`
  long long start, end, n_regions;
  int n_ref, skip_mask, req_mask, use_filter, min_mapq;
  int min_bs;  // the chain stops at a block_size below it (and at 0)
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
  int* btid;
  int* bstart;
  int* bend;
  long long* runs;     // [chunks * kChunk][kRunWords], a chunk's from its
                       // first record's slot
  long long* chunks;   // [chunks][kChunkWords]
  // the parse's columns, in its arena (rec_off, the records' offsets from
  // origin; tid, nm, ind, bstart and bend above are its too), [n_records]
  // unless said
  int* pos;
  uint16_t* flag;
  uint8_t* mapq;
  int* l_seq;
  long long* as_score;
  uint64_t* qname_hash;
  long long* aligned_cov;
  long long* aligned_pair;
  int* read_end;
  long long* rec_end;
  int* block_read;     // [blocks]
  // blocks, the first bad record (the parse's), the first of corrupt
  // geometry (the parse's), regions done; all kNone at first
  long long* pwords;   // [4]
  long long origin;    // rec_off and rec_end count from it
  uint16_t* roff;      // [n_records] each record's start in its region
  // the scan's analyse and the parse's count:
  long long* rblk;     // [n_regions] the blocks of the region's records
  long long* rbase;    // [n_regions] the index of the region's first block
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

// The 32 bits from bit sh (0-31) of the 64-bit hi:lo.
SCAN_HD uint32_t funnel(uint32_t lo, uint32_t hi, int sh) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(lo, hi, sh);
#else
  return sh ? (lo >> sh) | (hi << (32 - sh)) : lo;
#endif
}

// The little-endian uint32 at d[pos], pos + 4 <= end, d 4-byte aligned
// when `aligned`: on the card two aligned 4-byte loads (a lane's load
// touches one line, not four byte loads each a wavefront of their own)
// where both words end by `end`; else four byte loads.
SCAN_HD uint32_t ld_u32_at(const uint8_t* d, long long pos, long long end,
                           bool aligned) {
#ifdef __CUDA_ARCH__
  long long w = pos & ~3ll;
  if (aligned && w + 8 <= end) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(d + w);
    return funnel(p[0], p[1], 8 * (int)(pos & 3));
  }
#else
  (void)end;
  (void)aligned;
#endif
  return ld_u32(d + pos);
}

// The 16 bytes at p as four little-endian words: one 16-byte load on the
// card when p is 16-byte aligned (`aligned`).
SCAN_HD void ld_16(const uint8_t* p, bool aligned, uint32_t* w) {
#ifdef __CUDA_ARCH__
  if (aligned) {
    uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
    return;
  }
#else
  (void)aligned;
#endif
  for (int k = 0; k < 4; k++) w[k] = ld_u32(p + 4 * k);
}

SCAN_HD int lowest_bit(unsigned m) {
#ifdef __CUDA_ARCH__
  return __ffs(m) - 1;
#else
  return __builtin_ctz(m);
#endif
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

// each for one warp: f(l) for every lane l, then the lanes meet at a
// __syncwarp() (the host runs the lanes one after another).
template <class F>
SCAN_HD void each_lane(F f) {
#ifdef __CUDA_ARCH__
  f((int)(threadIdx.x & 31));
  __syncwarp();
#else
  for (int l = 0; l < 32; l++) f(l);
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

// *p = min(*p, v), *p in shared or device memory (an integer atomic on
// the card)
SCAN_HD void shared_min(long long* p, long long v) {
#ifdef __CUDA_ARCH__
  atomicMin(p, v);
#else
  if (v < *p) *p = v;
#endif
}

// *p += 1, returning what *p held (device memory: an atomic after a fence
// that orders the block's earlier stores before it)
SCAN_HD long long count_done(long long* p) {
#ifdef __CUDA_ARCH__
  __threadfence();
  return (long long)atomicAdd(reinterpret_cast<unsigned long long*>(p), 1ull);
#else
  return (*p)++;
#endif
}

// A word that another block wrote before its count_done (past the SM's L1)
SCAN_HD long long load_fresh(const long long* p) {
#ifdef __CUDA_ARCH__
  return __ldcg(p);
#else
  return *p;
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

// The index of v in the sorted list[0, n), or -1.
template <class T>
SCAN_HD int find(const T* list, int n, int v) {
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

// One region's speculation in a warp's shared memory: each lane's chain
// over its sub-range (its first plausible header p, -1 when none; x,
// where it left the sub-range or stopped; its n starts in st, as offsets
// in the region), the index of x among the starts of the lane whose
// sub-range holds x (link), and what the join takes: each lane's starts
// from `from` on, placed at `at` in the region's list.
struct SpecWarp {
  long long p[32], x[32];
  int n[32], link[32], from[32], at[32];
  long long first, exit;
  int cnt;
  uint16_t st[kSubs * kLaneCap];
};

// The first plausible header in [s0, s1), or -1. The lane reads its
// bytes 16 at a time from 16-byte lines counted from data's first byte
// (one load each on the card when data is 16-byte aligned) and tests the
// 16 offsets of a line at once, from its words and the next line's: a
// block_size of 33 or more within the bytes and a refID in [-1, n_ref);
// plausible() runs only where both pass.
SCAN_HD long long lane_first(const ScanArgs& a, long long s0, long long s1) {
  long long q1 = min_ll(s1, a.end - 35);  // plausible needs q + 36 <= end
  if (s0 >= q1) return -1;
  const uint8_t* d = a.data;
  bool aligned = ((uintptr_t)d & 15) == 0;
  uint32_t w[8], refs = (uint32_t)a.n_ref + 1;
  long long c0 = s0 & ~15ll;
  ld_16(d + c0, aligned, w);
  for (; c0 < q1; c0 += 16) {
    ld_16(d + c0 + 16, aligned, w + 4);  // c0 + 31 < end - 4
    // block_size <= room - j at offset c0 + j; a false pass near the end
    // (room under 33 + j) is caught below
    uint32_t room = (uint32_t)min_ll(a.end - c0 - 4, 0xFFFFFFFFll);
    unsigned m = 0;
#pragma unroll
    for (int j = 0; j < 16; j++) {
      int k = j >> 2, sh = 8 * (j & 3);
      uint32_t bs = funnel(w[k], w[k + 1], sh);
      uint32_t ref = funnel(w[k + 1], w[k + 2], sh);
      if (bs - 33u <= room - (uint32_t)j - 33u && ref + 1u < refs)
        m |= 1u << j;
    }
    while (m) {
      long long c = c0 + lowest_bit(m);
      m &= m - 1;
      if (c >= s0 && c < q1 && plausible(d, c, a.end, a.n_ref)) return c;
    }
    for (int k = 0; k < 4; k++) w[k] = w[k + 4];
  }
  return -1;
}

// The chain from pos over a sub-range that ends at s1: its starts into st
// as offsets from r0, up to the first position at or past s1 or where it
// stops (block_size 0, a record past the end, block_size < min_bs),
// returned in *x; returns how many.
SCAN_HD int lane_walk(const ScanArgs& a, long long pos, long long s1,
                      long long r0, uint16_t* st, long long* x) {
  bool aligned = ((uintptr_t)a.data & 3) == 0;
  int n = 0;
  while (pos < s1 && pos + 4 <= a.end) {
    uint32_t bs = ld_u32_at(a.data, pos, a.end, aligned);
    if (bs == 0 || pos + 4 + (long long)bs > a.end || bs < (uint32_t)a.min_bs)
      break;
    st[n++] = (uint16_t)(pos - r0);
    pos += 4 + (long long)bs;
  }
  *x = pos;
  return n;
}

// The index of e (in lane m's sub-range) among lane m's starts, or -1.
SCAN_HD int lane_rank(const SpecWarp& s, int m, long long e, long long r0) {
  long long f = s.p[m];
  if (f == e) return 0;
  if (f < 0 || f > e) return -1;
  return find(s.st + m * kLaneCap, s.n[m], (int)(e - r0));
}

// The join (see (a) above), by one thread: from the region's first
// plausible header, lane by lane in order.
SCAN_HD void join_lanes(const ScanArgs& a, long long r0, long long r1,
                        SpecWarp& s) {
  int l = 0;
  while (l < kSubs && s.p[l] < 0) l++;
  s.first = s.exit = -1;
  s.cnt = 0;
  if (l == kSubs) return;  // no plausible header in the region
  long long e = s.first = s.p[l];
  int k = 0, total = 0;
  while (true) {
    long long s1 = min_ll(r0 + ((long long)(l + 1) << kLogSub), r1);
    bool again = k < 0;  // the lane's chain misses e: walk it from e
    if (again) {
      s.n[l] = lane_walk(a, e, s1, r0, s.st + l * kLaneCap, &s.x[l]);
      k = 0;
    }
    s.from[l] = k;
    s.at[l] = total;
    total += s.n[l] - k;
    long long x = s.x[l];
    if (x < s1 || x >= r1) {  // the chain stops, or leaves the region
      s.exit = x;
      break;
    }
    int m = (int)((x - r0) >> kLogSub);
    k = again ? lane_rank(s, m, x, r0) : s.link[l];
    l = m;
    e = x;
  }
  s.cnt = total;
}

// Step (a) for region b by one warp (see (a) above).
SCAN_HD void speculate_region(const ScanArgs& a, long long b, SpecWarp& s) {
  long long r0 = a.start + (b << kLogRegion);
  long long r1 = min_ll(r0 + kRegion, a.end);
  each_lane([&](int l) {  // each lane's chain over its sub-range
    long long s0 = r0 + ((long long)l << kLogSub);
    long long s1 = min_ll(s0 + kSub, r1), p = -1, x = s0;
    int n = 0;
    if (l < kSubs && s0 < r1) {
      p = b == 0 && l == 0 ? a.start : lane_first(a, s0, s1);  // the anchor
      if (p >= 0) n = lane_walk(a, p, s1, r0, s.st + l * kLaneCap, &x);
    }
    s.p[l] = p;
    s.x[l] = x;
    s.n[l] = n;
    s.from[l] = n;  // nothing taken unless the join comes by
    s.at[l] = 0;
  });
  each_lane([&](int l) {  // where each lane's chain enters the next lane
    long long s1 = min_ll(r0 + ((long long)(l + 1) << kLogSub), r1);
    long long x = s.x[l];
    s.link[l] = s.p[l] >= 0 && x >= s1 && x < r1
                    ? lane_rank(s, (int)((x - r0) >> kLogSub), x, r0)
                    : -1;
  });
  each_lane([&](int l) {
    if (l == 0) join_lanes(a, r0, r1, s);
  });
  each_lane([&](int l) {  // each lane's share of the region's starts
    int k = s.from[l], n = s.n[l];
    int* list = a.list + b * kCap + s.at[l] - k;
    for (int i = k; i < n; i++) list[i] = s.st[l * kLaneCap + i];
    if (l == 0) {
      a.first[b] = s.first;
      a.exit_[b] = s.exit;
      a.cnt[b] = s.cnt;
    }
  });
}

// ---- (b) stitch

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
      s.stop = kTooShort;  // below min_bs
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
        if (bs == 0 || pos + 4 + (long long)bs > a.end ||
            bs < (uint32_t)a.min_bs)
          break;
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

struct CountShared {
  long long x[kThreads];  // a block scan's values
  long long warp[kThreads / 32];
  long long tot;
  int last;  // this block finished last
};

// put(i, offset) for each of the c starts of region b's records (the true
// chain's): from the region's list when the stitch took its speculation,
// else walked from its entry by one thread.
template <class F>
SCAN_HD void region_starts(const ScanArgs& a, long long b, int c, F put) {
  long long r0 = a.start + (b << kLogRegion);
  int k = a.rank[b];
  if (c && k >= 0) {
    const int* list = a.list + b * kCap + k;
    each([&](int t) {
      for (int i = t; i < c; i += kThreads) put(i, r0 + list[i]);
    });
  } else if (c) {
    each([&](int t) {
      if (t) return;
      long long pos = a.entry[b];
      for (int i = 0; i < c; i++) {
        put(i, pos);
        pos += 4 + (long long)ld_u32(a.data + pos);
      }
    });
  }
}

// Region b's blocks (s.tot, after a block scan) into rblk; the last block
// to finish (a counter in pwords[3]) scans every region's into rbase, each
// region's first block, and the total into pwords[0].
SCAN_HD void region_done(const ScanArgs& a, long long b, CountShared& s) {
  each([&](int t) {
    if (t) return;
    a.rblk[b] = s.tot;
    s.last = count_done(a.pwords + 3) == kNone + a.n_regions - 1;
  });
  if (!s.last) return;
  // a thread a run of `per` regions: their sum, one block scan, then each
  // region's first block along the run
  long long per = (a.n_regions + kThreads - 1) / kThreads;
  each([&](int t) {
    long long sum = 0, r1 = min_ll((t + 1) * per, a.n_regions);
    for (long long r = t * per; r < r1; r++) sum += load_fresh(a.rblk + r);
    s.x[t] = sum;
  });
  block_scan<1>(s.x, s.warp, &s.tot);
  each([&](int t) {
    long long o = s.x[t], r1 = min_ll((t + 1) * per, a.n_regions);
    for (long long r = t * per; r < r1; r++) {
      a.rbase[r] = o;
      o += load_fresh(a.rblk + r);
    }
  });
  each([&](int t) {
    if (!t) a.pwords[0] = s.tot;
  });
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

// scan_aux_tags of native/bamdecode.cpp: NM alone (want_as false, the
// scan) or NM and AS (the parse), the search ending when it has found as
// many tags as it wants; nm -1 and as_score INT64_MIN when absent. 0, or -1
// on a malformed or truncated tag.
SCAN_HD int scan_aux_tags(const uint8_t* rec, long long aux, long long rec_len,
                          long long* nm, long long* as_score, bool want_as) {
  *nm = -1;
  *as_score = kAsMissing;
  if (aux < 0 || aux > rec_len) aux = rec_len;  // corrupt: no aux region
  int found = 0, want = want_as ? 2 : 1;
  while (aux + 3 <= rec_len && found < want) {
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
    if (has_val) {
      if (t0 == 'N' && t1 == 'M') {
        *nm = val;
        found++;
      } else if (want_as && t0 == 'A' && t1 == 'S') {
        *as_score = val;
        found++;
      }
    }
  }
  return 0;
}

// scan_chunk_records' work on record g at off, less the fold: its flags,
// tid, block count, NM, indels and identity; returns the block count. The
// fixed fields and the CIGAR come in whole words (ld_u32_at).
SCAN_HD int analyse(const ScanArgs& a, long long off, long long g) {
  const uint8_t* d = a.data;
  bool al = ((uintptr_t)d & 3) == 0;
  long long r = off + 4;  // the record after its block_size
  const uint8_t* rec = d + r;
  long long rec_len = ld_u32_at(d, off, a.end, al);
  int32_t tid = (int32_t)ld_u32_at(d, r, a.end, al);
  uint32_t w8 = ld_u32_at(d, r + 8, a.end, al);    // l_read_name, mapq
  uint32_t w12 = ld_u32_at(d, r + 12, a.end, al);  // n_cigar_op, flag
  int l_rn = w8 & 0xFF;
  uint32_t n_cigar = w12 & 0xFFFF;
  uint32_t flag = w12 >> 16;
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
    int32_t l_seq = (int32_t)ld_u32_at(d, r + 16, a.end, al);
    if (l_seq < 0 || 32 + (long long)l_rn + 4ll * n_cigar > rec_len) {
      fl |= kError;
    } else {
      long long cig = r + 32 + l_rn;
      long long a_cov = 0;
      for (uint32_t k = 0; k < n_cigar; k++) {
        uint32_t c = ld_u32_at(d, cig + 4 * k, a.end, al);
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
      long long as_score;
      if (scan_aux_tags(rec, aux, rec_len, &nm, &as_score, false) != 0) {
        fl |= kError;
      } else if (a.use_filter &&
                 !single_read_passes(a, (uint8_t)(w8 >> 8), a_cov, l_seq,
                                     nm)) {
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
  if (!(fl & kCounted)) nb = 0;
  a.flags[g] = fl;
  a.tid[g] = tid;
  a.nblk[g] = nb;
  a.nm[g] = nm;
  a.ind[g] = ind;
  a.idv[g] = idv;
  return nb;
}

// Record g's blocks, from the segment's o-th.
SCAN_HD void emit(const ScanArgs& a, long long g, long long o) {
  const uint8_t* d = a.data;
  bool al = ((uintptr_t)d & 3) == 0;
  long long r = a.rec_off[g] + 4;
  long long cursor = (int32_t)ld_u32_at(d, r + 4, a.end, al);
  int l_rn = ld_u32_at(d, r + 8, a.end, al) & 0xFF;
  uint32_t n_cigar = ld_u32_at(d, r + 12, a.end, al) & 0xFFFF;
  long long cig = r + 32 + l_rn;
  int tid = a.tid[g];
  for (uint32_t k = 0; k < n_cigar; k++) {
    uint32_t c = ld_u32_at(d, cig + 4 * k, a.end, al);
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

// Analyse for region b (see (c) above): its records' starts, their work,
// and the region's blocks; the last block to finish scans every region's.
SCAN_HD void analyse_region(const ScanArgs& a, long long b, CountShared& s) {
  int c = a.count[b];
  long long base = a.base[b];
  long long* rec_off = a.rec_off + (c ? base : 0);
  region_starts(a, b, c, [&](int i, long long off) { rec_off[i] = off; });
  each([&](int t) {
    long long nb = 0;
    for (int i = t; i < c; i += kThreads)
      nb += analyse(a, rec_off[i], base + i);
    s.x[t] = nb;
  });
  block_scan<1>(s.x, s.warp, &s.tot);
  region_done(a, b, s);
}

// Emit for region b (see (c) above): each record's blocks after the
// region's first, 256 records at a time.
SCAN_HD void emit_blocks(const ScanArgs& a, long long b, CountShared& s) {
  int c = a.count[b];
  long long base = a.base[b], o = c ? a.rbase[b] : 0;
  for (int t0 = 0; t0 < c; t0 += kThreads) {
    each([&](int t) {
      int i = t0 + t;
      s.x[t] = i < c ? a.nblk[base + i] : 0;
    });
    block_scan<1>(s.x, s.warp, &s.tot);
    each([&](int t) {
      int i = t0 + t;
      if (i < c && a.nblk[base + i]) emit(a, base + i, o + s.x[t]);
    });
    o += s.tot;
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

// ---- (e) parse

struct ParseShared {
  alignas(16) uint8_t bytes[kStage + 16];  // the window, from the 16-byte
                                           // line its first byte lies in
  long long x[kThreads];                   // a block scan's values
  long long warp[kThreads / 32];
  long long tot;
  int bread[kBlkStage], bstart[kBlkStage], bend[kBlkStage];
  alignas(8) unsigned long long bar;  // the window copy's mbarrier
};
// three blocks an SM (227 KiB of shared memory, 1 KiB of it reserved a
// block)
static_assert(3 * (sizeof(ParseShared) + 1024) <= 232448,
              "a parse block's shared memory");

#ifdef __CUDA_ARCH__
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// One thread: the window's mbarrier expects one arrival, made with
// bulk_load's byte count or by bulk_skip.
__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One thread: `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from device memory into shared memory, completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_skip(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(0u)
        : "memory");
  } while (!done);
}
#endif

// A region's window in shared memory: sb[p - r0] is data[p] for p in
// [r0, w1).
struct Window {
  const uint8_t* sb;
  long long r0, w1;
};

// Region b's window [r0, min(r0 + kStage, end)) into s.bytes (see (e)
// above; the host copies it with memcpy). Every thread calls it, once a
// block.
SCAN_HD Window stage_region(const ScanArgs& a, long long b, ParseShared& s) {
  Window w;
  w.r0 = a.start + (b << kLogRegion);
  w.w1 = min_ll(w.r0 + kStage, a.end);
  const uint8_t* g = a.data + w.r0;
  int mis = (int)((uintptr_t)g & 15);
  uint8_t* sb = s.bytes + mis;
  w.sb = sb;
  long long len = w.w1 - w.r0;
#ifdef __CUDA_ARCH__
  int head = (int)min_ll((16 - mis) & 15, len);
  long long mid = (len - head) & ~15ll;
  int tail = (int)(len - head - mid);
  int t = threadIdx.x;
  if (t == 0) bar_init(&s.bar);
  __syncthreads();
  if (t == 0) {
    if (mid)
      bulk_load(sb + head, g + head, (unsigned)mid, &s.bar);
    else
      bulk_skip(&s.bar);
  }
  if (t < head) sb[t] = g[t];
  if (t >= 16 && t - 16 < tail)
    sb[head + mid + t - 16] = g[head + mid + t - 16];
  bar_wait(&s.bar);
  __syncthreads();
#else
  memcpy(sb, g, (size_t)len);
#endif
  return w;
}

// The bytes of the record at off, from its block_size on: in the window
// when it ends there, else in device memory. Its block_size always lies in
// the window: off is a start in the region, and the window runs 2 KiB past
// it or to the end.
SCAN_HD const uint8_t* record_at(const ScanArgs& a, const Window& w,
                                 long long off) {
  const uint8_t* p = w.sb + (off - w.r0);
  return off + 4 + (long long)ld_u32(p) <= w.w1 ? p : a.data + off;
}

struct Rec {
  long long rec_len, a_cov, a_pair, ind, nm, as_score;
  uint64_t hash;
  int32_t tid, pos, l_seq, read_end;
  int nb;
  int bad;  // 0; 1 a bad record; 2 one of corrupt geometry
  uint16_t flag;
  uint8_t mapq;
};

// ct_parse_phase2's work on the record whose block_size is at p: its
// columns (the name's hash only with `hash`) and its count of blocks. A
// record whose l_seq is negative or whose aux tags are malformed is bad; one
// whose name and CIGAR run past its block_size has corrupt geometry. The
// chain holds only records of 32 bytes or more, so the fixed fields lie in
// the record.
SCAN_HD void read_record(const uint8_t* p, bool hash, Rec& r) {
  const uint8_t* rec = p + 4;
  r.rec_len = ld_u32(p);
  r.tid = (int32_t)ld_u32(rec);
  r.pos = (int32_t)ld_u32(rec + 4);
  int l_rn = rec[8];
  r.mapq = rec[9];
  uint32_t n_cigar = ld_u16(rec + 12);
  r.flag = (uint16_t)ld_u16(rec + 14);
  r.l_seq = (int32_t)ld_u32(rec + 16);
  r.nb = 0;
  r.hash = kFnvOffset;
  bool geom = 32 + (long long)l_rn + 4ll * n_cigar > r.rec_len;
  r.bad = geom ? 2 : r.l_seq < 0 ? 1 : 0;
  if (r.bad) return;
  if (hash)
    for (int i = 0; i + 1 < l_rn; i++) {
      r.hash ^= rec[32 + i];
      r.hash *= kFnvPrime;
    }
  const uint8_t* cig = rec + 32 + l_rn;
  long long cursor = r.pos, a_cov = 0, a_pair = 0, ind = 0;
  int nb = 0;
  for (uint32_t k = 0; k < n_cigar; k++) {
    uint32_t c = ld_u32(cig + 4 * k);
    uint32_t op = c & 0xF;
    long long ln = c >> 4;
    if (op == 0 || op == 7 || op == 8) {  // M, =, X: a block
      nb++;
      a_cov += ln;
      a_pair += ln;
      cursor += ln;
    } else if (op == 1) {  // I
      a_cov += ln;
      a_pair += ln;
      ind += ln;
    } else if (op == 2) {  // D
      a_cov += ln;
      ind += ln;
      cursor += ln;
    } else if (op == 3) {  // N
      cursor += ln;
    }  // S, H, P and the codes above 8 move nothing
  }
  r.nb = nb;
  r.a_cov = a_cov;
  r.a_pair = a_pair;
  r.ind = ind;
  r.read_end = (int32_t)cursor;
  // (l_seq + 1) / 2 in int32, as the host computes it
  long long aux = 32 + (long long)l_rn + 4ll * n_cigar +
                  (int32_t)((uint32_t)r.l_seq + 1u) / 2 + r.l_seq;
  if (scan_aux_tags(rec, aux, r.rec_len, &r.nm, &r.as_score, true) != 0)
    r.bad = 1;
}

// Record g, at off, into the columns.
SCAN_HD void put_columns(const ScanArgs& a, long long g, long long off,
                         const Rec& r) {
  a.tid[g] = r.tid;
  a.pos[g] = r.pos;
  a.flag[g] = r.flag;
  a.mapq[g] = r.mapq;
  a.l_seq[g] = r.l_seq;
  a.nm[g] = r.nm;
  a.as_score[g] = r.as_score;
  a.qname_hash[g] = r.hash;
  a.aligned_cov[g] = r.a_cov;
  a.aligned_pair[g] = r.a_pair;
  a.ind[g] = r.ind;
  a.read_end[g] = r.read_end;
  a.rec_off[g] = off - a.origin;
  a.rec_end[g] = off + 4 + r.rec_len - a.origin;
}

// The blocks of record g (bytes at p) from the region's o-th: into the
// block stage (staged), else at the region's first block b0 on.
SCAN_HD void put_blocks(const ScanArgs& a, ParseShared& s, const uint8_t* p,
                        long long g, long long o, long long b0,
                        bool staged) {
  const uint8_t* rec = p + 4;
  int l_rn = rec[8];
  uint32_t n_cigar = ld_u16(rec + 12);
  const uint8_t* cig = rec + 32 + l_rn;
  long long cursor = (int32_t)ld_u32(rec + 4);
  for (uint32_t k = 0; k < n_cigar; k++) {
    uint32_t c = ld_u32(cig + 4 * k);
    uint32_t op = c & 0xF;
    long long ln = c >> 4;
    if (op == 0 || op == 7 || op == 8) {
      int32_t lo = (int32_t)cursor, hi = (int32_t)(cursor + ln);
      if (staged) {
        s.bread[o] = (int32_t)g;
        s.bstart[o] = lo;
        s.bend[o] = hi;
      } else {
        a.block_read[b0 + o] = (int32_t)g;
        a.bstart[b0 + o] = lo;
        a.bend[b0 + o] = hi;
      }
      o++;
      cursor += ln;
    } else if (op == 2 || op == 3) {
      cursor += ln;
    }
  }
}

// The parse's count for region b (see (e) above): the records' starts,
// their checks and the region's blocks, from device memory; the last
// block to finish scans every region's.
SCAN_HD void count_region(const ScanArgs& a, long long b, CountShared& s) {
  int c = a.count[b];
  long long base = a.base[b];
  long long r0 = a.start + (b << kLogRegion);
  uint16_t* roff = a.roff + (c ? base : 0);
  region_starts(a, b, c,
                [&](int i, long long off) { roff[i] = (uint16_t)(off - r0); });
  each([&](int t) {
    long long nb = 0;
    for (int i = t; i < c; i += kThreads) {
      Rec r;
      read_record(a.data + r0 + roff[i], false, r);
      if (r.bad) {
        shared_min(a.pwords + 1, base + i);
        if (r.bad == 2) shared_min(a.pwords + 2, base + i);
      }
      nb += r.nb;
    }
    s.x[t] = nb;
  });
  block_scan<1>(s.x, s.warp, &s.tot);
  region_done(a, b, s);
}

// The parse's emit for region b (see (e) above): every column of its
// records and their blocks.
SCAN_HD void emit_region(const ScanArgs& a, long long b, ParseShared& s) {
  int c = a.count[b];
  if (!c) return;  // the whole block
  long long base = a.base[b], b0 = a.rbase[b], n_blk = a.rblk[b];
  bool staged = n_blk <= kBlkStage;
  const uint16_t* roff = a.roff + base;
  Window w = stage_region(a, b, s);
  long long carry = 0;
  for (int t0 = 0; t0 < c; t0 += kThreads) {
    each([&](int t) {
      int i = t0 + t;
      s.x[t] = 0;
      if (i >= c) return;
      long long off = w.r0 + roff[i];
      Rec r;
      read_record(record_at(a, w, off), true, r);
      put_columns(a, base + i, off, r);
      s.x[t] = r.nb;
    });
    block_scan<1>(s.x, s.warp, &s.tot);
    each([&](int t) {
      int i = t0 + t;
      if (i >= c) return;
      put_blocks(a, s, record_at(a, w, w.r0 + roff[i]), base + i,
                 carry + s.x[t], b0, staged);
    });
    carry += s.tot;
  }
  if (staged)
    each([&](int t) {
      for (long long j = t; j < n_blk; j += kThreads) {
        a.block_read[b0 + j] = s.bread[j];
        a.bstart[b0 + j] = s.bstart[j];
        a.bend[b0 + j] = s.bend[j];
      }
    });
}

}  // namespace

#ifdef __CUDACC__

namespace {

__global__ void __launch_bounds__(32 * kWarps)
    bam_scan_speculate(ScanArgs a) {
  __shared__ SpecWarp s[kWarps];
  int w = threadIdx.x >> 5;
  long long b = (long long)blockIdx.x * kWarps + w;
  if (b >= a.n_regions) return;  // the whole warp
  speculate_region(a, b, s[w]);
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

// mode 0 analyse, 1 emit: a block a region (see (c) above)
__global__ void __launch_bounds__(kThreads)
    bam_scan_records(ScanArgs a, int mode) {
  __shared__ CountShared s;
  if (mode == 0)
    analyse_region(a, blockIdx.x, s);
  else
    emit_blocks(a, blockIdx.x, s);
}

// the parse's two launches, a block a region (see (e) above)
__global__ void __launch_bounds__(kThreads) bam_scan_parse_count(ScanArgs a) {
  __shared__ CountShared s;
  count_region(a, blockIdx.x, s);
}

__global__ void __launch_bounds__(kThreads)
    bam_scan_parse_emit(ScanArgs a) {
  extern __shared__ __align__(16) unsigned char parse_smem[];
  emit_region(a, blockIdx.x, *reinterpret_cast<ParseShared*>(parse_smem));
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
      if (a.n_regions)
        bam_scan_records<<<(unsigned)a.n_regions, kThreads, 0, st>>>(
            a, step == kAnalyse ? 0 : 1);
      break;
    case kParse:
      if (a.n_regions)
        bam_scan_parse_count<<<(unsigned)a.n_regions, kThreads, 0, st>>>(a);
      break;
    case kParseEmit: {
      int smem = (int)sizeof(ParseShared);
      err = cudaFuncSetAttribute(bam_scan_parse_emit,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return 2000 + (int)err;
      if (a.n_regions)
        bam_scan_parse_emit<<<(unsigned)a.n_regions, kThreads, smem, st>>>(a);
      break;
    }
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
    case kSpeculate: {
      SpecWarp* s = new SpecWarp;
      for (long long b = 0; b < a.n_regions; b++) speculate_region(a, b, *s);
      delete s;
      return 0;
    }
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
    case kAnalyse: {
      CountShared s;
      for (long long b = 0; b < a.n_regions; b++) analyse_region(a, b, s);
      return 0;
    }
    case kParse: {
      CountShared s;
      for (long long b = 0; b < a.n_regions; b++) count_region(a, b, s);
      return 0;
    }
    case kParseEmit: {
      ParseShared* s = new ParseShared;
      for (long long b = 0; b < a.n_regions; b++) emit_region(a, b, *s);
      delete s;
      return 0;
    }
    case kFold: {
      FoldShared* s = new FoldShared;
      for (long long ch = 0; ch < n_chunks(a); ch++) fold_chunk(a, ch, *s);
      delete s;
      return 0;
    }
    case kEmit: {
      CountShared s;
      for (long long b = 0; b < a.n_regions; b++) emit_blocks(a, b, s);
      return 0;
    }
    default:
      return -1;
  }
}

}  // extern "C"

#endif

extern "C" {

// The layout constants the wrapper sizes its buffers by.
int bam_scan_region_bytes() { return (int)kRegion; }
int bam_scan_stage_bytes() { return kStage; }
int bam_scan_region_cap() { return kCap; }
int bam_scan_sub_bytes() { return (int)kSub; }
int bam_scan_args_bytes() { return (int)sizeof(ScanArgs); }

}  // extern "C"
