// Post-sort sweep scan for Hopper (sm_90a): a segmented scan over the
// sorted event keys with decoupled look-back, which also reduces the
// per-contig statistics.
//
// Replaces the TPU kernel coverm_tpu/ops/pallas_sweep.py::_sweep_kernel
// (through pallas_sweep_scan, pallas_call at :207) together with the
// scans the JAX package runs after it in ops/sweep.py::_sweep_core: the
// cummax fills of length, carry, window max and window min, the four
// int64 cumsums and the per-contig boundary differences.
//
// Input: E int64 keys sorted ascending, key = seg<<34 | (pos+1)<<2 |
// is_start<<1, one sentinel (pos == -1) first in each segment, padding
// INT64_MAX last; len_tab: int32[n_seg + 1] segment lengths, 0 at n_seg.
// Two facts about such keys remove the TPU kernel's forward fills:
//   - the length fill at an event of segment s is len_tab[s], because
//     the sentinel comes first in its segment: a gather that hits L1/L2;
//   - the global sign sum at a sentinel is >= 0 (every earlier segment
//     is complete) and the carry fill is that sum, so depth is the sum
//     of the signs since the last sentinel: a segmented sum scan.
// The consumer reads the window max and min fills and the cumsums only at
// each segment's last event, so they become per-segment reductions:
// integer adds and maxima, exact in any order.
// Outputs: depth, w_len_all (window gap length, unmasked) and seg, int32[E];
// per_seg, int64[6, n_seg]: sum_w, cov_w, cov_f, max_w, sq_w and
// minpay = max(2^31 - depth) over window gaps (the JAX encoding of the
// window minimum).
//
// Bound: 8 bytes read and 12 written per event, 20 B/event, so memory
// bandwidth bounds it: 0.054 ms for the 9.0 M events of a bench-size run
// at 3.35 TB/s. The integer work is a few dozen operations per event.
//
// Design, to meet that bound:
//   - a tile of kThreads x kItems events per block, claimed from an atomic
//     ticket, so a block only ever waits on blocks that already run;
//   - the keys come in with coalesced 16-byte loads into a padded shared
//     buffer, from which each thread takes kItems consecutive keys
//     without bank conflicts; outputs leave as 16-byte stores;
//   - the only cross-tile dependency is one int32, the segmented sign
//     sum, carried by decoupled look-back (Merrill & Garland, "Single-pass
//     Parallel Prefix Scan with Decoupled Look-back", 2016). Each tile
//     publishes one 64-bit descriptor (status, holds-a-sentinel bit,
//     value) with one store: no payload to order against a flag. A tile
//     that holds a sentinel knows its inclusive value at once and
//     publishes it so; the others publish their aggregate, then warp 0
//     reads up to 32 predecessors' descriptors at a time and adds the
//     aggregates back to the first inclusive one;
//   - per-segment reductions in registers over each thread's runs, a
//     block-wide segmented scan over the threads' last runs, then one
//     atomic per (block, segment run) and statistic, skipped where the
//     value is 0: a tile inside one contig makes at most six;
//   - one zeroed scratch buffer (per_seg, the ticket, the descriptors),
//     so one memset per launch.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;  // events per thread: a multiple of 4
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = kItems / 2;  // 16-byte vectors of two keys a thread
constexpr int kRow = kVecs + 1;    // a thread's padded row in shared memory
constexpr int kStats = 6;
constexpr long long kPadKey = LLONG_MAX;
constexpr long long kBigM = 1LL << 31;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kItems % 4 == 0, "outputs leave in groups of four");

// A tile's look-back descriptor: status in bits 62-63 (0 empty, so the
// memset clears it), bit 32 set when the tile holds a sentinel, and the
// int32 value in bits 0-31.
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kInclusive = 2ull << 62;
constexpr unsigned long long kStatusMask = 3ull << 62;
constexpr unsigned long long kHasSentinel = 1ull << 32;
// A predecessor holds an earlier ticket, so it runs and publishes; a
// descriptor still empty after ~10 s of polling means a broken invariant,
// and the kernel traps (a launch error) rather than hanging the card.
constexpr long long kSpinLimit = 1LL << 27;

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

struct Event {
  int seg, pos, sign;
  bool sent;
};

// The decode of sweep_scan.py::decode_keys.
__device__ __forceinline__ Event decode(long long k, int n_seg, int pad_pos) {
  if (k == kPadKey) return Event{n_seg, pad_pos, 0, false};
  Event e;
  e.seg = (int)(k >> 34);
  e.pos = (int)(((k >> 2) & 0xffffffffLL) - 1);
  e.sent = e.pos == -1;
  e.sign = e.sent ? 0 : ((k & 2) ? 1 : -1);
  return e;
}

// Segmented sum: f is set once a sentinel was seen, v is the sum since it.
struct SegSum {
  int f, v;
};
struct SegSumOp {
  __device__ SegSum operator()(SegSum a, SegSum b) const {
    return SegSum{a.f | b.f, b.f ? b.v : a.v + b.v};
  }
};

// Partial statistics of one segment's run of events, in per_seg's row
// order; rows 3 and 5 are maxima, the others sums.
struct Run {
  int s;
  long long v[kStats];
};

__device__ __forceinline__ long long add64(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}

__device__ __forceinline__ void merge(Run& into, const Run& r) {
  #pragma unroll
  for (int k = 0; k < kStats; ++k)
    into.v[k] = (k == 3 || k == 5) ? max(into.v[k], r.v[k])
                                   : add64(into.v[k], r.v[k]);
}

// Segmented combine of runs in event order: b continues a's run when the
// segments match.
struct RunOp {
  __device__ Run operator()(Run a, Run b) const {
    if (a.s == b.s) merge(b, a);
    return b;
  }
};

__device__ __forceinline__ Run empty_run(int s) {
  Run r;
  r.s = s;
  #pragma unroll
  for (int k = 0; k < kStats; ++k) r.v[k] = 0;
  return r;
}

__device__ __forceinline__ SegSum shfl_up(SegSum x, int k) {
  return SegSum{__shfl_up_sync(kFull, x.f, k), __shfl_up_sync(kFull, x.v, k)};
}
__device__ __forceinline__ Run shfl_up(const Run& x, int k) {
  Run r;
  r.s = __shfl_up_sync(kFull, x.s, k);
  #pragma unroll
  for (int j = 0; j < kStats; ++j) r.v[j] = __shfl_up_sync(kFull, x.v[j], k);
  return r;
}

// Block-wide exclusive scan of one element per thread, `identity` on the
// left of thread 0; every thread also gets the block's aggregate.
template <typename T, typename Op>
__device__ __forceinline__ T block_exclusive_scan(T x, T identity, Op op,
                                                  T* warp_tot, T& agg) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T incl = x;
  #pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    T up = shfl_up(incl, k);
    if (lane >= k) incl = op(up, incl);
  }
  T excl = shfl_up(incl, 1);  // meaningful for lane > 0
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  T pre = identity;
  agg = identity;
  #pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) pre = op(pre, warp_tot[w]);
    agg = op(agg, warp_tot[w]);
  }
  if (lane > 0) pre = op(pre, excl);
  __syncthreads();  // warp_tot is reused by the next scan
  return pre;
}

// Warp 0 of tile `tile` > 0: the segmented sign sum carried into the tile,
// from the predecessors' descriptors, 32 at a time; lane j reads tile
// end - 1 - j. A window is used once it is published from its lane 0 up
// to its first inclusive descriptor, or in full (CUB's rule): later
// predecessors do not hold it up.
__device__ __forceinline__ int look_back(const unsigned long long* desc,
                                         long long tile) {
  const int lane = threadIdx.x & 31;
  int sum = 0;
  long long spins = 0;
  for (long long end = tile;; end -= 32) {
    const long long idx = end - 1 - lane;
    unsigned long long d;
    unsigned incl;
    for (;;) {
      d = idx >= 0 ? ld_relaxed(desc + idx) : kInclusive;
      const unsigned empty = __ballot_sync(kFull, (d & kStatusMask) == 0);
      // the lanes below the first empty one
      const unsigned published = empty ? (empty & (0u - empty)) - 1 : kFull;
      incl = __ballot_sync(kFull, (d & kStatusMask) == kInclusive) & published;
      if (incl != 0 || empty == 0) break;
      __nanosleep(64);
      if (++spins > kSpinLimit) __trap();
    }
    int v = (int)(unsigned)d;
    if (incl != 0 && lane > __ffs(incl) - 1) v = 0;
    sum += __reduce_add_sync(kFull, v);
    if (incl != 0) return sum;
  }
}

// One atomic per non-zero statistic of a complete (block, segment) run.
__device__ __forceinline__ void flush(const Run& r, long long* per_seg,
                                      int n_seg) {
  if ((unsigned)r.s >= (unsigned)n_seg) return;  // padding
  #pragma unroll
  for (int k = 0; k < kStats; ++k) {
    if (r.v[k] == 0) continue;
    long long* p = per_seg + (long long)k * n_seg + r.s;
    if (k == 3 || k == 5)
      atomicMax(p, r.v[k]);
    else
      atomicAdd(reinterpret_cast<unsigned long long*>(p),
                (unsigned long long)r.v[k]);
  }
}

__global__ void __launch_bounds__(kThreads)
sweep_scan_kernel(const long long* __restrict__ keys,
                  const int* __restrict__ len_tab,
                  int* __restrict__ depth_out, int* __restrict__ wlen_out,
                  int* __restrict__ seg_out, long long* per_seg,
                  unsigned long long* ticket, unsigned long long* desc,
                  long long E, int n_seg, int ee, int pad_pos) {
  __shared__ longlong2 s_keys[kThreads * kRow];
  __shared__ SegSum s_wsum[kWarps];
  __shared__ Run s_wrun[kWarps];
  __shared__ long long s_tile;
  __shared__ int s_prefix;

  const int tid = threadIdx.x;
  if (tid == 0) s_tile = (long long)atomicAdd(ticket, 1ull);
  __syncthreads();
  const long long tile = s_tile;
  const long long base = tile * kTile;

  // ---- keys: coalesced 16-byte loads into padded rows; the ragged tail
  // reads as padding, which is never stored
  const longlong2* kv = reinterpret_cast<const longlong2*>(keys);
  #pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int c = j * kThreads + tid;  // vector within the tile
    const long long i = base + 2LL * c;
    longlong2 v;
    if (i + 1 < E) {
      v = kv[(base >> 1) + c];
    } else {
      v.x = i < E ? keys[i] : kPadKey;
      v.y = kPadKey;
    }
    s_keys[(c / kVecs) * kRow + c % kVecs] = v;
  }
  long long key_after = kPadKey;  // the key after this thread's last
  if (tid == kThreads - 1 && base + kTile < E) key_after = keys[base + kTile];
  __syncthreads();
  const longlong2* row = s_keys + tid * kRow;
  if (tid < kThreads - 1) key_after = s_keys[(tid + 1) * kRow].x;

  // ---- local segmented sign scan
  int dl[kItems];
  int first_sent = kItems;  // items before it need the carried-in sum
  SegSum mine{0, 0};
  #pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const longlong2 v = row[j];
    #pragma unroll
    for (int h = 0; h < 2; ++h) {
      const Event e = decode(h ? v.y : v.x, n_seg, pad_pos);
      const int i = 2 * j + h;
      if (e.sent) {
        mine = SegSum{1, 0};
        first_sent = min(first_sent, i);
      }
      mine.v += e.sign;
      dl[i] = mine.v;
    }
  }
  SegSum tile_agg;
  const SegSum excl =
      block_exclusive_scan(mine, SegSum{0, 0}, SegSumOp(), s_wsum, tile_agg);

  // ---- decoupled look-back for the sum carried into the tile
  if (tid < 32) {
    const bool known = tile_agg.f || tile == 0;
    if (tid == 0)
      st_relaxed(desc + tile, (known ? kInclusive : kAggregate) |
                                  (tile_agg.f ? kHasSentinel : 0ull) |
                                  (unsigned)tile_agg.v);
    const int prefix = tile == 0 ? 0 : look_back(desc, tile);
    if (tid == 0) {
      if (!known)
        st_relaxed(desc + tile, kInclusive | (unsigned)(prefix + tile_agg.v));
      s_prefix = prefix;
    }
  }
  __syncthreads();
  const int carry_in = excl.f ? excl.v : s_prefix + excl.v;

  // ---- per event: depth, gap lengths, outputs and the runs' statistics
  Run head = empty_run(-1), cur = empty_run(decode(row[0].x, n_seg,
                                                   pad_pos).seg);
  bool has_head = false;
  int o_d[4], o_w[4], o_s[4];
  #pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const longlong2 v = row[j];
    const long long nk = j + 1 < kVecs ? row[j + 1].x : key_after;
    #pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 2 * j + h;
      const Event e = decode(h ? v.y : v.x, n_seg, pad_pos);
      const Event n = decode(h ? nk : v.y, n_seg, pad_pos);
      const int d = i < first_sent ? carry_in + dl[i] : dl[i];
      const int length =
          (unsigned)e.seg <= (unsigned)n_seg ? __ldg(len_tab + e.seg) : 0;
      // int64 arithmetic: padding positions must not wrap
      const long long gap_end = n.seg == e.seg ? n.pos : length;
      long long full = min(gap_end, (long long)length) - max(e.pos, 0);
      long long w = min(gap_end, (long long)length - ee) - max(e.pos, ee);
      full = max(full, 0LL);
      w = length > 2 * ee ? max(w, 0LL) : 0LL;
      if (e.pos >= pad_pos) {
        full = 0;
        w = 0;
      }
      if (e.seg != cur.s) {  // a run ends inside this thread
        if (has_head) {
          flush(cur, per_seg, n_seg);  // complete: no other thread has it
        } else {
          head = cur;
          has_head = true;
        }
        cur = empty_run(e.seg);
      }
      const bool covered = d > 0;
      const long long d64 = d, wc = covered ? w : 0;
      cur.v[0] = add64(cur.v[0], d64 * wc);
      cur.v[1] = add64(cur.v[1], wc);
      cur.v[2] = add64(cur.v[2], covered ? full : 0LL);
      cur.v[3] = max(cur.v[3], (covered && w > 0) ? d64 : 0LL);
      cur.v[4] = add64(cur.v[4], (long long)((unsigned long long)(d64 * d64) *
                                             (unsigned long long)wc));
      cur.v[5] = max(cur.v[5], w > 0 ? kBigM - d64 : 0LL);
      o_d[i & 3] = d;
      o_w[i & 3] = (int)w;
      o_s[i & 3] = e.seg;
      if ((i & 3) == 3) {
        const long long at = base + (long long)tid * kItems + (i - 3);
        if (at + 3 < E) {
          *reinterpret_cast<int4*>(depth_out + at) =
              make_int4(o_d[0], o_d[1], o_d[2], o_d[3]);
          *reinterpret_cast<int4*>(wlen_out + at) =
              make_int4(o_w[0], o_w[1], o_w[2], o_w[3]);
          *reinterpret_cast<int4*>(seg_out + at) =
              make_int4(o_s[0], o_s[1], o_s[2], o_s[3]);
        } else {
          #pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (at + q < E) {
              depth_out[at + q] = o_d[q];
              wlen_out[at + q] = o_w[q];
              seg_out[at + q] = o_s[q];
            }
          }
        }
      }
    }
  }

  // ---- block-wide: join each thread's head run to the runs of the
  // threads before it, and flush every run where it ends in the tile
  Run unused;
  const Run before = block_exclusive_scan(cur, empty_run(-1), RunOp(),
                                          s_wrun, unused);
  if (has_head) {
    if (before.s == head.s) merge(head, before);
    flush(head, per_seg, n_seg);
  }
  const int next_first = decode(key_after, n_seg, pad_pos).seg;
  if (tid == kThreads - 1 || next_first != cur.s) {
    if (before.s == cur.s) merge(cur, before);
    flush(cur, per_seg, n_seg);
  }
}

}  // namespace

extern "C" {

// int64 words of scratch one launch needs: per_seg, the ticket, one
// descriptor a tile (zeroed by the launch).
long long sweep_scan_scratch_words(long long E, int n_seg) {
  const long long tiles = (E + kTile - 1) / kTile;
  return (long long)kStats * n_seg + 1 + tiles;
}

// Launch on card `device`, on `stream` (a stream of that card); returns
// the first CUDA error (0 on success). keys must be 16-byte aligned;
// per_seg is scratch[0 : 6 * n_seg]. The library links its own static
// runtime, whose current device is its own per thread and 0 until set:
// the caller names the card, so the memset and the launch run on the
// card that holds the tensors whatever device torch has made current.
int sweep_scan_launch(const long long* keys, const int* len_tab, int* depth,
                      int* w_len_all, int* seg, long long* scratch,
                      long long E, int n_seg, int ee, int pad_pos,
                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(
      scratch, 0, sizeof(long long) * sweep_scan_scratch_words(E, n_seg), st);
  if (err != cudaSuccess) return (int)err;
  if (E <= 0) return 0;
  const long long tiles = (E + kTile - 1) / kTile;
  unsigned long long* ticket =
      reinterpret_cast<unsigned long long*>(scratch + (long long)kStats * n_seg);
  sweep_scan_kernel<<<(unsigned)tiles, kThreads, 0, st>>>(
      keys, len_tab, depth, w_len_all, seg, scratch, ticket, ticket + 1, E,
      n_seg, ee, pad_pos);
  return (int)cudaGetLastError();
}

}  // extern "C"
