// Fused post-sort sweep scan for Hopper (sm_90a).
//
// Replaces the TPU kernel coverm_tpu/ops/pallas_sweep.py::_sweep_kernel
// (called through pallas_sweep_scan). Input: six int32 event arrays
// sorted by (contig, position), one sentinel (pos == -1) first in each
// contig carrying the contig length in `paylen`. One pass computes, per
// event:
//   - the running depth: the inclusive sign scan minus the per-contig
//     carry, the scan value at the contig's sentinel forward-filled by a
//     lexicographic (seg, value) max-scan;
//   - the contig length, forward-filled from the sentinel's paylen;
//   - the gap length full_len over [0, len) and the window length w_len
//     over [ee, len - ee), zeroed when len <= 2*ee and on padding events
//     (pos >= pad_pos);
//   - the running per-contig window-max fill (max_seg, max_val).
// Outputs: depth, w_len and full_len masked to depth > 0, max_seg,
// max_val, and w_len unmasked (the trimmed-mean rank queries and the
// window minimum read depth-0 window gaps too).
//
// Bound: 6 int32 inputs read once and 6 int32 outputs written once,
// 48 bytes per event, so memory bandwidth bounds it: about 0.03 ms for
// 2 M events at 3.35 TB/s. The arithmetic is a few dozen integer
// operations per event.
//
// Design: a chained scan. The TPU kernel carried 7 int32 words in SMEM
// from one grid step to the next, relying on the grid running in order;
// GPU blocks run in no order. Here each block takes its tile index from
// an atomic ticket (so tiles are claimed in launch order and a block
// only ever waits on a block that is already running), computes its
// tile's local scans (sign sum, length fill, sentinel-carry fill), then
// waits on its predecessor's published state, folds it in with O(1)
// work, and publishes its own. The window-max fill depends on depth, so
// it forms a second chain, published after the tile's depths and the
// local max-scan are known: the fills are ordered after the sign scan as
// in the TPU kernel. Each link of both chains costs a flag round trip
// through L2 plus O(1) arithmetic; the tile scans themselves run in
// parallel across blocks.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // 2048 events, the TPU tile size
constexpr int kWarps = kThreads / 32;
constexpr int kStateInts = 16;            // per-tile published state
constexpr int kHeaderInts = 16;           // scratch[0] is the ticket

// Published state of tile t at scratch[kHeaderInts + kStateInts * t]:
//   [0] stage-1 flag  [1] sign sum  [2,3] length fill  [4,5] carry fill
//   [8] stage-2 flag  [9,10] window-max fill

struct Pair {
  int s, v;
};

// Lexicographic max of (seg, value) pairs, b later than a (the TPU
// kernel's _lexmax).
__device__ __forceinline__ Pair lexmax(Pair a, Pair b) {
  bool take_b = (b.s > a.s) || (b.s == a.s && b.v >= a.v);
  return take_b ? b : a;
}

// Blend an inter-tile carry into a tile-local fill (the TPU kernel's
// fill(): the carry wins only when strictly greater).
__device__ __forceinline__ Pair blend(Pair c, Pair f) {
  bool take_c = (c.s > f.s) || (c.s == f.s && c.v > f.v);
  return take_c ? c : f;
}

// Tile-local summary of the sentinel-carry fill. The fill's value at a
// sentinel is the GLOBAL sign scan there, unknown until the predecessor
// state arrives; so the scan keeps, for the greatest seg seen, the
// largest LOCAL scan value over its sentinels (a, valid when f & 1) and
// whether any non-sentinel event (value 0) of that seg was seen (f & 2).
struct Sent {
  int s, a, f;
};

__device__ __forceinline__ Sent sent_combine(Sent x, Sent y) {
  if (y.s > x.s) return y;
  if (x.s > y.s) return x;
  Sent r;
  r.s = x.s;
  if ((x.f & 1) && (y.f & 1)) {
    r.a = max(x.a, y.a);
  } else {
    r.a = (x.f & 1) ? x.a : y.a;
  }
  r.f = x.f | y.f;
  return r;
}

// Value of the fill once the predecessor's sign sum S is known.
__device__ __forceinline__ int sent_value(Sent c, int S) {
  int v = INT_MIN;
  if (c.f & 1) v = c.a + S;
  if (c.f & 2) v = max(v, 0);
  return v;
}

__device__ __forceinline__ int shfl_up(int v, int k) {
  return __shfl_up_sync(0xffffffffu, v, k);
}
__device__ __forceinline__ Pair shfl_up(Pair p, int k) {
  return Pair{shfl_up(p.s, k), shfl_up(p.v, k)};
}
__device__ __forceinline__ Sent shfl_up(Sent p, int k) {
  return Sent{shfl_up(p.s, k), shfl_up(p.a, k), shfl_up(p.f, k)};
}

struct AddOp {
  __device__ int operator()(int a, int b) const { return a + b; }
};
struct LexOp {
  __device__ Pair operator()(Pair a, Pair b) const { return lexmax(a, b); }
};
struct SentOp {
  __device__ Sent operator()(Sent a, Sent b) const {
    return sent_combine(a, b);
  }
};

// Block-wide inclusive scan of kItems consecutive items per thread
// (blocked arrangement); every thread gets the block aggregate.
template <typename T, typename Op>
__device__ __forceinline__ T block_scan(T (&items)[kItems], Op op,
                                        T* warp_tot) {
  #pragma unroll
  for (int i = 1; i < kItems; ++i) items[i] = op(items[i - 1], items[i]);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T incl = items[kItems - 1];
  #pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    T up = shfl_up(incl, k);
    if (lane >= k) incl = op(up, incl);
  }
  T excl = shfl_up(incl, 1);  // meaningful for lane > 0
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  T agg = warp_tot[0];
  T wpre = warp_tot[0];
  #pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    if (w < warp) wpre = op(wpre, warp_tot[w]);
    agg = op(agg, warp_tot[w]);
  }
  if (warp > 0 || lane > 0) {
    T pre = lane == 0 ? wpre : (warp > 0 ? op(wpre, excl) : excl);
    #pragma unroll
    for (int i = 0; i < kItems; ++i) items[i] = op(pre, items[i]);
  }
  __syncthreads();  // warp_tot is reused by the next scan
  return agg;
}

// The predecessor holds an earlier ticket, so it is resident and its flag
// arrives; a flag missing after ~10 s means a broken invariant, and the
// kernel traps (a launch error) rather than hanging the card.
__device__ __forceinline__ void wait_flag(const volatile int* flag) {
  long long spins = 0;
  while (*flag == 0) {
    __nanosleep(64);
    if (++spins > (1LL << 27)) __trap();
  }
  __threadfence();
}

__device__ __forceinline__ void publish(volatile int* flag) {
  __threadfence();
  *flag = 1;
}

__global__ void __launch_bounds__(kThreads)
sweep_scan_kernel(const int* __restrict__ seg_in,
                  const int* __restrict__ pos_in,
                  const int* __restrict__ sign_in,
                  const int* __restrict__ paylen_in,
                  const int* __restrict__ nseg_in,
                  const int* __restrict__ npos_in,
                  int* __restrict__ depth_out, int* __restrict__ wlen_out,
                  int* __restrict__ flen_out, int* __restrict__ maxs_out,
                  int* __restrict__ maxv_out, int* __restrict__ wall_out,
                  int* scratch, long long E, int ee, int pad_pos) {
  __shared__ int s_tile;
  __shared__ int s_prev[7];
  __shared__ int w_add[kWarps];
  __shared__ Pair w_pair[kWarps];
  __shared__ Sent w_sent[kWarps];

  if (threadIdx.x == 0) s_tile = atomicAdd(&scratch[0], 1);
  __syncthreads();
  const long long t = s_tile;
  const long long base = t * kTile + (long long)threadIdx.x * kItems;
  volatile int* mine = scratch + kHeaderInts + kStateInts * t;
  volatile int* prev = mine - kStateInts;

  int seg[kItems], pos[kItems], li[kItems], nseg[kItems], npos[kItems];
  Pair L[kItems];
  Sent C[kItems];
  #pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long idx = base + i;
    if (idx < E) {
      seg[i] = seg_in[idx];
      pos[i] = pos_in[idx];
      li[i] = sign_in[idx];
      L[i].v = paylen_in[idx];
      nseg[i] = nseg_in[idx];
      npos[i] = npos_in[idx];
    } else {  // ragged tail: after every real event, never stored
      seg[i] = INT_MAX;
      pos[i] = pad_pos;
      li[i] = 0;
      L[i].v = 0;
      nseg[i] = INT_MAX;
      npos[i] = pad_pos;
    }
  }

  // ---- stage 1, local: sign scan, length fill, sentinel-carry fill
  const int sum_t = block_scan(li, AddOp(), w_add);
  #pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const bool sent = pos[i] == -1;
    L[i] = Pair{seg[i], sent ? L[i].v : 0};
    C[i] = sent ? Sent{seg[i], li[i], 1} : Sent{seg[i], INT_MIN, 2};
  }
  const Pair l_agg = block_scan(L, LexOp(), w_pair);
  const Sent c_agg = block_scan(C, SentOp(), w_sent);

  // ---- stage 1, chain: fold the predecessor's state, publish ours
  if (threadIdx.x == 0) {
    int p[5] = {0, -1, 0, -1, 0};  // the TPU kernel's initial carries
    if (t > 0) {
      wait_flag(prev);
      #pragma unroll
      for (int k = 0; k < 5; ++k) p[k] = prev[1 + k];
    }
    const Pair ln = blend(Pair{p[1], p[2]}, l_agg);
    const Pair cn =
        blend(Pair{p[3], p[4]}, Pair{c_agg.s, sent_value(c_agg, p[0])});
    mine[1] = p[0] + sum_t;
    mine[2] = ln.s;
    mine[3] = ln.v;
    mine[4] = cn.s;
    mine[5] = cn.v;
    publish(mine);
    #pragma unroll
    for (int k = 0; k < 5; ++k) s_prev[k] = p[k];
  }
  __syncthreads();
  const int S = s_prev[0];
  const Pair p_len{s_prev[1], s_prev[2]};
  const Pair p_car{s_prev[3], s_prev[4]};

  // ---- elementwise: depth, gap and window lengths, window-max values
  int depth[kItems], wl[kItems], fl[kItems];
  Pair M[kItems];
  #pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int gsign = S + li[i];
    const int length = blend(p_len, L[i]).v;
    const int carry =
        blend(p_car, Pair{C[i].s, sent_value(C[i], S)}).v;
    const int d = gsign - carry;
    // int64 arithmetic: padding positions near INT_MAX must not wrap
    const long long gap_end = nseg[i] == seg[i] ? npos[i] : length;
    long long full = min(gap_end, (long long)length) - max(pos[i], 0);
    long long w = min(gap_end, (long long)length - ee) - max(pos[i], ee);
    full = max(full, 0LL);
    w = length > 2 * ee ? max(w, 0LL) : 0LL;
    if (pos[i] >= pad_pos) {
      full = 0;
      w = 0;
    }
    depth[i] = d;
    wl[i] = (int)w;
    fl[i] = (int)full;
    M[i] = Pair{seg[i], (d > 0 && w > 0) ? d : 0};
  }
  const Pair m_agg = block_scan(M, LexOp(), w_pair);

  // ---- stage 2, chain: the window-max fill
  if (threadIdx.x == 0) {
    int pm[2] = {-1, 0};
    if (t > 0) {
      wait_flag(prev + 8);
      pm[0] = prev[9];
      pm[1] = prev[10];
    }
    const Pair mn = blend(Pair{pm[0], pm[1]}, m_agg);
    mine[9] = mn.s;
    mine[10] = mn.v;
    publish(mine + 8);
    s_prev[5] = pm[0];
    s_prev[6] = pm[1];
  }
  __syncthreads();
  const Pair p_max{s_prev[5], s_prev[6]};

  #pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long idx = base + i;
    if (idx < E) {
      const Pair m = blend(p_max, M[i]);
      const bool covered = depth[i] > 0;
      depth_out[idx] = depth[i];
      wlen_out[idx] = covered ? wl[i] : 0;
      flen_out[idx] = covered ? fl[i] : 0;
      maxs_out[idx] = m.s;
      maxv_out[idx] = m.v;
      wall_out[idx] = wl[i];
    }
  }
}

}  // namespace

extern "C" {

// Ints of scratch the launch needs for E events (zeroed by the launch).
long long sweep_scan_scratch_ints(long long E) {
  const long long tiles = (E + kTile - 1) / kTile;
  return kHeaderInts + kStateInts * tiles;
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).
int sweep_scan_launch(const int* seg, const int* pos, const int* sign,
                      const int* paylen, const int* next_seg,
                      const int* next_pos, int* depth, int* w_len,
                      int* full_len, int* max_seg, int* max_val,
                      int* w_len_all, int* scratch, long long E, int ee,
                      int pad_pos, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E <= 0) return 0;
  const long long tiles = (E + kTile - 1) / kTile;
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, sizeof(int) * sweep_scan_scratch_ints(E), st);
  if (err != cudaSuccess) return (int)err;
  sweep_scan_kernel<<<(unsigned)tiles, kThreads, 0, st>>>(
      seg, pos, sign, paylen, next_seg, next_pos, depth, w_len, full_len,
      max_seg, max_val, w_len_all, scratch, E, ee, pad_pos);
  return (int)cudaGetLastError();
}

}  // extern "C"
