"""Reference layout, the dense depth engine, per-contig statistics and the
numpy oracle.

The port of the JAX package's ops/depth.py. Its dense scatter-add
engine (`compute_depth_stats`) works over a *chunked, padded position
space*:

  - contigs are padded to a multiple of ``LANE`` (128) and greedily
    packed into chunks of up to ``DEFAULT_CHUNK`` positions; the packing
    is reference-static and each chunk's position metadata (segment ids,
    window and valid masks) is built once per device and reused by every
    sample;
  - per sample only the chunks that received blocks run, and only the
    scatter points (one int32 index and one int32 delta per block end)
    cross host -> device;
  - blocks scatter +1 at their start and -1 at their end (ends at the
    contig end are dropped, matching contig.rs:178-183); depth is one
    cumsum per chunk with a per-contig carry subtracted;
  - per-contig statistics are segment reductions over the positions, and
    the depth histogram a 2-D scatter-add with its width fixed per
    sample; only those cross device -> host.

The event sweep in ops/sweep.py is the engine of the CLI; this one is
called directly (tests/test_torch_dense.py, chip_smoke.py). It is plain
torch: every statistic is an integer sum, maximum or minimum, exact in
any order. The estimator layer (estimators.py) reproduces the
reference's exact f32 arithmetic from them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property

import numpy as np
import torch

LANE = 128
DEFAULT_CHUNK = 1 << 22  # 4M positions per chunk
_I32_MIN = -(1 << 31)
_I32_MAX = (1 << 31) - 1


def _round_up(x, m):
    return (x + m - 1) // m * m


def _bucket(n: int, minimum: int = 1024) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclass
class _Chunk:
    """One chunk of the padded position space."""

    cids: np.ndarray          # global contig ids packed in this chunk
    base: np.ndarray          # int64, chunk-local offset of each contig
    n_local: int
    # device -> (pos_seg, window, valid), built on first use
    on_device: dict = field(default_factory=dict)


@dataclass
class _Packing:
    P: int                    # positions per chunk
    K: int                    # segments per chunk (padding is K - 1)
    chunks: list
    chunk_of_contig: np.ndarray
    base_of_contig: np.ndarray
    padded: np.ndarray


class ReferenceLayout:
    """Reference-static layout: contig lengths and end exclusion, and the
    dense engine's chunk packing (built on first use: the sweep engine
    reads only the lengths and the exclusion)."""

    def __init__(self, lengths, contig_end_exclusion: int,
                 chunk_positions: int = DEFAULT_CHUNK):
        self.lengths = np.asarray(lengths, dtype=np.int64)
        self.contig_end_exclusion = int(contig_end_exclusion)
        self.chunk_positions = int(chunk_positions)

    @staticmethod
    def build(lengths, contig_end_exclusion: int) -> "ReferenceLayout":
        return ReferenceLayout(lengths, contig_end_exclusion)

    @property
    def n_contigs(self) -> int:
        return int(self.lengths.size)

    @cached_property
    def _packing(self) -> _Packing:
        C = self.lengths.size
        padded = np.maximum(_round_up(self.lengths, LANE), LANE) if C else \
            np.zeros(0, np.int64)
        max_padded = int(padded.max()) if C else LANE
        total = int(padded.sum()) if C else LANE
        P = min(_bucket(total, minimum=LANE), self.chunk_positions)
        P = max(P, _bucket(max_padded, minimum=LANE))

        # greedy packing in tid order
        chunk_of_contig = np.zeros(C, dtype=np.int32)
        base_of_contig = np.zeros(C, dtype=np.int64)
        packed = []
        cur_ids, cur_fill = [], 0
        for cid in range(C):
            pl = int(padded[cid])
            if cur_fill + pl > P:
                packed.append(cur_ids)
                cur_ids, cur_fill = [], 0
            chunk_of_contig[cid] = len(packed)
            base_of_contig[cid] = cur_fill
            cur_ids.append(cid)
            cur_fill += pl
        if cur_ids or not packed:
            packed.append(cur_ids)
        chunks = []
        for ids in packed:
            cids = np.asarray(ids, dtype=np.int64)
            chunks.append(_Chunk(cids=cids, base=base_of_contig[cids],
                                 n_local=len(ids)))
        # one segment count for every chunk; padding positions map to
        # segment K - 1, which no contig uses because the bucket is
        # strictly larger than the most contigs a chunk holds
        K = _bucket(max([len(ids) for ids in packed] + [1]) + 1, minimum=8)
        return _Packing(P, K, chunks, chunk_of_contig, base_of_contig,
                        padded)

    @property
    def P(self) -> int:
        return self._packing.P

    @property
    def K(self) -> int:
        return self._packing.K

    @property
    def chunks(self) -> list:
        return self._packing.chunks

    @property
    def chunk_of_contig(self) -> np.ndarray:
        return self._packing.chunk_of_contig

    @property
    def base_of_contig(self) -> np.ndarray:
        return self._packing.base_of_contig

    def device_chunk(self, ci: int, device):
        """(pos_seg int64[P], window bool[P], valid bool[P]) of chunk ci on
        `device` (built once per device)."""
        device = torch.device(device)
        ch = self.chunks[ci]
        got = ch.on_device.get(device)
        if got is not None:
            return got
        P, K = self.P, self.K
        plens = self._packing.padded[ch.cids]
        fill = int(plens.sum())
        seg = np.full(P, K - 1, dtype=np.int64)
        seg[:fill] = np.repeat(np.arange(ch.n_local, dtype=np.int64), plens)
        pos_in = np.arange(P, dtype=np.int64)
        base_of_pos = np.zeros(P, dtype=np.int64)
        base_of_pos[:fill] = np.repeat(ch.base, plens)
        pos_in = pos_in - base_of_pos
        len_of_pos = np.zeros(P, dtype=np.int64)
        len_of_pos[:fill] = np.repeat(self.lengths[ch.cids], plens)
        valid = pos_in < len_of_pos
        valid[fill:] = False
        ee = self.contig_end_exclusion
        window = valid & (len_of_pos > 2 * ee) & (pos_in >= ee) & (
            pos_in <= len_of_pos - 1 - ee)
        got = tuple(torch.from_numpy(a).to(device)
                    for a in (seg, window, valid))
        ch.on_device[device] = got
        return got


@dataclass
class DepthStats:
    """Per-contig integer statistics for one sample (host numpy)."""

    sum_depth_window: np.ndarray   # int64[C]  Σ depth inside exclusion window
    covered_window: np.ndarray     # int64[C]  positions depth>0 inside window
    covered_full: np.ndarray       # int64[C]  positions depth>0 anywhere
    max_depth_window: np.ndarray   # int64[C]  max depth inside window
    hist: np.ndarray | None = None  # int64[C, D] window depth histogram
    trimmed_sum: np.ndarray | None = None  # int64[C] trimmed-mean numerators
    # second moment + window minimum: enough for the shifted-variance
    # estimator without materialising a histogram (hist cost is
    # O(contigs x max_depth) — prohibitive at assembly scale)
    sumsq_window: np.ndarray | None = None  # int64[C] Σ depth² inside window
    min_depth_window: np.ndarray | None = None  # int64[C] min depth in window
    # ragged overflow rows for contigs whose depth exceeds the dense hist
    # width (tid -> full int64 row); dense rows for those tids are zero
    hist_wide: dict | None = None


def stats_core_math(scatter_idx, scatter_val, pos_seg, window_mask,
                    valid_mask, n_seg):
    """One chunk: scatter the deltas, cumsum the depth, reduce per local
    segment. Returns (sum_w int64, cov_w int64, cov_f int64, max_w int32,
    depth int32[P], sq_w int64, min_w int32), each per segment but depth.

    scatter_idx in [0, P] (P takes the dropped block ends), pos_seg
    int64[P] in [0, n_seg) and non-decreasing. A segment without
    positions gets the int32 minimum as max_w and 0 as min_w, as the
    JAX package's segment_max and segment_min give; 0 is min_w too for
    a contig without a window."""
    P = pos_seg.shape[0]
    dev = pos_seg.device
    idx = torch.as_tensor(scatter_idx, device=dev).long()
    val = torch.as_tensor(scatter_val, device=dev).int()
    delta = torch.zeros(P + 1, dtype=torch.int32, device=dev)
    delta.index_add_(0, idx, val)
    delta = delta[:P]

    raw = torch.cumsum(delta, 0, dtype=torch.int32)
    seg_total = torch.zeros(n_seg, dtype=torch.int32, device=dev)
    seg_total.index_add_(0, pos_seg, delta)
    carry = torch.cumsum(seg_total, 0, dtype=torch.int32) - seg_total
    depth = raw - carry[pos_seg]

    zero = torch.zeros((), dtype=torch.int32, device=dev)
    dw = torch.where(window_mask, depth, zero)
    dw64 = dw.long()

    def seg_sum(v):
        return torch.zeros(n_seg, dtype=torch.int64, device=dev).index_add_(
            0, pos_seg, v.long())

    def seg_reduce(v, how, init):
        return torch.full((n_seg,), init, dtype=torch.int32,
                          device=dev).scatter_reduce_(
            0, pos_seg, v, how, include_self=False)

    sum_w = seg_sum(dw64)
    cov_w = seg_sum(dw > 0)
    cov_f = seg_sum((depth > 0) & valid_mask)
    max_w = seg_reduce(dw, "amax", _I32_MIN)
    sq_w = seg_sum(dw64 * dw64)
    big = torch.full((), _I32_MAX, dtype=torch.int32, device=dev)
    min_w = seg_reduce(torch.where(window_mask, depth, big), "amin",
                       _I32_MAX)
    min_w = torch.where(min_w == _I32_MAX, zero, min_w)
    return sum_w, cov_w, cov_f, max_w, depth, sq_w, min_w


def hist_core(depth, pos_seg, window_mask, n_seg, n_bins):
    """int32[n_seg, n_bins] window depth histogram of one chunk (depths
    clipped into [0, n_bins - 1])."""
    d = torch.clamp(depth, 0, n_bins - 1).long()
    flat = pos_seg * n_bins + d
    # positions outside the window land in the extra slot, then dropped
    flat = torch.where(window_mask, flat, n_seg * n_bins)
    hist = torch.zeros(n_seg * n_bins + 1, dtype=torch.int32,
                       device=depth.device)
    hist.index_add_(0, flat, torch.ones_like(depth))
    return hist[:n_seg * n_bins].view(n_seg, n_bins)


def compute_depth_stats(layout: ReferenceLayout, tids, starts, ends,
                        need_hist: bool = False, trim=None,
                        device=None) -> DepthStats:
    """Per-contig depth statistics of one sample's blocks by the dense
    engine on `device` (default: device.default_device()).

    tids/starts/ends: one row per alignment block (M/X/= run), already
    filtered to records that contribute coverage, with
    0 <= start < len and start <= end <= len.
    """
    from ..device import resolve_device
    dev = resolve_device(device)
    C = layout.n_contigs
    sum_w = np.zeros(C, dtype=np.int64)
    cov_w = np.zeros(C, dtype=np.int64)
    cov_f = np.zeros(C, dtype=np.int64)
    max_w = np.zeros(C, dtype=np.int64)
    sq_w = np.zeros(C, dtype=np.int64)
    min_w = np.zeros(C, dtype=np.int64)

    tids = np.asarray(tids, dtype=np.int64)
    starts = np.asarray(starts, dtype=np.int64)
    ends = np.asarray(ends, dtype=np.int64)
    if tids.size == 0 or C == 0:
        return DepthStats(sum_w, cov_w, cov_f, max_w,
                          np.zeros((C, 1), np.int64) if need_hist else None,
                          np.zeros(C, np.int64) if trim is not None else None,
                          sq_w, min_w)

    P, K = layout.P, layout.K
    chunk_ids = layout.chunk_of_contig[tids]
    order = np.argsort(chunk_ids, kind="stable")
    s_chunk = chunk_ids[order]
    s_tids = tids[order]
    base = layout.base_of_contig[s_tids]
    local_start = base + starts[order]
    raw_end = ends[order]
    local_end = np.where(raw_end < layout.lengths[s_tids], base + raw_end, P)

    touched = np.unique(s_chunk)
    lo = np.searchsorted(s_chunk, touched, side="left")
    hi = np.searchsorted(s_chunk, touched, side="right")

    pending = []  # (chunk, per-segment results on the device)
    for ci, a, b in zip(touched.tolist(), lo.tolist(), hi.tolist()):
        n = b - a
        idx = np.concatenate([local_start[a:b], local_end[a:b]]).astype(
            np.int32)
        val = np.concatenate([np.ones(n, np.int32), -np.ones(n, np.int32)])
        pos_seg, window, valid = layout.device_chunk(ci, dev)
        r = stats_core_math(torch.from_numpy(idx).to(dev),
                            torch.from_numpy(val).to(dev),
                            pos_seg, window, valid, K)
        pending.append((ci, r))

    global_max = 0
    for ci, r in pending:
        ch = layout.chunks[ci]
        nl = ch.n_local
        # only the per-segment statistics cross device -> host
        rs, rcw, rcf, rmw, rsq, rmin = (
            x.cpu().numpy() for x in (r[0], r[1], r[2], r[3], r[5], r[6]))
        sum_w[ch.cids] += rs[:nl]
        cov_w[ch.cids] += rcw[:nl]
        cov_f[ch.cids] += rcf[:nl]
        sq_w[ch.cids] += rsq[:nl]
        min_w[ch.cids] = rmin[:nl]  # a contig lives in exactly one chunk
        mw = np.maximum(rmw[:nl], 0)
        max_w[ch.cids] = np.maximum(max_w[ch.cids], mw)
        if mw.size:
            global_max = max(global_max, int(mw.max()))

    hist = None
    if need_hist or trim is not None:
        n_bins = _bucket(global_max + 1, minimum=128)
        hist = np.zeros((C, n_bins), dtype=np.int64)
        for ci, r in pending:
            ch = layout.chunks[ci]
            pos_seg, window, _valid = layout.device_chunk(ci, dev)
            h = hist_core(r[4], pos_seg, window, K, n_bins).cpu().numpy()
            hist[ch.cids] += h[: ch.n_local]

    trimmed = None
    if trim is not None:
        from .sweep import trimmed_sum_via_hist
        trimmed = trimmed_sum_via_hist(layout, hist, trim)
        if not need_hist:
            hist = None
    return DepthStats(sum_w, cov_w, cov_f, max_w, hist, trimmed, sq_w, min_w)


def compute_depth_stats_numpy(layout: ReferenceLayout, tids, starts, ends,
                              need_hist: bool = False,
                              trim=None) -> DepthStats:
    """Pure-numpy oracle of the depth engines (for tests)."""
    C = layout.n_contigs
    sum_w = np.zeros(C, dtype=np.int64)
    cov_w = np.zeros(C, dtype=np.int64)
    cov_f = np.zeros(C, dtype=np.int64)
    max_w = np.zeros(C, dtype=np.int64)
    sq_w = np.zeros(C, dtype=np.int64)
    min_w = np.zeros(C, dtype=np.int64)
    ee = layout.contig_end_exclusion
    tids = np.asarray(tids)
    starts = np.asarray(starts)
    ends = np.asarray(ends)
    max_bins = 1
    per_contig_depth = {}
    for c in np.unique(tids).tolist():
        ln = int(layout.lengths[c])
        delta = np.zeros(ln + 1, dtype=np.int64)
        m = tids == c
        np.add.at(delta, starts[m], 1)
        e = ends[m]
        np.add.at(delta, e[e < ln], -1)
        depth = np.cumsum(delta[:ln])
        per_contig_depth[c] = depth
        if ln > 2 * ee:
            w = depth[ee : ln - ee]
            sum_w[c] = w.sum()
            cov_w[c] = (w > 0).sum()
            max_w[c] = w.max() if w.size else 0
            sq_w[c] = (w * w).sum()
            min_w[c] = w.min() if w.size else 0
            max_bins = max(max_bins, int(max_w[c]) + 1)
        cov_f[c] = (depth > 0).sum()
    hist = None
    if need_hist:
        hist = np.zeros((C, max_bins), dtype=np.int64)
        for c, depth in per_contig_depth.items():
            ln = int(layout.lengths[c])
            if ln > 2 * ee:
                w = depth[ee : ln - ee]
                hist[c] += np.bincount(w, minlength=max_bins)[:max_bins]
    trimmed = None
    if trim is not None:
        hh = hist
        if hh is None:
            hh = np.zeros((C, max_bins), dtype=np.int64)
            for c, depth in per_contig_depth.items():
                ln = int(layout.lengths[c])
                if ln > 2 * ee:
                    w = depth[ee : ln - ee]
                    hh[c] += np.bincount(w, minlength=max_bins)[:max_bins]
        from .sweep import trimmed_sum_via_hist
        trimmed = trimmed_sum_via_hist(layout, hh, trim)
    return DepthStats(sum_w, cov_w, cov_f, max_w, hist, trimmed, sq_w, min_w)
