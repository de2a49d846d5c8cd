"""Event-sweep depth engine on torch: O(B log B) in alignment blocks.

Port of the JAX package's ops/sweep.py. Instead of materialising
per-position depth, sort the 2B interval endpoints and sweep: between
consecutive events the depth is constant, so every statistic is a
weighted reduction over event *gaps*:

    sum_w  = Σ_gaps depth · |gap ∩ window|
    cov_w  = Σ_gaps [depth>0] · |gap ∩ window|
    cov_f  = Σ_gaps [depth>0] · |gap ∩ [0, len)|
    hist[d]= Σ_gaps [depth=d] · |gap ∩ window|   (d>0; bin 0 by difference)

Per batch the host uploads ONE u8 buffer (block starts or start deltas,
block lengths, per-contig counts) and the device:

  1. unpacks it and rebuilds the contig id, start and end of every block;
  2. sorts the int64 event keys (torch.sort), with one sentinel per
     contig sorting first in its contig;
  3. runs the post-sort sweep scan (ops/sweep_scan.py: the hand-written
     CUDA kernel on the card), which gives per-event depth and gap
     lengths and reduces the per-contig sums and the window max and min;
  4. runs the trimmed-mean rank queries and the histogram.

The result is one packed int64 vector
[sum_w | cov_w | cov_f | max_w | sq_w | min_w | gmax (| trim) (| hist)],
byte-identical to the JAX package's `_sweep_packed_u8` on the same
buffer. Semantics match the numpy oracle (ops/depth.py): ends at the
contig end drop their -1 event (contig.rs:178-183), the exclusion window
is [ee, len-1-ee] for contigs with len > 2·ee.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .depth import DepthStats, ReferenceLayout, _bucket
from .sweep_scan import BIGM, PAD_KEY, sweep_scan

# beyond this many contigs, per-contig outputs are remapped to the dense
# observed set on host to bound histogram/stat sizes
DENSE_REMAP_THRESHOLD = 1 << 16

# speculative histogram width fused into the main sweep call; depths
# >= this are recomputed exactly on the host for the contigs concerned
SPEC_HIST_BINS = 512


def _bucket_geo(n: int, minimum: int = 1024) -> int:
    """Geometric size buckets: ratio 1.25 below 1M blocks, 1.5 above.
    Kept from the JAX package so that the u8 buffer layout, and with it
    the packed result, is identical in both packages."""
    b = minimum
    while b < n:
        num, den = (3, 2) if b >= (1 << 20) else (5, 4)
        b = (-(-b * num // den) + 127) // 128 * 128
    return b


def packed_result_len(n_seg: int, need_hist: bool, n_bins: int,
                      has_trim: bool) -> int:
    """Length of the packed int64 stats vector produced by packed_math:
    [sum_w | cov_w | cov_f | max_w | sq_w | min_w | gmax (| trim) (| hist)]."""
    n = 6 * n_seg + 1
    if has_trim:
        n += n_seg
    if need_hist:
        n += n_seg * n_bins
    return n


def sort_events(tids, starts, ends, valid_block, end_keep, n_seg):
    """The sweep-scan kernel's input: the int64 event keys, sorted.

    tids/starts/ends: int32[B] (padded; valid_block False on padding)
    end_keep: bool[B] (end < contig length; end events at the contig end
              are dropped, contig.rs:178-183)
    """
    seg_b = tids.long()
    # keys: seg<<34 | (pos+1)<<2 | is_start<<1 ; sentinels use pos-field 0
    # so they sort first within their contig; padding sorts last. Events
    # at equal (seg, pos) order ends before starts (a zero-length gap).
    key_start = torch.where(
        valid_block, (seg_b << 34) | ((starts.long() + 1) << 2) | 2, PAD_KEY)
    key_end = torch.where(
        end_keep, (seg_b << 34) | ((ends.long() + 1) << 2), PAD_KEY)
    sent = torch.arange(n_seg, dtype=torch.int64, device=tids.device) << 34
    return torch.sort(torch.cat([sent, key_start, key_end]),
                      stable=True).values


def sweep_core(tids, starts, ends, valid_block, end_keep, len_tab, n_seg,
               ee):
    """Events + sort + sweep-scan kernel, which also reduces per contig.

    len_tab: int32[n_seg + 1] contig lengths (0 for unused segments and
    for padding). Returns (sum_w, cov_w, cov_f, max_w, gmax, depth,
    w_len, seg_s, sq_w, min_w); depth/w_len/seg_s are per sorted event,
    w_len unmasked.
    """
    key_s = sort_events(tids, starts, ends, valid_block, end_keep, n_seg)
    depth, w_len, seg_s, per_seg = sweep_scan(key_s, len_tab, n_seg, ee)
    sum_w, cov_w, cov_f, max_w, sq_w, minpay = per_seg
    min_w = torch.where(minpay > 0, BIGM - minpay, 0)
    return (sum_w, cov_w, cov_f, max_w, max_w.max(), depth, w_len, seg_s,
            sq_w, min_w)


def hist_math(depth, w_len, seg_of_event, n_seg, n_bins):
    """Gap-weighted window depth histogram [n_seg, n_bins] (bins clip at
    n_bins-1), as an integer scatter-add: exact in any order."""
    valid = seg_of_event < n_seg
    d = depth.clamp(0, n_bins - 1).long()
    contrib = torch.where((depth > 0) & valid, w_len.long(), 0)
    bin_key = torch.where(valid, seg_of_event.long() * n_bins + d,
                          n_seg * n_bins)
    out = torch.zeros(n_seg * n_bins + 1, dtype=torch.int64,
                      device=depth.device)
    out.index_add_(0, bin_key, contrib)
    return out[:-1].reshape(n_seg, n_bins)


def trimmed_math(depth, w_len, seg_s, seg_W, trim_min, trim_max, n_seg):
    """Per-seg trimmed-mean numerators from sorted gaps — scan-only.

    Rank-space closed form of the reference's histogram CDF walk
    (estimators.rs:598-643): the walk sums the depths at window ranks
    [max(lo,1), min(hi+1, W)], except when a single depth bin contains
    both rank lo and rank hi+1, which contributes (hi-lo+1)·depth.
    Gaps are re-sorted by (seg, depth); rank queries are searchsorted
    probes into the weight CDF, so cost is independent of the maximum
    depth.
    """
    dev = depth.device
    E = depth.shape[0]
    segi = seg_s.long()
    valid = segi < n_seg
    d64 = depth.long()
    w64 = torch.where(valid, w_len.long(), 0)
    key = torch.where(valid, (segi << 32) + d64, PAD_KEY)
    key_s, order = torch.sort(key, stable=True)
    w_s = w64[order]
    d_s = d64[order]
    cumw = torch.cumsum(w_s, 0)
    cumwd = torch.cumsum(w_s * d_s, 0)

    # trim indices, f32 arithmetic as the reference (estimators.rs:595-597)
    Wf = seg_W.float()
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    lo = torch.floor(f32(trim_min) * Wf).long()
    hi = torch.ceil(f32(trim_max) * Wf).long()

    seg_ids = torch.arange(n_seg, dtype=torch.int64, device=dev)
    bounds = torch.searchsorted(key_s, seg_ids << 32)  # first gap of each seg

    def before(cs, j):
        """cs[j-1], or 0 where j == 0 (indices clipped: torch wraps
        negative indices where JAX's gather clamps)."""
        return torch.where(j > 0, cs[(j - 1).clamp(min=0)], 0)

    base_w = before(cumw, bounds)
    base_wd = before(cumwd, bounds)

    def rank_gap(r):
        """Sorted-gap index holding within-seg rank r (1 <= r <= W)."""
        tgt = base_w + torch.minimum(r.clamp(min=1), seg_W)
        return torch.searchsorted(cumw, tgt).clamp(0, E - 1)

    def S(r):
        """Σ_{k<=r} depth_at_rank(k) within each seg (0 when r <= 0)."""
        rr = torch.minimum(r.clamp(min=0), seg_W)
        j = rank_gap(rr)
        s = (before(cumwd, j) - base_wd) \
            + (base_w + rr - before(cumw, j)) * d_s[j]
        return torch.where(rr > 0, s, 0)

    a = lo.clamp(min=1)
    b = torch.minimum(hi + 1, seg_W)
    normal = torch.where(b >= a, S(b) - S(a - 1), 0)
    # single-bin override: ranks lo and hi+1 fall in the same depth bin
    can_single = (lo >= 1) & (hi + 1 <= seg_W)
    d_lo = d_s[rank_gap(lo)]
    single = can_single & (d_lo == d_s[rank_gap(hi + 1)])
    total = torch.where(single, (hi - lo + 1) * d_lo, normal)
    return torch.where(seg_W > 0, total, 0)


def packed_math(starts, lens_or_ends, counts_ext, seg_len, scalar_len,
                n_seg, ee, need_hist, n_bins, len_mode, trim=None,
                start_mode="abs", first_start=None):
    """Transfer-minimal fused sweep: one packed int64 result.

    starts: int32[B] block starts (grouped by contig), or u8/u16 start
        DELTAS within each contig (start_mode "d8"/"d16"), rebuilt here
        with one cumsum and a per-contig rebase from `first_start`
    lens_or_ends: block lengths (len_mode "u16"), block ends ("ends"),
        or unused when every block has length scalar_len ("scalar")
    counts_ext: int32[n_seg+1] blocks per contig (+ padding count); the
        contig-id column is rebuilt with a repeat
    seg_len: int64[n_seg]
    """
    dev = starts.device
    B = starts.shape[0]
    counts = counts_ext.long()
    tids = torch.repeat_interleave(
        torch.arange(n_seg + 1, dtype=torch.int32, device=dev), counts,
        output_size=B)
    len_tab = torch.cat([seg_len.int(),
                         torch.zeros(1, dtype=torch.int32, device=dev)])
    len_of = torch.repeat_interleave(len_tab, counts, output_size=B)
    if start_mode in ("d16", "d8"):
        cum = torch.cumsum(starts.long(), 0)
        first_idx = (torch.cumsum(counts, 0) - counts).clamp(0, B - 1)
        base = torch.repeat_interleave(cum[first_idx], counts, output_size=B)
        first = torch.repeat_interleave(first_start.long(), counts,
                                        output_size=B)
        starts = (first + cum - base).int()
    if len_mode == "scalar":
        ends = starts + scalar_len
    elif len_mode == "u16":
        ends = starts + lens_or_ends.int()
    else:
        ends = lens_or_ends
    valid_block = tids < n_seg
    end_keep = valid_block & (ends < len_of)

    r = sweep_core(tids, starts, ends, valid_block, end_keep, len_tab,
                   n_seg, ee)
    sum_w, cov_w, cov_f, max_w, gmax, depth, w_len, seg_s, sq_w, min_w = r
    parts = [sum_w, cov_w, cov_f, max_w, sq_w, min_w, gmax.reshape(1)]
    if trim is not None:
        seg_W = torch.where(seg_len > 2 * ee, seg_len - 2 * ee, 0)
        parts.append(trimmed_math(depth, w_len, seg_s, seg_W, trim[0],
                                  trim[1], n_seg))
    if need_hist:
        parts.append(hist_math(depth, w_len, seg_s, n_seg, n_bins)
                     .reshape(-1))
    return torch.cat(parts)


def _u8_layout(B, n_seg, start_mode, len_mode):
    """Byte offsets of the single-upload input buffer: a 16-byte header
    (the scalar length), counts_ext, first_start, the start column padded
    to 4 bytes, then the length/end column. Every int32 section starts on
    a 4-byte boundary, so it can be viewed in place."""
    start_bytes = {"abs": 4, "d16": 2, "d8": 1}[start_mode] * B
    start_bytes = -(-start_bytes // 4) * 4
    pay_bytes = {"scalar": 0, "u16": 2 * B, "ends": 4 * B}[len_mode]
    hdr = 16
    meta = 4 * (n_seg + 1)
    o_counts = hdr
    o_first = o_counts + meta
    o_starts = o_first + meta
    o_pay = o_starts + start_bytes
    total = o_pay + pay_bytes
    return o_counts, o_first, o_starts, o_pay, total


def sweep_packed_u8(buf, acc, seg_len, n_seg, ee, need_hist, n_bins,
                    len_mode, trim, start_mode, B, device=None):
    """Single-buffer sweep plus in-call merge: the packed int64 vector of
    `buf` (laid out by _u8_layout) added to `acc`. Takes the same arrays
    as the JAX package's `_sweep_packed_u8` (numpy arrays or tensors)
    and returns a tensor on `device` (default: the device of `buf` when
    it is a tensor, else default_device())."""
    if device is None and isinstance(buf, torch.Tensor):
        device = buf.device
    dev = resolve_device(device)
    buf = torch.as_tensor(buf, device=dev)
    acc = torch.as_tensor(acc, device=dev)
    seg_len = torch.as_tensor(seg_len, device=dev)
    o_counts, o_first, o_starts, o_pay, _ = _u8_layout(
        B, n_seg, start_mode, len_mode)

    def i32(lo, n):
        return buf[lo:lo + 4 * n].view(torch.int32)

    def u16(lo, n):
        return buf[lo:lo + 2 * n].view(torch.int16).int() & 0xFFFF

    scalar_len = i32(0, 1)  # a tensor: reading it would sync the card
    counts_ext = i32(o_counts, n_seg + 1)
    first_start = i32(o_first, n_seg + 1)
    if start_mode == "abs":
        starts = i32(o_starts, B)
    elif start_mode == "d16":
        starts = u16(o_starts, B)
    else:
        starts = buf[o_starts:o_starts + B]
    if len_mode == "scalar":
        payload = None
    elif len_mode == "u16":
        payload = u16(o_pay, B)
    else:
        payload = i32(o_pay, B)
    packed = packed_math(starts, payload, counts_ext, seg_len, scalar_len,
                         n_seg, ee, need_hist, n_bins, len_mode, trim,
                         start_mode, first_start)
    return packed + acc


def _pack_u8(scalar_len, counts_ext, first_start, starts_col, payload_col,
             B, n_seg, start_mode, len_mode):
    """Assemble the single-upload buffer (host side, one memcpy each)."""
    o_counts, o_first, o_starts, o_pay, total = _u8_layout(
        B, n_seg, start_mode, len_mode)
    buf = np.zeros(total, dtype=np.uint8)
    buf[:4] = np.asarray([scalar_len], dtype=np.int32).view(np.uint8)
    buf[o_counts:o_counts + counts_ext.nbytes] = counts_ext.view(np.uint8)
    fs = first_start
    buf[o_first:o_first + fs.nbytes] = fs.view(np.uint8)
    sc = np.ascontiguousarray(starts_col)
    buf[o_starts:o_starts + sc.nbytes] = sc.view(np.uint8)
    if payload_col is not None:
        pc = np.ascontiguousarray(payload_col)
        buf[o_pay:o_pay + pc.nbytes] = pc.view(np.uint8)
    return buf


def empty_depth_stats(C, need_hist, trim):
    zero = lambda: np.zeros(C, dtype=np.int64)
    return DepthStats(zero(), zero(), zero(), zero(),
                      np.zeros((C, 1), np.int64) if need_hist else None,
                      zero() if trim is not None else None,
                      zero(), zero())


def prep_segments(layout: ReferenceLayout, tids, starts, ends,
                  contig_counts=None):
    """Shared host prologue: tid-sort fallback + dense remap.

    Returns (tids, starts, ends, seg_ids, n_seg, seg_len, n_out, obs,
    counts); obs is None unless the dense remap kicked in.

    contig_counts (int64[C], from the native fused scan) certifies that
    blocks arrive grouped by contig in tid order and carries the
    per-contig block counts, skipping the sortedness pass and the
    bincount over all blocks."""
    C = layout.n_contigs
    if contig_counts is None:
        if np.any(tids[1:] < tids[:-1]):
            order = np.argsort(tids, kind="stable")
            tids, starts, ends = tids[order], starts[order], ends[order]
    if C > DENSE_REMAP_THRESHOLD:
        if contig_counts is None:
            obs = np.unique(tids)
        else:
            obs = np.flatnonzero(contig_counts)
        seg_ids = np.searchsorted(obs, tids).astype(np.int32)
        n_seg = _bucket(obs.size, minimum=8)
        n_out = obs.size
        seg_len = np.zeros(n_seg, dtype=np.int64)
        seg_len[:n_out] = layout.lengths[obs]
        src = None if contig_counts is None else contig_counts[obs]
    else:
        obs = None
        seg_ids = tids.astype(np.int32)
        n_seg = _bucket(C, minimum=8)
        n_out = C
        seg_len = np.zeros(n_seg, dtype=np.int64)
        seg_len[:C] = layout.lengths
        src = contig_counts
    if src is None:
        counts = np.bincount(seg_ids, minlength=n_seg)
    else:
        counts = np.zeros(n_seg, dtype=np.int64)
        counts[:n_out] = src
    return tids, starts, ends, seg_ids, n_seg, seg_len, n_out, obs, counts


def choose_payload(layout, tids, starts, ends):
    """Pick the cheapest block-length representation for the upload.

    Returns (len_mode, scalar_len, vals) where vals is the per-block
    payload column (None for scalar mode).
    """
    lens = (ends - starts).astype(np.int64)
    L = int(lens.max(initial=0))
    scalar_len = np.int32(L)
    # scalar also covers uniform-length reads clamped at contig ends:
    # a computed end >= contig length drops its -1 event exactly like
    # the true clamped end does (contig.rs:178-183)
    if tids.size and (
        np.all(lens == L)
        or np.array_equal(
            np.minimum(starts + L, layout.lengths[tids]), ends)):
        return "scalar", scalar_len, None
    if L < (1 << 16):
        return "u16", scalar_len, lens.astype(np.uint16)
    return "ends", scalar_len, ends.astype(np.int32)


def unpack_packed(layout, packed, n_seg, n_out, obs, tids, need_hist, trim,
                  n_bins):
    """Decode the packed vector into DepthStats (hist requires the caller
    to have handled overflow already)."""
    C = layout.n_contigs
    ee = layout.contig_end_exclusion
    zero = lambda: np.zeros(C, dtype=np.int64)
    out = DepthStats(zero(), zero(), zero(), zero(), None,
                     sumsq_window=zero(), min_depth_window=zero())
    tgt = obs if obs is not None else slice(0, C)
    out.sum_depth_window[tgt] = packed[:n_out]
    out.covered_window[tgt] = packed[n_seg: n_seg + n_out]
    out.covered_full[tgt] = packed[2 * n_seg: 2 * n_seg + n_out]
    out.max_depth_window[tgt] = np.maximum(
        packed[3 * n_seg: 3 * n_seg + n_out], 0)
    out.sumsq_window[tgt] = packed[4 * n_seg: 4 * n_seg + n_out]
    out.min_depth_window[tgt] = packed[5 * n_seg: 5 * n_seg + n_out]
    base = 6 * n_seg + 1
    if trim is not None:
        out.trimmed_sum = zero()
        out.trimmed_sum[tgt] = packed[base: base + n_out]
        base += n_seg
    if need_hist:
        h = packed[base:].reshape(n_seg, n_bins)
        hist = np.zeros((C, n_bins), dtype=np.int64)
        hist[tgt] = h[:n_out]
        _fix_hist_bin0(layout, out, hist, tids, obs, ee)
        out.hist = hist
    return out


def encode_start_deltas(starts, counts, n_blocks):
    """Within-contig start differences (1-2 bytes/block on the link).

    BAM streams are coordinate-sorted, so starts are non-decreasing
    within a contig and the deltas are tiny (mean spacing = contig
    length / reads per contig).  Returns (deltas, first_start_i32, mode)
    where mode is "d8" (u8 deltas) or "d16" (u16), or (None, None, None)
    when a delta is negative (synthetic unsorted input) or over 65535.
    """
    d = np.empty(n_blocks, dtype=np.int64)
    d[0] = 0
    np.subtract(starts[1:], starts[:-1], out=d[1:])
    bounds = np.concatenate(([0], np.cumsum(counts)))[:-1]
    nz = counts > 0
    d[bounds[nz]] = 0  # first block of each (non-empty) contig run
    dmax = d.max()
    if d.min() < 0 or dmax >= (1 << 16):
        return None, None, None
    first_start = np.zeros(counts.shape[0] + 1, dtype=np.int32)
    first_start[: counts.shape[0]][nz] = starts[bounds[nz]]
    if dmax < (1 << 8):  # typical: mean spacing = contig_len/reads
        return d.astype(np.uint8), first_start, "d8"
    return d.astype(np.uint16), first_start, "d16"


class _HostCopy:
    """A device->host copy in flight: a non-blocking copy into pinned
    memory ordered by a CUDA event on the tensor's own card (a plain view
    for CPU tensors)."""

    def __init__(self, t):
        if t.device.type == "cuda":
            with torch.cuda.device(t.device):
                self._host = torch.empty(t.shape, dtype=t.dtype,
                                         pin_memory=True)
                self._host.copy_(t, non_blocking=True)
                self._event = torch.cuda.Event()
                self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._host = t
            self._event = None

    def numpy(self):
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def _fetch(t, copy):
    return (copy if copy is not None else _HostCopy(t)).numpy()


class _EmptyPending:
    """Pending that resolves to an empty DepthStats (used for empty
    inputs and for batches whose statistics were folded into a
    DepthAccumulator)."""

    def __init__(self, C, need_hist, trim):
        self._out = empty_depth_stats(C, need_hist, trim)

    def start_fetch(self):
        pass

    def result(self):
        return self._out


class DepthAccumulator:
    """Device-side merge of contig-disjoint batch sweeps.

    Streaming scans cut batches at contig boundaries, so per-contig
    statistics from different batches never overlap — merging is plain
    addition, done on the device inside each batch's packed sweep, so a
    whole streaming pass costs ONE device->host fetch.

    The accumulated gmax element is a SUM of batch maxima (an upper
    bound); accumulation is therefore only engaged for need_hist=False
    calls, where gmax has no consumer.
    """

    def __init__(self):
        self._dev = None
        self._meta = None
        self._unpack = None
        self._copy = None

    @property
    def empty(self):
        return self._dev is None

    def compatible(self, meta):
        return self._dev is None or self._meta == meta

    def start_fetch(self):
        if self._dev is not None:
            self._copy = _HostCopy(self._dev)

    def result(self):
        """One fetch -> DepthStats of everything accumulated (None if
        nothing was)."""
        if self._dev is None:
            return None
        layout, n_seg, n_out, trim = self._unpack
        packed = _fetch(self._dev, self._copy)
        return unpack_packed(layout, packed, n_seg, n_out, None, None,
                             False, trim, 0)


class PendingDepthStats:
    """An in-flight packed sweep: the device work is queued and the
    result fetch deferred, so the caller can prepare the next batch on
    the host while the card computes this one."""

    def __init__(self, dev, layout, n_seg, n_out, obs, tids, need_hist,
                 trim, n_bins, blocks):
        self._dev = dev
        self._copy = None
        self._args = (layout, n_seg, n_out, obs, tids, need_hist, trim)
        self._n_bins = n_bins
        self._blocks = blocks  # original (tids, starts, ends) numpy arrays

    def start_fetch(self):
        """Begin the async device->host copy."""
        self._copy = _HostCopy(self._dev)

    def result(self) -> DepthStats:
        layout, n_seg, n_out, obs, tids, need_hist, trim = self._args
        packed = _fetch(self._dev, self._copy)
        d = unpack_packed(layout, packed, n_seg, n_out, obs, tids,
                          need_hist, trim, self._n_bins)
        if not need_hist or int(packed[6 * n_seg]) < self._n_bins:
            return d
        # A handful of very deep contigs must not widen every contig's
        # histogram row (O(contigs x max_depth)): keep the speculative-
        # width result for the normal contigs and recompute the overflow
        # contigs' exact rows on the host with the oracle over a
        # sub-layout, stored as a ragged side table.
        of = np.flatnonzero(d.max_depth_window >= self._n_bins)
        if of.size:
            from .depth import compute_depth_stats_numpy
            bt, bs, be = self._blocks
            sel = np.isin(bt, of)
            remap = np.full(layout.n_contigs, -1, np.int64)
            remap[of] = np.arange(of.size)
            sub = ReferenceLayout.build(
                layout.lengths[of], layout.contig_end_exclusion)
            dd = compute_depth_stats_numpy(
                sub, remap[bt[sel]], bs[sel], be[sel], need_hist=True)
            wide = {}
            for j, c in enumerate(of.tolist()):
                wide[c] = dd.hist[j].astype(np.int64)
                d.hist[c, :] = 0
            d.hist_wide = wide
        return d


def resolve_depth(stats):
    """Resolve any pending depth result (PendingDepthStats, _EmptyPending)
    into a concrete DepthStats."""
    return stats.result() if hasattr(stats, "result") else stats


def compute_depth_stats_sweep(layout: ReferenceLayout, tids, starts, ends,
                              need_hist: bool = False, trim=None,
                              deferred: bool = False,
                              acc: "DepthAccumulator | None" = None,
                              contig_counts=None, device=None):
    """Per-contig DepthStats of alignment blocks (tids, starts, ends).

    Host cost is O(B): a bincount for the contig-id run lengths (blocks
    arrive grouped by contig because BAM streams are reference-sorted; a
    stable argsort fallback covers synthetic callers) and the padding
    copy. The device gets ONE u8 buffer of 1-6 bytes per block. With
    deferred=True the fetch is left in flight (PendingDepthStats); with
    acc= given (and need_hist=False), the result is instead added into
    the accumulator ON THE DEVICE and an empty pending is returned — the
    caller fetches acc.result() once at the end of the stream.
    """
    dev = resolve_device(device)
    C = layout.n_contigs
    tids = np.asarray(tids)
    starts = np.asarray(starts)
    ends = np.asarray(ends)
    if tids.size == 0 or C == 0:
        out = _EmptyPending(C, need_hist, trim)
        return out if deferred else out.result()

    ee = layout.contig_end_exclusion
    n_blocks = tids.size
    (tids, starts, ends, seg_ids, n_seg, seg_len, n_out, obs,
     counts) = prep_segments(layout, tids, starts, ends,
                             contig_counts=contig_counts)

    len_mode, scalar_len, vals = choose_payload(layout, tids, starts, ends)

    start_mode = "abs"
    first_start = np.zeros(n_seg + 1, dtype=np.int32)
    deltas = None
    if n_blocks > (1 << 14):  # shrinking the upload only matters at scale
        deltas, fs, mode = encode_start_deltas(starts, counts, n_blocks)
        if deltas is not None:
            start_mode, first_start = mode, fs
    trim_key = (float(trim[0]), float(trim[1])) if trim is not None else None
    B = _bucket_geo(n_blocks)
    if start_mode in ("d16", "d8"):
        starts_p = np.zeros(B, dtype=deltas.dtype)
        starts_p[:n_blocks] = deltas
    else:
        starts_p = np.zeros(B, dtype=np.int32)
        starts_p[:n_blocks] = starts
    counts_ext = np.append(counts, B - n_blocks).astype(np.int32)
    if vals is None:
        payload = None
    else:
        payload = np.zeros(B, dtype=vals.dtype)
        payload[:n_blocks] = vals

    buf = _pack_u8(scalar_len, counts_ext, first_start, starts_p, payload,
                   B, n_seg, start_mode, len_mode)
    d_buf = torch.from_numpy(buf).to(dev)
    d_len = torch.from_numpy(seg_len).to(dev)

    use_acc = acc is not None and not need_hist and obs is None
    if use_acc:
        meta = (id(layout), n_seg, n_out, trim_key, dev)
        use_acc = acc.compatible(meta)

    def dispatch(acc_in):
        if acc_in is None:
            acc_in = torch.zeros(
                packed_result_len(n_seg, need_hist, SPEC_HIST_BINS,
                                  trim_key is not None),
                dtype=torch.int64, device=dev)
        return sweep_packed_u8(
            d_buf, acc_in, d_len, n_seg=n_seg, ee=ee, need_hist=need_hist,
            n_bins=SPEC_HIST_BINS, len_mode=len_mode, trim=trim_key,
            start_mode=start_mode, B=B, device=dev)

    if use_acc:
        acc._dev = dispatch(acc._dev)
        acc._meta = meta
        acc._unpack = (layout, n_seg, n_out, trim)
        out = _EmptyPending(C, need_hist, trim)
        return out if deferred else out.result()

    pending = PendingDepthStats(dispatch(None), layout, n_seg, n_out, obs,
                                tids, need_hist, trim, SPEC_HIST_BINS,
                                blocks=(tids, starts, ends))
    return pending if deferred else pending.result()


def _fix_hist_bin0(layout, out, hist, tids, obs, ee):
    """bin 0 = window positions not covered (observed contigs only)."""
    win_len = np.where(layout.lengths > 2 * ee, layout.lengths - 2 * ee, 0)
    hist[:, 0] = 0
    obs_all = np.unique(tids) if obs is None else obs
    hist[obs_all, 0] = win_len[obs_all] - out.covered_window[obs_all]


def trimmed_sum_via_hist(layout, hist, trim):
    """Host fallback: trimmed-mean numerators from a dense histogram
    (the numpy oracle's path)."""
    from ..estimators import trimmed_total_from_hist
    ee = layout.contig_end_exclusion
    W = np.where(layout.lengths > 2 * ee, layout.lengths - 2 * ee, 0)
    lo = np.floor(np.float32(trim[0]) * W.astype(np.float32)).astype(np.int64)
    hi = np.ceil(np.float32(trim[1]) * W.astype(np.float32)).astype(np.int64)
    return trimmed_total_from_hist(hist, lo, hi)
