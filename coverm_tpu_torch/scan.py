"""Per-sample scan: RecordBatch -> per-contig integer statistics.

The device-side analogue of the reference's streaming hot loop
(contig.rs:107-215, genome.rs:516-729): read filters are boolean masks
over the record arrays, coverage blocks are scattered into the device
depth engine, and the per-record bookkeeping (read counts, edit
distances, identity sums) becomes bincounts over the contig id axis.

The three scan modes of the reference count reads slightly differently;
all three counts are computed here so any mode can be served:
  - primary-only            (contig mode, contig.rs:157-159)
  - non-supplementary       (separator genome mode, genome.rs:677-682)
  - all passing records     (named-genome mode, genome.rs:170-174)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .flags import FlagFilter
from .io.bam import BamHeader, RecordBatch
from .ops.depth import DepthStats, ReferenceLayout
from .ops.sweep import (DepthAccumulator, compute_depth_stats_sweep,
                        empty_depth_stats, resolve_depth)


class BamSortingError(Exception):
    pass


class MissingNMTagError(Exception):
    pass


@dataclass
class SampleScan:
    """Per-contig statistics for one sample (stoit)."""

    header: BamHeader
    depth: DepthStats
    observed: np.ndarray          # bool[C]: >=1 passing mapped record
    reads_primary: np.ndarray     # int64[C]
    reads_nonsupp: np.ndarray     # int64[C]
    reads_all: np.ndarray         # int64[C]
    nm_sum: np.ndarray            # int64[C] Σ NM over passing mapped records
    indel_sum: np.ndarray         # int64[C] Σ (I+D)
    identity_sum_primary: np.ndarray   # f64[C] (contig + separator modes)
    identity_sum_nonsupp: np.ndarray   # f64[C] (named-genome mode)
    num_detected_primary_alignments: int

    @property
    def mismatches(self) -> np.ndarray:
        return self.nm_sum - self.indel_sum


def scan_sample(header: BamHeader, batch: RecordBatch, layout: ReferenceLayout,
                flag_filter: FlagFilter, need_hist: bool, trim=None,
                device=None, deferred=False, acc=None) -> SampleScan:
    """One batch -> SampleScan. With deferred=True the depth field is a
    pending device result (see ops/sweep.compute_depth_stats_sweep)."""
    C = header.n_ref
    passes = flag_filter.passes(batch)
    mapped = ~batch.is_unmapped()
    use = passes & mapped

    tids = batch.tid[use]
    if tids.size and (int(tids.min()) < 0 or int(tids.max()) >= C):
        # corrupt input: a mapped record naming a reference outside the
        # header dictionary (the native fused scan raises the same way)
        from .io.bam import BamFormatError
        raise BamFormatError("BAM record references an out-of-range tid")
    if tids.size and np.any(np.diff(tids) < 0):
        raise BamSortingError(
            "BAM file appears to be unsorted. Input BAM files must be sorted "
            "by reference (i.e. by samtools sort)")
    if np.any(batch.nm[use] < 0):
        raise MissingNMTagError(
            "Mapping record encountered that does not have an 'NM' auxiliary "
            "tag in the SAM/BAM format. This is required to work out some "
            "coverage statistics.")

    # coverage blocks from every passing mapped record
    buse = use[batch.block_read]
    btids = batch.tid[batch.block_read[buse]]
    depth = compute_depth_stats_sweep(
        layout, btids, batch.block_start[buse], batch.block_end[buse],
        need_hist=need_hist, trim=trim, deferred=deferred, acc=acc,
        device=device)

    observed = np.zeros(C, dtype=bool)
    observed[np.unique(tids)] = True

    primary = batch.is_primary()
    nonsupp = ~batch.is_supplementary()

    def count(mask):
        return np.bincount(batch.tid[mask], minlength=C).astype(np.int64)

    def weighted(mask, w):
        return np.bincount(batch.tid[mask], weights=w[mask], minlength=C)

    reads_primary = count(use & primary)
    reads_nonsupp = count(use & nonsupp)
    reads_all = count(use)

    nm_sum = weighted(use, batch.nm.astype(np.float64)).astype(np.int64)
    indel_sum = weighted(use, batch.indels.astype(np.float64)).astype(np.int64)

    aligned = batch.aligned_cov.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        identity = np.where(aligned > 0, (aligned - batch.nm) / aligned, 0.0)
    identity_sum_primary = weighted(use & primary & (batch.aligned_cov > 0), identity)
    identity_sum_nonsupp = weighted(use & nonsupp & (batch.aligned_cov > 0), identity)

    num_primary = int(np.count_nonzero(batch.is_primary()))

    return SampleScan(
        header=header, depth=depth, observed=observed,
        reads_primary=reads_primary, reads_nonsupp=reads_nonsupp,
        reads_all=reads_all, nm_sum=nm_sum, indel_sum=indel_sum,
        identity_sum_primary=identity_sum_primary,
        identity_sum_nonsupp=identity_sum_nonsupp,
        num_detected_primary_alignments=num_primary,
    )


def merge_depth_stats(da: DepthStats, db: DepthStats) -> DepthStats:
    """Merge DepthStats over DISJOINT contig sets by addition (every
    per-contig statistic is zero on untouched contigs — max/min/trimmed
    included, only one side is ever nonzero per contig)."""

    def add(x, y):
        return None if x is None else x + y

    hist = None
    hist_wide = None
    if da.hist is not None:
        wa, wb = da.hist.shape[1], db.hist.shape[1]
        W = max(wa, wb)
        hist = np.zeros((da.hist.shape[0], W), dtype=np.int64)
        hist[:, :wa] += da.hist
        hist[:, :wb] += db.hist
        if da.hist_wide or db.hist_wide:
            # contig-disjoint batches: ragged overflow rows never collide
            hist_wide = {**(da.hist_wide or {}), **(db.hist_wide or {})}
    return DepthStats(
        hist_wide=hist_wide,
        sum_depth_window=da.sum_depth_window + db.sum_depth_window,
        covered_window=da.covered_window + db.covered_window,
        covered_full=da.covered_full + db.covered_full,
        max_depth_window=da.max_depth_window + db.max_depth_window,
        hist=hist,
        trimmed_sum=add(da.trimmed_sum, db.trimmed_sum),
        sumsq_window=add(da.sumsq_window, db.sumsq_window),
        min_depth_window=add(da.min_depth_window, db.min_depth_window),
    )


def merge_scans(a: SampleScan, b: SampleScan) -> SampleScan:
    """Merge per-batch scans whose observed contigs are DISJOINT (the
    BamStreamReader's contig-boundary batching guarantees this)."""
    depth = merge_depth_stats(a.depth, b.depth)
    return SampleScan(
        header=a.header, depth=depth,
        observed=a.observed | b.observed,
        reads_primary=a.reads_primary + b.reads_primary,
        reads_nonsupp=a.reads_nonsupp + b.reads_nonsupp,
        reads_all=a.reads_all + b.reads_all,
        nm_sum=a.nm_sum + b.nm_sum,
        indel_sum=a.indel_sum + b.indel_sum,
        identity_sum_primary=a.identity_sum_primary + b.identity_sum_primary,
        identity_sum_nonsupp=a.identity_sum_nonsupp + b.identity_sum_nonsupp,
        num_detected_primary_alignments=(
            a.num_detected_primary_alignments
            + b.num_detected_primary_alignments),
    )


def _empty_scan(header: BamHeader, need_hist: bool = False,
                trim=None) -> SampleScan:
    C = header.n_ref
    z = lambda: np.zeros(C, dtype=np.int64)
    # empty_depth_stats keeps the hist/trimmed fields consistent with
    # the fused path's zero-record result (trim requested -> zeros, not
    # None), so a record-free BAM prints identically through either
    # engine (tests/test_fused_carry_fuzz.py truncation agreement)
    return SampleScan(
        header=header, depth=empty_depth_stats(C, need_hist, trim),
        observed=np.zeros(C, dtype=bool),
        reads_primary=z(), reads_nonsupp=z(), reads_all=z(),
        nm_sum=z(), indel_sum=z(),
        identity_sum_primary=np.zeros(C), identity_sum_nonsupp=np.zeros(C),
        num_detected_primary_alignments=0)


def scan_sample_batches(header: BamHeader, batches, layout: ReferenceLayout,
                        flag_filter: FlagFilter, need_hist: bool, trim=None,
                        device=None) -> SampleScan:
    """Streaming scan, fully pipelined: per-batch depth calls are
    dispatched DEFERRED (the device result stays in flight), so batch
    i+1's host decode (prefetch thread) and h2d overlap batch i's device
    compute; the per-contig results are fetched and merged by addition
    at the end (batches are contig-disjoint, scan.merge_scans)."""
    from .prefetch import prefetch_iter

    acc = DepthAccumulator()
    scans = []
    last_max_tid = -1
    for batch in prefetch_iter(batches):
        mapped_tids = batch.tid[~batch.is_unmapped()]
        if mapped_tids.size:
            if int(mapped_tids[0]) < last_max_tid:
                raise BamSortingError(
                    "BAM file appears to be unsorted. Input BAM files must "
                    "be sorted by reference (i.e. by samtools sort)")
            last_max_tid = max(last_max_tid, int(mapped_tids.max()))
        scans.append(scan_sample(header, batch, layout, flag_filter,
                                 need_hist, trim=trim, device=device,
                                 deferred=True, acc=acc))
    acc.start_fetch()  # the whole pass is usually ONE pending fetch
    for s in scans:
        if hasattr(s.depth, "start_fetch"):
            s.depth.start_fetch()  # overlap all d2h copies
    agg = None
    for s in scans:
        s.depth = resolve_depth(s.depth)
        agg = s if agg is None else merge_scans(agg, s)
    if agg is not None and not acc.empty:
        agg.depth = merge_depth_stats(agg.depth, acc.result())
    return agg if agg is not None else _empty_scan(header, need_hist, trim)


def scan_any(header, payload, layout, flag_filter, need_hist, trim=None,
             device=None) -> SampleScan:
    """Dispatch: RecordBatch -> scan_sample; FusedScanStream -> the
    native fused engine (io/fastscan.py) when it applies; any other
    batch iterator -> the classic streaming scan."""
    if isinstance(payload, RecordBatch):
        return scan_sample(header, payload, layout, flag_filter, need_hist,
                           trim=trim, device=device)
    from .io.fastscan import FusedScanStream, fused_available, \
        scan_sample_fused
    if isinstance(payload, FusedScanStream):
        if fused_available():
            return scan_sample_fused(header, payload, layout, flag_filter,
                                     need_hist, trim=trim, device=device)
        payload = payload.batches()
    return scan_sample_batches(header, payload, layout, flag_filter,
                               need_hist, trim=trim, device=device)
