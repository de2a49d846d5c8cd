"""Reference layout, per-contig statistics and the numpy oracle.

The host part of the JAX package's ops/depth.py. The dense scatter-add
engine (`compute_depth_stats`) is not ported yet; the event sweep in
ops/sweep.py is the engine on every path of this package.

All statistics are integers; the estimator layer (estimators.py)
reproduces the reference's exact f32 arithmetic from them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _bucket(n: int, minimum: int = 1024) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


class ReferenceLayout:
    """Reference-static layout: contig lengths and end exclusion. (The
    JAX package's layout also packs contigs into position chunks for its
    dense engine, which this package does not have yet.)"""

    def __init__(self, lengths, contig_end_exclusion: int):
        self.lengths = np.asarray(lengths, dtype=np.int64)
        self.contig_end_exclusion = int(contig_end_exclusion)

    @staticmethod
    def build(lengths, contig_end_exclusion: int) -> "ReferenceLayout":
        return ReferenceLayout(lengths, contig_end_exclusion)

    @property
    def n_contigs(self) -> int:
        return int(self.lengths.size)


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
