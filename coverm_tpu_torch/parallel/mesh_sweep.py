"""Contig-sharded multi-device sweep (the `--sharded` mesh analogue).

Port of the JAX package's parallel/mesh_sweep.py. The event-sweep depth
engine (ops/sweep.py) is independent across contigs, so the natural
multi-device decomposition is *reference sharding* (the mesh
re-imagining of the reference's shard_bam_reader.rs merge): alignment
blocks are routed to shards by contig id (greedy longest-processing-time
balance over per-contig block counts), each shard runs the identical
packed sweep (`packed_math`, with the sweep-scan kernel K1) on its own
device, and the per-shard int64 vectors are summed on the row's first
device. Every contig's statistics are nonzero on exactly one shard, and
integer addition is exact in any order, so the result is bit-equal to
the single-device engine.

A mesh here is a `[dp][shard]` grid of `torch.device`s, plain lists: no
mesh object. A grid may name one device several times (`[[cuda:0] * 4]`)
so that logical shards share a card. The `dp` rows carry sample data
parallelism: sample s of a stacked call runs on row s // (S / dp).

This path is CLI-reachable: modes._scanned selects it whenever more than
one local device is visible (COVERM_TPU_MESH=0 disables; =1 forces it
even for multi-sample runs, which otherwise scan on device groups).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..device import device_grid
from ..ops.depth import ReferenceLayout
from ..ops.sweep import (SPEC_HIST_BINS, PendingDepthStats, _bucket_geo,
                         _EmptyPending, choose_payload, packed_math,
                         prep_segments, trimmed_sum_via_hist)

# make_shard_mesh(n_devices=None, dp=1, devices=None): a `[dp][shard]` grid
make_shard_mesh = device_grid


def assign_contigs(counts: np.ndarray, n_shards: int) -> np.ndarray:
    """Greedy LPT: heaviest contig (by block count) to the least-loaded
    shard. Deterministic (ties broken by lowest shard id / lowest tid)."""
    shard_of = np.zeros(counts.shape[0], dtype=np.int32)
    load = np.zeros(n_shards, dtype=np.int64)
    order = np.argsort(-counts, kind="stable")
    for c in order:
        s = int(np.argmin(load))
        shard_of[c] = s
        load[s] += int(counts[c])
    return shard_of


def _shard_inputs(starts, payload, counts_ext, s, j, B_local, len_mode,
                  dev):
    """Shard j of sample s, on its device."""
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    st = up(starts[s, j * B_local:(j + 1) * B_local])
    pay = None
    if len_mode != "scalar":
        pay = up(payload[s, j * B_local:(j + 1) * B_local].astype(np.int32))
    return st, pay, up(counts_ext[s, j])


def mesh_sweep(starts, payload, counts_ext, seg_len, scalar_len, n_seg, ee,
               need_hist, n_bins, len_mode, trim, mesh, cols=None,
               reduce=None):
    """One packed sweep per (dp row, shard), summed over shards.

    starts/payload: [S, n_shards * B_local]  (payload [S, n_shards] when
                    len_mode is "scalar": unused)
    counts_ext:     [S, n_shards, n_seg + 1]
    seg_len:        [n_seg]
    scalar_len:     [S, 1]
    All numpy; mesh is a [dp][n_shards] grid and S a multiple of dp.
    Each shard's sweep (K1 included) runs on its own device; the sum of
    the int64 vectors on the row's first device is the JAX package's
    psum. Its gmax element is a sum of shard maxima: an upper bound on
    the true maximum, used only as the histogram-overflow trigger.

    cols (default: every column) are the shard columns this process
    runs; `reduce`, when given, takes the row's partial sum and returns
    the sum over processes (parallel/distributed.py).
    Returns one packed int64 tensor per sample."""
    S = starts.shape[0]
    dp, n_shards = len(mesh), len(mesh[0])
    if S % dp:
        raise ValueError(f"{S} samples do not split over {dp} dp rows")
    B_local = starts.shape[1] // n_shards
    cols = range(n_shards) if cols is None else cols
    out = []
    for s in range(S):
        row = mesh[s // (S // dp)]
        total = None
        for j in cols:
            dev = row[j]
            st, pay, ce = _shard_inputs(starts, payload, counts_ext, s, j,
                                        B_local, len_mode, dev)
            packed = packed_math(st, pay, ce, torch.from_numpy(seg_len).to(dev),
                                 int(scalar_len[s, 0]), n_seg, ee, need_hist,
                                 n_bins, len_mode, trim)
            total = packed if total is None else \
                total.add_(packed.to(total.device))
        out.append(total if reduce is None else reduce(total))
    return out


def split_heavy_contigs(tids, starts, ends, n_shards,
                        slack: float = 1.25):
    """Position-split contigs whose block count defeats contig-level
    balancing (SURVEY §5: the sequence-parallel axis; a single huge
    contig must shard across devices).

    A heavy contig's blocks are cut at position boundaries chosen from
    block-start quantiles; blocks crossing a boundary are CLIPPED into
    two sub-blocks, so every reference position's depth lives on exactly
    one piece and per-position statistics sum-merge exactly.  Returns
    (tids, starts, ends, piece_of_block, piece_counts, split_tids) —
    with split_tids empty, the inputs pass through untouched (and the
    caller keeps the bit-identical whole-contig route)."""
    if n_shards <= 1 or tids.size == 0 or np.any(tids[1:] < tids[:-1]):
        # unsorted synthetic input: let prep_segments' argsort handle it
        # on the whole-contig route
        return tids, starts, ends, None, None, np.empty(0, np.int64)
    counts = np.bincount(tids)
    total = int(counts.sum())
    target = -(-total // n_shards)  # ceil
    heavy = np.flatnonzero(counts > slack * target)
    if heavy.size == 0:
        return tids, starts, ends, None, None, np.empty(0, np.int64)

    bounds = np.concatenate(([0], np.cumsum(counts)))
    # Python loops run only over the handful of HEAVY contigs; runs of
    # non-heavy contigs between them pass through as whole slices with
    # vectorised piece ids (assembly-scale: 100k+ contigs, few heavy)
    out_t, out_s, out_e, out_p = [], [], [], []
    piece_counts = []
    next_piece = 0

    def passthrough(c_lo, c_hi):
        """Contigs [c_lo, c_hi) unsplit: one piece per non-empty contig."""
        nonlocal next_piece
        lo, hi = int(bounds[c_lo]), int(bounds[c_hi])
        if hi == lo:
            return
        sub_counts = counts[c_lo:c_hi]
        nz = sub_counts[sub_counts > 0]
        pid = np.repeat(np.arange(nz.size, dtype=np.int64) + next_piece, nz)
        out_t.append(tids[lo:hi])
        out_s.append(starts[lo:hi])
        out_e.append(ends[lo:hi])
        out_p.append(pid)
        piece_counts.extend(nz.tolist())
        next_piece += nz.size

    prev = 0
    for c in heavy.tolist():
        passthrough(prev, c)
        prev = c + 1
        lo, hi = int(bounds[c]), int(bounds[c + 1])
        ct, cs, ce = tids[lo:hi], starts[lo:hi], ends[lo:hi]
        k = min(int(-(-counts[c] // target)), n_shards)
        # position boundaries at block-start quantiles (starts are
        # nondecreasing within a contig: BAM coordinate order)
        qs = cs[np.linspace(0, hi - lo - 1, k + 1).astype(np.int64)]
        cuts = np.unique(qs[1:-1])
        edges = np.concatenate(([np.iinfo(np.int32).min], cuts,
                                [np.iinfo(np.int32).max]))
        for m0, m1 in zip(edges[:-1], edges[1:]):
            sel = (cs < m1) & (ce > m0)
            if not np.any(sel):
                continue
            ps = np.maximum(cs[sel], m0)
            pe = np.minimum(ce[sel], m1)
            out_t.append(ct[sel])
            out_s.append(ps.astype(starts.dtype))
            out_e.append(pe.astype(ends.dtype))
            out_p.append(np.full(ps.size, next_piece, np.int64))
            piece_counts.append(ps.size)
            next_piece += 1
    passthrough(prev, counts.shape[0])
    return (np.concatenate(out_t), np.concatenate(out_s),
            np.concatenate(out_e), np.concatenate(out_p),
            np.asarray(piece_counts, np.int64), heavy.astype(np.int64))


def _route_sample(layout, tids, starts, ends, n_shards,
                  allow_split: bool = False):
    """Host-side routing of one sample's blocks to contig shards.

    Returns (per-shard starts list, per-shard payload list, counts
    [n_shards, n_seg], len_mode, scalar_len, plus the prep_segments
    outputs needed for unpacking, and the tids of position-split
    contigs — empty unless allow_split found an imbalance)."""
    split_tids = np.empty(0, np.int64)
    piece_of_block = None
    if allow_split:
        (tids, starts, ends, piece_of_block, piece_counts,
         split_tids) = split_heavy_contigs(tids, starts, ends, n_shards)
    (tids, starts, ends, seg_ids, n_seg, seg_len_dev, n_out, obs,
     counts) = prep_segments(layout, tids, starts, ends)
    len_mode, scalar_len, vals = choose_payload(layout, tids, starts, ends)

    if split_tids.size:
        shard_of_piece = assign_contigs(piece_counts, n_shards)
        shard_of_block = shard_of_piece[piece_of_block]
        counts_mat = np.zeros((n_shards, n_seg), np.int64)
        np.add.at(counts_mat, (shard_of_block, seg_ids), 1)
    else:
        shard_of_contig = assign_contigs(counts, n_shards)
        shard_of_block = shard_of_contig[seg_ids]
        counts_mat = counts[None, :] * (shard_of_contig[None, :]
                                        == np.arange(n_shards)[:, None])
    order = np.argsort(shard_of_block, kind="stable")  # keeps tid order
    seg_sorted = seg_ids[order]
    starts_sorted = starts[order].astype(np.int32)
    vals_sorted = None if vals is None else vals[order]
    per_shard = np.bincount(shard_of_block, minlength=n_shards)
    offsets = np.concatenate(([0], np.cumsum(per_shard)))

    return (seg_sorted, starts_sorted, vals_sorted, offsets, counts_mat,
            len_mode, scalar_len, n_seg, seg_len_dev, n_out, obs, tids,
            per_shard, split_tids)


def _pack_shards(starts_sorted, vals_sorted, offsets, counts_mat, B_local,
                 n_shards, n_seg, len_mode):
    """Pad each shard's block list to B_local and stack."""
    starts_p = np.zeros((n_shards, B_local), dtype=np.int32)
    if len_mode == "scalar":
        payload_p = np.zeros((n_shards, 1), dtype=np.uint16)
    else:
        payload_p = np.zeros((n_shards, B_local), dtype=vals_sorted.dtype)
    counts_ext = np.zeros((n_shards, n_seg + 1), dtype=np.int32)
    counts_ext[:, :n_seg] = counts_mat
    for s in range(n_shards):
        lo, hi = offsets[s], offsets[s + 1]
        k = hi - lo
        starts_p[s, :k] = starts_sorted[lo:hi]
        if len_mode != "scalar" and k:
            payload_p[s, :k] = vals_sorted[lo:hi]
        counts_ext[s, n_seg] = B_local - k
    return starts_p, payload_p, counts_ext


def _fix_split_contigs(d, split_tids, layout, trim, want_hist):
    """Exact min/trimmed for position-split contigs from the merged
    histogram.

    Under a position split, each shard's window includes the other
    shards' positions at depth 0, so the device rank/min outputs for a
    split contig are meaningless; but the sum-merged histogram is
    EXACT after the host bin-0 fix (foreign positions only ever land in
    a shard's bin 0, which unpack_packed recomputes from the merged
    covered counts).  Min is the first occupied bin; trimmed sums walk
    the histogram exactly like estimators.rs:566-647."""
    ee = layout.contig_end_exclusion
    rows = []
    for c in split_tids.tolist():
        wide = (d.hist_wide or {}).get(c)
        row = np.asarray(wide if wide is not None
                         else d.hist[c], dtype=np.int64)
        rows.append(row)
        win = max(int(layout.lengths[c]) - 2 * ee, 0) \
            if layout.lengths[c] > 2 * ee else 0
        nz = np.flatnonzero(row[1:])
        if win == 0 or row[0] > 0:
            d.min_depth_window[c] = 0
        else:
            d.min_depth_window[c] = int(nz[0]) + 1 if nz.size else 0
        # the sum of piece maxima over-counts; the last occupied bin is
        # the true window maximum
        d.max_depth_window[c] = int(nz[-1]) + 1 if nz.size else 0
    if trim is not None and rows:
        W = max(len(r) for r in rows)
        mat = np.zeros((len(rows), W), np.int64)
        for j, r in enumerate(rows):
            mat[j, : len(r)] = r
        sub = ReferenceLayout.build(layout.lengths[split_tids],
                                    layout.contig_end_exclusion)
        d.trimmed_sum[split_tids] = trimmed_sum_via_hist(sub, mat, trim)
    if not want_hist:
        d.hist = None
        d.hist_wide = None
    return d


class _SplitFixPending:
    """Wraps the mesh PendingDepthStats to post-fix split contigs."""

    def __init__(self, pending, split_tids, layout, trim, want_hist):
        self._p = pending
        self._args = (split_tids, layout, trim, want_hist)

    def start_fetch(self):
        self._p.start_fetch()

    def result(self):
        return _fix_split_contigs(self._p.result(), *self._args)


def sweep_routed(layout, tids, starts, ends, need_hist, trim, row, deferred,
                 allow_split, cols=None, reduce=None):
    """Route one sample's blocks over the shard `row` and sweep them
    (mesh_sweep's cols/reduce select this process's columns in a
    multi-process job); a PendingDepthStats when deferred."""
    C = layout.n_contigs
    tids = np.asarray(tids)
    starts = np.asarray(starts)
    ends = np.asarray(ends)
    if tids.size == 0 or C == 0:
        out = _EmptyPending(C, need_hist, trim)
        return out if deferred else out.result()

    n_shards = len(row)
    (seg_sorted, starts_sorted, vals_sorted, offsets, counts_mat, len_mode,
     scalar_len, n_seg, seg_len, n_out, obs, tids_s,
     per_shard, split_tids) = _route_sample(layout, tids, starts, ends,
                                            n_shards,
                                            allow_split=allow_split)
    want_hist = need_hist
    if split_tids.size:
        need_hist = True  # exact min/trimmed for split contigs ride it

    B_local = _bucket_geo(max(int(per_shard.max(initial=1)), 1), minimum=128)
    starts_p, payload_p, counts_ext = _pack_shards(
        starts_sorted, vals_sorted, offsets, counts_mat, B_local, n_shards,
        n_seg, len_mode)
    trim_key = (float(trim[0]), float(trim[1])) if trim is not None else None
    packed = mesh_sweep(
        starts_p.reshape(1, -1), payload_p.reshape(1, -1), counts_ext[None],
        seg_len, np.asarray([[scalar_len]], np.int32), n_seg,
        layout.contig_end_exclusion, need_hist, SPEC_HIST_BINS, len_mode,
        trim_key, [row], cols=cols, reduce=reduce)[0]
    # the pending's overflow path re-derives the rows of contigs whose
    # (summed, so possibly over-counted) maximum reaches SPEC_HIST_BINS
    # with the host oracle over the original, unsplit blocks
    pending = PendingDepthStats(packed, layout, n_seg, n_out, obs, tids_s,
                                need_hist, trim, SPEC_HIST_BINS,
                                blocks=(tids, starts, ends))
    if split_tids.size:
        pending = _SplitFixPending(pending, split_tids, layout, trim,
                                   want_hist)
    return pending if deferred else pending.result()


def compute_depth_stats_sweep_mesh(layout: ReferenceLayout, tids, starts,
                                   ends, need_hist: bool = False, trim=None,
                                   mesh=None, deferred: bool = False,
                                   allow_split: bool = True):
    """Drop-in for compute_depth_stats_sweep over a (dp=1, shard) mesh
    (its first row; default make_shard_mesh()).

    allow_split: position-split contigs whose block count defeats
    contig-level balance (the sequence-parallel axis); the dispatch then
    carries a histogram so split contigs' min/trimmed stay exact."""
    row = (make_shard_mesh() if mesh is None else mesh)[0]
    return sweep_routed(layout, tids, starts, ends, need_hist, trim, row,
                        deferred, allow_split)


def mesh_depth_fn(mesh=None):
    """A scan_sample-compatible depth_fn bound to a mesh."""
    if mesh is None:
        mesh = make_shard_mesh()
    return partial(compute_depth_stats_sweep_mesh, mesh=mesh)
