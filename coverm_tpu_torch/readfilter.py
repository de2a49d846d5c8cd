"""Vectorised read/pair quality filtering (filter.rs).

The reference's ReferenceSortedBamFilter is a stateful stream transformer:
single-read thresholds, and pair thresholds with mate joining by qname
within a reference.  Here the same semantics are computed as boolean masks
over the whole RecordBatch: pairs are joined with a (tid, qname-hash)
sort, paired greedily in stream order (1st+2nd occurrence, 3rd+4th, ...),
exactly like the BTreeMap insert/remove dance in filter.rs:150-225.

Returned is a keep-mask over records plus an emission order for BAM
rewriting (`filter` subcommand): kept pairs are emitted at the position
of their second mate, first mate first (filter.rs:212-219).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .flags import FlagFilter
from .io.bam import RecordBatch

f32 = np.float32
MAPQ_UNAVAILABLE = 255


@dataclass
class FilterParams:
    min_aligned_length_single: int = 0
    min_percent_identity_single: float = 0.0
    min_aligned_percent_single: float = 0.0
    min_mapq: int = MAPQ_UNAVAILABLE
    min_aligned_length_pair: int = 0
    min_percent_identity_pair: float = 0.0
    min_aligned_percent_pair: float = 0.0

    def doing_filtering(self) -> bool:
        return (self.min_percent_identity_single > 0.0
                or self.min_percent_identity_pair > 0.0
                or self.min_aligned_percent_single > 0.0
                or self.min_mapq < MAPQ_UNAVAILABLE
                or self.min_aligned_percent_pair > 0.0
                or self.min_aligned_length_single > 0
                or self.min_aligned_length_pair > 0)

    def filtering_modes(self, flag_filters: FlagFilter):
        """(filter_single, filter_pairs) activation (filter.rs:48-62)."""
        single_initial = (self.min_aligned_length_single > 0
                          or self.min_percent_identity_single > 0.0
                          or self.min_aligned_percent_single > 0.0)
        pairs_initial = (self.min_aligned_length_pair > 0
                         or self.min_percent_identity_pair > 0.0
                         or self.min_aligned_percent_pair > 0.0)
        filtering_single = single_initial or (
            not pairs_initial and self.min_mapq != MAPQ_UNAVAILABLE)
        filtering_pairs = pairs_initial or (
            (not filtering_single or not flag_filters.include_improper_pairs)
            and self.min_mapq != MAPQ_UNAVAILABLE)
        return filtering_single, filtering_pairs


def _mapq_ok(batch: RecordBatch, min_mapq: int) -> np.ndarray:
    if min_mapq == MAPQ_UNAVAILABLE:
        return np.ones(batch.n_records, dtype=bool)
    return (batch.mapq >= min_mapq) & (batch.mapq != MAPQ_UNAVAILABLE)


def single_read_passes(batch: RecordBatch, p: FilterParams) -> np.ndarray:
    """single_read_passes_filter (filter.rs:243-279), vectorised."""
    aligned = batch.aligned_single
    with np.errstate(divide="ignore", invalid="ignore"):
        frac_aligned = f32(aligned) / f32(batch.seq_len)
        identity = f32(1.0) - f32(batch.nm) / f32(aligned)
    return (
        _mapq_ok(batch, p.min_mapq)
        & (aligned >= p.min_aligned_length_single)
        & (frac_aligned >= f32(p.min_aligned_percent_single))
        & (identity >= f32(p.min_percent_identity_single))
    )


def _pair_partners(batch: RecordBatch, candidate: np.ndarray):
    """Greedy in-order mate pairing of candidate records by (tid, qname).

    Returns (first_idx, second_idx) arrays of paired record indices."""
    idx = np.flatnonzero(candidate)
    if idx.size == 0:
        return idx, idx
    key_tid = batch.tid[idx].astype(np.int64)
    key_hash = batch.qname_hash[idx]
    order = np.lexsort((idx, key_hash, key_tid))
    sid = idx[order]
    st = key_tid[order]
    sh = key_hash[order]
    same = (st[1:] == st[:-1]) & (sh[1:] == sh[:-1])
    grp_start = np.concatenate(([True], ~same))
    starts = np.flatnonzero(grp_start)
    counts = np.diff(np.concatenate((starts, [sid.size])))
    pos_in_grp = np.arange(sid.size) - np.repeat(starts, counts)
    # within a group (stream order): (0,1), (2,3), ... ; odd tail unpaired
    is_first = pos_in_grp % 2 == 0
    has_partner = pos_in_grp + 1 < np.repeat(counts, counts)
    f = sid[is_first & has_partner]
    s = sid[~is_first]
    return f, s


def apply_read_filter(batch: RecordBatch, params: FilterParams,
                      flag_filters: FlagFilter, filter_out: bool = True):
    """Compute which records the filtered reader would emit.

    ``filter_out`` follows the reference's convention (filter.rs:31):
    True is the NORMAL mode ("we are filtering out failing reads"); the
    `filter --inverse` flag passes False (coverm.rs:453).

    Returns (keep_mask, order) where order is the emission order of kept
    record indices (for BAM rewriting).
    """
    n = batch.n_records
    filtering_single, filtering_pairs = params.filtering_modes(flag_filters)
    unmapped = batch.is_unmapped()
    sec = batch.is_secondary()
    supp = batch.is_supplementary()

    if filtering_single and not filtering_pairs:
        keep = np.zeros(n, dtype=bool)
        if not filter_out:
            keep |= unmapped
        passes_filter1 = (~unmapped
                          & (flag_filters.include_supplementary | ~supp)
                          & (flag_filters.include_secondary | ~sec))
        passes2 = single_read_passes(batch, params)
        keep |= passes_filter1 & (passes2 == filter_out)
        return keep, np.flatnonzero(keep)

    # With neither mode active the reference still runs the PAIR path
    # with vacuous thresholds (filter.rs:88 routes everything that is not
    # single-only through it): normal mode emits proper pairs and drops
    # unmapped/improper/secondary/supplementary; inverse emits the
    # complement.  Fall through to the pair path below.

    # pair path (filter.rs:117-233)
    keep = np.zeros(n, dtype=bool)
    emit_at = np.full(n, -1, dtype=np.int64)  # sort key for emission order
    if not filter_out:
        keep |= unmapped
        emit_at[unmapped] = np.flatnonzero(unmapped) * 2

    mapped_ok = ~unmapped & ~sec & ~supp
    proper = batch.is_proper_pair()
    improper = mapped_ok & ~proper
    if not filter_out:
        keep |= improper
        emit_at[improper] = np.flatnonzero(improper) * 2

    # candidates for pairing: proper pairs with mate on the same contig
    candidate = mapped_ok & proper & (batch.tid == _mtid(batch))
    first_idx, second_idx = _pair_partners(batch, candidate)
    if first_idx.size:
        pass_pair = _pair_passes(batch, params, first_idx, second_idx,
                                 filtering_single)
        sel = pass_pair == filter_out
        f, s = first_idx[sel], second_idx[sel]
        keep[f] = True
        keep[s] = True
        # pair emitted at the second mate's position, first mate first
        emit_at[f] = s * 2
        emit_at[s] = s * 2 + 1

    kept = np.flatnonzero(keep)
    order = kept[np.argsort(emit_at[kept], kind="stable")]
    return keep, order


def filter_payload(source, payload, params: FilterParams,
                   flag_filters: FlagFilter):
    """Apply the read filter to a source payload — a whole RecordBatch or
    a streaming batch iterator — updating ``source.num_primary_override``
    as records are seen (the filtered reader counts primaries BEFORE
    filtering, bam_generator.rs:630-646).

    Streaming batches are cut at contig boundaries (BamStreamReader), so
    same-contig mate pairing — the only kind the pair filter joins
    (filter.rs:150-157 requires tid == mtid) — never spans batches.
    """
    if isinstance(payload, RecordBatch):
        source.num_primary_override = int(
            np.count_nonzero(payload.is_primary()))
        keep, _ = apply_read_filter(payload, params, flag_filters,
                                    filter_out=True)
        return payload.select(keep)

    source.num_primary_override = 0

    def gen():
        for batch in payload:
            source.num_primary_override += int(
                np.count_nonzero(batch.is_primary()))
            keep, _ = apply_read_filter(batch, params, flag_filters,
                                        filter_out=True)
            yield batch.select(keep)

    return gen()


def _mtid(batch: RecordBatch) -> np.ndarray:
    """next_refID (mate tid) decoded from the raw records."""
    arr = np.frombuffer(batch.data, dtype=np.uint8)
    offs = batch.rec_start
    return (
        arr[offs + 24].astype(np.uint32)
        | (arr[offs + 25].astype(np.uint32) << 8)
        | (arr[offs + 26].astype(np.uint32) << 16)
        | (arr[offs + 27].astype(np.uint32) << 24)
    ).astype(np.int32)


def _pair_passes(batch: RecordBatch, p: FilterParams, i1, i2, filtering_single):
    """read_pair_passes_filter (filter.rs:281-336) + optional per-mate
    single filters (filter.rs:190-203), vectorised over pairs."""
    ok = np.ones(i1.size, dtype=bool)
    if p.min_mapq != MAPQ_UNAVAILABLE:
        for i in (i1, i2):
            ok &= (batch.mapq[i] >= p.min_mapq) & (batch.mapq[i] != MAPQ_UNAVAILABLE)
    aligned = batch.aligned_pair[i1] + batch.aligned_pair[i2]
    seqlen = batch.seq_len[i1].astype(np.int64) + batch.seq_len[i2]
    nm = batch.nm[i1] + batch.nm[i2]
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = f32(aligned) / f32(seqlen)
        ident = f32(1.0) - f32(nm) / f32(aligned)
    ok &= (aligned >= p.min_aligned_length_pair)
    ok &= frac >= f32(p.min_aligned_percent_pair)
    ok &= ident >= f32(p.min_percent_identity_pair)
    if filtering_single:
        sp = single_read_passes(batch, p)
        ok &= sp[i1] & sp[i2]
    return ok
