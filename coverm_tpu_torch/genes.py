"""Per-gene coverage from GFF/GTF definitions (genes.rs).

Genes become *virtual contigs*: each alignment block overlapping a gene
is clipped to the gene interval and re-addressed to the gene's dense id,
then the standard event-sweep engine computes per-gene statistics.  This
reproduces the reference's gene-local delta array semantics exactly
(genes.rs:503-533): depth flowing in from blocks starting before the
gene appears as clipped blocks starting at offset 0, and the contig-end
clamp on the trailing -1 coincides with the gene-end clip.

Read-level quantities are assigned to a gene by the read's leftmost
mapped position (genes.rs:519-524).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .estimators import EntityStats, PileupCountsEstimator, any_needs_hist
from .flags import FlagFilter
from .modes import _emit_entry, _emit_zero_entry, _exclusion_of
from .ops.depth import ReferenceLayout
from .ops.sweep import compute_depth_stats_sweep
from .printers import ReadsMapped
from .scan import BamSortingError, MissingNMTagError


@dataclass
class Gene:
    id: str
    contig: str
    start: int  # 0-based inclusive
    end: int    # 0-based exclusive


class GeneDefinitions:
    def __init__(self, genes):
        self.genes = list(genes)

    @staticmethod
    def read_gff(path: str, feature_type=None) -> "GeneDefinitions":
        genes = []
        auto_id = 0
        with open(path) as f:
            for line_number, line in enumerate(f):
                trimmed = line.rstrip()
                if not trimmed or trimmed.startswith("#"):
                    continue
                fields = trimmed.split("\t")
                if len(fields) < 8:
                    continue
                if feature_type is not None and fields[2] != feature_type:
                    continue
                contig = fields[0]
                try:
                    start_1 = int(fields[3])
                    end_1 = int(fields[4])
                except ValueError:
                    continue
                if start_1 == 0 or end_1 < start_1:
                    continue
                attributes = fields[8] if len(fields) > 8 else ""
                gid = parse_gff_id(attributes)
                if gid is None:
                    auto_id += 1
                    gid = f"{contig}_gene_{auto_id}"
                genes.append(Gene(gid, contig, start_1 - 1, end_1))
        return GeneDefinitions(genes)


def parse_gff_id(attributes: str):
    for key in ("ID", "locus_tag", "gene_id", "Name", "gene", "Parent"):
        v = parse_gff_attribute(attributes, key)
        if v:
            return v
    return None


def parse_gff_attribute(attributes: str, key: str):
    for entry in attributes.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        if entry.startswith(key + "="):
            return entry[len(key) + 1:].strip()
        if entry.startswith(key + " "):
            return entry[len(key) + 1:].strip().strip('"')
    return None


@dataclass
class ResolvedGene:
    entry_id: int
    name: str  # tab-separated output columns: id, contig[, genome]
    tid: int
    start: int
    end: int


def resolve_genes_against_header(gene_definitions, header, genome_namer):
    """Clamp genes to the header, drop unknown contigs, assign entry ids in
    (tid, start) order (genes.rs:352-421)."""
    name_to_tid = {n: i for i, n in enumerate(header.target_names)}
    per_tid = [[] for _ in range(header.n_ref)]
    for gene in gene_definitions.genes:
        tid = name_to_tid.get(gene.contig)
        if tid is None:
            continue
        contig_len = int(header.target_lens[tid])
        start = min(gene.start, contig_len)
        end = min(gene.end, contig_len)
        if start >= end:
            continue
        if genome_namer is not None:
            genome = genome_namer(gene.contig)
            if genome is None:
                continue
            name = f"{gene.id}\t{gene.contig}\t{genome}"
        else:
            name = f"{gene.id}\t{gene.contig}"
        per_tid[tid].append(ResolvedGene(0, name, tid, start, end))
    next_id = 0
    for genes in per_tid:
        genes.sort(key=lambda g: g.start)
        for g in genes:
            g.entry_id = next_id
            next_id += 1
    return per_tid


def _clip_blocks_to_genes(btids, bstarts, bends, gene_tid, gene_start, gene_end):
    """Interval join: (block, gene) overlap pairs with clipped coordinates.

    Genes are sorted by (tid, start).  Returns (gene_idx, start', end') in
    gene-local coordinates."""
    if btids.size == 0 or gene_tid.size == 0:
        z = np.zeros(0, np.int64)
        return z, z.copy(), z.copy()
    order = np.lexsort((bstarts, btids))
    btids, bstarts, bends = btids[order], bstarts[order], bends[order]

    SHIFT = np.int64(1) << 33
    gkey_start = gene_tid * SHIFT + gene_start
    # running max of gene end within tid groups, for the candidate window
    bkey_start = btids * SHIFT + bstarts
    bkey_end = btids * SHIFT + bends

    # candidate gene range for each block: genes with start < block_end,
    # scanning left while gene (cumulative) end > block_start
    hi = np.searchsorted(gkey_start, bkey_end, side="left")
    # cumulative max of gene ends (per tid) to bound the left scan
    gkey_end = gene_tid * SHIFT + gene_end
    cummax_end = np.maximum.accumulate(gkey_end)
    lo = np.searchsorted(cummax_end, bkey_start, side="right")
    lo = np.minimum(lo, hi)

    counts = hi - lo
    total = int(counts.sum())
    if total == 0:
        z = np.zeros(0, np.int64)
        return z, z.copy(), z.copy()
    block_of_pair = np.repeat(np.arange(btids.size), counts)
    first = np.repeat(lo, counts)
    offset = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    gene_of_pair = first + offset

    same_tid = gene_tid[gene_of_pair] == btids[block_of_pair]
    s = np.maximum(bstarts[block_of_pair], gene_start[gene_of_pair])
    e = np.minimum(bends[block_of_pair], gene_end[gene_of_pair])
    keep = same_tid & (s < e)
    gp = gene_of_pair[keep]
    return (gp,
            s[keep] - gene_start[gp],
            e[keep] - gene_start[gp])


class _GeneAccum:
    """Per-gene accumulators merged additively across streamed batches.

    Batches are cut at contig boundaries (io/bam.py BamStreamReader), and
    every gene lies inside one contig, so each gene's events land in
    exactly one batch — plain addition is exact for every statistic,
    including the coverage histogram."""

    def __init__(self, n_genes):
        z = lambda: np.zeros(n_genes, dtype=np.int64)
        self.sum_depth_window = z()
        self.covered_window = z()
        self.covered_full = z()
        self.hist = None
        self.reads = z()
        self.mismatches = z()
        self.sum_identity = np.zeros(n_genes, dtype=np.float64)
        self._pending = []

    def add_depth_deferred(self, pending):
        """Queue a deferred device result; batch i+1's host work overlaps
        batch i's device compute (the same pipelining as
        scan.scan_sample_batches)."""
        self._pending.append(pending)

    def finalize(self):
        for p in self._pending:
            if hasattr(p, "start_fetch"):
                p.start_fetch()  # overlap all d2h copies
        for p in self._pending:
            self.add_depth(p.result() if hasattr(p, "result") else p)
        self._pending = []

    def add_depth(self, depth):
        if getattr(depth, "hist_wide", None):
            # ragged overflow rows of very deep genes: fold back densely
            # (gene rows are few relative to contigs)
            from .modes import _dense_hist
            depth.hist = _dense_hist(depth)
            depth.hist_wide = None
        self.sum_depth_window += depth.sum_depth_window
        self.covered_window += depth.covered_window
        self.covered_full += depth.covered_full
        if depth.hist is not None:
            if self.hist is None:
                self.hist = depth.hist.astype(np.int64, copy=True)
            else:
                wa, wb = self.hist.shape[1], depth.hist.shape[1]
                if wb > wa:
                    grown = np.zeros((self.hist.shape[0], wb), np.int64)
                    grown[:, :wa] = self.hist
                    self.hist = grown
                self.hist[:, :wb] += depth.hist


def _scan_gene_batch(batch, flag_filter, acc, vlayout, need_hist,
                     gene_tid, gene_start, gene_end, observed_contig,
                     last_max_tid, device, turn):
    """One RecordBatch's contribution to the per-gene accumulators; the
    clipped blocks go through the sweep on `device`, inside `turn` (the
    card's, device.card_turn).
    Returns (num_mapped_primary, num_primary, new_last_max_tid)."""
    passes = flag_filter.passes(batch)
    mapped = ~batch.is_unmapped()
    use = passes & mapped
    tids = batch.tid[use]
    if tids.size:
        if np.any(np.diff(tids) < 0) or int(tids[0]) < last_max_tid:
            raise BamSortingError("BAM file appears to be unsorted.")
        last_max_tid = max(last_max_tid, int(tids.max()))
    if np.any(batch.nm[use] < 0):
        raise MissingNMTagError(
            "Mapping record encountered that does not have an 'NM' "
            "auxiliary tag in the SAM/BAM format.")

    buse = use[batch.block_read]
    vg, vs, ve = _clip_blocks_to_genes(
        batch.tid[batch.block_read[buse]].astype(np.int64),
        batch.block_start[buse].astype(np.int64),
        batch.block_end[buse].astype(np.int64),
        gene_tid, gene_start, gene_end)
    with turn:
        acc.add_depth_deferred(compute_depth_stats_sweep(
            vlayout, vg, vs, ve, need_hist=need_hist, deferred=True,
            device=device))

    # read-level prefix stats keyed by (tid, leftmost pos)
    r_tid = batch.tid[use].astype(np.int64)
    r_pos = batch.pos[use].astype(np.int64)
    r_primary = batch.is_primary()[use].astype(np.int64)
    r_mism = np.maximum(batch.nm[use] - batch.indels[use], 0)
    aligned = batch.aligned_cov[use].astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        r_ident = np.where((r_primary > 0) & (aligned > 0),
                           (aligned - batch.nm[use]) / aligned, 0.0)
    okey = np.lexsort((r_pos, r_tid))
    r_tid, r_pos = r_tid[okey], r_pos[okey]
    pp = np.concatenate(([0], np.cumsum(r_primary[okey])))
    pm = np.concatenate(([0], np.cumsum(r_mism[okey])))
    pi = np.concatenate(([0], np.cumsum(r_ident[okey])))
    SHIFT = np.int64(1) << 33
    rkey = r_tid * SHIFT + r_pos
    glo = np.searchsorted(rkey, gene_tid * SHIFT + gene_start)
    ghi = np.searchsorted(rkey, gene_tid * SHIFT + gene_end)
    acc.reads += pp[ghi] - pp[glo]
    acc.mismatches += pm[ghi] - pm[glo]
    acc.sum_identity += pi[ghi] - pi[glo]

    if tids.size:
        observed_contig[np.unique(tids)] = True
    num_mapped = int((batch.is_primary() & use).sum())
    num_primary = int(np.count_nonzero(batch.is_primary()))
    return num_mapped, num_primary, last_max_tid


def gene_coverage(sources, taker, estimators, gene_definitions, genome_namer,
                  print_zero_coverage_genes, flag_filter: FlagFilter,
                  threads: int = 1, device=None):
    """`--gff` mode engine (genes.rs:182-344), the sweep on `device`
    (default: default_device()). Returns per-sample ReadsMapped."""
    from .device import card_turn, resolve_device
    from .io.bam import RecordBatch

    device = resolve_device(device)
    # the engine's dispatch takes turns with an ingest on the same card
    # (io/bam's card route)
    turn = card_turn(device)
    reads_mapped_vector = []
    need_hist = any_needs_hist(estimators)
    ee = _exclusion_of(estimators)
    for source in sources:
        header, payload = source.read()
        taker.start_stoit(source.name)

        per_tid = resolve_genes_against_header(
            gene_definitions, header, genome_namer)
        genes_flat = [g for genes in per_tid for g in genes]
        gene_tid = np.array([g.tid for g in genes_flat], dtype=np.int64)
        gene_start = np.array([g.start for g in genes_flat], dtype=np.int64)
        gene_end = np.array([g.end for g in genes_flat], dtype=np.int64)
        gene_len = gene_end - gene_start

        # virtual reference: one contig per gene
        vlayout = ReferenceLayout.build(gene_len, ee)
        acc = _GeneAccum(len(genes_flat))
        observed_contig = np.zeros(header.n_ref, dtype=bool)
        num_mapped_total = 0
        num_primary = 0
        last_max_tid = -1
        if isinstance(payload, RecordBatch):
            batches = [payload]
        elif hasattr(payload, "batches"):  # io/fastscan.FusedScanStream
            batches = payload.batches(device)
        else:
            batches = payload
        from .prefetch import prefetch_iter
        for batch in prefetch_iter(batches):
            nm_, np_, last_max_tid = _scan_gene_batch(
                batch, flag_filter, acc, vlayout, need_hist,
                gene_tid, gene_start, gene_end, observed_contig,
                last_max_tid, device, turn)
            num_mapped_total += nm_
            num_primary += np_
        acc.finalize()

        for gi, g in enumerate(genes_flat):
            if observed_contig[g.tid]:
                st = EntityStats()
                ln = int(gene_len[gi])
                st.total_count = int(acc.sum_depth_window[gi])
                st.total_bases_window = ln - 2 * ee if ln > 2 * ee else 0
                st.covered_window = int(acc.covered_window[gi])
                st.total_bases_full = ln
                st.covered_full = int(acc.covered_full[gi])
                st.observed_length_full = ln
                st.reads = int(acc.reads[gi])
                st.mismatches = int(acc.mismatches[gi])
                st.sum_identity = float(acc.sum_identity[gi])
                if acc.hist is not None:
                    st.hist = acc.hist[gi]
                st.unobserved_lengths = [0]
                coverages = [e.calculate(st) for e in estimators]
                nonzero = any(c > 0.0 for c in coverages)
                if print_zero_coverage_genes or nonzero:
                    taker.start_entry(g.entry_id, g.name)
                    _emit_entry(taker, estimators, coverages,
                                [st] * len(estimators))
                    taker.finish_entry()
            elif print_zero_coverage_genes:
                taker.start_entry(g.entry_id, g.name)
                _emit_zero_entry(taker, estimators, int(gene_len[gi]))
                taker.finish_entry()

        npo = getattr(source, "num_primary_override", None)
        if npo is not None:
            num_primary = npo
        reads_mapped_vector.append(ReadsMapped(
            num_mapped_reads=num_mapped_total, num_reads=num_primary))
        source.finish()
    return reads_mapped_vector
