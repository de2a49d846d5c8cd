"""Coverage run modes: per-contig, per-genome (separator / named).

The scan layer produces per-contig integer statistics; these functions
aggregate them into entities (contigs or genomes), evaluate the
estimator suite, and drive the taker exactly like the reference's
streaming loops do (contig.rs:13-253, genome.rs:17-322, genome.rs:419-797),
including zero-coverage back-fill and per-sample ReadsMapped accounting.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .estimators import (EntityStats, Estimator, PileupCountsEstimator,
                         TrimmedMeanEstimator, any_needs_hist,
                         any_needs_hist_batch)
from .flags import FlagFilter
from .device import resolve_device
from .io.bam import BamReader
from .ops.depth import ReferenceLayout
from .printers import ReadsMapped
from .scan import SampleScan, scan_any

logger = logging.getLogger("coverm_tpu_torch")


def _log_reads_mapped(stoit_name, rm, elapsed=None):
    pct = (rm.num_mapped_reads * 100) / rm.num_reads if rm.num_reads else float("nan")
    logger.info(
        "In sample '%s', found %d reads mapped out of %d total (%.2f%%)",
        stoit_name, rm.num_mapped_reads, rm.num_reads, pct)
    if elapsed:
        # reads/s is the north-star throughput metric (SURVEY.md §5/§6)
        logger.info("Sample '%s' scanned in %.2fs (%s aligned reads/s)",
                    stoit_name, elapsed,
                    f"{rm.num_reads / elapsed:,.0f}" if rm.num_reads else "-")
    if rm.num_reads == 0:
        logger.warning(
            "No primary alignments were observed for sample %s - perhaps "
            "something went wrong in the mapping?", stoit_name)


# BAMs whose compressed size exceeds this stream in bounded memory
# (contig-boundary batches) instead of whole-file decode.  Streaming
# also overlaps segment inflate with record parse and device dispatch,
# so the default cutover is low; it only needs to clear the
# small-fixture regime where per-batch dispatch overhead would dominate.
STREAM_THRESHOLD_BYTES = int(os.environ.get(
    "COVERM_TPU_STREAM_THRESHOLD", 1 << 25))


@dataclass
class BamFileSource:
    """A pre-made sorted BAM file (bam_generator.rs:103-144)."""

    path: str
    stoit_name: str = None
    # where a streamed BGZF file's classic batches inflate and parse
    # (io/bam.BamStreamReader; device.resolve_device: None is the card)
    device: object = None
    _stream: object = field(default=None, init=False, repr=False)

    def __post_init__(self):
        if self.stoit_name is None:
            base = os.path.basename(self.path)
            for ext in (".bam", ".sam", ".cram"):
                if base.endswith(ext):
                    base = base[: -len(ext)]
                    break
            self.stoit_name = base

    @property
    def name(self):
        return self.stoit_name

    def read(self):
        with open(self.path, "rb") as f:
            magic = f.read(4)
        # CRAM always streams: the per-slice direct-stats decoder
        # (io/fastscan._cram_slice_blocks) beats whole-file BAM
        # materialisation at EVERY size.  BGZF BAM streams above the
        # threshold; big SAM text / uncompressed BAM fall back to
        # whole-file decode (no streamable framing).
        if magic == b"CRAM" or (
                magic[:2] == b"\x1f\x8b"
                and os.path.getsize(self.path) >= STREAM_THRESHOLD_BYTES):
            from .io.fastscan import FusedScanStream
            self._stream = FusedScanStream(self.path, device=self.device)
            return self._stream.open(), self._stream
        r = BamReader(self.path)
        return r.header, r.batch

    def finish(self):
        # a CRAM plan that no fused scan consumed still holds its file
        if self._stream is not None:
            self._stream.close()
            self._stream = None


def _entity_stats(scan: SampleScan, layout: ReferenceLayout, observed_tids,
                  unobserved_tids, reads, identity, contig_mode=False) -> EntityStats:
    lens = layout.lengths[observed_tids]
    ee = layout.contig_end_exclusion
    long_enough = lens > 2 * ee
    d = scan.depth
    s = EntityStats()
    s.total_count = int(d.sum_depth_window[observed_tids].sum())
    s.total_bases_window = int((lens[long_enough] - 2 * ee).sum())
    s.covered_window = int(d.covered_window[observed_tids].sum())
    s.total_bases_full = int(lens.sum())
    s.covered_full = int(d.covered_full[observed_tids].sum())
    s.observed_length_full = int(lens.sum())
    s.reads = int(reads[observed_tids].sum())
    s.mismatches = int(scan.mismatches[observed_tids].sum())
    s.sum_identity = float(identity[observed_tids].sum())
    if d.hist is not None:
        s.hist = _sum_hist_rows(d, observed_tids)
    if contig_mode:
        s.unobserved_lengths = [0]
    else:
        s.unobserved_lengths = [int(l) for l in layout.lengths[unobserved_tids]]
    return s


def _sum_hist_rows(d, idx):
    """Sum histogram rows over contig indices, folding in the ragged
    overflow rows (DepthStats.hist_wide) of very deep contigs."""
    idx = np.asarray(idx)
    wide = d.hist_wide or {}
    rows = [wide[int(i)] for i in idx if int(i) in wide]
    W = max([d.hist.shape[1]] + [len(r) for r in rows])
    out = np.zeros(W, dtype=np.int64)
    out[: d.hist.shape[1]] = d.hist[idx].sum(axis=0)
    for r in rows:
        out[: len(r)] += r
    return out


def _dense_hist(d):
    """Dense [C, W] histogram with overflow rows folded back in (W grows
    to the deepest overflow row; used only on paths that require a
    rectangular matrix)."""
    if not d.hist_wide:
        return d.hist
    W = max(d.hist.shape[1], max(len(r) for r in d.hist_wide.values()))
    out = np.zeros((d.hist.shape[0], W), dtype=np.int64)
    out[:, : d.hist.shape[1]] = d.hist
    for c, r in d.hist_wide.items():
        out[c, : len(r)] = r
    return out


def _batch_stats(scan: SampleScan, layout: ReferenceLayout):
    """Column-wise per-contig stats for the vectorised contig mode."""
    from .estimators import BatchStats
    lens = layout.lengths
    ee = layout.contig_end_exclusion
    d = scan.depth
    return BatchStats(
        total_count=d.sum_depth_window,
        total_bases_window=np.where(lens > 2 * ee, lens - 2 * ee, 0),
        covered_window=d.covered_window,
        total_bases_full=lens,
        covered_full=d.covered_full,
        observed_length_full=lens,
        reads=scan.reads_primary,
        mismatches=scan.mismatches,
        sum_identity=scan.identity_sum_primary,
        hist=None if d.hist is None else _dense_hist(d),
        sumsq_window=d.sumsq_window,
        min_depth_window=d.min_depth_window,
        trimmed_sum=d.trimmed_sum,
    )


def _mesh_depth_fn(devices):
    """Contig-sharded mesh engine over `devices` when there are two or
    more, or the multi-process engine in a torch.distributed job.

    COVERM_TPU_MESH=0 disables (single-device sweep everywhere); the
    default routes single-sample scans through the (dp=1, shard) mesh —
    bit-equal to the single-device engine (each contig lives wholly on
    one shard, or a position-split contig's histogram is exact)."""
    from .parallel.distributed import is_multiprocess

    if os.environ.get("COVERM_TPU_MESH", "auto") == "0":
        return None
    if is_multiprocess():
        # one global mesh over every rank's devices
        from .parallel.distributed import make_global_mesh, multihost_depth_fn
        mesh = make_global_mesh()
        logger.info("engine: contig-sharded over %d shard(s) of %d "
                    "process(es)", len(mesh[0]),
                    len({r for r, _ in mesh[0]}))
        return multihost_depth_fn(mesh)
    if len(devices) < 2:
        return None
    from .parallel.mesh_sweep import mesh_depth_fn
    logger.info("engine: contig-sharded over %d shard(s)", len(devices))
    return mesh_depth_fn([list(devices)])


def _scanned(sources, ee, flag_filter, need_hist, trim=None, device=None):
    """Yield (source, header, layout, scan, scan_seconds) in source order.

    The devices are local_devices(device) (default: default_device()):
    every card, or only the card `device` names (`cuda:1`). With one of
    them, every sample scans on it and
    the prefetch pipeline overlaps sample i+1's host decode with sample
    i's scan. With several devices and several samples, samples are
    scanned CONCURRENTLY, one per device group (sample data parallelism —
    the multi-device analogue of the reference's serial multi-sample
    loop, SURVEY.md §2.3), each contig-sharded over its group; only the
    small per-contig statistics are retained. With a single sample (or
    COVERM_TPU_MESH=1, or in a multi-process job), each scan is instead
    sharded over ALL devices by contig (parallel/mesh_sweep.py).
    """
    from .device import local_devices
    from .parallel.distributed import is_multiprocess

    device = resolve_device(device)
    devs = local_devices(device)
    workers = min(len(sources), len(devs))
    if os.environ.get("COVERM_TPU_MESH", "auto") == "1":
        workers = 1  # force every scan through the mesh engine
    if is_multiprocess():
        workers = 1  # every rank scans every sample on the global mesh
    if workers <= 1:
        depth_fn = _mesh_depth_fn(devs)
        for s, (header, payload) in _prefetched(sources):
            t0 = time.perf_counter()
            layout = ReferenceLayout.build(header.target_lens, ee)
            scan = scan_any(header, payload, layout, flag_filter, need_hist,
                            trim=trim, device=devs[0], depth_fn=depth_fn)
            yield s, header, layout, scan, time.perf_counter() - t0
        return

    from concurrent.futures import ThreadPoolExecutor

    from .parallel.mesh_sweep import mesh_depth_fn

    # Sample data parallelism composed with reference sharding: devices
    # are partitioned into one group per concurrent sample, and each
    # sample's scan contig-shards over its whole group — with 8 devices
    # and 2 samples, each sample runs on 4 devices instead of leaving 6
    # idle.
    groups = [devs[i::workers] for i in range(workers)]
    logger.info(
        "engine: sample-DP over %d device group(s) of %s (contig-sharded "
        "within each group)", workers, [len(g) for g in groups])

    def job(i, s):
        t0 = time.perf_counter()
        group = groups[i % workers]
        depth_fn = mesh_depth_fn([group]) if len(group) > 1 else None
        with (torch.cuda.device(group[0]) if group[0].type == "cuda"
              else contextlib.nullcontext()):
            header, payload = s.read()
            layout = ReferenceLayout.build(header.target_lens, ee)
            scan = scan_any(header, payload, layout, flag_filter, need_hist,
                            trim=trim, device=group[0], depth_fn=depth_fn)
        return s, header, layout, scan, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=workers) as ex:
        futures = [ex.submit(job, i, s) for i, s in enumerate(sources)]
        for f in futures:
            yield f.result()


def _genome_batch_stats(scan: SampleScan, layout: ReferenceLayout,
                        genome_of_tid, n_genomes, reads_vec, identity_vec):
    """Genome-level BatchStats by segment reductions over the contig
    axis (the vectorised form of the reference's per-genome estimator
    cloning + add_contig accumulation, genome.rs:92-97/448-499)."""
    from .estimators import BatchStats
    d = scan.depth
    lens = layout.lengths
    ee = layout.contig_end_exclusion
    g = np.asarray(genome_of_tid, dtype=np.int64)
    valid = g >= 0
    obs = scan.observed & valid
    unobs = (~scan.observed) & valid

    def seg_int(x, mask):
        out = np.zeros(n_genomes, dtype=np.int64)
        np.add.at(out, g[mask], np.asarray(x)[mask])
        return out

    def seg_f64(x, mask):
        out = np.zeros(n_genomes, dtype=np.float64)
        np.add.at(out, g[mask], np.asarray(x)[mask])
        return out

    tbw = np.where(lens > 2 * ee, lens - 2 * ee, 0)
    # calculate_unobserved_bases quirk (estimators.rs:226-243)
    unobs_w = np.where(lens < 2 * ee, lens, lens - 2 * ee)

    hist = None
    if d.hist is not None:
        wide = d.hist_wide or {}
        W = max([d.hist.shape[1]] + [len(r) for r in wide.values()])
        hist = np.zeros((n_genomes, W), dtype=np.int64)
        np.add.at(hist[:, : d.hist.shape[1]], g[obs], d.hist[obs])
        for c, r in wide.items():
            if obs[c]:
                hist[g[c], : len(r)] += r

    sumsq = seg_int(d.sumsq_window, obs) if d.sumsq_window is not None else None
    min_depth = None
    if d.min_depth_window is not None:
        big = np.int64(1) << 62
        mins = np.full(n_genomes, big)
        haswin = obs & (lens > 2 * ee)
        np.minimum.at(mins, g[haswin], d.min_depth_window[haswin])
        min_depth = np.where(mins == big, 0, mins)

    return BatchStats(
        total_count=seg_int(d.sum_depth_window, obs),
        total_bases_window=seg_int(tbw, obs),
        covered_window=seg_int(d.covered_window, obs),
        total_bases_full=seg_int(lens, obs),
        covered_full=seg_int(d.covered_full, obs),
        observed_length_full=seg_int(lens, obs),
        reads=seg_int(reads_vec, obs),
        mismatches=seg_int(scan.mismatches, obs),
        sum_identity=seg_f64(identity_vec, obs),
        hist=hist,
        unobserved_window_bases=seg_int(unobs_w, unobs),
        unobserved_full_bases=seg_int(lens, unobs),
        sumsq_window=sumsq,
        min_depth_window=min_depth,
        trimmed_sum=None,  # order statistics do not pool across contigs
    )


def _prefetched(sources):
    """Overlap host BAM decode of sample i+1 with compute of sample i
    (the pipeline-parallelism analogue of the reference's
    mapper|sort|scan subprocess overlap, SURVEY.md §2.3)."""
    from .prefetch import prefetch_iter

    if len(sources) <= 1:
        for s in sources:
            yield s, s.read()
        return
    yield from prefetch_iter((s, s.read()) for s in sources)


def _emit_entry(taker, estimators, coverages, stats_list):
    """print_coverage per estimator (estimators.rs:936-969)."""
    for est, cov, st in zip(estimators, coverages, stats_list):
        if isinstance(est, PileupCountsEstimator):
            for depth_v, count in est.histogram_rows(cov, st):
                taker.add_coverage_entry(depth_v, count)
        else:
            taker.add_single_coverage(cov)


def _emit_zero_entry(taker, estimators, entry_length):
    """print_zero_coverage per estimator (estimators.rs:971-991)."""
    for est in estimators:
        if isinstance(est, PileupCountsEstimator):
            continue
        taker.add_single_coverage(est.zero_entry_value(entry_length))


def contig_coverage(sources, taker, estimators, print_zero_coverage_contigs,
                    flag_filter: FlagFilter, threads: int = 1,
                    device=None):
    """`coverm contig` engine. Returns per-sample ReadsMapped."""
    reads_mapped_vector = []
    has_pileup = any(isinstance(e, PileupCountsEstimator) for e in estimators)
    # the vectorised path derives variance from moments and trimmed_mean
    # from device rank queries, so the (large at assembly scale)
    # histogram is only computed for coverage_histogram output or when
    # several different trim windows are requested at once
    trims = {(float(e.trim_min), float(e.trim_max)) for e in estimators
             if isinstance(e, TrimmedMeanEstimator)}
    use_trim = (not has_pileup) and len(trims) == 1
    trim = next(iter(trims)) if use_trim else None
    need_hist = (any_needs_hist(estimators) if has_pileup
                 else (any_needs_hist_batch(estimators) and not use_trim))
    ee = _exclusion_of(estimators)
    for source, header, layout, scan, t_scan in _scanned(
            sources, ee, flag_filter, need_hist, trim, device):
        taker.start_stoit(source.name)
        npo = getattr(source, "num_primary_override", None)
        if npo is not None:
            scan.num_detected_primary_alignments = npo

        num_mapped_total = 0
        if not has_pileup:
            # vectorised path: one numpy pass per estimator instead of a
            # Python loop per contig (the loop costs ~100us/contig, which
            # dominates assembly-scale runs)
            bs = _batch_stats(scan, layout)
            cov_matrix = np.stack(
                [e.calculate_batch(bs) for e in estimators])  # [E, C]
            nonzero_v = (cov_matrix > 0.0).any(axis=0)
            num_mapped_total = int(
                scan.reads_primary[scan.observed & nonzero_v].sum())
            emit = (np.arange(header.n_ref)
                    if print_zero_coverage_contigs else
                    np.flatnonzero(scan.observed & nonzero_v))
            for tid in emit:
                tid = int(tid)
                if scan.observed[tid] and (print_zero_coverage_contigs
                                           or nonzero_v[tid]):
                    taker.start_entry(tid, header.target_names[tid])
                    for cov in cov_matrix[:, tid]:
                        taker.add_single_coverage(cov)
                    taker.finish_entry()
                elif not scan.observed[tid]:
                    taker.start_entry(tid, header.target_names[tid])
                    _emit_zero_entry(taker, estimators,
                                     int(header.target_lens[tid]))
                    taker.finish_entry()
        else:
            for tid in range(header.n_ref):
                if scan.observed[tid]:
                    st = _entity_stats(scan, layout, np.array([tid]), None,
                                       scan.reads_primary,
                                       scan.identity_sum_primary, contig_mode=True)
                    coverages = [e.calculate(st) for e in estimators]
                    nonzero = any(c > 0.0 for c in coverages)
                    if nonzero:
                        num_mapped_total += int(scan.reads_primary[tid])
                    if print_zero_coverage_contigs or nonzero:
                        taker.start_entry(tid, header.target_names[tid])
                        _emit_entry(taker, estimators, coverages, [st] * len(estimators))
                        taker.finish_entry()
                elif print_zero_coverage_contigs:
                    taker.start_entry(tid, header.target_names[tid])
                    _emit_zero_entry(taker, estimators, int(header.target_lens[tid]))
                    taker.finish_entry()

        rm = ReadsMapped(
            num_mapped_reads=num_mapped_total,
            num_reads=scan.num_detected_primary_alignments)
        _log_reads_mapped(source.name, rm, t_scan)
        reads_mapped_vector.append(rm)
        source.finish()
    return reads_mapped_vector


def genome_coverage_separator(sources, separator: str, taker, estimators,
                              print_zero_coverage_genomes,
                              flag_filter: FlagFilter, single_genome=False,
                              threads: int = 1, device=None):
    """`coverm genome -s <sep>` engine (genome.rs:419-797)."""
    reads_mapped_vector = []
    has_pileup = any(isinstance(e, PileupCountsEstimator) for e in estimators)
    # batch path: variance from pooled moments; histogram only for
    # coverage_histogram output or trimmed_mean (order statistics pool
    # through the histogram, not per-contig rank sums)
    need_hist = (any_needs_hist(estimators) if has_pileup
                 else any_needs_hist_batch(estimators))
    ee = _exclusion_of(estimators)
    for source, header, layout, scan, t_scan in _scanned(
            sources, ee, flag_filter, need_hist,
            device=device):
        taker.start_stoit(source.name)
        npo = getattr(source, "num_primary_override", None)
        if npo is not None:
            scan.num_detected_primary_alignments = npo

        # genome of each tid
        if single_genome:
            genome_of = ["genome1"] * header.n_ref
        else:
            genome_of = []
            for name in header.target_names:
                if separator not in name:
                    raise ValueError(
                        f"Contig name {name} does not contain split symbol, so "
                        "cannot determine which genome it belongs to")
                genome_of.append(name.split(separator, 1)[0])

        # group contigs by genome, ordered by first tid
        groups = {}
        for tid, g in enumerate(genome_of):
            groups.setdefault(g, []).append(tid)
        ordered = sorted(groups.items(), key=lambda kv: kv[1][0])

        num_mapped_total = 0
        # The reference still zero-fills every genome when there are primary
        # alignments but none pass/map (genome.rs:731-778 via
        # print_previous_zero_coverage_genomes2 with last_genome=None).
        any_entries = scan.observed.any() or scan.num_detected_primary_alignments > 0
        if single_genome and not scan.observed.any():
            # quirk parity (genome.rs:739-778): a single-genome run with no
            # passing mapped reads emits one zero row for "genome1" whose
            # unobserved set excludes tid 0 and whose zero entry_length is 9.
            if any_entries and print_zero_coverage_genomes:
                st = _entity_stats(scan, layout, np.empty(0, np.int64),
                                   np.arange(1, header.n_ref),
                                   scan.reads_nonsupp, scan.identity_sum_primary)
                coverages = [e.calculate(st) for e in estimators]
                taker.start_entry(0, "genome1")
                for est, cov in zip(estimators, coverages):
                    if cov > 0.0:
                        _emit_entry(taker, [est], [cov], [st])
                    else:
                        _emit_zero_entry(taker, [est], 9)
                taker.finish_entry()
            reads_mapped_vector.append(ReadsMapped(
                num_mapped_reads=0,
                num_reads=scan.num_detected_primary_alignments))
            source.finish()
            continue
        # vectorised genome aggregation (segment reductions); the scalar
        # per-genome path remains for coverage_histogram output
        cov_matrix = None
        if not has_pileup:
            gidx = {gname: i for i, (gname, _) in enumerate(ordered)}
            genome_of_tid = np.fromiter(
                (gidx[g] for g in genome_of), dtype=np.int64,
                count=header.n_ref)
            bs = _genome_batch_stats(scan, layout, genome_of_tid,
                                     len(ordered), scan.reads_nonsupp,
                                     scan.identity_sum_primary)
            cov_matrix = np.stack(
                [e.calculate_batch(bs) for e in estimators])
        for gi, (genome, tids) in enumerate(ordered):
            tids = np.asarray(tids)
            obs = tids[scan.observed[tids]]
            unobs = tids[~scan.observed[tids]]
            if obs.size == 0:
                if print_zero_coverage_genomes and any_entries:
                    taker.start_entry(int(tids[0]), genome)
                    _emit_zero_entry(taker, estimators,
                                     int(layout.lengths[tids].sum()))
                    taker.finish_entry()
                continue
            if cov_matrix is not None:
                st = None
                coverages = list(cov_matrix[:, gi])
            else:
                st = _entity_stats(scan, layout, obs, unobs,
                                   scan.reads_nonsupp,
                                   scan.identity_sum_primary)
                coverages = [e.calculate(st) for e in estimators]
            nonzero = any(c > 0.0 for c in coverages)
            if nonzero:
                num_mapped_total += int(scan.reads_nonsupp[tids].sum())
            if print_zero_coverage_genomes or nonzero:
                taker.start_entry(int(tids[0]), genome)
                for est, cov in zip(estimators, coverages):
                    if cov > 0.0:
                        _emit_entry(taker, [est], [cov], [st])
                    else:
                        _emit_zero_entry(taker, [est], 9)
                taker.finish_entry()

        rm = ReadsMapped(
            num_mapped_reads=num_mapped_total,
            num_reads=scan.num_detected_primary_alignments)
        _log_reads_mapped(source.name, rm, t_scan)
        reads_mapped_vector.append(rm)
        source.finish()
    return reads_mapped_vector


def genome_coverage_named(sources, genomes_and_contigs, taker, estimators,
                          print_zero_coverage_genomes, flag_filter: FlagFilter,
                          threads: int = 1, device=None):
    """`coverm genome` with a contig->genome map (genome.rs:17-322)."""
    reads_mapped_vector = []
    has_pileup = any(isinstance(e, PileupCountsEstimator) for e in estimators)
    need_hist = (any_needs_hist(estimators) if has_pileup
                 else any_needs_hist_batch(estimators))
    ee = _exclusion_of(estimators)
    for source, header, layout, scan, t_scan in _scanned(
            sources, ee, flag_filter, need_hist,
            device=device):
        taker.start_stoit(source.name)
        npo = getattr(source, "num_primary_override", None)
        if npo is not None:
            scan.num_detected_primary_alignments = npo

        genome_of_tid = np.full(header.n_ref, -1, dtype=np.int64)
        for tid, name in enumerate(header.target_names):
            gi = genomes_and_contigs.genome_index_of_contig(name)
            if gi is not None:
                genome_of_tid[tid] = gi
        if not (genome_of_tid >= 0).any():
            raise ValueError(
                "Error: There are no found reference sequences that are a "
                "part of a genome")

        num_mapped_total = 0
        no_primary = scan.num_detected_primary_alignments == 0 and not scan.observed.any()
        n_genomes = len(genomes_and_contigs.genomes)
        cov_matrix = None
        if not has_pileup and not no_primary:
            bs = _genome_batch_stats(scan, layout, genome_of_tid, n_genomes,
                                     scan.reads_all,
                                     scan.identity_sum_nonsupp)
            cov_matrix = np.stack(
                [e.calculate_batch(bs) for e in estimators])
            # per-genome totals for the zero-entry length / read counts
            genome_len = bs.total_bases_full + bs.unobserved_full_bases
            genome_reads = np.zeros(n_genomes, dtype=np.int64)
            np.add.at(genome_reads, genome_of_tid[genome_of_tid >= 0],
                      scan.reads_all[genome_of_tid >= 0])
        for gi, genome in enumerate(genomes_and_contigs.genomes):
            if no_primary:
                break
            if cov_matrix is not None:
                st = None
                coverages = list(cov_matrix[:, gi])
                zero_len = int(genome_len[gi])
                g_reads = int(genome_reads[gi])
            else:
                tids = np.flatnonzero(genome_of_tid == gi)
                obs = tids[scan.observed[tids]]
                unobs = tids[~scan.observed[tids]]
                st = _entity_stats(scan, layout, obs, unobs, scan.reads_all,
                                   scan.identity_sum_nonsupp)
                coverages = [e.calculate(st) for e in estimators]
                zero_len = int(layout.lengths[tids].sum())
                g_reads = int(scan.reads_all[tids].sum())
            nonzero = any(c > 0.0 for c in coverages)
            if nonzero:
                num_mapped_total += g_reads
            if print_zero_coverage_genomes or nonzero:
                taker.start_entry(gi, genome)
                for est, cov in zip(estimators, coverages):
                    if cov > 0.0:
                        _emit_entry(taker, [est], [cov], [st])
                    else:
                        _emit_zero_entry(taker, [est], zero_len)
                taker.finish_entry()

        rm = ReadsMapped(
            num_mapped_reads=num_mapped_total,
            num_reads=scan.num_detected_primary_alignments)
        _log_reads_mapped(source.name, rm, t_scan)
        reads_mapped_vector.append(rm)
        source.finish()
    return reads_mapped_vector


def _exclusion_of(estimators) -> int:
    for e in estimators:
        ee = getattr(e, "contig_end_exclusion", None)
        if ee is not None:
            return int(ee)
    return 0


