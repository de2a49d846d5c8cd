#!/usr/bin/env python3
"""Smoke run of coverm_tpu_torch (the PyTorch/CUDA port) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: the sweep-scan, BGZF inflate and BAM record-scan kernels
     (csrc/sweep_scan.cu, csrc/bgzf_inflate.cu, csrc/bam_scan.cu, nvcc
     for sm_90a) and the native BAM ingest library, all from this
     checkout and started together;
  3. kernel vs plain version on an adversarial case: blocks given to the
     sweep engine on the card, the kernel's inputs (sorted keys, length
     table) taken from the engine's own launch and held against
     sweep_scan_reference (all four outputs exactly equal), the
     statistics against the numpy oracle;
  4. main path: the bench workload (32 contigs x 1 Mbp at 20x, 150 bp
     reads, ~4.27 M reads) as a sorted BGZF BAM, through the port's CLI
     `contig -b ... -m mean trimmed_mean variance covered_fraction` on
     the card: a warm-up run that records the inputs of every kernel
     launch and every engine batch, then a run with the kernels' launch
     counts set to 0 just before and read just after (one K1 launch per
     engine batch, one inflate and one record scan per BGZF segment: the
     fused ingest inflates and scans on the card, and the host's
     stats_scan is never called), and the peak device memory of that
     run; the
     TSV must
     equal the same command on the CPU (the plain path) and the per-contig
     statistics the numpy oracle's. The kernel is then held against its
     plain version on each recorded launch and timed there with CUDA
     events: `ms` one wrapper call at a time (host launch gaps included),
     `device_ms` with the calls queued ahead of the card (its device
     time, memset included), and the recorded engine batches are replayed
     for the engine-only rate;
  5. genome mode: `genome -s '~'` on a smaller BAM (whole-file route),
     checked the same way;
  6. CRAM: the CRAM 3.0 twin of phase 4's BAM (the same alignments,
     synth.write_cram_twin) through `contig -b bench.cram` on the card:
     its TSV must equal phase 4's BAM TSV byte for byte and its
     statistics the numpy oracle's;
  7. genes: `contig --gff genes.gff -b bench.bam` on phase 4's BAM, a
     900 bp gene every 1,000 bp (32,000 genes, every tenth overlapping
     the next, a few on contigs the header lacks): TSV equal to the CPU's;
     the classic reader inflates and parses on the card, one inflate and
     one parse launch a segment of its own, and the host's inflate and
     parse are never called (the streamed source's header probe apart);
  8. `genome --sharded -s '~'` over two read-name-sorted paired shard
     BAMs (8 contigs x 100 kbp at 20x): TSV equal to the CPU's;
  9. `genome -f g*.fna --dereplicate --dereplication-cluster-method
     sketch` with the CheckM filter: four genome FASTAs from a seed (gB a
     copy of gA with 0.5% of its bases changed, so the two form one
     cluster), a CheckM tab table with `--min-completeness` dropping gD,
     and a BAM of 8 contigs x 100 kbp at 20x over their contigs: TSV and
     representative list equal to the CPU's;
 10. `--profile-dir` on phase 5's genome command: TSV equal to phase 5's,
     and a torch.profiler trace in the directory that names the kernel
     (`sweep_scan_kernel`);
 11. `filter --min-read-percent-identity 99` on phase 5's BAM (its
     standard error line must show some reads kept and some dropped;
     the BAM inflated and parsed on the card, a launch of each a segment,
     no host inflate or parse), then `contig -b filtered.bam` on the
     card: TSV equal to the CPU's;
 12. the dense engine, `ops.depth.compute_depth_stats`, on the card over
     phase 4's blocks (32 x 1 Mbp, ~4.27 M reads): every int64 field and
     the histogram equal to the numpy oracle; timed with CUDA events,
     and its device busy time read from torch.profiler over one call;
 13. the contig-sharded mesh sweep, `parallel.mesh_sweep.
     compute_depth_stats_sweep_mesh`, over phase 4's blocks with the
     trim and the histogram: on four logical shards of cuda:0 (and over
     every card when there are two or more), one K1 launch a shard, each
     held against the plain version; the statistics and histogram equal
     the single-device engine's and the numpy oracle's; then phase 4's
     contig 0 alone over four shards, which takes the position split;
     a pass timed on the host clock against the single-device pass;
 14. the fused scanner with the mesh depth_fn: `scan.scan_any(...,
     depth_fn=mesh_depth_fn(...))` on the bench BAM over four logical
     shards of cuda:0; its DepthStats equal phase 4's oracle;
 15. the two-rank job: `python -m coverm_tpu_torch contig -b bench.bam`
     as two processes under COVERM_TPU_COORDINATOR, _NUM_PROCESSES and
     _PROCESS_ID. With one card both ranks share it over gloo; with two
     or more each takes its own and the backend is NCCL. Rank 0's TSV
     must equal phase 4's and rank 1 must write nothing; each rank
     checks its own K1 launches against the plain version and reports
     them with its count;
 16. the multi-card CLI routes (COVERM_TPU_MESH=1 on the bench BAM, and
     sample-DP over two samples of the same contigs: the bench BAM and a
     5x one from another seed), only with two or more cards; with one,
     a line says they were not driven, and the kernels line carries
     "multi_card": false.
 17. `contig -m metabat` over a BAM of the bench's size whose NM (0-7 of
     150 bp) puts 3 reads in 8 under metabat's 97% identity, streamed in
     32 MiB segments: the fused scan, with the filter in its native
     record loop, driven as phases 4-11 are and without one record
     through the classic reader; then COVERM_TPU_FUSED=0 (the classic
     reader, every record parsed once on the card, one inflate and one
     parse launch a segment and no host inflate or parse, then the read
     filter). The two TSVs must be equal; the two pass times are
     printed.

 18. validate (`python -m coverm_tpu_torch.scripts.validate`, through its
     main) over phase 4's BAM (the fused route), phase 5's genome BAM
     (the whole-file route), a BAM of two 3 kbp contigs at 600x (deeper
     than the histogram's 512 bins: the overflow rows of
     DepthStats.hist_wide) and one of 400 contigs of 300 bp at 1x (some
     with no read): exit 0, every observed contig checked; then the last
     again with one contig's sum_depth_window one higher, through a
     wrapped depth engine: it must name that contig and exit 1;
 19. profile_ingest over phase 4's BAM, one pass a stage: every stage's
     seconds logged; the fused stage's record count must equal phase 4's
     reads, and the e2e stage's K1 and inflate launches phase 4's; the
     card inflate stage launches once a segment;
 20. scaling_bench with two ranks at 500,000 reads (one rank, then two;
     on one card they share cuda:0 over gloo): equal checksums; eff(2)
     and the transport logged, each rank's K1 launches held against the
     plain version;
 21. dp_ab_bench at 100,000 blocks a sample: the two arms bit-equal to
     each other and to the single-device engine; on one card over four
     logical devices of cuda:0.
 22. the BGZF inflate kernel (ops/bgzf_inflate.py) byte for byte against
     the host's ct_bgzf_inflate on eight adversarial BGZF streams (zlib
     levels 0, 1, 6, 9, Z_FIXED, Z_HUFFMAN_ONLY, Z_RLE, and Huffman-coded
     blocks followed by stored ones) and on phase 4's BAM segment by
     segment, where it must also equal its plain version (the largest
     byte difference is the kernels line's max_abs_err); six corrupt
     blocks must be flagged, and one inside a BAM must raise through the
     card route; the whole-BAM inflate rate and the kernel's ms a segment
     (CUDA events) beside its plain version and a 256 MiB pinned d2h
     copy; then the kernel's design: its shared bytes a CTA and CTAs an
     SM (the card's occupancy query), and its time segment by segment
     (coverm_tpu_torch/scripts/inflate_ab.py), on pinned host memory and
     on the card's own, on phase 4's BAM (zlib level 1), on its blocks at
     level 6 (zlib's default, which samtools writes) and on a 5 M-read
     sample shaped as the benchmark's (bench_torch/synth.py), its mapped
     and unmapped segments apart;
 23. the BAM record scan (ops/bam_scan.py) bit for bit against the
     host's ct_stats_scan (native.stats_scan) and its plain version on
     the CPU tests' adversarial streams (tests/test_torch_bam_scan.py,
     and the speculate's join streams of
     tests/test_torch_bam_speculate.py), unfiltered and under metabat's
     filter, then on phase 4's BAM segment by segment as the main path
     hands them over (the inflate's card slot, the carry before it; also
     against the plain version, timed) and on phase 17's 32 MiB metabat
     segments under its filter: blocks, per-contig counts, runs, scalars
     and carry; the speculate alone (first, exit, count and starts of
     every region) against its plain version on the streams and phase
     4's segments, with the scan's min_bs and the parse's; its ms (CUDA
     events around each call, and by step: speculate, the stitch's
     parallel check and its walk, analyse, fold, emit) beside its bound
     (also by step) and the plain version's, and the regions the stitch
     walked in sequence.
 24. the record parse (ops/bam_scan.parse_segment, the classic reader's
     columns) column for column against the host's parse_records_full
     and its plain version on the CPU tests' streams
     (tests/test_torch_bam_parse.py), with and without the bytes,
     refused ones with the host's exception and message, six of them
     also written as BAMs and read through the reader's card route
     against its host route; then on phase 4's BAM segment by segment as
     the reader hands them over (the slot after the carry, the header
     parsed on the host), each segment parsed without the bytes (as
     `--gff`: the columns and the carry come back) and with them (as the
     pair filters): its ms (CUDA events around each call, and by step,
     the copy back apart from the kernels), the launches a segment, one
     arena copy a parse (and one of the bytes), the card's peak around
     each parse (max_memory_allocated), beside its bound (also by step),
     the plain version's and the copy back over the link; the speculate
     with the parse's min_bs against its plain version on each segment.

Phases 4 to 11 and 17 each run their command once to warm up (recording the
kernel's inputs and the engine's batches), then once with the kernels'
launch counts set to 0 just before and read just after: K1's must equal
the number of engine batches and be above 0, the inflate's the number of BGZF segments of a streamed BAM (phases 4,
7, 11 and 17), the record scan's and the parse's together the same (the
fused scan's and the classic reader's), 0 on the other routes. They run with COVERM_TPU_MESH=0,
so that on a machine with several cards they still take the single-card
engine; phases 13-16 drive the multi-device engines. Mapping from reads and `makedb`
are not driven here: they need a mapper binary, which this script does
not assume. `cluster` runs on the host only and needs no card. The CPU
tests hold all three against the JAX package (with tests/fake_mapper.py
and fake skani and fastANI executables).

Prints the card line, then one {"kernels": [...]} JSON line (K1, the
inflate kernel, the record scan and the record parse, each with the
launch count of every path, and with two
or more cards phase 16's wall seconds under "multi_card_wall_s"), then the {"ok": true, "device":
{...}} JSON line last.
"""

import contextlib
import json
import os
import shutil
import sys
import tempfile
import threading
import time

import numpy as np

EE = 75
TRIM = (0.05, 0.95)
METHODS = ["mean", "trimmed_mean", "variance", "covered_fraction"]
METABAT_SEGMENT_BYTES = 32 << 20   # phase 17's streamed segments
H100_BYTES_PER_S = 3.35e12   # HBM3, NVIDIA data sheet (SXM)
# INT32 peak: the data sheet's 67 TFLOP/s fp32 counts an FMA as two
# operations (33.5 T lane-instructions/s), and an SM has 64 INT32 lanes
# beside its 128 fp32 lanes
H100_INT32_OPS_PER_S = 67e12 / 2 * 64 / 128
# bytes per event the kernel must move: the int64 key in; depth, w_len_all
# and seg (int32) out. The length table and per_seg add 4 (n_seg + 1) and
# 48 n_seg bytes a launch.
KERNEL_BYTES_PER_EVENT = 8 + 3 * 4
# int32 operations per event of sweep_scan_reference, counted from its
# body; an int64 operation counts as two
KERNEL_OPS_PER_EVENT = sum((
    12,     # decode: pad test, seg (shift, select), pos (shift, and, sub,
            # select), sentinel test, sign (or, and, test, 2 selects)
    4,      # depth: sign scan, sentinel jump, its scan, subtract
    1,      # length: len_tab gather
    2,      # gap end: test, select
    4,      # full_len: min, max, sub, clamp
    7,      # w_len: sub, min, max, sub, clamp, len > 2ee test, select
    3,      # padding: test, 2 selects
    1,      # covered test
    2 * 3,  # sum_w: mask select, multiply, add (int64)
    2,      # cov_w: add (int64)
    2 * 2,  # cov_f: mask select, add (int64)
    2 + 2 * 2,  # max_w: w > 0 test, and, select and max (int64)
    2 * 3,  # sq_w: two multiplies, add (int64)
    1 + 2 * 3,  # minpay: w > 0 test, sub, select, max (int64)
))


# the inflate kernel's launches of each path driven, by drive()'s label,
# the record scan's, the record parse's, the host's stats_scan calls, and
# the host's inflates (native.bgzf_inflate_blocks, the streamed source's
# header probe in FusedScanStream.open apart) and parses
# (native.parse_records_full)
INFLATE_LAUNCHES = {}
SCAN_LAUNCHES = {}
PARSE_LAUNCHES = {}
HOST_SCANS = {}
HOST_INGEST = {}
# the adversarial BGZF streams of phase 22: (zlib level, strategy)
INFLATE_STREAMS = [(0, 0), (1, 0), (6, 0), (9, 0), (6, 4), (6, 2), (6, 3)]
PCIE_GEN5_X16_BYTES_PER_S = 63e9  # one direction, published
# reads of phase 22's demo-shaped sample: six segments, two of mapped
# reads, one mixed, three of unmapped ones (the last short)
INFLATE_DEMO_READS = 5_000_000


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def blocks_of(tids, starts, lengths, read_len):
    ends = np.minimum(starts.astype(np.int64) + read_len, lengths[tids])
    return tids, starts.astype(np.int64), ends


@contextlib.contextmanager
def recording(module, name, store, copy):
    """Wrap module.<name> so that every call appends copy(args, kwargs)
    to store before running the original."""
    orig = getattr(module, name)

    def rec(*args, **kwargs):
        store.append(copy(args, kwargs))
        return orig(*args, **kwargs)
    setattr(module, name, rec)
    try:
        yield
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def host_ingest(store):
    """Counts into store ("inflate", "parse") the host's inflates of BGZF
    segments (native.bgzf_inflate_blocks, but for the header probe of
    io/fastscan.FusedScanStream.open, which every streamed source makes)
    and its record parses (native.parse_records_full)."""
    from coverm_tpu_torch.io import fastscan, native
    store.update(inflate=0, parse=0)
    probing = threading.local()
    inflate, parse = native.bgzf_inflate_blocks, native.parse_records_full
    probe = fastscan.FusedScanStream._open_bgzf_plan

    def inflate_counted(*args, **kwargs):
        if not getattr(probing, "on", False):
            store["inflate"] += 1
        return inflate(*args, **kwargs)

    def parse_counted(*args, **kwargs):
        store["parse"] += 1
        return parse(*args, **kwargs)

    def probe_marked(self):
        probing.on = True
        try:
            return probe(self)
        finally:
            probing.on = False
    native.bgzf_inflate_blocks = inflate_counted
    native.parse_records_full = parse_counted
    fastscan.FusedScanStream._open_bgzf_plan = probe_marked
    try:
        yield store
    finally:
        native.bgzf_inflate_blocks, native.parse_records_full = inflate, parse
        fastscan.FusedScanStream._open_bgzf_plan = probe


@contextlib.contextmanager
def ingest_counts(label):
    """The card's ingest launches and the host's ingest calls of what the
    block runs, by `label`: the counts set to 0 just before and read just
    after. Where the card inflated, every inflated segment must be
    scanned or parsed on the card once, and the host must have inflated,
    scanned and parsed nothing."""
    from coverm_tpu_torch.io import native
    from coverm_tpu_torch.ops import bam_scan as S
    from coverm_tpu_torch.ops import bgzf_inflate as B
    host_scans, host = [], {}
    B.bgzf_inflate_launches = 0
    S.bam_scan_launches = S.bam_parse_launches = 0
    with recording(native, "stats_scan", host_scans, lambda a, k: 1), \
            host_ingest(host):
        yield
    INFLATE_LAUNCHES[label] = B.bgzf_inflate_launches
    SCAN_LAUNCHES[label] = S.bam_scan_launches
    PARSE_LAUNCHES[label] = S.bam_parse_launches
    HOST_SCANS[label] = len(host_scans)
    HOST_INGEST[label] = dict(host)
    if SCAN_LAUNCHES[label] + PARSE_LAUNCHES[label] != \
            INFLATE_LAUNCHES[label] or (INFLATE_LAUNCHES[label] and (
                HOST_SCANS[label] or host["inflate"] or host["parse"])):
        raise SystemExit(f"{label}: the record scan launched "
                         f"{SCAN_LAUNCHES[label]} times and the parse "
                         f"{PARSE_LAUNCHES[label]} over "
                         f"{INFLATE_LAUNCHES[label]} inflated segments, the "
                         f"host's stats_scan {HOST_SCANS[label]} times, its "
                         f"inflate and parse {host}")


def reader_segments(path, target_bytes):
    """The number of segments that io/bam.BamStreamReader cuts `path`
    into."""
    from coverm_tpu_torch.io import native
    from coverm_tpu_torch.io.fastscan import plan_segments
    _, _, usz = native.bgzf_scan(np.memmap(path, np.uint8, mode="r"))
    return len(plan_segments(usz, 0, target_bytes))


def kernel_launches(store):
    """Records the inputs (key_s, len_tab, n_seg, ee) of each sweep-scan
    call."""
    from coverm_tpu_torch.ops import sweep as S
    return recording(S, "sweep_scan", store,
                     lambda a, k: (a[0].clone(), a[1].clone(), *a[2:4]))


@contextlib.contextmanager
def engine_batches(store):
    """Records (tids, starts, ends, contig_counts) of each engine batch,
    wherever the engine is called from: the fused scan looks it up in
    ops.sweep at call time, scan.py and genes.py bind it at import."""
    from coverm_tpu_torch import genes, scan
    from coverm_tpu_torch.ops import sweep as S

    def copy(a, k):
        counts = k.get("contig_counts")
        return (*(np.array(x) for x in a[1:4]),
                None if counts is None else np.array(counts))
    with contextlib.ExitStack() as stack:
        for module in (S, scan, genes):
            stack.enter_context(recording(
                module, "compute_depth_stats_sweep", store, copy))
        yield


def check_kernel(name, ins):
    """Kernel vs plain version on the card: exact equality of all four
    outputs (depth, w_len_all, seg, per_seg); returns the largest
    absolute difference (0)."""
    import torch
    from coverm_tpu_torch.ops import sweep_scan as K
    got = K.sweep_scan(*ins)
    want = K.sweep_scan_reference(*ins)
    torch.cuda.synchronize()
    err = max(int((g - w).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    log(f"[kernel] {name}: E={ins[0].numel()} n_seg={ins[2]} "
        f"max_abs_err={err}")
    if err != 0:
        raise SystemExit(f"sweep-scan kernel disagrees with its plain "
                         f"version on {name}: max_abs_err={err}")
    return err


def check_adversarial(dev):
    """Contigs with no blocks, len <= 2*ee, blocks ending at the contig
    end, duplicate and zero-length blocks, tiles straddling contigs, a
    ragged event count: through the sweep engine on the card, whose
    kernel launch is held against the plain version and whose statistics
    against the numpy oracle."""
    from coverm_tpu_torch.ops.depth import (ReferenceLayout,
                                            compute_depth_stats_numpy)
    from coverm_tpu_torch.ops.sweep import compute_depth_stats_sweep
    rng = np.random.default_rng(7)
    lengths = np.array([120, 150, 151, 5000, 90, 3000, 7000, 40, 2500, 10000])
    blocks = []
    for c, ln in enumerate(lengths):
        if c in (1, 7):
            continue  # contigs with no blocks
        n = int(rng.integers(50, 900))
        s = rng.integers(0, ln, n)
        e = np.minimum(s + rng.integers(0, 300, n), ln)
        e[: n // 10] = ln  # blocks ending at the contig end
        blocks.append((np.full(n, c), s, e))
    tids = np.concatenate([b[0] for b in blocks])
    starts = np.concatenate([b[1] for b in blocks])
    ends = np.concatenate([b[2] for b in blocks])
    o = np.lexsort((starts, tids))
    tids, starts, ends = tids[o], starts[o], ends[o]
    layout = ReferenceLayout.build(lengths, EE)
    launches = []
    with kernel_launches(launches):
        got = compute_depth_stats_sweep(layout, tids, starts, ends,
                                        trim=TRIM, device=dev)
    if len(launches) != 1:
        raise SystemExit("adversarial case: expected one kernel launch")
    check_kernel("adversarial", launches[0])
    check_stats("adversarial", got,
                compute_depth_stats_numpy(layout, tids, starts, ends,
                                          trim=TRIM))


def check_stats(label, got, want):
    for f in ("sum_depth_window", "covered_window", "covered_full",
              "max_depth_window", "sumsq_window", "min_depth_window",
              "trimmed_sum"):
        if not np.array_equal(getattr(got, f), getattr(want, f)):
            raise SystemExit(f"{label}: {f} differs from the numpy oracle")


def oracle_check(label, bam, truth, argv, dev):
    """Per-contig DepthStats of the port's scan on the card against the
    numpy oracle on the known blocks; returns the oracle's."""
    from coverm_tpu_torch.cli import build_parser, flag_filter_from_args
    from coverm_tpu_torch.modes import BamFileSource
    from coverm_tpu_torch.ops.depth import (ReferenceLayout,
                                            compute_depth_stats_numpy)
    from coverm_tpu_torch.scan import scan_any
    tids, starts, ends = truth
    header, payload = BamFileSource(bam).read()
    layout = ReferenceLayout.build(header.target_lens, EE)
    ff = flag_filter_from_args(build_parser().parse_args(argv))
    scan = scan_any(header, payload, layout, ff, need_hist=False, trim=TRIM,
                    device=dev)
    want = compute_depth_stats_numpy(layout, tids, starts, ends, trim=TRIM)
    check_stats(label, scan.depth, want)
    if int(scan.reads_primary.sum()) != tids.size:
        raise SystemExit(f"{label}: read count differs")
    log(f"[{label}] DepthStats equal the numpy oracle on {tids.size} reads")
    return want


def run_cli(argv, out, device):
    from coverm_tpu_torch.cli import main
    rc = main(argv + ["-o", out], device=device)
    if rc != 0:
        raise SystemExit(f"CLI {argv[0]} exited {rc} on {device}")
    with open(out, "rb") as f:
        return f.read()


def drive(label, argv, work, dev, keep=False):
    """One path through the CLI on the card: a warm-up run that records
    the kernel's inputs and the engine's batches, then the measured run
    with the kernel's launch count set to 0 just before and read just
    after; it must launch once per (non-empty) engine batch. The kernel
    is then held against its plain version on every recorded launch.
    Returns the measured run's TSV, wall seconds, launches, peak device
    bytes and the kernel's largest error, and (keep=True) the recorded
    launch inputs and batches."""
    import torch
    from coverm_tpu_torch.ops import sweep_scan as K
    launches_in, batches = [], []
    with kernel_launches(launches_in), engine_batches(batches):
        run_cli(argv, os.path.join(work, f"{label}_warm.tsv"), dev)
    n_batches = sum(1 for b in batches if b[0].size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.sweep_scan_launches = 0
    t0 = time.perf_counter()
    with ingest_counts(label):
        tsv = run_cli(argv, os.path.join(work, f"{label}_gpu.tsv"), dev)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.sweep_scan_launches
    peak = torch.cuda.max_memory_allocated()
    if launches <= 0:
        raise SystemExit(f"{label}: the path did not launch the sweep-scan "
                         "kernel")
    if launches != len(launches_in) or launches != n_batches:
        raise SystemExit(f"{label}: the kernel launched {launches} times, "
                         f"its warm-up {len(launches_in)} over {n_batches} "
                         "engine batches")
    log(f"[{label}] {launches} kernel launches over {n_batches} engine "
        f"batches, {INFLATE_LAUNCHES[label]} inflate, "
        f"{SCAN_LAUNCHES[label]} record-scan and {PARSE_LAUNCHES[label]} "
        f"parse launches, the host's stats_scan {HOST_SCANS[label]} times, "
        f"its inflate and parse {HOST_INGEST[label]}; {wall:.3f} s")
    err = max(check_kernel(f"{label} launch {i}", ins)
              for i, ins in enumerate(launches_in))
    if keep:
        return tsv, wall, launches, peak, err, launches_in, batches
    return tsv, wall, launches, peak, err


def same_as_cpu(label, argv, tsv_gpu, work, rows):
    """The TSV on the card equals the plain path's on the CPU and has
    `rows` lines after its header."""
    import torch
    tsv_cpu = run_cli(argv, os.path.join(work, f"{label}_cpu.tsv"),
                      torch.device("cpu"))
    if tsv_gpu != tsv_cpu:
        raise SystemExit(f"{label} TSV on the card differs from the CPU's")
    if tsv_gpu.count(b"\n") != rows + 1:
        raise SystemExit(f"{label} TSV does not have {rows} rows")


def phase_derep(work, dev):
    """Phase 9: genome --dereplicate with the CheckM filter. Returns the
    kernel's launches and largest error."""
    from coverm_tpu_torch.synth import write_genome_fastas, write_sorted_bam
    genomes = {g: [f"{g}_c{2 * i + k}" for k in (0, 1)]
               for i, g in enumerate(("gA", "gB", "gC", "gD"))}
    paths = write_genome_fastas(work, genomes, copies={"gB": "gA"})
    bam = os.path.join(work, "derep.bam")
    write_sorted_bam(bam, n_contigs=8, contig_len=100_000, seed=4,
                     names=[c for cs in genomes.values() for c in cs])
    checkm = os.path.join(work, "checkm.tsv")
    with open(checkm, "w") as f:
        f.write("Bin Id\tCompleteness\tContamination\n"
                "gA\t92.0\t1.0\ngB\t97.0\t0.5\ngC\t88.0\t2.0\n"
                "gD\t35.0\t1.0\n")
    reps = os.path.join(work, "reps.txt")
    argv = ["genome", "-f", *paths, "-b", bam, "--dereplicate",
            "--dereplication-cluster-method", "sketch",
            "--dereplication-output-representative-list", reps,
            "--checkm-tab-table", checkm, "--min-completeness", "50",
            "-m", *METHODS]
    tsv, _, launches, _, err = drive("derep", argv, work, dev)
    with open(reps) as f:
        reps_gpu = f.read()
    if reps_gpu.split() != [paths[1], paths[2]]:
        raise SystemExit(f"derep: representatives {reps_gpu.split()}")
    same_as_cpu("derep", argv, tsv, work, 2)
    with open(reps) as f:
        if f.read() != reps_gpu:
            raise SystemExit("derep: representatives differ from the CPU's")
    log(f"[derep] representatives {reps_gpu.split()}")
    return launches, err


def phase_profile(gargv, g_tsv, work, dev):
    """Phase 10: --profile-dir on phase 5's genome command. Returns the
    kernel's launches and largest error."""
    trace_dir = os.path.join(work, "profile")
    argv = gargv + ["--profile-dir", trace_dir]
    tsv, _, launches, _, err = drive("profile", argv, work, dev)
    if tsv != g_tsv:
        raise SystemExit("--profile-dir changed the genome TSV")
    traces = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    for name in traces:
        with open(os.path.join(trace_dir, name)) as f:
            if "sweep_scan_kernel" not in f.read():
                raise SystemExit(f"trace {name} does not name the kernel")
    if not traces:
        raise SystemExit("--profile-dir wrote no trace")
    log(f"[profile] {len(traces)} traces name sweep_scan_kernel")
    return launches, err


def phase_filter(gbam, work, dev):
    """Phase 11: filter (its BAM inflated and parsed on the card, a
    launch of each a segment), then contig over its output on the card.
    Returns the kernel's launches and largest error."""
    import io
    from coverm_tpu_torch.cli import main as cli_main
    out = os.path.join(work, "filtered.bam")
    said = io.StringIO()
    with contextlib.redirect_stderr(said), ingest_counts("filter"):
        rc = cli_main(["filter", "-b", gbam, "-o", out,
                       "--min-read-percent-identity", "99"])
    line = said.getvalue().strip().splitlines()[-1]
    kept, total = (int(w) for w in line.split() if w.isdigit())
    if rc != 0 or not 0 < kept < total:
        raise SystemExit(f"filter: {line!r}")
    n_seg = reader_segments(gbam, 1 << 28)
    if not INFLATE_LAUNCHES["filter"] == PARSE_LAUNCHES["filter"] == n_seg:
        raise SystemExit(f"filter: inflated {INFLATE_LAUNCHES['filter']} "
                         f"and parsed {PARSE_LAUNCHES['filter']} segments "
                         f"on the card of the reader's {n_seg}")
    argv = ["contig", "-b", out, "-m", *METHODS]
    tsv, _, launches, _, err = drive("filter_contig", argv, work, dev)
    same_as_cpu("filter_contig", argv, tsv, work, 8)
    log(f"[filter] {line}")
    return launches, err


def check_hist(label, got, want):
    """The histograms (ragged overflow rows folded in) equal, up to
    trailing zero bins."""
    from coverm_tpu_torch.modes import _dense_hist
    a, b = _dense_hist(got), _dense_hist(want)
    W = max(a.shape[1], b.shape[1])
    pad = [np.pad(h, ((0, 0), (0, W - h.shape[1]))) for h in (a, b)]
    if not np.array_equal(*pad):
        raise SystemExit(f"{label}: histogram differs from the numpy oracle")


def phase_dense(lengths, truth, want, dev):
    """Phase 12: the dense engine at the bench size against the numpy
    oracle `want` (with the histogram); returns its median milliseconds
    a call (CUDA events), the device's busy milliseconds in one call
    (torch.profiler) and the layout's chunk count."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from coverm_tpu_torch.ops.depth import (ReferenceLayout,
                                            compute_depth_stats)
    from coverm_tpu_torch.timing import event_ms
    layout = ReferenceLayout.build(lengths, EE)

    def run():
        return compute_depth_stats(layout, *truth, need_hist=True,
                                   trim=TRIM, device=dev)
    got = run()
    check_stats("dense", got, want)
    check_hist("dense", got, want)
    ms = event_ms(run, 5)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name[:60]] = (by_kernel.get(e.name[:60], 0.0)
                                      + e.time_range.elapsed_us() / 1e3)
    device_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:4]
    log(f"[dense] {truth[0].size} blocks over {len(layout.chunks)} chunks "
        f"of {layout.P} positions: {ms:.3f} ms a call (CUDA events), "
        f"device busy {device_ms:.3f} ms of one profiled call; top "
        f"{json.dumps(top)}")
    return ms, device_ms, len(layout.chunks)


def wall_ms(fn, reps):
    """Median host milliseconds of fn() over reps calls after one
    warm-up, each ending in a synchronize."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def counted(fn):
    """(fn(), K1 launches during it): the count set to 0 just before and
    read just after."""
    import torch
    from coverm_tpu_torch.ops import sweep_scan as K
    torch.cuda.synchronize()
    K.sweep_scan_launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, K.sweep_scan_launches


@contextlib.contextmanager
def parsed_records(store):
    """Appends the record count of each parse of the classic record
    reader to store: on the host (io/bam.parse_records) or on the card
    (ops/bam_scan.parse_segment)."""
    from coverm_tpu_torch.io import bam as B
    from coverm_tpu_torch.ops import bam_scan as S
    orig, orig_card = B.parse_records, S.parse_segment

    def parse(*args, **kwargs):
        batch, end = orig(*args, **kwargs)
        store.append(batch.n_records)
        return batch, end

    def parse_card(*args, **kwargs):
        ps = orig_card(*args, **kwargs)
        store.append(ps.n_records)
        return ps
    B.parse_records, S.parse_segment = parse, parse_card
    try:
        yield
    finally:
        B.parse_records, S.parse_segment = orig, orig_card


def phase_metabat(work, dev, card):
    """Phase 17: metabat's filtered fused scan against the classic reader
    and the read filter. Returns the kernel's launches and largest error,
    and the two pass times."""
    import torch
    from coverm_tpu_torch.synth import write_sorted_bam
    path = os.path.join(work, "metabat.bam")
    tids, _, _ = write_sorted_bam(path, seed=2, nm_hi=8)
    argv = ["contig", "-b", path, "-m", "metabat"]
    fused_parsed, classic_parsed = [], []
    os.environ["COVERM_TPU_SEGMENT_BYTES"] = str(METABAT_SEGMENT_BYTES)
    try:
        with parsed_records(fused_parsed):
            tsv, wall, launches, _, err = drive("metabat", argv, work, dev)
        os.environ["COVERM_TPU_FUSED"] = "0"
        with parsed_records(classic_parsed), ingest_counts("metabat_classic"):
            t0 = time.perf_counter()
            classic = run_cli(argv, os.path.join(work, "metabat_classic.tsv"),
                              dev)
            torch.cuda.synchronize()
            classic_wall = time.perf_counter() - t0
    finally:
        os.environ.pop("COVERM_TPU_SEGMENT_BYTES", None)
        os.environ.pop("COVERM_TPU_FUSED", None)
    if fused_parsed:
        raise SystemExit("metabat: the fused route ran the classic record "
                         "reader")
    if sum(classic_parsed) != tids.size or len(classic_parsed) < 4:
        raise SystemExit(f"metabat: the classic reader parsed "
                         f"{sum(classic_parsed)} records of {tids.size} in "
                         f"{len(classic_parsed)} segments")
    n_seg = reader_segments(path, METABAT_SEGMENT_BYTES)
    if not INFLATE_LAUNCHES["metabat_classic"] == \
            PARSE_LAUNCHES["metabat_classic"] == len(classic_parsed) == n_seg:
        raise SystemExit(f"metabat: COVERM_TPU_FUSED=0 inflated "
                         f"{INFLATE_LAUNCHES['metabat_classic']} and parsed "
                         f"{PARSE_LAUNCHES['metabat_classic']} segments on "
                         f"the card of the reader's {n_seg}")
    if tsv != classic:
        raise SystemExit("metabat: the fused filtered TSV differs from "
                         "COVERM_TPU_FUSED=0's")
    if tsv.count(b"\n") != 33:
        raise SystemExit("metabat TSV does not have 32 rows")
    log(f"[metabat] {tids.size} reads over {len(classic_parsed)} segments: "
        f"fused filtered scan {wall:.3f} s, classic reader (inflated and "
        f"parsed on the card) and read filter {classic_wall:.3f} s, TSVs "
        f"equal; {card}")
    return launches, err, wall, classic_wall


@contextlib.contextmanager
def perturbed_depth(contig):
    """The sweep engine, where scan.py and the fused scan call it, with
    `contig`'s sum_depth_window one higher in the batch that holds it."""
    from coverm_tpu_torch import scan
    from coverm_tpu_torch.ops import sweep as S
    orig = S.compute_depth_stats_sweep

    def bump(d):
        d.sum_depth_window[contig] += 1
        return d

    class Bumped:
        def __init__(self, pending):
            self._p = pending

        def start_fetch(self):
            self._p.start_fetch()

        def result(self):
            return bump(S.resolve_depth(self._p))

    def engine(layout, tids, *args, **kwargs):
        got = orig(layout, tids, *args, **kwargs)
        if not np.any(np.asarray(tids) == contig):
            return got
        return Bumped(got) if kwargs.get("deferred") else bump(got)
    for module in (S, scan):
        module.compute_depth_stats_sweep = engine
    try:
        yield
    finally:
        for module in (S, scan):
            module.compute_depth_stats_sweep = orig


def run_tool(main, argv):
    """(exit code, standard output lines, standard error) of a tool's
    main(argv), its output captured."""
    import io
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue().splitlines(), err.getvalue()


def phase_validate(bams, work, card):
    """Phase 18. Returns the K1 launches of the passing run and the
    kernel's largest error."""
    from coverm_tpu_torch.ops import depth as D
    from coverm_tpu_torch.scripts import validate as V
    from coverm_tpu_torch.synth import write_sorted_bam
    deep = os.path.join(work, "deep.bam")
    write_sorted_bam(deep, n_contigs=2, contig_len=3000, coverage=600, seed=5)
    sparse = os.path.join(work, "sparse.bam")
    sparse_tids, _, _ = write_sorted_bam(sparse, n_contigs=400,
                                         contig_len=300, coverage=1, seed=6)
    paths = [*bams, deep, sparse]
    ins, overflow = [], []
    with kernel_launches(ins), recording(D, "compute_depth_stats_numpy",
                                         overflow, lambda a, k: None):
        (rc, lines, said), launches = counted(lambda: run_tool(
            V.main, [*paths, "--device", "cuda"]))
    for line in lines:
        log(f"[validate] {line}")
    if rc != 0 or len(lines) != len(paths):
        raise SystemExit(f"validate exited {rc}:\n{said[-4000:]}")
    # every contig of the first three BAMs has reads
    for path, line, n in zip(paths, lines,
                             (32, 8, 2, np.unique(sparse_tids).size)):
        if not line.startswith(f"{os.path.basename(path)}: {n} covered "
                               "contigs checked, 0 failures "):
            raise SystemExit(f"validate: {line!r}, {n} observed contigs")
    if not overflow:
        raise SystemExit("validate: the 600x BAM took no histogram overflow "
                         "row (DepthStats.hist_wide)")
    if launches <= 0 or launches != len(ins):
        raise SystemExit(f"validate: {launches} K1 launches, {len(ins)} "
                         "recorded")
    err = max(check_kernel(f"validate launch {i}", x)
              for i, x in enumerate(ins))
    contig = int(sparse_tids[0])
    with perturbed_depth(contig):
        rc, lines, _ = run_tool(V.main, [sparse, "--device", "cuda"])
    want = f"FAIL c{contig}: histogram mean "
    if rc != 1 or not lines or not lines[0].startswith(want):
        raise SystemExit(f"validate did not catch a perturbed depth: exit "
                         f"{rc}, {lines[:2]}")
    log(f"[validate] {len(paths)} BAMs, {launches} K1 launches, exit 0; "
        f"with c{contig}'s depth sum one higher: exit 1, {lines[0]!r}; "
        f"{card}")
    return launches, err


def phase_profile_ingest(bam, n_reads, want_launches, dev, card):
    """Phase 19. Returns the K1 launches and the kernel's largest error,
    and the tool's record."""
    from coverm_tpu_torch.scripts.profile_ingest import profile
    ins, said = [], []
    with kernel_launches(ins):
        res, launches = counted(lambda: profile(bam, 1, dev,
                                                out=said.append))
    for line in said:
        log(f"[profile_ingest] {line}")
    st = res["stages"]
    if st["fused"]["records"] != n_reads:
        raise SystemExit(f"profile_ingest: the fused stage read "
                         f"{st['fused']['records']} records of {n_reads}")
    for key in ("phase1", "bookkeep"):
        if st[key]["records"] != n_reads:
            raise SystemExit(f"profile_ingest: {key} saw "
                             f"{st[key]['records']} records of {n_reads}")
    if st["e2e"]["inflate_launches"] != INFLATE_LAUNCHES["contig"] or \
            st["card_inflate"]["launches"] != st["card_inflate"]["segments"] \
            or st["e2e_stub"]["route"] != "card" \
            or "card_wait_s" not in st["e2e_stub"]:
        raise SystemExit(f"profile_ingest: the card stages launched the "
                         f"inflate {st['e2e']['inflate_launches']} and "
                         f"{st['card_inflate']['launches']} times over "
                         f"{st['card_inflate']['segments']} segments; the "
                         f"stubbed pass: {st['e2e_stub']}")
    if not (st["e2e"]["k1_launches"] == launches == want_launches
            == len(ins)):
        raise SystemExit(f"profile_ingest: the e2e stage launched K1 "
                         f"{st['e2e']['k1_launches']} times ({launches} "
                         f"counted), phase 4 {want_launches}")
    err = max(check_kernel(f"profile_ingest launch {i}", x)
              for i, x in enumerate(ins))
    secs = {k: v["s"] for k, v in st.items()}
    log(f"[profile_ingest] seconds {json.dumps(secs)}; prologue "
        f"{json.dumps(res['prologue_s'])}; {card}")
    return launches, err, res


SCALING_CHILD = "import sys, chip_smoke; sys.exit(chip_smoke.scaling_child())"


def scaling_child():
    """One rank of phase 20 (a child process): scaling_bench's worker on
    sys.argv[1:] with each K1 launch's inputs recorded, then its launch
    count and the kernel's largest error against the plain version, as a
    RANK_RESULT JSON line on standard error."""
    import torch
    from coverm_tpu_torch.ops import sweep_scan as K
    from coverm_tpu_torch.scripts import scaling_bench
    ins = []
    with kernel_launches(ins):
        rc = scaling_bench.main(sys.argv[1:])
    torch.cuda.synchronize()
    launches = K.sweep_scan_launches
    err = max((check_kernel(f"scaling rank launch {i}", x)
               for i, x in enumerate(ins)), default=0)
    log("RANK_RESULT " + json.dumps({"launches": launches,
                                     "recorded": len(ins),
                                     "max_abs_err": err}))
    return rc


def phase_scaling(dev, card):
    """Phase 20. Returns the K1 launches of every rank of both jobs, the
    kernel's largest error and the tool's record."""
    from coverm_tpu_torch.scripts import scaling_bench
    res, stderrs = scaling_bench.run(
        2, 500_000, dev, timeout=300,
        cmd=[sys.executable, "-c", SCALING_CHILD, "--worker"], out=log)
    launches, err = 0, 0
    for said in stderrs:
        got = [json.loads(l.split("RANK_RESULT ", 1)[1])
               for l in said.splitlines() if "RANK_RESULT " in l]
        if len(got) != 1 or got[0]["launches"] <= 0 \
                or got[0]["launches"] != got[0]["recorded"]:
            raise SystemExit(f"scaling_bench: a rank's launches {got}:\n"
                             f"{said[-4000:]}")
        launches += got[0]["launches"]
        err = max(err, got[0]["max_abs_err"])
    if err != 0:
        raise SystemExit(f"scaling_bench: K1 disagrees with its plain "
                         f"version: max_abs_err={err}")
    log(f"[scaling] eff(2) {res['efficiency']} ({res['rps_1proc']} reads/s "
        f"on one rank, {res['rps_2proc']} on two), transport "
        f"{res['transport']}, {res['rank_devices']}, checksum "
        f"{res['checksum']} on both; {card}")
    return launches, err, res


def phase_dp_ab(dev, card):
    """Phase 21. Returns the K1 launches, the kernel's largest error and
    the tool's record."""
    from coverm_tpu_torch.ops.sweep import compute_depth_stats_sweep
    from coverm_tpu_torch.scripts import dp_ab_bench
    ins, said = [], []
    with kernel_launches(ins):
        (res, ra, _), launches = counted(lambda: dp_ab_bench.run(
            100_000, 3, dev, out=said.append))
    for line in said:
        log(f"[dp_ab] {line}")
    layout, samples = dp_ab_bench.make_samples(100_000)
    for s, (t, st, en) in enumerate(samples):
        one = compute_depth_stats_sweep(layout, t, st, en,
                                        trim=dp_ab_bench.TRIM, device=dev)
        for f in dp_ab_bench.FIELDS:
            if not np.array_equal(getattr(ra[s], f), getattr(one, f)):
                raise SystemExit(f"dp_ab: sample {s}'s {f} differs from "
                                 "the single-device engine's")
    if launches <= 0 or launches != len(ins):
        raise SystemExit(f"dp_ab: {launches} K1 launches, {len(ins)} "
                         "recorded")
    err = max(check_kernel(f"dp_ab launch {i}", x)
              for i, x in enumerate(ins))
    log(f"[dp_ab] stacked/thread {res['stacked_over_thread']} "
        f"({res['verdict']}); {card}")
    return launches, err, res


def phase_mesh(lengths, truth, want, dev, card):
    """Phase 13: the contig-sharded mesh sweep at the bench size, and a
    heavy contig that takes the position split. Returns the launches of
    one bench-size pass over four logical shards, the kernel's largest
    error, and the pass's milliseconds against the single-device pass's
    (by grid label)."""
    import torch
    from coverm_tpu_torch.ops.depth import (ReferenceLayout,
                                            compute_depth_stats_numpy)
    from coverm_tpu_torch.ops.sweep import compute_depth_stats_sweep
    from coverm_tpu_torch.parallel.mesh_sweep import (
        compute_depth_stats_sweep_mesh, split_heavy_contigs)
    layout = ReferenceLayout.build(lengths, EE)
    cuda0 = torch.device("cuda", 0)
    grids = {"4 logical shards of cuda:0": [[cuda0] * 4]}
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        grids[f"{n_cards} cards"] = [[torch.device("cuda", i)
                                      for i in range(n_cards)]]

    def single():
        return compute_depth_stats_sweep(layout, *truth, need_hist=True,
                                         trim=TRIM, device=dev)
    ref = single()
    check_stats("mesh: single-device engine", ref, want)
    check_hist("mesh: single-device engine", ref, want)
    single_ms = wall_ms(single, 3)
    err, timings, first_launches = 0, {}, None
    for label, grid in grids.items():
        def run():
            return compute_depth_stats_sweep_mesh(
                layout, *truth, need_hist=True, trim=TRIM, mesh=grid)
        ins = []
        with kernel_launches(ins):
            got = run()
        for lbl, w in (("single-device engine", ref), ("numpy oracle",
                                                         want)):
            check_stats(f"mesh over {label} against the {lbl}", got, w)
            check_hist(f"mesh over {label} against the {lbl}", got, w)
        _, launches = counted(run)
        if launches != len(grid[0]) or len(ins) != launches:
            raise SystemExit(f"mesh over {label}: {launches} K1 launches "
                             f"for {len(grid[0])} shards")
        err = max([err] + [check_kernel(f"mesh {label} shard {i}", x)
                           for i, x in enumerate(ins)])
        ms = wall_ms(run, 3)
        timings[label] = ms
        first_launches = first_launches or launches
        log(f"[mesh] {truth[0].size} blocks over {label}: {launches} K1 "
            f"launches (one a shard, one dispatch), {ms:.3f} ms a pass "
            f"against {single_ms:.3f} ms single-device (host clock, "
            f"routing included); {card}")

    # the heavy contig: phase 4's contig 0 alone over four shards
    sel = truth[0] == 0
    heavy = tuple(a[sel] for a in truth)
    if split_heavy_contigs(*heavy, 4)[5].tolist() != [0]:
        raise SystemExit("mesh: contig 0 alone did not take the split")
    hwant = compute_depth_stats_numpy(layout, *heavy, need_hist=True,
                                      trim=TRIM)
    ins = []
    with kernel_launches(ins):
        got = compute_depth_stats_sweep_mesh(layout, *heavy, need_hist=True,
                                             trim=TRIM, mesh=[[cuda0] * 4])
    check_stats("mesh: split contig 0", got, hwant)
    check_hist("mesh: split contig 0", got, hwant)
    if len(ins) != 4:
        raise SystemExit(f"mesh: split contig 0 launched K1 {len(ins)} "
                         "times over 4 shards")
    err = max([err] + [check_kernel(f"mesh split shard {i}", x)
                       for i, x in enumerate(ins)])
    log(f"[mesh] contig 0 alone ({heavy[0].size} blocks) position-split "
        "over 4 shards: statistics and histogram equal the numpy oracle")
    return first_launches, err, timings, single_ms


def phase_fused_mesh(bam, want, argv, dev, card):
    """Phase 14: the fused scanner dispatching through the mesh
    depth_fn (four logical shards of cuda:0) on the bench BAM. Returns
    its K1 launches and the kernel's largest error."""
    import torch
    from coverm_tpu_torch.cli import build_parser, flag_filter_from_args
    from coverm_tpu_torch.io.fastscan import FusedScanStream
    from coverm_tpu_torch.modes import BamFileSource
    from coverm_tpu_torch.ops.depth import ReferenceLayout
    from coverm_tpu_torch.parallel.mesh_sweep import mesh_depth_fn
    from coverm_tpu_torch.scan import scan_any
    ff = flag_filter_from_args(build_parser().parse_args(argv))
    grid = [[torch.device("cuda", 0)] * 4]

    def run():
        header, payload = BamFileSource(bam).read()
        if not isinstance(payload, FusedScanStream):
            raise SystemExit("fused mesh: the bench BAM did not stream")
        layout = ReferenceLayout.build(header.target_lens, EE)
        return scan_any(header, payload, layout, ff, need_hist=False,
                        trim=TRIM, device=dev, depth_fn=mesh_depth_fn(grid))
    ins = []
    with kernel_launches(ins):
        check_stats("fused mesh", run().depth, want)
    t0 = time.perf_counter()
    scan, launches = counted(run)
    wall = time.perf_counter() - t0
    check_stats("fused mesh", scan.depth, want)
    if launches != len(ins) or launches == 0 or launches % 4:
        raise SystemExit(f"fused mesh: {launches} K1 launches, warm-up "
                         f"{len(ins)}, over 4 shards")
    err = max(check_kernel(f"fused mesh launch {i}", x)
              for i, x in enumerate(ins))
    log(f"[fused mesh] {launches} K1 launches ({launches // 4} dispatches "
        f"x 4 shards), {wall:.3f} s; DepthStats equal phase 4's; {card}")
    return launches, err


RANK_CHILD = "import sys, chip_smoke; sys.exit(chip_smoke.rank_child())"


def rank_child():
    """One rank of phase 15's job (run as a child process): the CLI on
    sys.argv[1:] with each K1 launch's inputs recorded; then its launch
    count and the kernel's largest error against the plain version on
    those inputs, as a RANK_RESULT JSON line on standard error."""
    import torch
    from coverm_tpu_torch.cli import main as cli_main
    from coverm_tpu_torch.ops import sweep_scan as K
    ins = []
    # no CUDA call before cli_main: it sets the rank's card first
    K.sweep_scan_launches = 0
    with kernel_launches(ins):
        rc = cli_main(sys.argv[1:])
    torch.cuda.synchronize()
    launches = K.sweep_scan_launches
    err = max((check_kernel(f"rank launch {i}", x)
               for i, x in enumerate(ins)), default=0)
    log("RANK_RESULT " + json.dumps({"launches": launches,
                                     "recorded": len(ins),
                                     "max_abs_err": err}))
    return rc


def phase_multiprocess(bam, tsv_want, work, card):
    """Phase 15: `python -m coverm_tpu_torch contig` (through rank_child)
    as a two-rank job. Returns the launches of each rank, the kernel's
    largest error, the backend and the job's wall seconds."""
    import socket
    import subprocess

    import torch
    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= 2 else "gloo"
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("COVERM_TPU")}
    env.update(PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p),
        COVERM_TPU_COORDINATOR=f"localhost:{port}",
        COVERM_TPU_NUM_PROCESSES="2")
    outs = [os.path.join(work, f"rank{r}.tsv") for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_CHILD, "contig", "-b", bam, "-m",
         *METHODS, "-o", outs[r]], cwd=root, text=True,
        env={**env, "COVERM_TPU_PROCESS_ID": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(2)]
    try:
        results = [p.communicate(timeout=400) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    launches, err = [], 0
    for r, (p, (_, stderr)) in enumerate(zip(procs, results)):
        if p.returncode != 0:
            raise SystemExit(f"multiprocess: rank {r} exited {p.returncode}:"
                             f"\n{stderr[-4000:]}")
        said = [l for l in stderr.splitlines()
                if f"distributed: rank {r} of 2 over {backend}" in l]
        got = [json.loads(l.split("RANK_RESULT ", 1)[1])
               for l in stderr.splitlines() if "RANK_RESULT " in l]
        if not said or len(got) != 1:
            raise SystemExit(f"multiprocess: rank {r} did not report "
                             f"{backend} and its launches:\n{stderr[-4000:]}")
        res = got[0]
        if res["launches"] <= 0 or res["launches"] != res["recorded"]:
            raise SystemExit(f"multiprocess: rank {r} launches {res}")
        launches.append(res["launches"])
        err = max(err, res["max_abs_err"])
        log(f"[multiprocess] {said[0].strip()}; {res['launches']} K1 "
            f"launches, max_abs_err {res['max_abs_err']}")
    if err != 0:
        raise SystemExit(f"multiprocess: K1 disagrees with its plain "
                         f"version: max_abs_err={err}")
    with open(outs[0], "rb") as f:
        if f.read() != tsv_want:
            raise SystemExit("multiprocess: rank 0's TSV differs from "
                             "phase 4's")
    if os.path.exists(outs[1]):
        raise SystemExit("multiprocess: rank 1 wrote its -o file")
    log(f"[multiprocess] two ranks over {backend} on {n_cards} card(s): "
        f"{wall:.3f} s wall (process start-up included), launches by rank "
        f"{launches}; rank 0's TSV equals phase 4's; {card}")
    return launches, err, backend, wall


def phase_multi_card(bam, tsv_want, work, dev, card):
    """Phase 16, with two or more cards: COVERM_TPU_MESH=1 on the bench
    BAM (its TSV equals phase 4's), and sample-DP over two samples, the
    bench BAM and a second sample of the same contigs at 5x from another
    seed (its TSV equals the plain path's on the CPU, which scans one
    sample after the other). Returns the launches and wall seconds of
    each, the wall seconds of each sample alone on one card
    (COVERM_TPU_MESH=0), and the kernel's largest error."""
    import torch
    from coverm_tpu_torch.synth import write_sorted_bam
    bam2 = os.path.join(work, "bench_5x.bam")
    write_sorted_bam(bam2, coverage=5, seed=2)
    argv = ["contig", "-b", bam, "-m", *METHODS]
    two = ["contig", "-b", bam, bam2, "-m", *METHODS]
    out = {}
    for name, cmd in (("bench", argv),
                      ("bench_5x", ["contig", "-b", bam2, "-m", *METHODS])):
        run_cli(cmd, os.path.join(work, f"{name}_warm.tsv"), dev)
        t0 = time.perf_counter()
        run_cli(cmd, os.path.join(work, f"{name}.tsv"), dev)
        out[f"{name}_one_card_wall_s"] = time.perf_counter() - t0
    single = run_cli(two, os.path.join(work, "two_cpu.tsv"),
                     torch.device("cpu"))
    err = 0
    try:
        for label, mode, cmd, want in (("mesh_cli", "1", argv, tsv_want),
                                       ("sample_dp", "auto", two, single)):
            os.environ["COVERM_TPU_MESH"] = mode
            ins = []
            with kernel_launches(ins):
                run_cli(cmd, os.path.join(work, f"{label}_warm.tsv"), dev)
            t0 = time.perf_counter()
            tsv, launches = counted(lambda: run_cli(
                cmd, os.path.join(work, f"{label}.tsv"), dev))
            wall = time.perf_counter() - t0
            if tsv != want:
                raise SystemExit(f"{label}: TSV differs on "
                                 f"COVERM_TPU_MESH={mode}")
            if launches <= 0 or launches != len(ins):
                raise SystemExit(f"{label}: {launches} K1 launches, "
                                 f"warm-up {len(ins)}")
            err = max([err] + [check_kernel(f"{label} launch {i}", x)
                               for i, x in enumerate(ins)])
            out[label] = launches
            out[f"{label}_wall_s"] = wall
            log(f"[multi-card] {label}: {launches} K1 launches, {wall:.3f} "
                f"s wall; TSV equal; {card}")
    finally:
        os.environ["COVERM_TPU_MESH"] = "0"
    log(f"[multi-card] one card, COVERM_TPU_MESH=0: bench "
        f"{out['bench_one_card_wall_s']:.3f} s, bench_5x "
        f"{out['bench_5x_one_card_wall_s']:.3f} s; {card}")
    return out, err


def bgzf_member(raw, level, strategy):
    """One BGZF member of raw, or None when it would pass 64 KiB."""
    import struct
    import zlib
    c = zlib.compressobj(level, zlib.DEFLATED, -15, 9, strategy)
    body = c.compress(raw) + c.flush()
    if len(body) + 26 > 65536:
        return None
    return struct.pack("<BBBBIBBHBBHH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6,
                       ord("B"), ord("C"), 2, len(body) + 25) + body + \
        struct.pack("<II", zlib.crc32(raw), len(raw))


def adversarial_bgzf(path, level, strategy):
    """A BGZF file whose blocks take every DEFLATE path (empty, one byte,
    runs with overlapping copies, random bytes, DNA text with repeats up
    to 32 KiB back, a 64 KiB block), the empty EOF member last."""
    from coverm_tpu_torch.io.bgzf import BGZF_EOF
    rng = np.random.default_rng(0)
    text = bytes(np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, 9000)])
    raws = [b"", b"\x07", b"A" * 65280, b"xy" * 32640,
            bytes(rng.integers(0, 256, 65280, dtype=np.uint8)),
            (text * 8)[:65280],
            text[:3000] + bytes(rng.integers(0, 256, 30000, dtype=np.uint8))
            + text[:3000], bytes(rng.integers(60, 75, 40000, dtype=np.uint8)),
            b"\x00" * 65536]
    raws += [bytes(rng.integers(0, 3, n, dtype=np.uint8))
             for n in (2, 3, 31, 257, 259, 4096)]
    with open(path, "wb") as f:
        for raw in raws:
            m = bgzf_member(raw, level, strategy)
            if m is not None:
                f.write(m)
        f.write(BGZF_EOF)


def huffman_then_stored_bgzf(path):
    """A BGZF file of blocks that each hold a Huffman-coded block (DNA
    text, literals only) and then stored blocks (a full flush's empty
    one, then 5,000 random bytes): the stored header steps back over the
    bytes in the decoder's bit buffer. The text's length runs over 64
    values, so the Huffman block ends at every offset modulo 16, near the
    end of the staged payload, with more than 4 KiB to follow."""
    import struct
    import zlib
    from coverm_tpu_torch.io.bgzf import BGZF_EOF
    rng = np.random.default_rng(2)
    text = bytes(np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, 13064)])
    tail = bytes(rng.integers(0, 256, 5000, dtype=np.uint8))
    with open(path, "wb") as f:
        for n in range(13000, 13064):
            c = zlib.compressobj(6, zlib.DEFLATED, -15, 9,
                                 zlib.Z_HUFFMAN_ONLY)
            body = c.compress(text[:n]) + c.flush(zlib.Z_FULL_FLUSH) \
                + c.compress(tail) + c.flush()
            raw = text[:n] + tail
            f.write(struct.pack("<BBBBIBBHBBHH", 0x1F, 0x8B, 8, 4, 0, 0,
                                0xFF, 6, ord("B"), ord("C"), 2,
                                len(body) + 25) + body
                    + struct.pack("<II", zlib.crc32(raw), len(raw)))
        f.write(BGZF_EOF)


def byte_err(a, b):
    """The largest absolute difference of two byte arrays; 256 when their
    lengths differ."""
    if a.shape != b.shape:
        return 256
    return int((np.maximum(a, b) - np.minimum(a, b)).max(initial=0))


def plain_inflate(mm, off, csz, usz):
    """The kernel's plain version over one segment's blocks: (bytes, ms
    of the inflate)."""
    import torch
    from coverm_tpu_torch.ops import bgzf_inflate as B
    comp = np.concatenate([np.ascontiguousarray(mm[off[0]:off[-1] + csz[-1]]),
                           np.zeros(B.PAD, np.uint8)])
    table = B.block_table(comp, off - off[0], csz, usz)
    out = torch.empty(int(usz.sum()), dtype=torch.uint8)
    status = torch.empty(off.size, dtype=torch.int32)
    t0 = time.perf_counter()
    B.bgzf_inflate_reference(torch.from_numpy(comp), torch.from_numpy(table),
                             out, status)
    ms = (time.perf_counter() - t0) * 1e3
    if status.any():
        raise SystemExit("the plain inflate failed on phase 4's BAM")
    return out.numpy(), ms


def corrupt_members():
    """(label, member, ISIZE) of blocks the inflate must reject."""
    import struct
    rng = np.random.default_rng(1)
    raw = bytes(rng.integers(0, 4, 20000, dtype=np.uint8) + 65)
    good = bgzf_member(raw, 6, 0)
    bad_type = bytearray(good)
    bad_type[18] |= 0x06
    body = good[18:-8][:(len(good) - 26) // 2]
    cut = good[:16] + struct.pack("<H", len(body) + 25) + body + good[-8:]
    # fixed Huffman: 'A', then a match at distance 2 after one byte
    bits = [1, 1, 0] + [(0x71 >> (7 - i)) & 1 for i in range(8)] + \
        [0] * 6 + [1] + [0] * 4 + [1] + [0] * 7
    acc = sum(b << i for i, b in enumerate(bits))
    body = acc.to_bytes((len(bits) + 7) // 8, "little")
    far = good[:16] + struct.pack("<H", len(body) + 25) + body + \
        struct.pack("<II", 0, 4)
    return [("block type 3", bytes(bad_type), len(raw)),
            ("payload cut short", cut, len(raw)),
            ("distance too far back", far, 4),
            ("ISIZE one more", good, len(raw) + 1),
            ("ISIZE one less", good, len(raw) - 1),
            ("ISIZE over 65536", bgzf_member(b"\x00" * 70000, 9, 0), 70000)]


def inflate_on_card(comp, table, out_size, dev):
    """The kernel over one block table, pinned buffers in and out, the
    output at an unaligned address: (bytes, status)."""
    import torch
    from coverm_tpu_torch.ops import bgzf_inflate as B
    pad = np.zeros(B.PAD, np.uint8)
    comp_t = torch.from_numpy(np.concatenate([comp, pad])).pin_memory()
    out = torch.zeros(out_size + 8, dtype=torch.uint8).pin_memory()
    status = torch.full((table.shape[0],), -1,
                        dtype=torch.int32).pin_memory()
    B.bgzf_inflate(comp_t, torch.from_numpy(table).pin_memory(),
                   out[3:3 + out_size], status, dev)
    torch.cuda.synchronize()
    return out.numpy()[3:3 + out_size], status.numpy()


def reblock_bgzf(src, dst, level):
    """src's BGZF blocks, each inflated and compressed again at zlib
    `level` with the same bytes a block, into dst."""
    from concurrent.futures import ThreadPoolExecutor
    from coverm_tpu_torch.io import native
    from coverm_tpu_torch.io.bgzf import BGZF_EOF, compress_block
    data = np.fromfile(src, np.uint8)
    off, csz, usz = native.bgzf_scan(data)
    raw = native.bgzf_inflate_blocks(data, off, csz, usz).tobytes()
    cut = np.concatenate(([0], np.cumsum(usz)))
    with open(dst, "wb") as f, ThreadPoolExecutor(os.cpu_count()) as ex:
        for block in ex.map(lambda b: compress_block(
                raw[cut[b]:cut[b + 1]], level), range(off.size)):
            f.write(block)
        f.write(BGZF_EOF)


def phase_inflate_design(bam, work, dev):
    """Phase 22, the kernel's design: its shared bytes a CTA and CTAs an
    SM, and its time segment by segment (scripts/inflate_ab.py, on the
    card's memory too) on phase 4's BAM (zlib level 1, as the
    benchmark's BAMs), its blocks at level 6 (zlib's default, which
    samtools and htslib write unless told otherwise) and a demo-shaped
    sample (bench_torch/synth.py) whose unmapped reads fill segments of
    their own. Returns what the kernels line carries."""
    from bench_torch import synth as demo_synth
    from coverm_tpu_torch.ops import bgzf_inflate as B
    from coverm_tpu_torch.scripts import inflate_ab
    smem, ctas = B.occupancy(dev)
    level6 = os.path.join(work, "bench_level6.bam")
    reblock_bgzf(bam, level6, 6)
    demo = os.path.join(work, "demo.bam")
    demo_synth.write_bam(demo, demo_synth.demo(INFLATE_DEMO_READS, seed=0))
    launch = inflate_ab.launchers(["kernel", "kernel@card"])
    runs = {name: inflate_ab.run_bam(path, launch, dev) for name, path in
            (("level1", bam), ("level6", level6), ("demo", demo))}
    for name, r in runs.items():
        log(f"[inflate design] {name}: {json.dumps(r)}")
    os.remove(level6)
    os.remove(demo)
    return {"smem_bytes": smem, "ctas_per_sm": ctas, "runs": runs}


def phase_inflate(bam, work, dev, card):
    """Phase 22: the inflate kernel against the host's ct_bgzf_inflate on
    the adversarial streams and on phase 4's BAM segment by segment,
    corrupt blocks flagged and raised, timed beside a pinned d2h copy.
    Returns the kernels-line entry's measured numbers."""
    import torch
    import zlib
    from coverm_tpu_torch.flags import FlagFilter
    from coverm_tpu_torch.io import native
    from coverm_tpu_torch.io.bam import BamFormatError
    from coverm_tpu_torch.io.fastscan import (_CARD_HEADROOM,
                                              FusedScanStream, plan_segments,
                                              scan_sample_fused)
    from coverm_tpu_torch.ops import bgzf_inflate as B
    from coverm_tpu_torch.ops.depth import ReferenceLayout
    from coverm_tpu_torch.ops.sweep import _EmptyPending
    from coverm_tpu_torch.synth import write_sorted_bam

    adversarial = []
    for level, strategy in INFLATE_STREAMS:
        path = os.path.join(work, f"adv_{level}_{strategy}.gz")
        adversarial_bgzf(path, level, strategy)
        adversarial.append((f"level {level}, strategy {strategy}", path))
    path = os.path.join(work, "adv_huffman_then_stored.gz")
    huffman_then_stored_bgzf(path)
    adversarial.append(("Huffman then stored blocks", path))
    err = 0
    for label, path in adversarial:
        data = np.fromfile(path, np.uint8)
        off, csz, usz = native.bgzf_scan(data)
        got, status = inflate_on_card(data, B.block_table(data, off, csz, usz),
                                      int(usz.sum()), dev)
        want = native.bgzf_inflate_blocks(data, off, csz, usz)
        if status.any() or byte_err(got, want):
            raise SystemExit(f"inflate kernel differs from ct_bgzf_inflate "
                             f"on {label}: {int(status.astype(bool).sum())} "
                             f"blocks failed, max_abs_err "
                             f"{byte_err(got, want)}")
    for label, m, size in corrupt_members():
        comp = np.frombuffer(m, np.uint8)
        table = B.block_table(comp, [0], [len(m)], [size])
        _, status = inflate_on_card(comp, table, size, dev)
        if not status[0]:
            raise SystemExit(f"inflate kernel took a corrupt block: {label}")
        d = zlib.decompressobj(-15)
        try:
            ok = len(d.decompress(m[18:-8], size + 1)) == size and d.eof \
                and size <= B.MAX_BLOCK
        except zlib.error:
            ok = False
        if ok:
            raise SystemExit(f"corrupt case {label} is not corrupt")
    log(f"[inflate] kernel equals ct_bgzf_inflate on "
        f"{len(adversarial)} adversarial streams; "
        f"{len(corrupt_members())} corrupt blocks flagged")

    # a corrupt block inside a BAM raises through the card route
    small = os.path.join(work, "inflate_small.bam")
    write_sorted_bam(small, n_contigs=4, contig_len=100_000, seed=4)
    data = np.fromfile(small, np.uint8)
    off, csz, _ = native.bgzf_scan(data)
    b = off.size - 3
    data[off[b] + 18] |= 0x06
    bad = os.path.join(work, "inflate_corrupt.bam")
    data.tofile(bad)
    stream = FusedScanStream(bad, target_bytes=1 << 20)
    header = stream.open()
    before = B.bgzf_inflate_launches
    try:
        scan_sample_fused(
            header, stream, ReferenceLayout.build(header.target_lens, EE),
            FlagFilter(), False, device=dev,
            depth_fn=lambda lay, *a, **k: _EmptyPending(lay.n_contigs, False,
                                                        None))
        raise SystemExit("the card route took a corrupt BGZF block")
    except BamFormatError as e:
        if str(e) != B.FAILED or B.bgzf_inflate_launches == before:
            raise SystemExit(f"the card route raised {e!r}")

    # phase 4's BAM, segment by segment as the main path inflates it
    stream = FusedScanStream(bam)
    stream.open()
    mm, off, csz, usz, _carry, j = stream._plan
    segments = plan_segments(usz, j, stream.target_bytes)
    # each segment's bytes against ct_bgzf_inflate's and the plain
    # version's on the same blocks
    inf = B.SegmentInflater(bam, off, csz, usz, segments, _CARD_HEADROOM,
                            dev)
    total, payload, plain_ms = 0, 0, 0.0
    try:
        inf.start(0)
        for k, (i, e) in enumerate(segments):
            if k + 1 < len(segments):
                inf.start(k + 1)
            slot, lo, hi = inf.take(k)
            got = slot[lo:hi].cpu().numpy()
            del slot
            want = native.bgzf_inflate_blocks(mm, off[i:e], csz[i:e],
                                              usz[i:e])
            plain, ms = plain_inflate(mm, off[i:e], csz[i:e], usz[i:e])
            plain_ms += ms
            seg_err = max(byte_err(got, want), byte_err(got, plain))
            if seg_err:
                raise SystemExit(f"inflate kernel differs from ct_bgzf_"
                                 f"inflate or its plain version on segment "
                                 f"{k}: max_abs_err {seg_err}")
            err = max(err, seg_err)
            total += hi - lo
            payload += int(csz[i:e].sum()) - 26 * (e - i)
    finally:
        inf.close()
    kernel_ms = sum(inf.kernel_ms)
    # bytes the function must move: payloads and table in, bytes and
    # status out
    moved = payload + total + (32 + 4) * int(off.size - j)
    bound_ms = moved / H100_BYTES_PER_S * 1e3
    link_ms = moved / PCIE_GEN5_X16_BYTES_PER_S * 1e3

    # the host link's practical rate: a 256 MiB copy to pinned memory
    src = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    dst = torch.empty(256 << 20, dtype=torch.uint8, pin_memory=True)
    d2h = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        dst.copy_(src, non_blocking=True)
        b.record()
        b.synchronize()
        d2h.append(a.elapsed_time(b))
    d2h_ms = float(np.median(d2h))
    del src, dst
    log(f"[inflate] phase 4's BAM: {total} bytes in {len(segments)} "
        f"segments of {off.size - j} blocks, equal to ct_bgzf_inflate; "
        f"kernel {kernel_ms:.3f} ms ({total / kernel_ms / 1e6:.3f} GB/s), "
        f"a segment {[round(x, 3) for x in inf.kernel_ms]} ms; "
        f"plain version {plain_ms:.1f} ms; max_abs_err {err}; "
        f"bound {bound_ms:.4f} ms (HBM), {link_ms:.3f} ms (host link)")
    log(f"[inflate] 256 MiB pinned d2h copy {d2h_ms:.3f} ms, "
        f"{(256 << 20) / d2h_ms / 1e6:.3f} GB/s; {card}")
    return {"ms": kernel_ms, "segment_ms": inf.kernel_ms, "plain_ms": plain_ms,
            "max_abs_err": err,
            "bound_ms": bound_ms, "link_bound_ms": link_ms,
            "gb_per_s": total / kernel_ms / 1e6, "bytes": total,
            "segments": len(segments), "pinned_bytes": inf.pinned_bytes,
            "d2h_256mib_ms": d2h_ms,
            "d2h_gb_per_s": (256 << 20) / d2h_ms / 1e6}


def scan_outcome(sc, n_ref):
    """A record scan's outcome as the card route adds it (the CPU tests'
    tests/test_torch_bam_scan.outcome_scan)."""
    from test_torch_bam_scan import outcome_scan
    return outcome_scan(sc, n_ref)


def scan_same(label, got, want):
    """Raise unless two scan outcomes are equal, field by field (the
    float64 sums bit for bit); returns the largest absolute difference of
    their blocks (0)."""
    from test_torch_bam_scan import assert_same
    try:
        assert_same(got, want)
    except AssertionError as e:
        raise SystemExit(f"record scan: {label} differs: {e}") from None
    return 0


def speculate_same(label, on_card, host, start, end, n_ref, min_bs):
    """Raise unless the speculate on the card (ops/bam_scan.speculate)
    gives its plain version's first, exit_, cnt and starts on the same
    bytes; returns their largest absolute difference (0) and the plain
    version's ms."""
    import torch
    from coverm_tpu_torch.ops import bam_scan as S
    got = S.speculate(on_card, start, end, n_ref, min_bs)
    t0 = time.perf_counter()
    want = S.speculate_reference(torch.from_numpy(host), start, end, n_ref,
                                 min_bs)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = 0
    pairs = list(zip(got[:3], want[:3])) + list(zip(got[3], want[3]))
    if len(got[3]) != len(want[3]) or any(g.shape != w.shape
                                          for g, w in pairs):
        raise SystemExit(f"speculate: {label} (min_bs {min_bs}): the "
                         "regions' starts differ in number")
    for g, w in pairs:
        err = max(err, int(np.abs(g.astype(np.int64) - w).max(initial=0)))
    if err:
        raise SystemExit(f"speculate: {label} (min_bs {min_bs}) differs "
                         f"from its plain version by {err}")
    return float(err), plain_ms


def scan_err(a, b):
    """The largest absolute difference of two record scans' blocks and
    runs (the integer words, and the float64 sums as values); 2**31 when
    their lengths differ."""
    pairs = [(a.btid, b.btid), (a.bstart, b.bstart), (a.bend, b.bend),
             (a.runs[:, :7], b.runs[:, :7])]
    if any(x.shape != y.shape for x, y in pairs) or \
            a.runs.shape != b.runs.shape:
        return float(1 << 31)
    sums = [np.ascontiguousarray(r[:, 7:]).view(np.float64)
            for r in (a.runs, b.runs)]
    return float(max([int(np.abs(x.astype(np.int64) - y).max(initial=0))
                      for x, y in pairs]
                     + [float(np.abs(sums[0] - sums[1]).max(initial=0.0))]))


def phase_scan(bam, metabat_bam, dev, card):
    """Phase 23: the record scan's kernels against the host's stats_scan
    and their plain version, on the CPU tests' adversarial streams, on
    phase 4's BAM segment by segment as the main path hands them over (the
    inflate's card slot, the carry before it) and on phase 17's 32 MiB
    metabat segments under its filter. Returns the kernels-line entry's
    measured numbers."""
    import torch
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    import test_torch_bam_scan as T
    import test_torch_bam_speculate as J
    from coverm_tpu_torch.flags import FlagFilter
    from coverm_tpu_torch.io.fastscan import (_CARD_HEADROOM,
                                              FusedScanStream, plan_segments)
    from coverm_tpu_torch.ops import bam_scan as S
    from coverm_tpu_torch.ops import bgzf_inflate as B
    from coverm_tpu_torch.readfilter import FilterParams

    # the adversarial streams, unfiltered and under metabat's filter
    rf_metabat = FilterParams(min_percent_identity_single=0.97001)
    n_streams = 0
    err = spec_err = 0.0  # the kernels against the plain version
    streams = {**T.STREAMS,
               **{"join_" + k: v for k, v in J.JOIN_STREAMS.items()}}
    for name in sorted(streams):
        data = streams[name]()
        on_card = torch.from_numpy(data).to(dev)
        for min_bs in (S.SCAN_MIN_BS, S.PARSE_MIN_BS):
            spec_err = max(spec_err, speculate_same(
                name, on_card, data, 0, data.size, T.N_REF, min_bs)[0])
        for rf in (None, rf_metabat):
            want = T.outcome_host(data, 0, data.size, T.N_REF, rf)
            sc = S.scan_segment(on_card, 0, data.size, T.N_REF, T.SKIP,
                                T.REQ, rf)
            plain = S.bam_scan_reference(torch.from_numpy(data), 0,
                                         data.size, T.N_REF, T.SKIP, T.REQ,
                                         rf)
            scan_same(f"{name} (kernels)", scan_outcome(sc, T.N_REF), want)
            scan_same(f"{name} (plain)", scan_outcome(plain, T.N_REF), want)
            err = max(err, scan_err(sc, plain))
            if not np.array_equal(sc.stitch[:4], plain.stitch[:4]):
                raise SystemExit(f"record scan: {name}'s stitch differs from "
                                 "the plain version's")
            if not np.array_equal(sc.chunks, plain.chunks):
                raise SystemExit(f"record scan: {name}'s chunk words differ "
                                 "from the plain version's")
            # the stitch's check stops at the first forged region, and
            # settles the plain stream whole
            walk_from = {**T.FORGED, "sorted": [0]}.get(name, [None])[0]
            if walk_from is not None and sc.stitch[6] != walk_from:
                raise SystemExit(f"record scan: {name}'s stitch walked from "
                                 f"region {sc.stitch[6]}, not {walk_from}")
            n_streams += 1
    log(f"[scan] kernels equal ct_stats_scan and the plain version on "
        f"{n_streams} adversarial streams and filters; the speculate its "
        f"plain version on {len(streams)} streams at min_bs 33 and 32")

    def segments_of(path, seg_bytes, rf, plain):
        """Each segment of `path` through the kernels (timed), the host
        scan and (plain) the plain version, as card_blocks hands them
        over."""
        nonlocal err, spec_err
        stream = FusedScanStream(path, seg_bytes)
        header = stream.open()
        mm, off, csz, usz, carry, j = stream._plan
        segments = plan_segments(usz, j, stream.target_bytes)
        skip, req = (FlagFilter(include_improper_pairs=True,
                                include_supplementary=True,
                                include_secondary=True) if rf is not None
                     else FlagFilter()).masks()
        inf = B.SegmentInflater(path, off, csz, usz, segments,
                                _CARD_HEADROOM, dev)
        rec = {"ms": 0.0, "step_ms": {}, "plain_ms": 0.0, "bytes": 0,
               "read": 0, "written": 0, "blocks": 0, "records": 0,
               "walked": 0, "in_sequence": 0, "segments": 0,
               "spec_bytes": 0, "regions": 0, "fold_written": 0,
               "plain_step_ms": {"speculate": 0.0, "records": 0.0}}
        carry = torch.from_numpy(np.ascontiguousarray(carry)).to(dev) \
            if carry is not None and len(carry) else None
        try:
            inf.start(0)
            for k in range(len(segments)):
                if k + 1 < len(segments):
                    inf.start(k + 1)
                slot, lo, hi = inf.take(k, carry)
                torch.cuda.synchronize()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                sc = S.scan_segment(slot, lo, hi, header.n_ref, skip, req,
                                    rf, timing=True)
                b.record()
                b.synchronize()
                rec["ms"] += a.elapsed_time(b)
                for key, v in sc.timing.items():
                    rec["step_ms"][key] = rec["step_ms"].get(key, 0.0) + v
                host = slot.cpu().numpy()
                want = T.outcome_host(host, lo, hi, header.n_ref, rf)
                scan_same(f"{path} segment {k}",
                          scan_outcome(sc, header.n_ref), want)
                if plain:
                    t0 = time.perf_counter()
                    p = S.bam_scan_reference(torch.from_numpy(host), lo, hi,
                                             header.n_ref, skip, req, rf)
                    rec["plain_ms"] += (time.perf_counter() - t0) * 1e3
                    scan_same(f"{path} segment {k} (plain)",
                              scan_outcome(p, header.n_ref), want)
                    err = max(err, scan_err(sc, p))
                    rec["read"] += S.bytes_read(torch.from_numpy(host), lo,
                                                hi, header.n_ref, skip, req,
                                                rf)
                    for min_bs in (S.SCAN_MIN_BS, S.PARSE_MIN_BS):
                        e, ms = speculate_same(f"{path} segment {k}", slot,
                                               host, lo, hi, header.n_ref,
                                               min_bs)
                        spec_err = max(spec_err, e)
                        if min_bs == S.SCAN_MIN_BS:
                            rec["plain_step_ms"]["speculate"] += ms
                    ht = torch.from_numpy(host)
                    rec["spec_bytes"] += S.chain_bytes(ht, lo, hi,
                                                       header.n_ref)
                    # the records step's plain version alone (analyse and
                    # emit over the plain chain's starts)
                    off = torch.from_numpy(S._chain(ht, lo, hi,
                                                    header.n_ref)[0])
                    t0 = time.perf_counter()
                    pa = S._analyse(ht, off, header.n_ref, skip, req, rf)
                    S._emit(ht, off, pa[1], pa[6])
                    rec["plain_step_ms"]["records"] += \
                        (time.perf_counter() - t0) * 1e3
                rec["bytes"] += hi - lo
                rec["written"] += 12 * sc.btid.size + 8 * sc.runs.size \
                    + 8 * sc.chunks.size
                rec["blocks"] += sc.btid.size
                rec["records"] += sc.n_records
                rec["regions"] += -(-(hi - lo) // S.REGION)
                rec["fold_written"] += 8 * (sc.runs.size + sc.chunks.size)
                rec["walked"] += sc.regions_walked
                rec["in_sequence"] += sc.regions_in_sequence
                rec["segments"] += 1
                carry = sc.tail
                del slot
        finally:
            inf.close()
        return rec

    main = segments_of(bam, None, None, plain=True)
    mb = segments_of(metabat_bam, METABAT_SEGMENT_BYTES, rf_metabat,
                     plain=False)
    # bytes the function must move: the 32-byte sectors that hold what a
    # scan has to read (each record's fixed fields, and the CIGAR and the
    # aux tags up to NM of each record the flags let through; not the
    # names, sequences and qualities), read once, and the blocks, runs and
    # chunk words written once
    bound_ms = (main["read"] + main["written"]) / H100_BYTES_PER_S * 1e3
    all_ms = (main["bytes"] + main["written"]) / H100_BYTES_PER_S * 1e3
    # by step: the speculate the sectors that hold each record's
    # block_size and its starts and region words written; the stitch's
    # check and walk each region's three words read and four written; the
    # records step (analyse and emit) the sectors the scan has to read and
    # 12 bytes a block written; the fold 33 bytes a record read (flags,
    # tid, nblk, nm, ind, idv) and the runs and chunk words written
    step_bound_ms = {k: v / H100_BYTES_PER_S * 1e3 for k, v in {
        "speculate": main["spec_bytes"],
        "stitch": 44 * main["regions"],
        "records": main["read"] + 12 * main["blocks"],
        "fold": 33 * main["records"] + main["fold_written"]}.items()}
    log(f"[scan] phase 4's BAM: {main['segments']} segments, "
        f"{main['records']} records, {main['blocks']} blocks, equal to "
        f"ct_stats_scan and the plain version (max_abs_err {err}); "
        f"kernels {main['ms']:.3f} ms "
        f"(steps {json.dumps(main['step_ms'])}), {main['in_sequence']} "
        f"regions walked in sequence after the stitch's check, "
        f"{main['walked']} of them walked again; plain version "
        f"{main['plain_ms']:.1f} "
        f"ms (by step {json.dumps(main['plain_step_ms'])}); bound "
        f"{bound_ms:.4f} ms (bytes: {main['read']} read of "
        f"{main['bytes']} inflated, {main['written']} written; every "
        f"inflated byte read would be {all_ms:.4f} ms; by step "
        f"{json.dumps(step_bound_ms)}); the speculate equal to its plain "
        f"version on every segment (max_abs_err {spec_err})")
    log(f"[scan] phase 17's metabat BAM: {mb['segments']} segments of "
        f"{METABAT_SEGMENT_BYTES} bytes under the filter, equal to "
        f"ct_stats_scan; kernels {mb['ms']:.3f} ms (steps "
        f"{json.dumps(mb['step_ms'])}), {mb['in_sequence']} regions walked "
        f"in sequence; {card}")
    return {"ms": main["ms"], "step_ms": main["step_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": bound_ms,
            "step_bound_ms": step_bound_ms,
            "plain_step_ms": main["plain_step_ms"],
            "max_abs_err": max(err, spec_err),
            "speculate_max_abs_err": spec_err, "bytes": main["bytes"],
            "bytes_read": main["read"], "bytes_written": main["written"],
            "blocks": main["blocks"], "records": main["records"],
            "regions_walked": main["walked"],
            "regions_in_sequence": main["in_sequence"],
            "segments": main["segments"],
            "metabat_segments": mb["segments"], "metabat_ms": mb["ms"],
            "metabat_step_ms": mb["step_ms"],
            "metabat_regions_in_sequence": mb["in_sequence"],
            "streams": n_streams}


def parse_outcome(fn):
    """A parse's outcome, as the CPU tests take it
    (tests/test_torch_bam_parse.outcome_parse)."""
    from test_torch_bam_parse import outcome_parse
    return outcome_parse(fn)


def parse_same(label, got, want):
    """Raise unless two parse outcomes are equal, column for column and
    type for type, or the same exception and message."""
    from test_torch_bam_parse import assert_same
    try:
        assert_same(got, want)
    except AssertionError as e:
        raise SystemExit(f"record parse: {label} differs: {e}") from None


def parse_err(a, b):
    """The largest absolute difference of two parses' integer columns
    (the hash's bits as int64); 2**63 when their shapes differ."""
    err = 0
    for k, v in a.columns.items():
        w = b.columns[k]
        if v.shape != w.shape or v.dtype != w.dtype:
            return float(1 << 63)
        x, y = v.view(np.int64) if v.dtype == np.uint64 else v, \
            w.view(np.int64) if w.dtype == np.uint64 else w
        if x.size:
            err = max(err, int(np.abs(x.astype(np.int64)
                                      - y.astype(np.int64)).max()))
    return float(err)


def bam_file(path, records, n_ref, block=4000):
    """A BGZF BAM of raw record bytes under a header of n_ref contigs."""
    from coverm_tpu_torch.io import bgzf
    from coverm_tpu_torch.io.sam import sam_text_to_bam_data
    head = sam_text_to_bam_data(iter(
        [f"@SQ\tSN:t{i}\tLN:1000000" for i in range(n_ref)]))
    data = bytes(head) + bytes(records)
    with open(path, "wb") as f:
        for o in range(0, len(data), block):
            f.write(bgzf.compress_block(data[o:o + block], 1))
        f.write(bgzf.BGZF_EOF)
    return path


def phase_parse(bam, work, dev, card, d2h_gb_per_s):
    """Phase 24: the record parse's kernels against the host's parse
    (io/bam.parse_records: parse_records_full) and their plain version,
    on the CPU tests' streams (tests/test_torch_bam_parse.py), six
    corrupt ones also written as BAMs and read through the reader's card
    route against its host route; then on phase 4's BAM segment by
    segment as the reader hands them over (the inflate's card slot after
    the carry, the header parsed on the host from the first segment),
    without the bytes and with them: every column and the carry against
    the host parse and the plain version, timed by step, the card's peak
    around each parse. Returns the kernels-line entry's measured
    numbers."""
    import torch
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    import test_torch_bam_parse as T
    from coverm_tpu_torch.io import bam as IB
    from coverm_tpu_torch.io import native
    from coverm_tpu_torch.io.fastscan import _CARD_HEADROOM, plan_segments
    from coverm_tpu_torch.ops import bam_scan as S
    from coverm_tpu_torch.ops import bgzf_inflate as B

    err, n_streams, refused = 0.0, 0, []
    for name in sorted(T.STREAMS):
        data = T.STREAMS[name]()
        want = T.outcome_host(data, 0, data.size)
        on_card = torch.from_numpy(data).to(dev)
        got = parse_outcome(lambda: S.parse_segment(on_card, 0, data.size,
                                                    T.N_REF))
        plain = parse_outcome(lambda: S.bam_parse_reference(
            torch.from_numpy(data), 0, data.size, T.N_REF))
        parse_same(f"{name} (kernels)", got, want)
        parse_same(f"{name} (plain)", plain, want)
        bare = parse_outcome(lambda: S.parse_segment(
            on_card, 0, data.size, T.N_REF, keep_bytes=False))
        parse_same(f"{name} (kernels, no bytes)", bare, want)
        if isinstance(want[0], str):
            refused.append(name)
        else:
            err = max(err, parse_err(S.ParsedSegment(got[0], got[1], None),
                                     S.ParsedSegment(plain[0], plain[1],
                                                     None)))
        n_streams += 1
    # corrupt records through the reader's card route: the host route's
    # exception and message
    for name in refused[:6]:
        path = bam_file(os.path.join(work, f"bad_{name}.bam"),
                        T.STREAMS[name](), T.N_REF)
        said = []
        for where in (dev, "cpu"):
            try:
                _, gen = IB.BamStreamReader(path, target_bytes=1 << 16,
                                            device=where).read()
                for _ in gen:
                    pass
                said.append(None)
            except Exception as e:  # the class is part of the outcome
                said.append((type(e).__name__, str(e)))
        if said[0] is None or said[0] != said[1]:
            raise SystemExit(f"record parse: {name} through the card route "
                             f"gave {said[0]}, the host route {said[1]}")
    # a corrupt BGZF block (phase 22's, a block type 3) through the
    # reader's card route: the host route's error
    from coverm_tpu_torch.synth import write_sorted_bam
    small = os.path.join(work, "parse_small.bam")
    write_sorted_bam(small, n_contigs=4, contig_len=100_000, seed=4)
    data = np.fromfile(small, np.uint8)
    off, _, _ = native.bgzf_scan(data)
    data[off[off.size - 3] + 18] |= 0x06
    bad = os.path.join(work, "parse_corrupt_block.bam")
    data.tofile(bad)
    said = []
    for where in (dev, "cpu"):
        try:
            for _ in IB.BamStreamReader(bad, target_bytes=1 << 20,
                                        device=where).read()[1]:
                pass
            said.append(None)
        except IB.BamFormatError as e:
            said.append(str(e))
    if said[0] is None or said[0] != said[1]:
        raise SystemExit(f"record parse: a corrupt block through the card "
                         f"route gave {said[0]!r}, the host route "
                         f"{said[1]!r}")
    log(f"[parse] kernels equal parse_records_full and the plain version on "
        f"{n_streams} streams ({len(refused)} refused with the host's "
        f"message); {min(6, len(refused))} corrupt BAMs and a corrupt BGZF "
        f"block raise the host route's error through the reader's card "
        f"route")

    # phase 4's BAM as the reader hands it over, each segment parsed as
    # `--gff` parses it (no bytes kept: the columns and the carry back)
    # and as the pair filters do (the slot's bytes back too)
    mm = np.memmap(bam, np.uint8, mode="r")
    off, csz, usz = native.bgzf_scan(mm)
    segments = plan_segments(usz, 0, 1 << 28)
    inf = B.SegmentInflater(bam, off, csz, usz, segments, _CARD_HEADROOM,
                            dev)
    routes = {"bare": False, "kept": True}
    rec = {"plain_ms": 0.0, "bytes": 0, "read": 0, "written": 0,
           "records": 0, "blocks": 0, "segments": 0, "launches": 0,
           "copies": 0, "spec_bytes": 0, "regions": 0,
           "spec_plain_ms": 0.0}
    spec_err = 0.0
    rec.update({r: {"ms": 0.0, "step_ms": {}, "back": 0, "peak": 0,
                    "above": 0} for r in routes})
    carry, n_ref = None, None
    try:
        inf.start(0)
        for k in range(len(segments)):
            if k + 1 < len(segments):
                inf.start(k + 1)
            slot, lo, hi = inf.take(k, carry)
            torch.cuda.synchronize()
            host = slot.cpu().numpy()
            start = lo
            if n_ref is None:
                header, hdr = IB._parse_header(host[lo:hi])
                n_ref, start = header.n_ref, lo + hdr
            want = T.outcome_host(host, start, hi)
            if not isinstance(want[0], str):
                want = ({**want[0], "rec_start": want[0]["rec_start"] - lo,
                         "rec_end": want[0]["rec_end"] - lo},
                        want[1] - lo)
            for route, keep in routes.items():
                r = rec[route]
                torch.cuda.synchronize()
                resident = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                before = S.bam_parse_launches
                copies = S._PINNED.copies
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                ps = S.parse_segment(slot, start, hi, n_ref, timing=True,
                                     base=lo, keep_bytes=keep)
                b.record()
                b.synchronize()
                peak = torch.cuda.max_memory_allocated(dev)
                r["peak"] = max(r["peak"], peak)
                r["above"] = max(r["above"], peak - resident)
                rec["launches"] += S.bam_parse_launches - before
                rec["copies"] += S._PINNED.copies - copies
                r["ms"] += a.elapsed_time(b)
                for key, v in ps.timing.items():
                    r["step_ms"][key] = r["step_ms"].get(key, 0.0) + v
                parse_same(f"{bam} segment {k} ({route})",
                           (ps.columns, ps.end_off), want)
                end_off = lo + ps.end_off
                if not np.array_equal(ps.tail, host[end_off:hi]):
                    raise SystemExit(f"record parse: segment {k}'s carry "
                                     f"came back changed ({route})")
                if keep and not np.array_equal(ps.data, host[lo:hi]):
                    raise SystemExit(f"record parse: segment {k}'s bytes "
                                     "came back changed")
                if not keep and ps.data is not None:
                    raise SystemExit(f"record parse: segment {k} came "
                                     "back with its bytes unasked")
                n_blocks = ps.columns["block_read"].size
                r["back"] += S.arena_layout(
                    ps.n_records, n_blocks,
                    0 if keep else hi - end_off)[1] + (hi - lo if keep
                                                       else 0)
            t0 = time.perf_counter()
            p = S.bam_parse_reference(torch.from_numpy(host), start, hi,
                                      n_ref, base=lo)
            rec["plain_ms"] += (time.perf_counter() - t0) * 1e3
            parse_same(f"{bam} segment {k} (plain)", (p.columns, p.end_off),
                       want)
            err = max(err, parse_err(ps, p))
            rec["read"] += S.parse_bytes_read(torch.from_numpy(host), start,
                                              hi, n_ref)
            e, ms = speculate_same(f"{bam} segment {k}", slot, host, start,
                                   hi, n_ref, S.PARSE_MIN_BS)
            spec_err = max(spec_err, e)
            rec["spec_plain_ms"] += ms
            rec["spec_bytes"] += S.chain_bytes(torch.from_numpy(host), start,
                                               hi, n_ref, S.PARSE_MIN_BS)
            rec["regions"] += -(-(hi - start) // S.REGION)
            rec["written"] += S.PARSE_RECORD_BYTES * ps.n_records \
                + S.PARSE_BLOCK_BYTES * n_blocks
            rec["bytes"] += hi - start
            rec["records"] += ps.n_records
            rec["blocks"] += n_blocks
            rec["segments"] += 1
            carry = ps.tail
            del slot, ps
    finally:
        inf.close()
    if rec["launches"] != 2 * rec["segments"]:
        raise SystemExit(f"record parse: {rec['launches']} launches over "
                         f"{rec['segments']} segments parsed twice")
    if rec["copies"] != 3 * rec["segments"]:
        raise SystemExit(f"record parse: {rec['copies']} copies back over "
                         f"{rec['segments']} segments parsed twice (one "
                         "arena copy a parse, one of the bytes)")
    # the least time: the sectors that hold what the parse has to read
    # (fixed fields, names, CIGARs, aux tags up to NM and AS), read once,
    # and the columns and blocks written once; then each route's copy
    # back over the link at phase 22's measured d2h rate
    bound_ms = (rec["read"] + rec["written"]) / H100_BYTES_PER_S * 1e3
    # by step, as phase 23 counts the speculate and the stitch; the parse's
    # two launches the bound above
    step_bound_ms = {k: v / H100_BYTES_PER_S * 1e3 for k, v in {
        "speculate": rec["spec_bytes"], "stitch": 44 * rec["regions"],
        "parse": rec["read"] + rec["written"]}.items()}
    out = {"plain_ms": rec["plain_ms"], "bound_ms": bound_ms,
           "step_bound_ms": step_bound_ms,
           "plain_step_ms": {"speculate": rec["spec_plain_ms"]},
           "max_abs_err": max(err, spec_err),
           "speculate_max_abs_err": spec_err, "bytes": rec["bytes"],
           "bytes_read": rec["read"], "bytes_written": rec["written"],
           "records": rec["records"], "blocks": rec["blocks"],
           "segments": rec["segments"], "streams": n_streams,
           "refused_streams": len(refused)}
    for route in routes:
        r = rec[route]
        steps = r["step_ms"]
        kernels = sum(v for key, v in steps.items() if key != "d2h")
        link_ms = r["back"] / (d2h_gb_per_s * 1e9) * 1e3
        log(f"[parse] phase 4's BAM ({route}: "
            f"{'the slot bytes kept' if routes[route] else 'no bytes'}): "
            f"{rec['segments']} segments, {rec['records']} records, "
            f"{rec['blocks']} blocks, equal to parse_records_full and the "
            f"plain version (max_abs_err {err}); call {r['ms']:.3f} ms, "
            f"kernels {kernels:.3f} ms ({len(steps) - 1} launches a "
            f"segment; steps {json.dumps(steps)}), copy back "
            f"{steps.get('d2h', 0.0):.3f} ms of {r['back']} bytes "
            f"({link_ms:.3f} ms at {d2h_gb_per_s:.3f} GB/s); peak "
            f"{r['peak']} bytes, {r['above']} above what was allocated "
            f"before the parse; plain version {rec['plain_ms']:.1f} ms; "
            f"bound {bound_ms:.4f} ms (bytes: {rec['read']} read of "
            f"{rec['bytes']} inflated, {rec['written']} written; by step "
            f"{json.dumps(step_bound_ms)}); the speculate (min_bs 32) equal "
            f"to its plain version on every segment (max_abs_err "
            f"{spec_err}); {card}")
        out[route] = {"ms": r["ms"], "kernel_ms": kernels,
                      "step_ms": steps,
                      "launches_a_segment": len(steps) - 1,
                      "copy_back_ms": steps.get("d2h", 0.0),
                      "bytes_back": r["back"], "link_ms": link_ms,
                      "peak_bytes": r["peak"],
                      "peak_above_resident_bytes": r["above"]}
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is false; this script "
            "needs an NVIDIA card")
        return 1
    from coverm_tpu_torch.io import native
    from coverm_tpu_torch.io.fastscan import FusedScanStream, plan_segments
    from coverm_tpu_torch.ops import cuda_build
    from coverm_tpu_torch.ops import sweep_scan as K
    from coverm_tpu_torch.ops.depth import (ReferenceLayout,
                                            compute_depth_stats_numpy)
    from coverm_tpu_torch.ops.sweep import (DepthAccumulator,
                                            compute_depth_stats_sweep)
    from coverm_tpu_torch.synth import (write_cram_twin, write_gene_gff,
                                        write_shard_bams, write_sorted_bam)
    from coverm_tpu_torch.timing import card_line, event_ms, queued_ms

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # ---- 1. card
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 2. build: the two kernels (one nvcc each) and the native ingest
    # library, all started together
    t0 = time.perf_counter()
    nat = threading.Thread(target=native.get_lib)
    nat.start()
    libs = cuda_build.build_all()
    nat.join()
    if native.get_lib() is None:
        raise SystemExit("native BAM ingest library did not build")
    build_s = time.perf_counter() - t0
    log(f"[build] {build_s:.1f} s; kernels "
        f"{', '.join(os.path.basename(p) for p in libs.values())}")
    for path in libs.values():
        with open(path + ".log") as f:
            log(f.read().strip())

    phase_s = {"build": build_s}
    launches_by_path = {}
    # phases 4-12 drive the single-card paths, which count one launch an
    # engine batch, whatever the number of cards; phases 13-16 take the
    # multi-device ones explicitly
    os.environ["COVERM_TPU_MESH"] = "0"
    work = tempfile.mkdtemp(prefix="coverm_tpu_torch_smoke_")
    try:
        # fixture: the bench.py workload
        t0 = time.perf_counter()
        bam = os.path.join(work, "bench.bam")
        tids, starts, lengths = write_sorted_bam(bam)
        truth = blocks_of(tids, starts, lengths, 150)
        n_reads = tids.size
        log(f"[fixture] {n_reads} reads, "
            f"{os.path.getsize(bam) / 1e9:.3f} GB, "
            f"{time.perf_counter() - t0:.1f} s")
        phase_s["fixture"] = time.perf_counter() - t0

        # ---- 3. kernel vs plain version, adversarial case
        t0 = time.perf_counter()
        check_adversarial(dev)
        phase_s["adversarial"] = time.perf_counter() - t0

        # ---- 4. main path at the bench size; the warm-up run records the
        # kernel's inputs and the engine's batches as the main path makes
        # them
        t_phase = time.perf_counter()
        argv = ["contig", "-b", bam, "-m", *METHODS]
        (tsv_gpu, wall, launches, peak_bytes, err, launches_in,
         batches) = drive("contig", argv, work, dev, keep=True)
        launches_by_path["contig_bam"] = launches
        plan = FusedScanStream(bam)
        plan.open()
        n_segments = len(plan_segments(plan._plan[3], plan._plan[5],
                                       plan.target_bytes))
        del plan
        if INFLATE_LAUNCHES["contig"] != n_segments or n_segments == 0 \
                or SCAN_LAUNCHES["contig"] != n_segments:
            raise SystemExit(f"contig: the inflate kernel launched "
                             f"{INFLATE_LAUNCHES['contig']} times and the "
                             f"record scan {SCAN_LAUNCHES['contig']} over "
                             f"{n_segments} BGZF segments")
        same_as_cpu("contig", argv, tsv_gpu, work, 32)
        want = oracle_check("contig", bam, truth, argv, dev)

        # the kernel's time at each main-path launch: sums over the
        # launches of one main-path run
        kernel_ms = device_ms = plain_ms = bytes_s = ops_s = 0.0
        events = []
        for ins in launches_in:
            E, n_seg = ins[0].numel(), ins[2]
            events.append(E)
            kernel_ms += event_ms(lambda: K.sweep_scan(*ins), 30)
            device_ms += queued_ms(lambda: K.sweep_scan(*ins), 30)
            plain_ms += event_ms(lambda: K.sweep_scan_reference(*ins), 20)
            bytes_s += (KERNEL_BYTES_PER_EVENT * E + 4 * (n_seg + 1)
                        + 48 * n_seg) / H100_BYTES_PER_S
            ops_s += KERNEL_OPS_PER_EVENT * E / H100_INT32_OPS_PER_S
        bound_ms = max(bytes_s, ops_s) * 1e3
        bound_by = "bytes" if bytes_s >= ops_s else "operations"
        log(f"[kernel] {launches} launches, E {events}: kernel "
            f"{kernel_ms:.4f} ms one call at a time ({device_ms:.4f} ms "
            f"queued), plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}; bytes {bytes_s * 1e3:.4f} ms, "
            f"operations {ops_s * 1e3:.4f} ms); {card}")

        # engine-only: the main path's own batches, from decoded block
        # arrays, folded into one accumulator
        layout = ReferenceLayout.build(lengths, EE)

        def device_pass():
            acc = DepthAccumulator()
            for bt, bs, be, counts in batches:
                compute_depth_stats_sweep(layout, bt, bs, be, trim=TRIM,
                                          acc=acc, contig_counts=counts,
                                          device=dev)
            acc.start_fetch()
            return acc.result()
        check_stats("engine-only", device_pass(), want)
        t0 = time.perf_counter()
        device_pass()
        device_s = time.perf_counter() - t0
        log(f"[main path] {n_reads} reads: decode-inclusive "
            f"{n_reads / wall:.0f} reads/s ({wall:.3f} s), engine-only "
            f"{n_reads / device_s:.0f} reads/s ({device_s:.3f} s, "
            f"{len(batches)} batches), {launches} kernel launches, peak "
            f"device memory {peak_bytes} bytes; {card}")
        del batches
        phase_s["main_path"] = time.perf_counter() - t_phase

        # ---- 5. genome mode, whole-file route
        t0 = time.perf_counter()
        gbam = os.path.join(work, "genome.bam")
        names = [f"g{i % 3}~c{i}" for i in range(8)]
        gt, gs, gl = write_sorted_bam(gbam, n_contigs=8, contig_len=100_000,
                                      seed=1, names=names)
        gargv = ["genome", "-s", "~", "-b", gbam, "-m", *METHODS]
        g_gpu, _, launches_by_path["genome"], _, g_err = drive(
            "genome", gargv, work, dev)
        same_as_cpu("genome", gargv, g_gpu, work, 3)
        oracle_check("genome", gbam, blocks_of(gt, gs, gl, 150), gargv, dev)
        phase_s["genome"] = time.perf_counter() - t0

        # ---- 6. CRAM twin of the bench BAM, at full width
        t0 = time.perf_counter()
        cram = os.path.join(work, "bench.cram")
        ct, cs, _ = write_cram_twin(cram)
        if not (np.array_equal(ct, tids) and np.array_equal(cs, starts)):
            raise SystemExit("the CRAM twin's reads differ from the BAM's")
        log(f"[cram] twin of {ct.size} reads, "
            f"{os.path.getsize(cram) / 1e9:.3f} GB, "
            f"{time.perf_counter() - t0:.1f} s")
        cargv = ["contig", "-b", cram, "-m", *METHODS]
        tsv_cram, cram_wall, cram_launches, _, c_err = drive(
            "cram", cargv, work, dev)
        launches_by_path["cram"] = cram_launches
        if tsv_cram != tsv_gpu:
            raise SystemExit("CRAM TSV differs from the BAM TSV")
        oracle_check("cram", cram, truth, cargv, dev)
        log(f"[cram] {n_reads} reads: decode-inclusive "
            f"{n_reads / cram_wall:.0f} reads/s ({cram_wall:.3f} s), "
            f"{cram_launches} kernel launches; {card}")
        phase_s["cram"] = time.perf_counter() - t0

        # ---- 7. genes (--gff) on the bench BAM, at full width
        t0 = time.perf_counter()
        gff = os.path.join(work, "genes.gff")
        n_genes = write_gene_gff(gff, [f"c{i}" for i in range(32)],
                                 int(lengths[0]))
        fargv = ["contig", "--gff", gff, "-b", bam, "-m", *METHODS]
        tsv_gff, gff_wall, gff_launches, _, f_err = drive(
            "gff", fargv, work, dev)
        launches_by_path["gff"] = gff_launches
        n_seg = reader_segments(bam, 1 << 28)
        if not INFLATE_LAUNCHES["gff"] == PARSE_LAUNCHES["gff"] == n_seg:
            raise SystemExit(f"gff: inflated {INFLATE_LAUNCHES['gff']} and "
                             f"parsed {PARSE_LAUNCHES['gff']} segments on "
                             f"the card of the reader's {n_seg}")
        same_as_cpu("gff", fargv, tsv_gff, work, n_genes)
        log(f"[gff] {n_genes} genes, {n_reads} reads: decode-inclusive "
            f"{n_reads / gff_wall:.0f} reads/s ({gff_wall:.3f} s), "
            f"{gff_launches} kernel launches; {card}")
        phase_s["gff"] = time.perf_counter() - t0

        # ---- 8. --sharded: two name-sorted paired shard BAMs
        t0 = time.perf_counter()
        shards = [os.path.join(work, f"shard{k}.bam") for k in (1, 2)]
        n_pairs = write_shard_bams(shards)
        sargv = ["genome", "--sharded", "-s", "~", "-b", *shards, "-m",
                 *METHODS]
        tsv_sh, _, launches_by_path["sharded"], _, s_err = drive(
            "sharded", sargv, work, dev)
        same_as_cpu("sharded", sargv, tsv_sh, work, 4)
        log(f"[sharded] {n_pairs} pairs over {len(shards)} shards")
        phase_s["sharded"] = time.perf_counter() - t0

        # ---- 9. genome --dereplicate with the CheckM filter
        t0 = time.perf_counter()
        launches_by_path["genome_dereplicate"], d_err = phase_derep(work,
                                                                    dev)
        phase_s["derep"] = time.perf_counter() - t0

        # ---- 10. --profile-dir on phase 5's command
        t0 = time.perf_counter()
        launches_by_path["profile_dir"], p_err = phase_profile(
            gargv, g_gpu, work, dev)
        phase_s["profile"] = time.perf_counter() - t0

        # ---- 11. filter, then contig over its output
        t0 = time.perf_counter()
        launches_by_path["filter_contig"], fc_err = phase_filter(gbam, work,
                                                                 dev)
        phase_s["filter"] = time.perf_counter() - t0

        # ---- 12. the dense engine at the bench size
        t0 = time.perf_counter()
        want_hist = compute_depth_stats_numpy(layout, *truth, need_hist=True,
                                              trim=TRIM)
        dense_ms, dense_device_ms, dense_chunks = phase_dense(
            lengths, truth, want_hist, dev)
        phase_s["dense"] = time.perf_counter() - t0

        # ---- 13. the mesh sweep at the bench size
        t0 = time.perf_counter()
        (launches_by_path["mesh_sweep"], m_err, mesh_ms,
         mesh_single_ms) = phase_mesh(lengths, truth, want_hist, dev, card)
        del want_hist
        phase_s["mesh"] = time.perf_counter() - t0

        # ---- 14. the fused scanner with the mesh depth_fn
        t0 = time.perf_counter()
        launches_by_path["fused_mesh"], fm_err = phase_fused_mesh(
            bam, want, argv, dev, card)
        phase_s["fused_mesh"] = time.perf_counter() - t0

        # ---- 15. the two-rank job
        t0 = time.perf_counter()
        mp_launches, mp_err, mp_backend, mp_wall = phase_multiprocess(
            bam, tsv_gpu, work, card)
        launches_by_path["multiprocess"] = sum(mp_launches)
        phase_s["multiprocess"] = time.perf_counter() - t0

        # ---- 16. the multi-card CLI routes
        t0 = time.perf_counter()
        multi_card = torch.cuda.device_count() >= 2
        mc_err, mc_wall = 0, None
        if multi_card:
            mc, mc_err = phase_multi_card(bam, tsv_gpu, work, dev, card)
            launches_by_path.update(
                {k: v for k, v in mc.items() if not k.endswith("_s")})
            mc_wall = {k: v for k, v in mc.items() if k.endswith("_s")}
        else:
            log("[multi-card] not driven: this machine has one card, and "
                "COVERM_TPU_MESH=1 over cards and sample-DP over device "
                "groups need two or more")
        phase_s["multi_card"] = time.perf_counter() - t0

        # ---- 17. metabat: the filtered fused scan against the classic one
        t0 = time.perf_counter()
        (launches_by_path["metabat"], mb_err, mb_fused_s,
         mb_classic_s) = phase_metabat(work, dev, card)
        phase_s["metabat"] = time.perf_counter() - t0
        if INFLATE_LAUNCHES["metabat"] <= 0 or \
                SCAN_LAUNCHES["metabat"] != INFLATE_LAUNCHES["metabat"]:
            raise SystemExit("metabat: the fused route launched no inflate, "
                             "or not one record scan a segment")

        # ---- 18. validate
        t0 = time.perf_counter()
        launches_by_path["validate"], v_err = phase_validate(
            [bam, gbam], work, card)
        phase_s["validate"] = time.perf_counter() - t0

        # ---- 19. profile_ingest over the bench BAM
        t0 = time.perf_counter()
        (launches_by_path["profile_ingest"], pi_err,
         profile_res) = phase_profile_ingest(bam, n_reads, launches, dev,
                                             card)
        phase_s["profile_ingest"] = time.perf_counter() - t0

        # ---- 20. scaling_bench, two ranks
        t0 = time.perf_counter()
        (launches_by_path["scaling_bench"], sc_err,
         scaling_res) = phase_scaling(dev, card)
        phase_s["scaling_bench"] = time.perf_counter() - t0

        # ---- 21. dp_ab_bench
        t0 = time.perf_counter()
        (launches_by_path["dp_ab_bench"], ab_err,
         dp_ab_res) = phase_dp_ab(dev, card)
        phase_s["dp_ab_bench"] = time.perf_counter() - t0

        # ---- 22. the inflate kernel against the host's inflate
        t0 = time.perf_counter()
        inflate = phase_inflate(bam, work, dev, card)
        design = phase_inflate_design(bam, work, dev)
        phase_s["inflate"] = time.perf_counter() - t0

        # ---- 23. the record scan against the host's stats_scan
        t0 = time.perf_counter()
        scan = phase_scan(bam, os.path.join(work, "metabat.bam"), dev, card)
        phase_s["scan"] = time.perf_counter() - t0

        # ---- 24. the record parse against the host's parse
        t0 = time.perf_counter()
        parse = phase_parse(bam, work, dev, card, inflate["d2h_gb_per_s"])
        phase_s["parse"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"[phases] seconds: {json.dumps(phase_s)}")

    print(f"[inflate] phase 4's BAM {inflate['bytes']} bytes: "
          f"{inflate['gb_per_s']:.3f} GB/s on the card, "
          f"{[round(x, 3) for x in inflate['segment_ms']]} ms a segment; "
          f"256 MiB pinned d2h copy {inflate['d2h_256mib_ms']:.3f} ms "
          f"({inflate['d2h_gb_per_s']:.3f} GB/s); {card}")
    runs = design["runs"]
    ms = {name: {v: r["variants"][v]["ms"] for v in r["variants"]}
          for name, r in runs.items()}
    print(f"[inflate] kernel {design['smem_bytes']} shared bytes a CTA, "
          f"{design['ctas_per_sm']} CTAs an SM; ms a segment of the demo "
          f"sample: "
          + "; ".join(f"{kd} {v['segments']} segments "
                      f"{v['min_ms']:.3f}-{v['max_ms']:.3f}"
                      for kd, v in
                      runs["demo"]["variants"]["kernel"]["by_kind"].items())
          + f"; phase 4's BAM at zlib level 1 (its own, the benchmark's) "
          f"{ms['level1']['kernel']:.3f} ms, at level 6 (zlib's default, "
          f"samtools' and htslib's) {ms['level6']['kernel']:.3f} ms; on "
          f"the card's memory {ms['level1']['kernel@card']:.3f} and "
          f"{ms['level6']['kernel@card']:.3f} ms; {card}")
    print(card)
    print(json.dumps({"kernels": [{
        "name": "sweep_scan",
        "route": "cuda",
        "source": "coverm_tpu_torch/csrc/sweep_scan.cu",
        "replaces": "coverm_tpu/ops/pallas_sweep.py:107",
        "launches": launches,
        "launches_by_path": launches_by_path,
        "max_abs_err": max(err, g_err, c_err, f_err, s_err, d_err, p_err,
                           fc_err, m_err, fm_err, mp_err, mc_err, mb_err,
                           v_err, pi_err, sc_err, ab_err),
        "multi_card": multi_card,
        "multi_card_wall_s": mc_wall,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "device_ms": device_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "library_note": "no single PyTorch call computes the sweep scan",
        "events_per_launch": events,
        "build_s": build_s,
        "decode_inclusive_reads_per_s": n_reads / wall,
        "device_only_reads_per_s": n_reads / device_s,
        "main_path_peak_device_bytes": peak_bytes,
        "cram_decode_inclusive_reads_per_s": n_reads / cram_wall,
        "gff_decode_inclusive_reads_per_s": n_reads / gff_wall,
        "gff_genes": n_genes,
        "dense_engine_ms": dense_ms,
        "dense_engine_device_ms": dense_device_ms,
        "dense_engine_chunks": dense_chunks,
        "mesh_pass_ms": mesh_ms,
        "mesh_single_device_pass_ms": mesh_single_ms,
        "multiprocess_backend": mp_backend,
        "multiprocess_launches_by_rank": mp_launches,
        "multiprocess_wall_s": mp_wall,
        "metabat_fused_filtered_s": mb_fused_s,
        "metabat_classic_s": mb_classic_s,
        "profile_ingest_s": {k: v["s"] for k, v in
                             profile_res["stages"].items()},
        "profile_ingest_prologue_s": profile_res["prologue_s"],
        "scaling_efficiency_2": scaling_res["efficiency"],
        "scaling_transport": scaling_res["transport"],
        "dp_ab_stacked_over_thread": dp_ab_res["stacked_over_thread"],
        "phase_s": phase_s,
    }, {
        "name": "bgzf_inflate",
        "route": "cuda",
        "source": "coverm_tpu_torch/csrc/bgzf_inflate.cu",
        "replaces": "coverm_tpu_torch/native/bamdecode.cpp:839 (the host "
                    "inflate_drain; no TPU kernel inflates)",
        "launches": INFLATE_LAUNCHES["contig"],
        "launches_by_path": dict(INFLATE_LAUNCHES),
        "max_abs_err": inflate["max_abs_err"],
        "ms": inflate["ms"],
        "segment_ms": inflate["segment_ms"],
        "plain_ms": inflate["plain_ms"],
        "bound_ms": inflate["bound_ms"],
        "bound_by": "bytes",
        "link_bound_ms": inflate["link_bound_ms"],
        "library_ms": None,
        "library_note": "none: no PyTorch call inflates DEFLATE",
        "gb_per_s": inflate["gb_per_s"],
        "inflated_bytes": inflate["bytes"],
        "segments": inflate["segments"],
        "pinned_bytes": inflate["pinned_bytes"],
        "d2h_256mib_ms": inflate["d2h_256mib_ms"],
        "d2h_gb_per_s": inflate["d2h_gb_per_s"],
        "smem_bytes": design["smem_bytes"],
        "ctas_per_sm": design["ctas_per_sm"],
        "design_ms": ms,
        "demo_by_kind_ms": {v: r["by_kind"] for v, r in
                            runs["demo"]["variants"].items()},
    }, {
        "name": "bam_scan",
        "route": "cuda",
        "source": "coverm_tpu_torch/csrc/bam_scan.cu",
        "replaces": "coverm_tpu_torch/native/bamdecode.cpp:903 (the host "
                    "run_stats_pipeline and scan_chunk_records; no TPU "
                    "kernel scans records)",
        "launches": SCAN_LAUNCHES["contig"],
        "launches_by_path": dict(SCAN_LAUNCHES),
        "host_stats_scan_calls_by_path": dict(HOST_SCANS),
        "max_abs_err": scan["max_abs_err"],
        "ms": scan["ms"],
        "step_ms": scan["step_ms"],
        "plain_ms": scan["plain_ms"],
        "bound_ms": scan["bound_ms"],
        "step_bound_ms": scan["step_bound_ms"],
        "plain_step_ms": scan["plain_step_ms"],
        "speculate_max_abs_err": scan["speculate_max_abs_err"],
        "bound_by": "bytes",
        "library_ms": None,
        "library_note": "none: no PyTorch call scans BAM records",
        "inflated_bytes": scan["bytes"],
        "blocks": scan["blocks"],
        "records": scan["records"],
        "segments": scan["segments"],
        "regions_walked": scan["regions_walked"],
        "regions_in_sequence": scan["regions_in_sequence"],
        "metabat_segments": scan["metabat_segments"],
        "metabat_ms": scan["metabat_ms"],
        "metabat_step_ms": scan["metabat_step_ms"],
        "metabat_regions_in_sequence": scan["metabat_regions_in_sequence"],
        "adversarial_streams": scan["streams"],
    }, {
        "name": "bam_parse",
        "route": "cuda",
        "source": "coverm_tpu_torch/csrc/bam_scan.cu",
        "replaces": "coverm_tpu_torch/native/bamdecode.cpp:220,306,338 (the "
                    "host ct_walk_complete, ct_parse_phase1 and "
                    "ct_parse_phase2; no TPU kernel parses records)",
        "launches": PARSE_LAUNCHES["gff"],
        "launches_by_path": dict(PARSE_LAUNCHES),
        "host_inflate_and_parse_calls_by_path": dict(HOST_INGEST),
        "max_abs_err": parse["max_abs_err"],
        # the kernels of a parse as `--gff` runs it, the copy back apart
        "ms": parse["bare"]["kernel_ms"],
        "step_ms": parse["bare"]["step_ms"],
        "plain_ms": parse["plain_ms"],
        "bound_ms": parse["bound_ms"],
        "step_bound_ms": parse["step_bound_ms"],
        "plain_step_ms": parse["plain_step_ms"],
        "speculate_max_abs_err": parse["speculate_max_abs_err"],
        "bound_by": "bytes",
        "library_ms": None,
        "library_note": "none: no PyTorch call parses BAM records",
        "without_bytes": parse["bare"],
        "with_bytes": parse["kept"],
        "inflated_bytes": parse["bytes"],
        "bytes_read": parse["bytes_read"],
        "bytes_written": parse["bytes_written"],
        "records": parse["records"],
        "blocks": parse["blocks"],
        "segments": parse["segments"],
        "adversarial_streams": parse["streams"],
        "refused_streams": parse["refused_streams"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
