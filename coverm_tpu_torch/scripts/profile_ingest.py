"""Profile the host BAM ingest stage by stage, then the whole pass with
the sweep engine on the device.

Times, on one BAM, each stage as the best of --reps passes:

  bgzf scan         - io/native.bgzf_scan: the block table
  inflate           - bgzf_inflate_blocks, at the thread count that
                      ingest_scan takes (min(cpu_count + 1, 8))
  phase1            - ct_parse_phase1: the sequential record walk
  full parse        - io/bam.parse_records (parse_records_full): phase 1
                      and the parallel decode into a RecordBatch
  stats scan alone  - stats_scan on inflated data, at ingest_scan's thread
                      count: the fused call less the inflate
  bookkeep          - scan.scan_sample with the depth engine stubbed
  stream            - io/bam.BamStreamReader on the device: inflate and
                      parse, prefetched (on a CUDA device its card route)
  classic host      - the classic reader's host route (the CPU's) as
                      `--gff` runs it (no records' bytes kept), its
                      stages' seconds summed apart: native.bgzf_scan,
                      the inflate (bgzf_inflate_blocks, on the prefetch
                      thread), the record walk (ct_walk_complete), the
                      parse (parse_records_full less the walk), and the
                      joins (_cat, concat_batches)
  classic card      - on a CUDA device the classic reader's card route
                      as `--gff` runs it: the worker's seconds staging
                      segments, the seconds waiting for the card slot
                      (the inflate), the inflate kernel's ms, the parse's
                      ms by step (CUDA events: speculate, the stitch's
                      check and walk, parse_count, parse_emit, the d2h of
                      the arena of columns and the carry) and its wall
                      seconds, and the joins (concat_batches)
  fused             - ingest_scan over the FusedScanStream plan, one
                      native call a segment (stream open included)
  card inflate      - ops/bgzf_inflate.SegmentInflater over the plan's
                      segments alone, on the device (the kernel on a card,
                      its plain version on the CPU): the wall seconds, the
                      kernel's milliseconds a segment (CUDA events), its
                      launches and the pinned bytes it holds
  host scan split   - the card route as it ran before the records were
                      scanned on the card: each inflated segment copied to
                      a pinned host buffer, then the host's
                      native.stats_scan, timed apart: the wait for the
                      inflate, the copy, the carry's placement before the
                      segment and its copy after, the scan at its threads,
                      and inside the scan (its own clocks) the chain walk's
                      wall seconds and the chunk workers' thread seconds
  e2e, stubbed      - io/fastscan.scan_sample_fused on the device with the
                      depth engine stubbed: bench_torch/run.py's ingest_s;
                      on a CUDA device the card inflates and scans, and its
                      SegmentInflater's own timings split the pass: the
                      worker's seconds staging segments, the seconds
                      waiting for the inflate, the inflate kernel's ms, and
                      the record scan's ms by step (CUDA events: speculate,
                      stitch, analyse, emit and fold, the outputs' d2h),
                      with the regions the stitch walked again
  e2e               - the same with the sweep engine on the device; the
                      sweep-scan and inflate kernels' launches are counted,
                      and on a card the peak device bytes allocated inside
                      the engine's calls and outside them (the ingest)

The inflate to bookkeep stages go segment by segment, over the
FusedScanStream's own segments (COVERM_TPU_SEGMENT_BYTES, 256 MiB by
default), and sum over them: the file is never inflated whole. In the e2e
pass the host prologue of each engine batch (ops/sweep.prep_segments,
choose_payload, encode_start_deltas, _pack_u8) is timed where it runs,
and the pageable upload of each batch's buffer (`torch.from_numpy(buf)
.to(device)`) is replayed after the pass, one synchronised copy at a
time. Beside each stage stands its peak host RSS: the largest resident
set (VmRSS) that a thread reading /proc/self/status every 10 ms saw
while the stage ran (the high-water mark VmHWM cannot be reset on every
machine, and getrusage's ru_maxrss never can).

With --cram it profiles a CRAM's direct-stats route instead
(io/fastscan._cram_slice_blocks), each stage the best of --reps passes:

  sequential        - the route on one thread, slice by slice, its stages
                      timed apart and summed over the slices, and apart
                      again for the unmapped slices (reference id -1):
                        walk        the container walk (cram.walk_cram_slices)
                        decompress  the blocks' CRC checks, gzip and rANS
                                    (cram.slice_block_data)
                        glue        native.cram_stats_decode's Python: the
                                    external blocks joined, the arrays made
                        ct_decode   ct_cram_stats_slice itself
                        finish      native._finish_stats_handle, in order
  pool              - _cram_slice_blocks as the scan runs it: the walk and
                      the in-order finish on the calling thread, the rest
                      on io/fastscan.cram_workers() threads; the wall
                      seconds, each stage's seconds summed over the
                      threads, and the calling thread's seconds outside
                      the walk and the finish (its wait for the pool)
  e2e, stubbed      - io/fastscan.scan_sample_fused with the depth engine
                      stubbed: bench_torch/run.py's ingest_s
  e2e               - the same with the sweep engine on the device, the
                      sweep-scan kernel's launches counted

Run: python -m coverm_tpu_torch.scripts.profile_ingest [bam] [--reps 3]
         [--device cpu] [--cram]
Without a BAM it writes the bench BAM (synth.write_sorted_bam's
defaults: 32 contigs x 1 Mbp at 20x, 150 bp reads) in a temporary
directory, or with --cram its CRAM twin (synth.write_cram_twin). Ends
with one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from .common import add_device_arg, result_line

EE = 75
TRIM = (0.05, 0.95)
STAGES = [("bgzf_scan", "bgzf scan"), ("inflate", "inflate"),
          ("phase1", "phase1 (seq walk)"),
          ("full_parse", "phase1+phase2 (full parse)"),
          ("stats_scan", "stats scan alone"),
          ("bookkeep", "bookkeep (scan_sample-dev)"),
          ("stream", "stream (inflate+parse)"),
          ("classic_host", "classic reader, host"),
          ("fused", "fused one-call ingest"),
          ("card_inflate", "card inflate alone"),
          ("host_scan_split", "host scan, split"),
          ("e2e_stub", "e2e, depth stubbed"), ("e2e", "e2e, sweep engine")]
# the stages that run only on a card
CARD_STAGES = [("classic_card", "classic reader, card")]
HOST_SPLIT = ("wait", "d2h", "carry", "stats_scan", "chain_walk",
              "chunk_workers")
SEGMENTED = ("inflate", "phase1", "full_parse", "stats_scan", "bookkeep")
PROLOGUE = ("prep_segments", "choose_payload", "encode_start_deltas",
            "_pack_u8")
CRAM_STAGES = ("walk", "decompress", "glue", "ct_decode", "finish")


def rss_bytes() -> int:
    """This process's resident set now (VmRSS; 0 without /proc)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


class RssPeak:
    """The largest rss_bytes() seen every `every` seconds, by a thread,
    between entering and leaving the context."""

    def __init__(self, every=0.01):
        self.every = every
        self.peak = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)

    def _watch(self):
        while True:
            self.peak = max(self.peak, rss_bytes())
            if self._stop.wait(self.every):
                return

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, rss_bytes())
        return False


def ingest_threads() -> int:
    """The thread count ingest_scan takes by default (io/native.py)."""
    return min((os.cpu_count() or 1) + 1, 8)


def segment_groups(stream):
    """The plan's BGZF block ranges [(i, k)]: the header probe's blocks,
    then groups of about stream.target_bytes inflated, cut as
    io/fastscan.scan_sample_fused cuts its segments."""
    from ..io.fastscan import plan_segments
    _mm, _off, _csz, usz, _carry, j = stream._plan
    return [(0, j)] + plan_segments(usz, j, stream.target_bytes)


def _stub(layout, *_, **kw):
    """A depth engine that drops its blocks: a finished, empty result."""
    from ..ops.sweep import _EmptyPending
    return _EmptyPending(layout.n_contigs, kw.get("need_hist", False),
                         kw.get("trim"))


def _open(path, cram=False):
    from ..io.fastscan import FusedScanStream
    stream = FusedScanStream(path)
    header = stream.open()
    if cram and stream._cram is None:
        stream.close()
        raise ValueError(f"{path} is not a CRAM the direct-stats route "
                         "decodes")
    if not cram and stream._plan is None:
        stream.close()
        raise ValueError(f"{path} is not a BGZF BAM the native ingest plans")
    return stream, header


def segmented_pass(path):
    """One pass of the inflate to bookkeep stages over the plan's
    segments: (seconds by stage, counts by stage)."""
    from ..flags import FlagFilter
    from ..io import native
    from ..io.bam import parse_records
    from ..ops.depth import ReferenceLayout
    from ..scan import scan_sample

    stream, header = _open(path)
    mm, off, csz, usz, probe_rest, j = stream._plan
    hdr_end = int(usz[:j].sum()) - probe_rest.size
    lib = native.get_lib()
    ff = FlagFilter()
    skip, req = ff.masks()
    layout = ReferenceLayout.build(header.target_lens, EE)
    acc = native.StatsAccum(header.n_ref)
    nt = ingest_threads()
    secs = dict.fromkeys(SEGMENTED, 0.0)
    n = {"bytes": 0, "phase1": 0, "records": 0, "blocks": 0,
         "stats_records": 0, "stats_blocks": 0, "bookkeep": 0,
         "segments": 0}
    carry = np.empty(0, np.uint8)
    for i, k in segment_groups(stream):
        if k <= i:
            continue
        t0 = time.perf_counter()
        seg = native.bgzf_inflate_blocks(mm, off[i:k], csz[i:k], usz[i:k],
                                         n_threads=nt)
        secs["inflate"] += time.perf_counter() - t0
        if seg is None:
            raise ValueError(f"BGZF inflate failed in {path}")
        n["bytes"] += seg.size
        n["segments"] += 1
        if i == 0:
            buf, start = seg, hdr_end
        else:
            buf = np.concatenate([carry, seg]) if carry.size else seg
            start = 0

        t0 = time.perf_counter()
        est = (buf.size - start) // 36 + 16  # a record is 37 bytes or more
        rec_off = np.empty(est, np.int64)
        nblocks = np.empty(est, np.int64)
        got = lib.ct_parse_phase1(native._u8p(buf), buf.size, start, est,
                                  native._i64p(rec_off),
                                  native._i64p(nblocks))
        secs["phase1"] += time.perf_counter() - t0
        n["phase1"] += int(got)

        t0 = time.perf_counter()
        batch, parsed_to = parse_records(buf, start)
        secs["full_parse"] += time.perf_counter() - t0
        n["records"] += batch.n_records
        n["blocks"] += batch.block_read.size

        before = acc.n_records
        t0 = time.perf_counter()
        bt, _bs, _be, _counts, end_off = native.stats_scan(
            buf, start, acc, skip, req, n_threads=nt)
        secs["stats_scan"] += time.perf_counter() - t0
        n["stats_records"] += acc.n_records - before
        n["stats_blocks"] += bt.size
        if end_off != parsed_to:
            raise ValueError(f"stats scan and full parse end at {end_off} "
                             f"and {parsed_to}")

        t0 = time.perf_counter()
        scan_sample(header, batch, layout, ff, False, depth_fn=_stub)
        secs["bookkeep"] += time.perf_counter() - t0
        n["bookkeep"] += batch.n_records
        carry = buf[parsed_to:].copy()
        del buf, seg, batch
    if carry.size:
        raise ValueError(f"{path} ends inside a record ({carry.size} "
                         "bytes left)")
    return secs, n


def fused_pass(path):
    """ingest_scan over the plan, as io/fastscan.scan_sample_fused calls
    it (the bytes left after the last call through stats_scan):
    (records, blocks)."""
    from ..flags import FlagFilter
    from ..io import native

    stream, header = _open(path)
    mm, off, csz, usz, carry, _j = stream._plan
    skip, req = FlagFilter().masks()
    stats = native.StatsAccum(header.n_ref)
    blocks = 0
    for i, k in segment_groups(stream)[1:]:
        bt, _bs, _be, _counts, carry = native.ingest_scan(
            mm, off[i:k], csz[i:k], usz[i:k], carry, 0, stats, skip, req)
        blocks += bt.size
    if carry is not None and len(carry):
        res = native.stats_scan(np.ascontiguousarray(carry), 0, stats, skip,
                                req)
        blocks += res[0].size
    return stats.n_records, blocks


def classic_pass(path, seg_bytes, device):
    """The classic reader (io/bam.BamStreamReader) over `path` on
    `device` as `--gff` runs it, without the records' bytes, batches
    dropped: (records, seconds by stage), the host
    route's stages timed where they run and summed (the inflate on the
    prefetch thread overlaps the rest), the card route's from the
    reader's own timings."""
    from ..io import bam as IB
    from ..io import native
    secs = dict.fromkeys(("bgzf_scan", "inflate", "walk", "parse", "cat",
                          "concat"), 0.0)
    lock = threading.Lock()
    lib = native.get_lib()

    def timed(key, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                with lock:
                    secs[key] += time.perf_counter() - t0
        return run
    patches = [(native, "bgzf_scan", "bgzf_scan"),
               (native, "bgzf_inflate_blocks", "inflate"),
               (native, "parse_records_full", "parse"),
               (IB, "_cat", "cat"), (IB, "concat_batches", "concat"),
               (lib, "ct_walk_complete", "walk")]
    origs = [getattr(obj, name) for obj, name, _ in patches]
    for (obj, name, key), fn in zip(patches, origs):
        setattr(obj, name, timed(key, fn))
    try:
        reader = IB.BamStreamReader(path, target_bytes=seg_bytes,
                                    device=device, timing=True,
                                    keep_bytes=False)
        _, gen = reader.read()
        records = sum(b.n_records for b in gen)
    finally:
        for (obj, name, _), fn in zip(patches, origs):
            setattr(obj, name, fn)
    secs["parse"] -= secs["walk"]  # the walk runs inside the parse
    if reader.timings:
        secs.update(reader.timings)
    return records, secs


def pinned_allocated(nbytes) -> int:
    """Bytes torch's pinned host allocator takes for a tensor of nbytes:
    the next power of two (CachingHostAllocator)."""
    return 1 << max(int(nbytes) - 1, 0).bit_length()


def card_inflate_pass(path, device):
    """SegmentInflater over the plan's segments, each started one ahead
    of the one taken: (bytes, segments, kernel ms a segment, launches,
    pinned bytes, pinned bytes as allocated)."""
    from ..io.fastscan import _CARD_HEADROOM, plan_segments
    from ..ops import bgzf_inflate as B

    stream, _ = _open(path)
    _mm, off, csz, usz, _carry, j = stream._plan
    segments = plan_segments(usz, j, stream.target_bytes)
    before = B.bgzf_inflate_launches
    inf = B.SegmentInflater(path, off, csz, usz, segments, _CARD_HEADROOM,
                            device)
    try:
        total = 0
        for s in range(len(segments)):
            if s == 0:
                inf.start(0)
            if s + 1 < len(segments):
                inf.start(s + 1)
            _buf, lo, hi = inf.take(s)
            total += hi - lo
    finally:
        inf.close()
    allocated = sum(pinned_allocated(n) for n in inf.tensor_bytes) \
        if inf.pinned_bytes else 0
    return (total, len(segments), inf.kernel_ms,
            B.bgzf_inflate_launches - before, inf.pinned_bytes, allocated)


def host_scan_split_pass(path, device):
    """The card route as it was before its scan moved onto the card: each
    segment inflated by SegmentInflater, its bytes copied to a pinned host
    buffer behind 64 MiB of headroom (as the kernel wrote them there), the
    carry put before them, native.stats_scan at its threads, the carry
    copied out. Returns (seconds by HOST_SPLIT stage, records, blocks);
    chain_walk and chunk_workers are the scan's own clocks (thread seconds
    for the workers)."""
    from ..flags import FlagFilter
    from ..io import native
    from ..io.fastscan import _check_stuck_carry, plan_segments
    from ..ops import bgzf_inflate as B

    stream, header = _open(path)
    _mm, off, csz, usz, raw_carry, j = stream._plan
    segments = plan_segments(usz, j, stream.target_bytes)
    skip, req = FlagFilter().masks()
    stats = native.StatsAccum(header.n_ref)
    secs = dict.fromkeys(HOST_SPLIT, 0.0)
    inner = {}
    blocks = 0
    at = 64 << 20
    host = torch.empty(at + max(int(usz[i:k].sum()) for i, k in segments)
                       if segments else 0, dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    buf = host.numpy()
    inf = B.SegmentInflater(path, off, csz, usz, segments, 0, device)
    try:
        if segments:
            inf.start(0)
        for s in range(len(segments)):
            if s + 1 < len(segments):
                inf.start(s + 1)
            t0 = time.perf_counter()
            slot, lo, hi = inf.take(s)
            t1 = time.perf_counter()
            host[at:at + hi - lo].copy_(slot[lo:hi])
            lo, hi = at, at + hi - lo
            del slot
            t2 = time.perf_counter()
            seg = buf
            n = 0 if raw_carry is None else len(raw_carry)
            if n > lo:
                seg = np.concatenate([raw_carry, buf[lo:hi]])
                lo, hi = 0, seg.size
            elif n:
                seg[lo - n:lo] = raw_carry
                lo -= n
            t3 = time.perf_counter()
            bt, _bs, _be, _counts, end = native.stats_scan(
                seg, lo, stats, skip, req, end=hi, timings=inner)
            t4 = time.perf_counter()
            raw_carry = seg[end:hi].copy()
            _check_stuck_carry(raw_carry)
            t5 = time.perf_counter()
            secs["wait"] += t1 - t0
            secs["d2h"] += t2 - t1
            secs["carry"] += (t3 - t2) + (t5 - t4)
            secs["stats_scan"] += t4 - t3
            blocks += bt.size
    finally:
        inf.close()
    secs["chain_walk"] = inner.get("chain_s", 0.0)
    secs["chunk_workers"] = inner.get("chunks_s", 0.0)
    return secs, stats.n_records, blocks


def e2e_pass(path, device, stub=False, cram=False):
    """io/fastscan.scan_sample_fused over the BAM (or CRAM) on `device`:
    with the sweep engine there, or with it stubbed (stub=True). Returns
    (mapped reads counted, blocks given to the stub, None with the
    engine)."""
    from ..flags import FlagFilter
    from ..io.fastscan import scan_sample_fused
    from ..ops.depth import ReferenceLayout

    stream, header = _open(path, cram)
    layout = ReferenceLayout.build(header.target_lens, EE)
    blocks = 0 if stub else None

    def counting_stub(layout, bt, *a, **kw):
        nonlocal blocks
        blocks += bt.size
        return _stub(layout, **kw)

    scan = scan_sample_fused(header, stream, layout, FlagFilter(), False,
                             trim=TRIM, device=device,
                             depth_fn=counting_stub if stub else None)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return int(scan.reads_all.sum()), blocks


@contextlib.contextmanager
def inflaters_made():
    """Collect the SegmentInflaters that io/fastscan's card route makes
    while the block runs, so their own timings can be read."""
    from ..ops import bgzf_inflate as B
    made, cls = [], B.SegmentInflater

    class Recorded(cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)
    B.SegmentInflater = Recorded
    try:
        yield made
    finally:
        B.SegmentInflater = cls


@contextlib.contextmanager
def scans_made():
    """Record each ops.bam_scan.scan_segment call that io/fastscan's card
    route makes while the block runs, timed by step (CUDA events on a
    card, none on the CPU): {"records", "regions_walked", "ms"} a call."""
    from ..ops import bam_scan
    made, orig = [], bam_scan.scan_segment

    def timed(*args, **kwargs):
        sc = orig(*args, **{**kwargs, "timing": True})
        made.append({"records": sc.n_records,
                     "regions_walked": sc.regions_walked, "ms": sc.timing})
        return sc
    bam_scan.scan_segment = timed
    try:
        yield made
    finally:
        bam_scan.scan_segment = orig


@contextlib.contextmanager
def engine_memory(peaks, device):
    """On a card, the peak device bytes allocated inside each call of
    ops.sweep.compute_depth_stats_sweep (peaks["engine"]) and between
    them (peaks["outside"], the ingest's), while the block runs."""
    if device.type != "cuda":
        yield
        return
    from ..ops import sweep as S
    orig = S.compute_depth_stats_sweep

    def engine(*args, **kwargs):
        peaks["outside"] = max(peaks["outside"],
                               torch.cuda.max_memory_allocated(device))
        torch.cuda.reset_peak_memory_stats(device)
        try:
            return orig(*args, **kwargs)
        finally:
            peaks["engine"] = max(peaks["engine"],
                                  torch.cuda.max_memory_allocated(device))
            torch.cuda.reset_peak_memory_stats(device)
    torch.cuda.reset_peak_memory_stats(device)
    S.compute_depth_stats_sweep = engine
    try:
        yield
    finally:
        S.compute_depth_stats_sweep = orig
        peaks["outside"] = max(peaks["outside"],
                               torch.cuda.max_memory_allocated(device))


@contextlib.contextmanager
def prologue_timers(totals, bufs):
    """Time each PROLOGUE function of ops.sweep into totals[name] where
    compute_depth_stats_sweep calls it, and keep every buffer _pack_u8
    returns in bufs."""
    from ..ops import sweep as S
    origs = {name: getattr(S, name) for name in PROLOGUE}

    def timed(name, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            totals[name] += time.perf_counter() - t0
            if name == "_pack_u8":
                bufs.append(out)
            return out
        return run
    for name, fn in origs.items():
        setattr(S, name, timed(name, fn))
    try:
        yield
    finally:
        for name, fn in origs.items():
            setattr(S, name, fn)


def upload_s(bufs, device) -> float:
    """Seconds of the pageable uploads of bufs, one synchronised copy at
    a time."""
    cuda = device.type == "cuda"
    total = 0.0
    for buf in bufs:
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        torch.from_numpy(buf).to(device)
        if cuda:
            torch.cuda.synchronize(device)
        total += time.perf_counter() - t0
    return total


@contextlib.contextmanager
def cram_stage_timers(totals):
    """Add the seconds of each CRAM_STAGES stage into totals[stage],
    from whichever thread runs it, while the block runs: the walk's
    next() calls, cram.slice_block_data, native._cram_stats_args (glue),
    native.cram_stats_decode less its glue (ct_decode) and
    native._finish_stats_handle."""
    from ..io import cram as C
    from ..io import native as N
    lock = threading.Lock()
    glue_s = threading.local()

    def add(stage, dt):
        with lock:
            totals[stage] += dt

    def timed(stage, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t0
                if stage == "glue":
                    glue_s.s = getattr(glue_s, "s", 0.0) + dt
                add(stage, dt)
        return run

    def timed_decode(*args, **kwargs):
        glue_s.s = 0.0
        t0 = time.perf_counter()
        try:
            return decode(*args, **kwargs)
        finally:
            add("ct_decode", time.perf_counter() - t0 - glue_s.s)

    def timed_walk(*args, **kwargs):
        gen = walk(*args, **kwargs)
        while True:
            t0 = time.perf_counter()
            try:
                task = next(gen)
            except StopIteration:
                return
            finally:
                add("walk", time.perf_counter() - t0)
            yield task

    walk, decode = C.walk_cram_slices, N.cram_stats_decode
    origs = [(C, "walk_cram_slices", walk),
             (C, "slice_block_data", C.slice_block_data),
             (N, "_cram_stats_args", N._cram_stats_args),
             (N, "cram_stats_decode", decode),
             (N, "_finish_stats_handle", N._finish_stats_handle)]
    C.walk_cram_slices = timed_walk
    C.slice_block_data = timed("decompress", C.slice_block_data)
    N._cram_stats_args = timed("glue", N._cram_stats_args)
    N.cram_stats_decode = timed_decode
    N._finish_stats_handle = timed("finish", N._finish_stats_handle)
    try:
        yield
    finally:
        for mod, name, fn in origs:
            setattr(mod, name, fn)


def cram_sequential_pass(path):
    """The direct-stats route on this thread alone, slice by slice: (wall
    seconds, seconds by stage, seconds by stage of the unmapped slices,
    counts). A slice the native decoder rejects is counted, not
    decoded."""
    from ..flags import FlagFilter
    from ..io import cram as C
    from ..io import native as N

    stream, header = _open(path, cram=True)
    mm, body_off, _f = stream._cram
    skip, req = FlagFilter().masks()
    stats = N.StatsAccum(header.n_ref)
    lib = N.get_lib()
    totals = dict.fromkeys(CRAM_STAGES, 0.0)
    unmapped = dict.fromkeys(CRAM_STAGES, 0.0)
    n = {"slices": 0, "unmapped_slices": 0, "rejected_slices": 0,
         "blocks": 0}
    t_start = time.perf_counter()
    try:
        with cram_stage_timers(totals):
            tasks = C.walk_cram_slices(mm, body_off, lazy_skippable=True)
            while True:
                before = dict(totals)
                task = next(tasks, None)
                if task is None:
                    break
                core, ext = C.slice_block_data(mm, task)
                dec = N.cram_stats_decode(
                    task.comp_block.data, task.sh_block.data, core, ext,
                    header.n_ref, skip, req)
                if dec is None:
                    n["rejected_slices"] += 1
                else:
                    bt = N._finish_stats_handle(lib, *dec, stats, False)[0]
                    n["blocks"] += bt.size
                n["slices"] += 1
                if task.sl.ref_id == -1:
                    n["unmapped_slices"] += 1
                    for k in CRAM_STAGES:
                        unmapped[k] += totals[k] - before[k]
    finally:
        stream.close()
    n["records"] = stats.n_records
    return time.perf_counter() - t_start, totals, unmapped, n


def cram_pool_pass(path):
    """io/fastscan._cram_slice_blocks over the CRAM: (wall seconds,
    seconds by stage summed over the threads, counts)."""
    from ..flags import FlagFilter
    from ..io import native as N
    from ..io.fastscan import _cram_slice_blocks

    stream, header = _open(path, cram=True)
    stats = N.StatsAccum(header.n_ref)
    totals = dict.fromkeys(CRAM_STAGES, 0.0)
    blocks = slices = 0
    t0 = time.perf_counter()
    with cram_stage_timers(totals):
        for bt, _bs, _be, _counts in _cram_slice_blocks(
                stream, stats, *FlagFilter().masks()):
            blocks += bt.size
            slices += 1
    return (time.perf_counter() - t0, totals,
            {"slices": slices, "records": stats.n_records, "blocks": blocks})


def profile_cram(path, reps=3, device=None, out=print):
    """Every CRAM stage of the module docstring over the CRAM at `path`,
    each the best of `reps` passes; prints one line a stage and returns
    the record of them all."""
    from ..device import resolve_device
    from ..io import native
    from ..io.fastscan import cram_workers
    from ..ops import sweep_scan as K

    dev = resolve_device(device)
    if native.get_lib() is None:
        raise RuntimeError("the native ingest library is off "
                           "(COVERM_TPU_NO_NATIVE); nothing to profile")
    size = os.path.getsize(path)
    out(f"file: {path} ({size / 1e6:.0f} MB, CRAM)")
    rss_at_start = rss_bytes()
    stages = {}

    with RssPeak() as rss:
        seq = min((cram_sequential_pass(path) for _ in range(reps)),
                  key=lambda r: r[0])
    wall, totals, unmapped, counts = seq
    stages["sequential"] = {"s": wall, "peak_rss_bytes": rss.peak,
                            "stage_s": totals, "unmapped_stage_s": unmapped,
                            **counts}
    with RssPeak() as rss:
        pool = min((cram_pool_pass(path) for _ in range(reps)),
                   key=lambda r: r[0])
    wall, totals, counts = pool
    stages["pool"] = {"s": wall, "peak_rss_bytes": rss.peak,
                      "workers": cram_workers(), "stage_thread_s": totals,
                      "caller_wait_s": wall - totals["walk"]
                      - totals["finish"], **counts}

    def stub():
        return e2e_pass(path, dev, stub=True, cram=True)
    with RssPeak() as rss:
        times, got = [], None
        for _ in range(reps):
            t0 = time.perf_counter()
            got = stub()
            times.append(time.perf_counter() - t0)
    stages["e2e_stub"] = {"s": min(times), "peak_rss_bytes": rss.peak,
                          "mapped_reads": got[0], "blocks": got[1]}

    launches = set()
    with RssPeak() as rss:
        times = []
        for _ in range(reps):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            K.sweep_scan_launches = 0
            t0 = time.perf_counter()
            rec, _ = e2e_pass(path, dev, cram=True)
            times.append(time.perf_counter() - t0)
            launches.add(K.sweep_scan_launches)
    if len(launches) != 1:
        raise RuntimeError(f"the e2e passes launched the sweep-scan kernel "
                           f"{sorted(launches)} times")
    stages["e2e"] = {"s": min(times), "peak_rss_bytes": rss.peak,
                     "mapped_reads": rec, "k1_launches": launches.pop(),
                     "device": str(dev)}

    for key, st in stages.items():
        said = ", ".join(
            f"{k} " + (" ".join(f"{a} {b:.3f}" for a, b in v.items())
                       if isinstance(v, dict) else f"{v}")
            for k, v in st.items() if k not in ("s", "peak_rss_bytes"))
        out(f"{key:12s} {st['s']:7.3f}s  peak RSS "
            f"{st['peak_rss_bytes'] / 1e9:.2f} GB  {said}")
    return {"cram": path, "cram_bytes": size, "reps": reps,
            "stages": stages, "rss_at_start_bytes": rss_at_start}


def profile(path, reps=3, device=None, out=print):
    """Every stage of the module docstring over the BAM at `path`, each
    the best of `reps` passes; prints one line a stage and returns the
    record of them all."""
    from ..device import resolve_device
    from ..io import native
    from ..io.bam import BamStreamReader
    from ..ops import bgzf_inflate as B
    from ..ops import sweep_scan as K

    dev = resolve_device(device)
    if native.get_lib() is None:
        raise RuntimeError("the native ingest library is off "
                           "(COVERM_TPU_NO_NATIVE); nothing to profile")
    stages = {}

    rss_at_start = rss_bytes()

    def best(key, fn):
        times, got = [], None
        with RssPeak() as rss:
            for _ in range(reps):
                t0 = time.perf_counter()
                got = fn()
                times.append(time.perf_counter() - t0)
        stages[key] = {"s": min(times), "peak_rss_bytes": rss.peak}
        return got

    size = os.path.getsize(path)
    seg_bytes = _open(path)[0].target_bytes
    out(f"file: {path} ({size / 1e6:.0f} MB compressed)")
    mm = np.memmap(path, np.uint8, mode="r")
    off, _csz, usz = best("bgzf_scan", lambda: native.bgzf_scan(mm))
    stages["bgzf_scan"]["bgzf_blocks"] = int(off.size)
    del mm

    with RssPeak() as rss:  # of the five stages together
        seg = [segmented_pass(path) for _ in range(reps)]
    counts = seg[-1][1]
    for key in SEGMENTED:
        stages[key] = {"s": min(s[key] for s, _ in seg),
                       "peak_rss_bytes": rss.peak}
    stages["inflate"].update(bytes=counts["bytes"],
                             segments=counts["segments"],
                             threads=ingest_threads())
    stages["phase1"]["records"] = counts["phase1"]
    stages["full_parse"].update(records=counts["records"],
                                blocks=counts["blocks"])
    stages["stats_scan"].update(records=counts["stats_records"],
                                blocks=counts["stats_blocks"],
                                threads=ingest_threads())
    stages["bookkeep"]["records"] = counts["bookkeep"]

    def stream():
        _, gen = BamStreamReader(path, target_bytes=seg_bytes,
                                 device=dev).read()
        return sum(b.n_records for b in gen)
    stages["stream"]["records"] = best("stream", stream)
    for key, where in (("classic_host", "cpu"), ("classic_card", dev)):
        if key == "classic_card" and dev.type != "cuda":
            continue
        runs = []

        def classic(where=where, runs=runs):
            t0 = time.perf_counter()
            got = classic_pass(path, seg_bytes, where)
            runs.append((time.perf_counter() - t0, got))
            return got[0]
        stages[key]["records"] = best(key, classic)
        stages[key]["split_s"] = min(runs, key=lambda r: r[0])[1][1]

    rec, blk = best("fused", lambda: fused_pass(path))
    stages["fused"].update(records=rec, blocks=blk)
    (total, n_seg, kernel_ms, launches, pinned,
     allocated) = best("card_inflate", lambda: card_inflate_pass(path, dev))
    stages["card_inflate"].update(
        bytes=total, segments=n_seg, launches=launches,
        kernel_ms=kernel_ms, device=str(dev), pinned_bytes=pinned,
        pinned_bytes_allocated=allocated)
    if dev.type == "cuda":
        ms = sum(kernel_ms)
        stages["card_inflate"].update(
            kernel_ms_total=ms, kernel_gb_per_s=total / ms / 1e6)
    hs = best("host_scan_split", lambda: host_scan_split_pass(path, dev))
    stages["host_scan_split"].update(records=hs[1], blocks=hs[2],
                                     stage_s=hs[0], device=str(dev))
    walls, scans = [], []

    def stub_pass():
        with scans_made() as made_scans:
            t0 = time.perf_counter()
            got = e2e_pass(path, dev, stub=True)
            walls.append(time.perf_counter() - t0)
        scans.append(made_scans)
        return got
    with inflaters_made() as made:
        rec, blk = best("e2e_stub", stub_pass)
    stages["e2e_stub"].update(mapped_reads=rec, blocks=blk,
                              route="card" if dev.type == "cuda" else "host")
    if made and len(made) == len(walls):
        # the card route's split, of the pass whose wall is kept
        fastest = int(np.argmin(walls))
        inf, fast_scans = made[fastest], scans[fastest]
        scan_ms = {}
        for sc in fast_scans:
            for k, v in (sc["ms"] or {}).items():
                scan_ms[k] = scan_ms.get(k, 0.0) + v
        stages["e2e_stub"].update(
            card_stage_s=inf.stage_s, card_wait_s=inf.wait_s,
            kernel_ms_total=sum(inf.kernel_ms),
            scan_segments=len(fast_scans),
            scan_records=sum(sc["records"] for sc in fast_scans),
            scan_regions_walked=sum(sc["regions_walked"]
                                    for sc in fast_scans),
            scan_ms=scan_ms)

    per_rep, launches, inflates = [], set(), set()

    peaks = {"engine": 0, "outside": 0}

    def e2e():
        totals, bufs = dict.fromkeys(PROLOGUE, 0.0), []
        with prologue_timers(totals, bufs), engine_memory(peaks, dev):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            K.sweep_scan_launches = 0
            B.bgzf_inflate_launches = 0
            t0 = time.perf_counter()
            rec, _ = e2e_pass(path, dev)
            wall = time.perf_counter() - t0
            launches.add(K.sweep_scan_launches)
            inflates.add(B.bgzf_inflate_launches)
        totals["upload"] = upload_s(bufs, dev)
        totals["batches"] = len(bufs)
        per_rep.append((wall, totals))
        return rec
    with RssPeak() as rss:
        rec = [e2e() for _ in range(reps)][-1]
    if len(launches) != 1:
        raise RuntimeError(f"the e2e passes launched the sweep-scan kernel "
                           f"{sorted(launches)} times")
    if len(inflates) != 1:
        raise RuntimeError(f"the e2e passes launched the inflate kernel "
                           f"{sorted(inflates)} times")
    stages["e2e"] = {"s": min(w for w, _ in per_rep), "mapped_reads": rec,
                     "k1_launches": launches.pop(),
                     "inflate_launches": inflates.pop(), "device": str(dev),
                     "peak_rss_bytes": rss.peak}
    if dev.type == "cuda":
        stages["e2e"].update(device_peak_engine_bytes=peaks["engine"],
                             device_peak_outside_engine_bytes=peaks["outside"])
    prologue = {name: min(t[name] for _, t in per_rep)
                for name in (*PROLOGUE, "upload")}
    prologue["total"] = sum(prologue.values())
    prologue["batches"] = per_rep[-1][1]["batches"]

    for key, label in STAGES + CARD_STAGES:
        if key not in stages:  # the card's stages on the CPU
            continue
        st = stages[key]
        said = ", ".join(f"{k} {v}" for k, v in st.items()
                         if k not in ("s", "peak_rss_bytes"))
        out(f"{label:26s} {st['s']:7.3f}s  peak RSS "
            f"{st['peak_rss_bytes'] / 1e9:.2f} GB  {said}")
    split = {"inflate_s": stages["inflate"]["s"],
             "stats_scan_s": stages["stats_scan"]["s"],
             "inflate_plus_stats_scan_s": (stages["inflate"]["s"]
                                           + stages["stats_scan"]["s"]),
             "fused_s": stages["fused"]["s"]}
    out(f"inflate + stats scan alone {split['inflate_plus_stats_scan_s']:.3f}"
        f" s against the fused call's {split['fused_s']:.3f} s")
    out("host prologue a pass: " + ", ".join(
        f"{k} {v:.4f} s" for k, v in prologue.items() if k != "batches")
        + f" over {prologue['batches']} batches")
    return {"bam": path, "bam_bytes": size, "reps": reps,
            "segment_bytes": seg_bytes,
            "stages": stages, "split": split, "prologue_s": prologue,
            "rss_at_start_bytes": rss_at_start}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0])
    p.add_argument("bam", nargs="?", default=None,
                   help="a sorted BGZF BAM, or with --cram a sorted CRAM "
                        "(default: write the bench BAM)")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--cram", action="store_true",
                   help="profile a CRAM's direct-stats route (default: "
                        "write the bench BAM's CRAM twin)")
    add_device_arg(p)
    args = p.parse_args(argv)
    from ..device import resolve_device
    dev = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as work:
        path = args.bam
        if path is None and args.cram:
            from ..synth import write_cram_twin
            path = os.path.join(work, "bench.cram")
            write_cram_twin(path)
        elif path is None:
            from ..synth import write_sorted_bam
            path = os.path.join(work, "bench.bam")
            write_sorted_bam(path)
        res = (profile_cram if args.cram else profile)(path, args.reps, dev)
    print(result_line(dev, tool="profile_ingest", **res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
