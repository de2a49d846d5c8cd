"""Fused-native streaming scan: the production BAM-ingestion fast path.

This module collapses BAM ingest into ONE pass per segment: on a card
the inflate kernel (ops/bgzf_inflate.py) and the record-scan kernels
(ops/bam_scan.py) over the segment in card memory; on the CPU one native
call (native/bamdecode.cpp ct_ingest_scan) with the host's inflate. The
chain walk, CIGAR walk, aux NM scan, flag gating, a filtered source's
single-read filter, and every per-contig statistic the scan layer needs
are computed there, and only the filtered coverage-block arrays (12
bytes/block) and the statistic runs come back for device dispatch.
Columns the coverage path never reads (qname hashes, AS scores,
per-record arrays, record byte offsets) are not materialised at all — the analogue of htslib's role in the
reference (bam_generator.rs:125-129) but with the per-record loop of
contig.rs:107-215 folded into the decoder.

Streaming state between segments:
  - raw carry: the bytes of a record straddling the segment boundary
    are copied to the head of the next segment's decode buffer (by the
    native ingest call, or on the card into the headroom before the
    next inflated segment) — no full-segment concat;
  - block carry: the open (trailing) contig's BLOCKS are carried instead
    of its raw record bytes, so memory for a contig that spans many
    segments is 12 bytes/block instead of ~full record size (the
    streaming-memory fix of VERDICT r3 #2; reference streams one contig
    at 4 bytes/bp, contig.rs:144-145).

Per-contig float statistics (identity sums) accumulate sequentially
within each 32k-record chunk and merge in chunk order, so results are
deterministic; they can differ from the numpy batch path by O(1e-12)
relative rounding when a contig spans a chunk boundary.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from . import native
from .bam import (BamFormatError, BamStreamReader, TruncatedHeaderError,
                  _parse_header, check_stuck_zero)

# Virtual headroom ahead of each segment's inflate output for the
# straddling-record carry (np.empty leaves it unmapped until touched, so
# the cost is only the pages the carry actually fills).
_HEADROOM = 64 << 20
# Room ahead of each segment's inflated bytes in its card slot for the
# carry, which the slot's allocation holds whole: a longer carry grows
# the slot.
_CARD_HEADROOM = 1 << 20


def _check_stuck_carry(carry) -> None:
    """A carry whose head record has block_size 0 with bytes behind it
    can never make progress (the chain walk treats bs==0 as EOS): fail
    loudly instead of accumulating O(file) carry RSS and silently
    dropping the tail (ADVICE r4).  Same rule as the classic reader's
    check_stuck_zero, so fused and classic reach the same outcome."""
    if carry is not None and len(carry):
        check_stuck_zero(carry, 0)


def fused_available() -> bool:
    if os.environ.get("COVERM_TPU_FUSED", "1") == "0":
        return False
    lib = native.get_lib()
    return lib is not None and hasattr(lib, "ct_stats_scan")


class FusedScanStream:
    """Lazy segment stream over a BGZF BAM (or CRAM) with an eagerly
    parsed header.

    scan_any routes this payload through scan_sample_fused when the
    fused native engine applies; otherwise (COVERM_TPU_FUSED=0)
    iterating it yields plain contig-disjoint RecordBatches via
    BamStreamReader, byte-identical to the classic path.  The CRAM plan
    holds an mmap and an open file; close() releases them (the fused
    scan does so when it has read the last slice).

    A filtered source puts its read filter on the stream with
    filtered(); `read_filter` is then the readfilter.FilterParams that
    the fused scan applies in its record loop, and the classic batches
    of anyone who iterates the stream instead pass through
    readfilter.filter_payload."""

    def __init__(self, path: str, target_bytes: int | None = None,
                 device=None):
        self.path = path
        # where the classic batches inflate and parse (BamStreamReader)
        self.device = device
        if target_bytes is None:
            target_bytes = int(os.environ.get("COVERM_TPU_SEGMENT_BYTES",
                                              1 << 28))
        self.target_bytes = int(target_bytes)
        self.header = None
        self._gen = None
        self._first = None
        self._cram = None
        self._plan = None
        self._filter = None  # (source, params, flag_filters)
        # whether the classic batches keep their bytes: only under a read
        # filter that reads records whole (readfilter.reads_whole_records)
        self._whole = False

    def filtered(self, source, params, flag_filters):
        """This stream's payload under a filtered source's read filter
        (commands.FilteredBamFileSource): the stream itself, the filter
        applied in the fused scan's record loop, when it is on the BGZF
        plan, the native scan is available and the filter is
        single-read-only. The scan counts the primary alignments before
        the filter, so source.num_primary_override stays None. Else (pair
        filters join mates; CRAM) the classic batches through
        readfilter.filter_payload, which sets it."""
        from ..readfilter import filter_payload, reads_whole_records

        if (self._plan is not None and fused_available()
                and params.filtering_modes(flag_filters) == (True, False)):
            self._filter = (source, params, flag_filters)
            source.num_primary_override = None
            return self
        self._whole = reads_whole_records(params, flag_filters)
        return filter_payload(source, self, params, flag_filters)

    @property
    def read_filter(self):
        """The readfilter.FilterParams the fused scan applies, or None."""
        return None if self._filter is None else self._filter[1]

    # ---- classic fallback ----
    def batches(self, device=None):
        """The classic reader's batches (under the stream's read filter),
        inflated and parsed on `device`, else the stream's own device
        (device.resolve_device: None is the card); with their bytes only
        when the filter that the stream was given reads records whole (a
        pair filter), so that `--gff` and the single-read filters copy
        back only the columns."""
        from ..readfilter import filter_payload

        header, gen = BamStreamReader(
            self.path, target_bytes=self.target_bytes,
            device=self.device if device is None else device,
            keep_bytes=self._whole).read()
        if self._filter is None:
            return gen
        source, params, flag_filters = self._filter
        return filter_payload(source, gen, params, flag_filters)

    def __iter__(self):
        return self.batches()

    # ---- fused path ----
    def open(self):
        """Parse the header; on the native-BGZF path only the leading
        blocks inflate (geometrically grown until the header fits) and
        the remainder is planned as raw block-table groups for the
        one-call fused ingest (ct_ingest_scan); on the CRAM path the
        container body offset is planned for per-slice stats decoding
        (ct_cram_stats_slice)."""
        import struct

        self._plan = None
        if self._open_bgzf_plan():
            return self.header
        if self._open_cram_plan():
            return self.header
        self._gen = self._segments_raw()
        acc = None
        for out, lo, hi in self._gen:
            chunk = out[lo:hi]
            acc = chunk if acc is None else np.concatenate([acc, chunk])
            try:
                self.header, start = _parse_header(acc)
            except (struct.error, IndexError, UnicodeDecodeError,
                    TruncatedHeaderError):
                continue  # header spans segments; keep accumulating
            self._first = (acc, start, len(acc))
            return self.header
        if acc is None:
            raise BamFormatError(f"empty BAM stream: {self.path}")
        self.header, start = _parse_header(acc)  # raises on real garbage
        self._first = (acc, start, len(acc))
        return self.header

    def _open_bgzf_plan(self) -> bool:
        import struct

        lib = native.get_lib()
        if lib is None or not hasattr(lib, "ct_ingest_scan"):
            return False
        with open(self.path, "rb") as f:
            if f.read(2) != b"\x1f\x8b":
                return False
        mm = np.memmap(self.path, np.uint8, mode="r")
        tables = native.bgzf_scan(mm)
        if tables is None:
            return False
        off, csz, usz = tables
        n = off.size
        j = min(8, n)
        while True:
            buf = native.bgzf_inflate_blocks(mm, off[:j], csz[:j], usz[:j])
            if buf is None:
                raise BamFormatError(f"BGZF inflate failed in {self.path}")
            try:
                self.header, hdr_end = _parse_header(buf)
                break
            except (struct.error, IndexError, UnicodeDecodeError,
                    TruncatedHeaderError):
                if j >= n:
                    _parse_header(buf)  # re-raise the real error
                    raise
                j = min(j * 4, n)
        self._plan = (mm, off, csz, usz, buf[hdr_end:], j)
        return True

    def _open_cram_plan(self) -> bool:
        """CRAM direct-stats plan: slices decode straight into block/stat
        arrays (ct_cram_stats_slice) — no BAM byte materialisation, no
        re-scan.  COVERM_TPU_CRAM_STATS=0 forces the legacy
        BAM-materialising route (kept as oracle/fallback)."""
        with open(self.path, "rb") as f:
            if f.read(4) != b"CRAM":
                return False
        if os.environ.get("COVERM_TPU_CRAM_STATS", "1") == "0":
            return False
        if os.environ.get("COVERM_TPU_NATIVE_CRAM", "1") == "0":
            return False
        lib = native.get_lib()
        if lib is None or not hasattr(lib, "ct_cram_stats_slice"):
            return False
        import mmap
        import struct
        import zlib

        from .cram import (CramFormatError, bam_header_bytes_from_sam_text,
                           read_cram_header_text)
        f = open(self.path, "rb")
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        try:
            sam_text, body_off = read_cram_header_text(mm)
            hdr_bytes = bam_header_bytes_from_sam_text(sam_text)
            self.header, _ = _parse_header(
                np.frombuffer(hdr_bytes, np.uint8))
        except (IndexError, struct.error, zlib.error, EOFError, KeyError,
                ValueError, UnicodeDecodeError) as e:
            mm.close()
            f.close()
            raise CramFormatError(
                f"Truncated or corrupt CRAM file ({e}); if the file is a "
                "newer CRAM minor version re-encode it, e.g.: samtools "
                "view -C --output-fmt cram,version=3.0 in.cram") from e
        except Exception:
            mm.close()
            f.close()
            raise
        self._cram = (mm, body_off, f)
        return True

    def close(self):
        """Release the CRAM plan's mmap and file (idempotent)."""
        if self._cram is not None:
            mm, _off, f = self._cram
            self._cram = None
            mm.close()
            f.close()

    def raw_buffers(self):
        """(buffer, data_lo, data_hi) triples; records start at data_lo
        of the first yield (the header is already consumed).  Only used
        when no ingest plan exists (CRAM / no-native fallback)."""
        if self.header is None:
            self.open()
        assert self._plan is None
        yield self._first
        yield from self._gen

    def _segments_raw(self):
        with open(self.path, "rb") as f:
            magic = f.read(4)
        if magic == b"CRAM":
            from .cram import iter_bam_segments
            import mmap
            with open(self.path, "rb") as f:
                mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
                try:
                    for seg in iter_bam_segments(mm):
                        arr = np.frombuffer(seg, dtype=np.uint8)
                        yield arr, 0, arr.size
                finally:
                    mm.close()
            return
        if native.get_lib() is not None:
            mm = np.memmap(self.path, np.uint8, mode="r")
            tables = native.bgzf_scan(mm)
            if tables is not None:
                off, csz, usz = tables
                cum = np.cumsum(usz)
                i, n = 0, off.size
                while i < n:
                    base = int(cum[i - 1]) if i else 0
                    j = int(np.searchsorted(cum, base + self.target_bytes)) + 1
                    j = min(max(j, i + 1), n)
                    tot = int(cum[j - 1]) - base
                    out = np.empty(_HEADROOM + tot, np.uint8)
                    rc = native.bgzf_inflate_into(
                        mm, off[i:j], csz[i:j], usz[i:j], out, _HEADROOM)
                    if not rc:
                        raise BamFormatError(
                            f"BGZF inflate failed in {self.path}")
                    yield out, _HEADROOM, _HEADROOM + tot
                    i = j
                return
        # portable fallback: sequential zlib streaming
        from . import bgzf as _bgzf
        with open(self.path, "rb") as f:
            pend, size = [], 0
            for piece in _bgzf.iter_decompress(f):
                pend.append(piece)
                size += len(piece)
                if size >= self.target_bytes:
                    arr = np.frombuffer(b"".join(pend), np.uint8)
                    yield arr, 0, arr.size
                    pend, size = [], 0
            if pend:
                arr = np.frombuffer(b"".join(pend), np.uint8)
                yield arr, 0, arr.size


def cram_workers() -> int:
    """Threads that decode CRAM slices at once on the direct-stats route:
    one a host CPU, at most 8, as the native calls count them."""
    return min(os.cpu_count() or 1, 8)


def _decode_cram_slice(raw, task, n_ref, skip_mask, req_mask, stop):
    """A pool worker's share of one slice: the CRC checks, inflate and
    rANS decode of its blocks (one rANS thread: the pool is the
    parallelism), then ct_cram_stats_slice; zlib and ctypes release the
    GIL for both. Touches no StatsAccum. Returns (dec, blocks): dec the
    native handle and scalars, or None where the native decoder rejects
    the slice, and then blocks = (core, ext_items) for the python
    fallback. Once `stop` is set it returns (None, None) at its next
    step."""
    from .cram import slice_block_data

    if stop.is_set():
        return None, None
    core, ext_items = slice_block_data(raw, task, rans_threads=1)
    if stop.is_set():
        return None, None
    dec = native.cram_stats_decode(task.comp_block.data, task.sh_block.data,
                                   core, ext_items, n_ref, skip_mask,
                                   req_mask)
    return dec, None if dec is not None else (core, ext_items)


def _cram_slice_blocks(stream, stats, skip_mask, req_mask):
    """Per-slice (btid, bstart, bend, seg_counts) via the native direct
    stats decoder, falling back to the python record model + stats_scan
    for any slice the native decoder rejects (identical outcome either
    way: the python path raises CramFormatError loudly on real
    corruption).

    The container walk runs on this thread, at most 2 x cram_workers()
    slices ahead of the slice it hands on (host memory stays bounded);
    each slice's blocks and native decode go to a pool of
    cram_workers() threads (_decode_cram_slice), and every
    result is taken strictly in file order: this thread adds it into
    `stats` (so the float64 identity sums add in the order of a
    sequential scan), runs a rejected slice's fallback, and raises a
    slice's error, or the walk's, where that slice or the walk's
    position comes in the file. On every exit the pool is stopped and
    joined and the handles not taken are freed before the stream's CRAM
    plan, the mmap the workers read, is closed."""
    import struct
    import zlib
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    from .cram import (CramFormatError, _bam_record_bytes,
                       decode_slice_python, parse_compression_header,
                       walk_cram_slices)

    mm, body_off, _f = stream._cram
    lib = native.get_lib()
    workers = cram_workers()
    stop = threading.Event()
    pool = ThreadPoolExecutor(workers, thread_name_prefix="cram-slice")
    tasks = walk_cram_slices(mm, body_off, lazy_skippable=True)
    pending = deque()  # (task, future) in file order
    walk_error = None
    comp_cache = (None, None)
    try:
        while True:
            while tasks is not None and len(pending) < 2 * workers:
                try:
                    task = next(tasks)
                except StopIteration:
                    tasks = None
                    break
                except Exception as e:  # raised after the slices before
                    walk_error, tasks = e, None
                    break
                pending.append((task, pool.submit(
                    _decode_cram_slice, mm, task, stats.n_ref, skip_mask,
                    req_mask, stop)))
            if not pending:
                if walk_error is not None:
                    raise walk_error
                return
            task, fut = pending[0]
            dec, blocks = fut.result()  # the slice's own error, in order
            pending.popleft()
            if dec is not None:
                h, scalars = dec
                res = native._finish_stats_handle(lib, h, scalars, stats,
                                                  leftover_from_buf=False)
                yield res[:4]
                continue
            # python fallback for this slice; the cache holds the block
            # object itself so identity stays valid.  Size-only streams
            # decompress here after all — the fallback reads them.
            core_data, ext_items = blocks
            ext_items = [(cid, d.materialize() if hasattr(d, "rsize")
                          else d) for cid, d in ext_items]
            comp_block = task.comp_block
            comp = comp_cache[1] if comp_cache[0] is comp_block else None
            if comp is None:
                comp = parse_compression_header(comp_block.data)
                comp_cache = (comp_block, comp)
            recs = decode_slice_python(comp, task.sl, core_data, ext_items)
            part = bytearray()
            for r in recs:
                part += _bam_record_bytes(r)
            res2 = native.stats_scan(
                np.frombuffer(bytes(part), np.uint8), 0, stats,
                skip_mask, req_mask)
            if res2 is None:
                raise RuntimeError("native fused scan unavailable")
            yield res2[0], res2[1], res2[2], res2[3]
    except (IndexError, struct.error, zlib.error, EOFError, KeyError,
            ValueError, UnicodeDecodeError) as e:
        # same wrap as iter_cram_containers: malformed container bytes
        # (or stats-layer rejects such as an out-of-range tid) surface
        # through the CLI's fail-fast `Error:` path; CramFormatError
        # itself passes through untouched.
        raise CramFormatError(
            f"Truncated or corrupt CRAM file ({e}); if the file is a "
            "newer CRAM minor version re-encode it, e.g.: samtools view "
            "-C --output-fmt cram,version=3.0 in.cram") from e
    finally:
        # no worker may be inside the mmap, nor a handle left, when the
        # plan closes
        stop.set()
        pool.shutdown(wait=True, cancel_futures=True)
        for _task, fut in pending:
            if not fut.cancelled() and fut.exception() is None:
                dec = fut.result()[0]
                if dec is not None:
                    lib.ct_stats_free(dec[0])
        if tasks is not None:
            tasks.close()
        stream.close()


def plan_segments(usz, j, target_bytes):
    """The (i, k) BGZF block ranges of the fused ingest after the header
    probe's first j blocks: each about target_bytes inflated, and at least
    one block."""
    cum = np.cumsum(usz)
    segments, i, n = [], j, usz.size
    while i < n:
        base = int(cum[i - 1]) if i else 0
        k = int(np.searchsorted(cum, base + target_bytes)) + 1
        k = min(max(k, i + 1), n)
        segments.append((i, k))
        i = k
    return segments


def _card_inflater(dev):
    """The inflater of a BGZF file's segments on `dev`, for the fused
    ingest and the classic reader (io/bam.BamStreamReader): on a CUDA
    device ops.bgzf_inflate.SegmentInflater on that card, into card slots
    that the card's record scan or parse reads; None on the CPU, where the
    host inflates (the fused ingest's ct_ingest_scan, the reader's native
    threads)."""
    if dev.type != "cuda":
        return None
    from ..ops.bgzf_inflate import SegmentInflater

    def make(path, off, csz, usz, segments, at):
        return SegmentInflater(path, off, csz, usz, segments, at, dev)
    return make


def scan_sample_fused(header, stream: FusedScanStream, layout, flag_filter,
                      need_hist: bool, trim=None, device=None,
                      depth_fn=None):
    """One-native-pass streaming scan -> SampleScan.

    Matches scan.scan_sample_batches semantically (same SampleScan, same
    error messages) while doing all per-record work in C++.  Each
    contig-closed group of blocks is dispatched to the sweep on `device`
    as soon as it closes, folding into one on-device accumulator; or,
    when depth_fn is given (a deferred-capable engine: the contig-sharded
    mesh sweep or the multi-process sweep), through depth_fn, deferred
    and without the accumulator, so multi-device runs get the same fused
    host ingestion.  The stream's `read_filter` goes to every native
    call: a record that fails it counts toward the primary alignments
    and nothing else, as readfilter.filter_payload leaves it.

    The BGZF plan's segments are inflated and scanned on the card when
    `device` resolves (device.resolve_device: None is the card) to a CUDA
    device, the first local card on a multi-device route: the hand-written
    kernels of ops/bgzf_inflate.py and ops/bam_scan.py, the inflated bytes
    staying in card memory and only the blocks, runs and scalars coming
    back. There is no fall-back to the host's inflate or scan there. On
    the CPU the host inflates and scans in one native call a segment."""
    from ..device import card_turn as device_turn
    from ..device import resolve_device
    from ..prefetch import prefetch_iter
    from ..scan import (BamSortingError, MissingNMTagError, SampleScan,
                        merge_depth_stats)
    from ..ops.sweep import (DepthAccumulator, compute_depth_stats_sweep,
                             empty_depth_stats, resolve_depth)

    C = header.n_ref
    skip_mask, req_mask = flag_filter.masks()
    rf = stream.read_filter
    stats = native.StatsAccum(C)
    dep_acc = DepthAccumulator()
    pendings = []
    carry = []       # [(btid, bstart, bend)] chunks of the open contig
    carry_tid = -1
    # a card slot and its scan's buffers live only between engine calls:
    # the card route's ingest and the engine's dispatch take turns
    card_turn = device_turn(device)

    def dispatch(chunks, counts=None):
        with card_turn:
            _dispatch(chunks, counts)

    def _dispatch(chunks, counts=None):
        if not chunks:
            return
        if len(chunks) == 1:
            bt, bs, be = chunks[0]
        else:
            bt = np.concatenate([c[0] for c in chunks])
            bs = np.concatenate([c[1] for c in chunks])
            be = np.concatenate([c[2] for c in chunks])
        if bt.size == 0:
            return
        if depth_fn is not None:
            pendings.append(depth_fn(layout, bt, bs, be, need_hist=need_hist,
                                     trim=trim, deferred=True))
            return
        pendings.append(compute_depth_stats_sweep(
            layout, bt, bs, be, need_hist=need_hist, trim=trim,
            deferred=True, acc=dep_acc, contig_counts=counts,
            device=device))

    def plan_blocks():
        """Yield (btid, bstart, bend, seg_counts) per segment of the BGZF
        plan; returns the raw carry left after the last one. On the CPU
        one native call a segment (ct_ingest_scan): inflate, chain and
        scan overlap inside it, and the raw_carry (incomplete tail record
        bytes) threads through natively. NOTE: distinct from the ingest
        loop's outer `carry` (the open contig's BLOCK chunks) -- renamed
        so the two can never be conflated (ADVICE r4)."""
        mm, off, csz, usz, raw_carry, j = stream._plan
        segments = plan_segments(usz, j, stream.target_bytes)
        inflater = _card_inflater(resolve_device(device))
        if inflater is not None:
            return (yield from card_blocks(inflater, off, csz, usz,
                                           segments, raw_carry))
        for i, k in segments:
            res = native.ingest_scan(mm, off[i:k], csz[i:k], usz[i:k],
                                     raw_carry, 0, stats, skip_mask,
                                     req_mask, read_filter=rf)
            if res is None:
                raise RuntimeError("native fused ingest unavailable")
            bt, bs, be, seg_counts, raw_carry = res
            _check_stuck_carry(raw_carry)
            yield bt, bs, be, seg_counts
        return raw_carry

    def card_blocks(inflater, off, csz, usz, segments, raw_carry):
        """The plan's segments inflated and scanned on the card, each in a
        slot of its own that is let go before the engine's next turn: the
        raw carry goes just before each inflated segment, and the bytes
        left after the last one are scanned there too. The carry (the
        bytes of the record that straddles the segments, most often a few
        hundred) comes back with the scan's outputs and goes in again
        with the next segment, so that nothing of the ingest is left on
        the card while the engine runs. Returns None: no carry is left
        for the host."""
        inf = inflater(stream.path, off, csz, usz, segments,
                       _CARD_HEADROOM)
        carry = raw_carry
        try:
            if segments:
                inf.start(0)
            for s in range(len(segments)):
                if s + 1 < len(segments):
                    inf.start(s + 1)
                with card_turn:
                    slot, lo, hi = inf.take(s, carry)
                    res, carry = card_scan(inf, slot, lo, hi)
                    del slot
                _check_stuck_carry(carry)
                yield res
            if carry is not None and len(carry):
                # trailing bytes (or a header-probe remainder when the
                # whole file fit in the probe)
                with card_turn:
                    tail = torch.from_numpy(np.ascontiguousarray(
                        carry)).to(inf.device)
                    res, _ = card_scan(inf, tail, 0, tail.numel())
                    del tail
                if res[0].size:
                    yield res
        finally:
            inf.close()
        return None

    def card_scan(inf, slot, lo, hi):
        """ops.bam_scan over slot[lo:hi] on the inflater's stream, its
        outputs added into `stats` as the host scan's are: the segment's
        (btid, bstart, bend, seg_counts) and the carry, the bytes after
        its last complete record, in host memory."""
        from ..ops import bam_scan
        with inf.on_stream():
            sc = bam_scan.scan_segment(slot, lo, hi, C, skip_mask, req_mask,
                                       rf)
        scalars = sc.scalars()
        native.check_scalars(scalars)
        seg_counts = stats.add_runs(sc.runs)
        stats.add_segment(scalars)
        return (sc.btid, sc.bstart, sc.bend, seg_counts), sc.tail

    def seg_blocks():
        """Yield (btid, bstart, bend) per segment, updating `stats`."""
        if getattr(stream, "_cram", None) is not None:
            yield from _cram_slice_blocks(stream, stats, skip_mask,
                                          req_mask)
            return
        if getattr(stream, "_plan", None) is not None:
            raw_carry = yield from plan_blocks()
            if raw_carry is not None and len(raw_carry):
                # trailing bytes (or a header-probe remainder when the
                # whole file fit in the probe): scan them directly
                res = native.stats_scan(np.ascontiguousarray(raw_carry), 0,
                                        stats, skip_mask, req_mask,
                                        read_filter=rf)
                if res is not None and res[0].size:
                    yield res[0], res[1], res[2], res[3]
            return
        leftover = None
        for out, lo, hi in prefetch_iter(stream.raw_buffers()):
            if leftover is not None and leftover.size:
                n = leftover.size
                if n <= lo and out.flags.writeable:
                    out[lo - n:lo] = leftover
                    lo -= n
                else:
                    out = np.concatenate([leftover, out[lo:hi]])
                    lo, hi = 0, out.size
            res = native.stats_scan(out, lo, stats, skip_mask, req_mask,
                                    end=hi, read_filter=rf)
            if res is None:
                raise RuntimeError("native fused scan unavailable")
            bt, bs, be, seg_counts, end_off = res
            leftover = out[end_off:hi]
            _check_stuck_carry(leftover)
            yield bt, bs, be, seg_counts

    def iter_segments():
        gen = seg_blocks()
        if getattr(stream, "_plan", None) is not None or \
                getattr(stream, "_cram", None) is not None:
            # overlap the next native ingest / slice decode with this
            # segment's dispatch prep (bincount/delta-encode/pack + h2d)
            gen = prefetch_iter(gen)
        try:
            yield from gen
        except ValueError as e:  # malformed records from the native scan
            raise BamFormatError(str(e))

    carry_counts = None
    for bt, bs, be, seg_counts in iter_segments():
        if not stats.sorted:
            raise BamSortingError(
                "BAM file appears to be unsorted. Input BAM files must be "
                "sorted by reference (i.e. by samtools sort)")
        if stats.nm_missing:
            raise MissingNMTagError(
                "Mapping record encountered that does not have an 'NM' "
                "auxiliary tag in the SAM/BAM format. This is required to "
                "work out some coverage statistics.")
        if bt.size == 0:
            continue
        first, last = int(bt[0]), int(bt[-1])
        if carry_tid >= 0 and first != carry_tid:
            dispatch(carry, carry_counts)  # carried contig closed at EOS
            carry, carry_counts = [], None
        split = int(np.searchsorted(bt, last))
        if split > 0:
            carry.append((bt[:split], bs[:split], be[:split]))
            closed_counts = seg_counts.copy()
            closed_counts[last] = 0
            if carry_counts is not None:
                closed_counts += carry_counts
            dispatch(carry, closed_counts)
            carry = []
            # copy the open tail so the closed part's memory frees
            carry.append((bt[split:].copy(), bs[split:].copy(),
                          be[split:].copy()))
            carry_counts = np.zeros_like(seg_counts)
            carry_counts[last] = seg_counts[last]
        else:
            carry.append((bt, bs, be))
            if carry_counts is None:
                carry_counts = seg_counts.copy()
            else:
                carry_counts += seg_counts
        carry_tid = last
    dispatch(carry, carry_counts)

    dep_acc.start_fetch()
    for p in pendings:
        p.start_fetch()
    depth = None
    for p in pendings:
        d = resolve_depth(p)
        depth = d if depth is None else merge_depth_stats(depth, d)
    if not dep_acc.empty:
        d = dep_acc.result()
        depth = d if depth is None else merge_depth_stats(depth, d)
    if depth is None:
        depth = empty_depth_stats(C, need_hist, trim)

    return SampleScan(
        header=header, depth=depth, observed=stats.observed.view(bool),
        reads_primary=stats.reads_primary,
        reads_nonsupp=stats.reads_nonsupp, reads_all=stats.reads_all,
        nm_sum=stats.nm_sum, indel_sum=stats.indel_sum,
        identity_sum_primary=stats.ident_primary,
        identity_sum_nonsupp=stats.ident_nonsupp,
        num_detected_primary_alignments=stats.n_primary,
    )
