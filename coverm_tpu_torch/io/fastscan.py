"""Fused-native streaming scan: the production BAM-ingestion fast path.

This module collapses the host side of BAM ingest into ONE native pass
per segment (native/bamdecode.cpp ct_stats_scan): the
chain walk, CIGAR walk, aux NM scan, flag gating, and every per-contig
statistic the scan layer needs are computed in the C++ workers, and only
the filtered coverage-block arrays (12 bytes/block) cross back into
Python for device dispatch.  Columns the coverage path never reads
(qname hashes, AS scores, per-record arrays, record byte offsets) are
not materialised at all — the analogue of htslib's role in the
reference (bam_generator.rs:125-129) but with the per-record loop of
contig.rs:107-215 folded into the decoder.

Streaming state between segments:
  - raw carry: the bytes of a record straddling the segment boundary
    thread through the native ingest call (copied to the head of the
    next segment's decode buffer) — no full-segment concat;
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

import numpy as np

from . import native
from .bam import (CRAM_UNSUPPORTED, BamFormatError, BamStreamReader,
                  TruncatedHeaderError, _parse_header, check_stuck_zero)

# Virtual headroom ahead of each segment's inflate output for the
# straddling-record carry (np.empty leaves it unmapped until touched, so
# the cost is only the pages the carry actually fills).
_HEADROOM = 64 << 20


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
    """Lazy segment stream over a BGZF BAM with an eagerly parsed header.

    scan_any routes this payload through scan_sample_fused when the
    fused native engine applies; otherwise (COVERM_TPU_FUSED=0)
    iterating it yields plain contig-disjoint RecordBatches via
    BamStreamReader, byte-identical to the classic path.  CRAM input is
    not supported by this package yet."""

    def __init__(self, path: str, target_bytes: int | None = None):
        self.path = path
        if target_bytes is None:
            target_bytes = int(os.environ.get("COVERM_TPU_SEGMENT_BYTES",
                                              1 << 28))
        self.target_bytes = int(target_bytes)
        self.header = None
        self._gen = None
        self._first = None

    # ---- classic fallback ----
    def batches(self):
        header, gen = BamStreamReader(self.path,
                                      target_bytes=self.target_bytes).read()
        return gen

    def __iter__(self):
        return self.batches()

    # ---- fused path ----
    def open(self):
        """Parse the header; on the native-BGZF path only the leading
        blocks inflate (geometrically grown until the header fits) and
        the remainder is planned as raw block-table groups for the
        one-call fused ingest (ct_ingest_scan)."""
        import struct

        self._plan = None
        with open(self.path, "rb") as f:
            if f.read(4) == b"CRAM":
                raise BamFormatError(CRAM_UNSUPPORTED)
        if self._open_bgzf_plan():
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

    def raw_buffers(self):
        """(buffer, data_lo, data_hi) triples; records start at data_lo
        of the first yield (the header is already consumed).  Only used
        when no ingest plan exists (no-native fallback)."""
        if self.header is None:
            self.open()
        assert self._plan is None
        yield self._first
        yield from self._gen

    def _segments_raw(self):
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


def scan_sample_fused(header, stream: FusedScanStream, layout, flag_filter,
                      need_hist: bool, trim=None, device=None):
    """One-native-pass streaming scan -> SampleScan.

    Matches scan.scan_sample_batches semantically (same SampleScan, same
    error messages) while doing all per-record work in C++.  Each
    contig-closed group of blocks is dispatched to the sweep on `device`
    as soon as it closes, folding into one on-device accumulator."""
    from ..prefetch import prefetch_iter
    from ..scan import (BamSortingError, MissingNMTagError, SampleScan,
                        merge_depth_stats)
    from ..ops.sweep import (DepthAccumulator, compute_depth_stats_sweep,
                             empty_depth_stats, resolve_depth)

    C = header.n_ref
    skip_mask, req_mask = flag_filter.masks()
    stats = native.StatsAccum(C)
    dep_acc = DepthAccumulator()
    pendings = []
    carry = []       # [(btid, bstart, bend)] chunks of the open contig
    carry_tid = -1

    def dispatch(chunks, counts=None):
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
        pendings.append(compute_depth_stats_sweep(
            layout, bt, bs, be, need_hist=need_hist, trim=trim,
            deferred=True, acc=dep_acc, contig_counts=counts,
            device=device))

    def seg_blocks():
        """Yield (btid, bstart, bend) per segment, updating `stats`."""
        if getattr(stream, "_plan", None) is not None:
            # one-call fused ingest per raw block-table group: inflate,
            # chain and scan overlap inside the native call; the
            # raw_carry (incomplete tail record bytes) threads through
            # natively.  NOTE: distinct from the ingest loop's outer
            # `carry` (the open contig's BLOCK chunks) — renamed so the
            # two can never be conflated (ADVICE r4).
            mm, off, csz, usz, raw_carry, j = stream._plan
            cum = np.cumsum(usz)
            n = off.size
            i = n if j >= n else j
            while i < n:
                base = int(cum[i - 1]) if i else 0
                k = int(np.searchsorted(cum, base + stream.target_bytes)) + 1
                k = min(max(k, i + 1), n)
                res = native.ingest_scan(mm, off[i:k], csz[i:k], usz[i:k],
                                         raw_carry, 0, stats, skip_mask,
                                         req_mask)
                if res is None:
                    raise RuntimeError("native fused ingest unavailable")
                bt, bs, be, seg_counts, raw_carry = res
                _check_stuck_carry(raw_carry)
                yield bt, bs, be, seg_counts
                i = k
            if raw_carry is not None and len(raw_carry):
                # trailing bytes (or a header-probe remainder when the
                # whole file fit in the probe): scan them directly
                res = native.stats_scan(np.ascontiguousarray(raw_carry), 0,
                                        stats, skip_mask, req_mask)
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
                                    end=hi)
            if res is None:
                raise RuntimeError("native fused scan unavailable")
            bt, bs, be, seg_counts, end_off = res
            leftover = out[end_off:hi]
            _check_stuck_carry(leftover)
            yield bt, bs, be, seg_counts

    def iter_segments():
        gen = seg_blocks()
        if getattr(stream, "_plan", None) is not None:
            # overlap the next native ingest with this segment's
            # dispatch prep (bincount/delta-encode/pack + h2d)
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
