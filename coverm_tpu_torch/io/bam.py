"""Host-side BAM decode into packed struct-of-arrays batches.

This is the ingestion layer of the TPU engine (the analogue of the
reference's rust-htslib record loop, bam_generator.rs + the CIGAR walks
in contig.rs:168-202).  Instead of streaming one record at a time, a BAM
file is decoded into numpy struct-of-arrays: one row per alignment record
plus one row per *coverage block* (a M/X/= CIGAR run, the unit that
increments the depth delta array).  All CIGAR arithmetic is vectorised;
the per-record sequential work is only the record-offset walk and aux-tag
scan (replaced by the native C++ decoder when built).

Flag semantics and per-record derived quantities follow the reference:
  - aligned length for coverage/identity: M+X+=+D+I   (contig.rs:168-199)
  - aligned length for single-read filter: M+I+D+X+=  (filter.rs:259-266)
  - aligned length for pair filter:        M+I+X+=    (filter.rs:302-318, no D)
  - indels: I+D                                        (contig.rs:187-199)
"""

from __future__ import annotations

import struct
import time
from dataclasses import dataclass, field

import numpy as np

from . import bgzf

# BAM CIGAR op codes
OP_M, OP_I, OP_D, OP_N, OP_S, OP_H, OP_P, OP_EQ, OP_X = range(9)

FLAG_PAIRED = 0x1
FLAG_PROPER_PAIR = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_READ1 = 0x40
FLAG_READ2 = 0x80
FLAG_SECONDARY = 0x100
FLAG_QCFAIL = 0x200
FLAG_DUP = 0x400
FLAG_SUPPLEMENTARY = 0x800


class BamFormatError(Exception):
    pass


class TruncatedHeaderError(BamFormatError):
    """Header spans beyond the current buffer (streaming ingestion)."""


@dataclass
class BamHeader:
    text: str
    target_names: list  # list[str]
    target_lens: np.ndarray  # int64[n_ref]
    raw: bytes = b""  # raw header block (magic..refs) for BAM re-emission

    @property
    def n_ref(self) -> int:
        return len(self.target_names)


@dataclass
class RecordBatch:
    """Struct-of-arrays decode of a run of BAM records.

    Read-level arrays (length n_records, BAM stream order):
      tid, pos: int32 (pos is 0-based leftmost ref coordinate)
      flag: uint16; mapq: uint8
      nm: int64 (NM aux tag; -1 when absent)
      as_score: int64 (AS aux tag; INT64_MIN when absent)
      seq_len: int32 (l_seq)
      aligned_cov: int64   M+X+=+D+I  (identity denominator)
      aligned_single: int64  M+I+D+X+= (single-read filter)
      aligned_pair: int64  M+I+X+=   (pair filter, excludes D)
      indels: int64        I+D
      read_end: int32      pos + reference-consumed length
      qname_hash: uint64   FNV-1a of the query name (pair joining)
      rec_start/rec_end: int64 offsets of the raw record (incl. block_size
                         prefix) in the decoded byte stream, for rewriting.

    Block-level arrays (length n_blocks; one row per M/X/= CIGAR run):
      block_read: int32 index into the read-level arrays
      block_start/block_end: int32 reference interval [start, end)
    """

    n_records: int
    tid: np.ndarray
    pos: np.ndarray
    flag: np.ndarray
    mapq: np.ndarray
    nm: np.ndarray
    as_score: np.ndarray
    seq_len: np.ndarray
    aligned_cov: np.ndarray
    aligned_single: np.ndarray
    aligned_pair: np.ndarray
    indels: np.ndarray
    read_end: np.ndarray
    qname_hash: np.ndarray
    rec_start: np.ndarray
    rec_end: np.ndarray
    block_read: np.ndarray
    block_start: np.ndarray
    block_end: np.ndarray
    # decoded BAM byte stream (for record re-emission); None when the
    # reader was asked not to keep it (BamStreamReader keep_bytes=False)
    data: bytes | None = b""

    # ---- flag helpers (vectorised) ----
    def is_unmapped(self):
        return (self.flag & FLAG_UNMAPPED) != 0

    def is_secondary(self):
        return (self.flag & FLAG_SECONDARY) != 0

    def is_supplementary(self):
        return (self.flag & FLAG_SUPPLEMENTARY) != 0

    def is_proper_pair(self):
        return (self.flag & FLAG_PROPER_PAIR) != 0

    def is_primary(self):
        return (self.flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY)) == 0

    def select(self, mask: np.ndarray) -> "RecordBatch":
        """Subset record-level rows (and their blocks) by a boolean mask."""
        idx = np.flatnonzero(mask)
        remap = np.full(self.n_records, -1, dtype=np.int64)
        remap[idx] = np.arange(idx.size)
        bkeep = mask[self.block_read]
        return RecordBatch(
            n_records=idx.size,
            tid=self.tid[idx], pos=self.pos[idx], flag=self.flag[idx],
            mapq=self.mapq[idx], nm=self.nm[idx], as_score=self.as_score[idx],
            seq_len=self.seq_len[idx], aligned_cov=self.aligned_cov[idx],
            aligned_single=self.aligned_single[idx],
            aligned_pair=self.aligned_pair[idx], indels=self.indels[idx],
            read_end=self.read_end[idx], qname_hash=self.qname_hash[idx],
            rec_start=self.rec_start[idx], rec_end=self.rec_end[idx],
            block_read=remap[self.block_read[bkeep]].astype(np.int32),
            block_start=self.block_start[bkeep],
            block_end=self.block_end[bkeep],
            data=self.data,
        )

    def rows(self, lo: int, hi: int) -> "RecordBatch":
        """Record rows [lo, hi) (and their blocks) as zero-copy views;
        block_read counts from row lo. block_read is non-decreasing
        (blocks are emitted in record order), so the block range is a
        searchsorted slice."""
        b0, b1 = (int(i) for i in np.searchsorted(self.block_read, (lo, hi)))
        block_read = self.block_read[b0:b1]
        return RecordBatch(
            n_records=hi - lo,
            **{c: getattr(self, c)[lo:hi] for c in _RECORD_COLUMNS},
            rec_start=self.rec_start[lo:hi], rec_end=self.rec_end[lo:hi],
            block_read=block_read - np.int32(lo) if lo else block_read,
            block_start=self.block_start[b0:b1],
            block_end=self.block_end[b0:b1], data=self.data)

    def qnames(self) -> list:
        """Decode query names (slow path; used by pair-filtering)."""
        out = []
        data = record_bytes(self)
        for s in self.rec_start:
            l_read_name = data[s + 12]
            off = s + 36
            out.append(bytes(data[off:off + l_read_name - 1]).decode())
        return out


def record_bytes(batch) -> np.ndarray:
    """The decoded bytes behind a batch's rec_start/rec_end, as uint8;
    raises on a batch read without them (BamStreamReader
    keep_bytes=False)."""
    if batch.data is None:
        raise ValueError(
            "this batch was read without its records' bytes "
            "(BamStreamReader keep_bytes=False); a reader of whole records "
            "needs keep_bytes=True")
    return _as_u8(batch.data)


# the read-level arrays of a RecordBatch but the two raw-byte offsets
_RECORD_COLUMNS = ("tid", "pos", "flag", "mapq", "nm", "as_score",
                   "seq_len", "aligned_cov", "aligned_single",
                   "aligned_pair", "indels", "read_end", "qname_hash")


def concat_batches(pieces) -> RecordBatch:
    """One RecordBatch of already-parsed non-empty batches, in order. The
    records' raw bytes are copied into one buffer, rec_start/rec_end
    rebased into it (readfilter._mtid and the `filter` subcommand read
    raw records through them) and block_read offset by the rows before
    each piece. Batches without their bytes (data None) give one without
    them: the offsets rebased alike, no byte copied."""
    if len(pieces) == 1:
        return pieces[0]
    keep = all(b.data is not None for b in pieces)
    datas, rec_start, rec_end, block_read = [], [], [], []
    base = rows = 0
    for b in pieces:
        lo, hi = int(b.rec_start[0]), int(b.rec_end[-1])
        if keep:
            datas.append(_as_u8(b.data)[lo:hi])
        rec_start.append(b.rec_start - lo + base)
        rec_end.append(b.rec_end - lo + base)
        block_read.append(b.block_read + np.int32(rows))
        base += hi - lo
        rows += b.n_records
    cols = {c: np.concatenate([getattr(b, c) for b in pieces])
            for c in _RECORD_COLUMNS + ("block_start", "block_end")}
    return RecordBatch(
        n_records=rows, **cols,
        rec_start=np.concatenate(rec_start), rec_end=np.concatenate(rec_end),
        block_read=np.concatenate(block_read),
        data=np.concatenate(datas) if keep else None)


def _u32_gather(arr: np.ndarray, offs: np.ndarray) -> np.ndarray:
    return (
        arr[offs].astype(np.uint32)
        | (arr[offs + 1].astype(np.uint32) << 8)
        | (arr[offs + 2].astype(np.uint32) << 16)
        | (arr[offs + 3].astype(np.uint32) << 24)
    )


def _u16_gather(arr: np.ndarray, offs: np.ndarray) -> np.ndarray:
    return arr[offs].astype(np.uint16) | (arr[offs + 1].astype(np.uint16) << 8)


_FNV_OFFSET = np.uint64(0xCBF29CE484222325)
_FNV_PRIME = np.uint64(0x100000001B3)


def _as_u8(data) -> np.ndarray:
    """Zero-copy uint8 view of a bytes / bytearray / ndarray buffer."""
    if isinstance(data, np.ndarray):
        return data
    return np.frombuffer(data, dtype=np.uint8)


def _cat(carry, seg):
    """Concatenate two byte buffers of either kind; zero-copy when carry
    is empty (the streaming common case)."""
    if carry is None or len(carry) == 0:
        return seg
    if isinstance(carry, np.ndarray) or isinstance(seg, np.ndarray):
        return np.concatenate([_as_u8(carry), _as_u8(seg)])
    return carry + seg


def _parse_header(data):
    if bytes(data[:4]) != b"BAM\x01":
        raise BamFormatError("Not a BAM file (bad magic)")
    # l_text is unsigned in practice: htslib round-trips >2 GiB SAM
    # headers (test_cmdline.rs:4212 writes a 2.5 GB header)
    (l_text,) = struct.unpack_from("<I", data, 4)
    if 8 + l_text + 4 > len(data):
        raise TruncatedHeaderError("header spans buffer")
    # huge headers are comment padding; keep text lazily bounded
    text = bytes(data[8: 8 + min(l_text, 1 << 26)]).split(b"\x00", 1)[0].decode()
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    from . import native
    walked = native.walk_refs(data, off, n_ref)
    if walked is not None:
        name_off, name_len, lens, end = walked
        if end < 0:
            raise TruncatedHeaderError("header spans buffer")
        names = [
            bytes(data[int(a): int(a + l)]).decode()
            for a, l in zip(name_off, name_len)]
        off = end
    else:
        names = []
        lens = np.empty(n_ref, dtype=np.int64)
        for i in range(n_ref):
            (l_name,) = struct.unpack_from("<i", data, off)
            off += 4
            names.append(bytes(data[off: off + l_name - 1]).decode())
            off += l_name
            (lens[i],) = struct.unpack_from("<I", data, off)
            off += 4
    header = BamHeader(text=text, target_names=names,
                       target_lens=np.asarray(lens, dtype=np.int64),
                       raw=data[:off])
    return header, off


def _scan_aux(data, aux_starts, aux_ends):
    """Extract NM (int) and AS (int) aux tags for each record.

    Returns (nm, as_score) int64 arrays; nm = -1 / as = INT64_MIN when the
    tag is absent.  Pure-python per-record walk (native decoder replaces
    this on the fast path).
    """
    n = len(aux_starts)
    nm = np.full(n, -1, dtype=np.int64)
    asv = np.full(n, np.iinfo(np.int64).min, dtype=np.int64)
    mv = data
    size1 = {ord("A"), ord("c"), ord("C")}
    size2 = {ord("s"), ord("S")}
    size4 = {ord("i"), ord("I"), ord("f")}
    for r in range(n):
        p = aux_starts[r]
        end = aux_ends[r]
        got = 0
        while p < end and got < 2:
            t0 = mv[p]
            t1 = mv[p + 1]
            typ = mv[p + 2]
            p += 3
            if typ in size1:
                val = mv[p]
                if typ == ord("c") and val >= 128:
                    val -= 256
                width = 1
            elif typ in size2:
                val = mv[p] | (mv[p + 1] << 8)
                if typ == ord("s") and val >= 1 << 15:
                    val -= 1 << 16
                width = 2
            elif typ in size4:
                val = mv[p] | (mv[p + 1] << 8) | (mv[p + 2] << 16) | (mv[p + 3] << 24)
                if typ == ord("i") and val >= 1 << 31:
                    val -= 1 << 32
                width = 4
            elif typ in (ord("Z"), ord("H")):
                q = p
                while mv[q] != 0:
                    q += 1
                width = q - p + 1
                val = None
            elif typ == ord("B"):
                sub = mv[p]
                (cnt,) = struct.unpack_from("<I", data, p + 1)
                esz = 1 if sub in size1 else 2 if sub in size2 else 4
                width = 5 + cnt * esz
                val = None
            else:
                raise BamFormatError(f"Unknown aux type {chr(typ)}")
            if val is not None:
                if t0 == 0x4E and t1 == 0x4D:  # 'NM'
                    nm[r] = val
                    got += 1
                elif t0 == 0x41 and t1 == 0x53:  # 'AS'
                    asv[r] = val
                    got += 1
            p += width
    return nm, asv


def parse_bam_bytes(raw: bytes) -> tuple:
    """Decode a whole BAM byte string: BGZF-compressed, uncompressed
    BAM, or SAM text (htslib reads all three transparently through the
    same `-b` inputs, e.g. tests/data/mapq_test.sam)."""
    if raw[:4] == b"BAM\x01":
        return parse_bam_data_raw(raw)
    if raw[:4] == b"CRAM":
        # the reference reads CRAM through htslib (lib.rs:138-180); here
        # the native CRAM 3.0 decoder lowers containers to uncompressed
        # BAM record bytes and the one vectorised parser handles both
        from .cram import cram_to_bam_data
        return parse_bam_data_raw(cram_to_bam_data(raw))
    if raw[:2] != b"\x1f\x8b":
        from .sam import sam_text_to_bam_data
        return parse_bam_data_raw(
            sam_text_to_bam_data(iter(raw.decode().splitlines())))
    from . import native
    data = native.bgzf_decompress(raw)
    if data is None:
        data = bgzf.decompress_all(raw)
    if data[:4] != b"BAM\x01":  # gzipped SAM text
        from .sam import sam_text_to_bam_data
        return parse_bam_data_raw(
            sam_text_to_bam_data(iter(data.decode().splitlines())))
    return parse_bam_data_raw(data)


def parse_bam_data_raw(data: bytes) -> tuple:
    """Decode uncompressed BAM bytes -> (BamHeader, RecordBatch)."""
    header, off = _parse_header(data)
    batch, _end = parse_records(data, off)
    return header, batch


def check_stuck_zero(buf, end_off: int) -> None:
    """A mid-stream zero block_size stalls the record chain forever: the
    walk treats bs==0 as end-of-stream, so a streaming reader would pile
    every later segment behind the stuck record — O(file) carry RSS and
    a silent tail drop (ADVICE r4).  Raise when bytes FOLLOW the zero
    field; a bare 4-zero tail at end-of-stream stays accepted."""
    if end_off + 4 < len(buf) and \
            bytes(memoryview(buf)[end_off:end_off + 4]) == b"\x00\x00\x00\x00":
        raise BamFormatError(
            "Malformed BAM record (zero block_size mid-stream)")


def batch_of_columns(cols, data) -> RecordBatch:
    """The RecordBatch of parse_records_full's columns (or the card
    parse's, ops/bam_scan.ParsedSegment.columns) over `data`."""
    return RecordBatch(
        n_records=cols["tid"].size,
        tid=cols["tid"], pos=cols["pos"], flag=cols["flag"],
        mapq=cols["mapq"], nm=cols["nm"], as_score=cols["as_score"],
        seq_len=cols["seq_len"], aligned_cov=cols["aligned_cov"],
        aligned_single=cols["aligned_cov"],  # M+I+D+X+= is the same set
        aligned_pair=cols["aligned_pair"], indels=cols["indels"],
        read_end=cols["read_end"], qname_hash=cols["qname_hash"],
        rec_start=cols["rec_start"], rec_end=cols["rec_end"],
        block_read=cols["block_read"], block_start=cols["block_start"],
        block_end=cols["block_end"], data=data,
    )


def parse_records(data: bytes, start: int, end: int | None = None) -> tuple:
    """Decode the COMPLETE records in data[start:end) -> (RecordBatch,
    end_offset). Records straddling `end` are left for the caller's next
    buffer (streaming ingestion)."""
    from . import native
    try:
        full = native.parse_records_full(data, start, end)
    except ValueError as e:
        raise BamFormatError(str(e))
    if full is not None:
        return batch_of_columns(full, data), full["end_off"]
    arr = _as_u8(data)
    n_bytes = len(data) if end is None else end
    off = start

    # 1. record offsets + aux tags + qname hashes (native fast path)
    from . import native
    native_scan = native.scan_records(data, off, n_bytes)
    if native_scan is not None:
        rec_offs, native_nm, native_as, native_qh = native_scan
        end_off = int(rec_offs[-1] + 4 + int(
            _u32_gather(arr, rec_offs[-1:])[0])) if rec_offs.size else off
    else:
        native_nm = None
        rec_offs = []
        p = off
        while p + 4 <= n_bytes:
            (block_size,) = struct.unpack_from("<I", data, p)
            if block_size == 0 or p + 4 + block_size > n_bytes:
                break
            rec_offs.append(p)
            p += 4 + block_size
        end_off = p
        rec_offs = np.asarray(rec_offs, dtype=np.int64)
    n = rec_offs.size
    if n == 0:
        empty_i32 = np.empty(0, dtype=np.int32)
        empty_i64 = np.empty(0, dtype=np.int64)
        batch = RecordBatch(
            n_records=0, tid=empty_i32, pos=empty_i32.copy(),
            flag=np.empty(0, dtype=np.uint16), mapq=np.empty(0, dtype=np.uint8),
            nm=empty_i64, as_score=empty_i64.copy(), seq_len=empty_i32.copy(),
            aligned_cov=empty_i64.copy(), aligned_single=empty_i64.copy(),
            aligned_pair=empty_i64.copy(), indels=empty_i64.copy(),
            read_end=empty_i32.copy(),
            qname_hash=np.empty(0, dtype=np.uint64),
            rec_start=empty_i64.copy(), rec_end=empty_i64.copy(),
            block_read=empty_i32.copy(), block_start=empty_i32.copy(),
            block_end=empty_i32.copy(), data=data,
        )
        return batch, end_off

    block_sizes = _u32_gather(arr, rec_offs).astype(np.int64)
    rec_end = rec_offs + 4 + block_sizes

    # 2. fixed fields (vectorised gathers)
    tid = _u32_gather(arr, rec_offs + 4).astype(np.int32)
    pos = _u32_gather(arr, rec_offs + 8).astype(np.int32)
    l_read_name = arr[rec_offs + 12].astype(np.int64)
    mapq = arr[rec_offs + 13]
    n_cigar = _u16_gather(arr, rec_offs + 16).astype(np.int64)
    flag = _u16_gather(arr, rec_offs + 18)
    l_seq = _u32_gather(arr, rec_offs + 20).astype(np.int32)

    # 3. CIGAR (fully vectorised)
    cig_start = rec_offs + 36 + l_read_name
    total_ops = int(n_cigar.sum())
    rec_of_op = np.repeat(np.arange(n, dtype=np.int64), n_cigar)
    excl = np.concatenate(([0], np.cumsum(n_cigar)))[:-1]
    op_idx = np.arange(total_ops, dtype=np.int64) - excl[rec_of_op]
    cig_pos = cig_start[rec_of_op] + 4 * op_idx
    cig = _u32_gather(arr, cig_pos)
    ops = (cig & 0xF).astype(np.int8)
    lens = (cig >> 4).astype(np.int64)

    consumes_ref = np.isin(ops, (OP_M, OP_D, OP_N, OP_EQ, OP_X))
    ref_adv = np.where(consumes_ref, lens, 0)
    # segmented exclusive cumsum of reference advances -> block cursors
    csum = np.cumsum(ref_adv)
    csum_excl = csum - ref_adv
    seg_base = np.concatenate(([0], csum))[excl]  # cumsum before each record
    cursor = pos[rec_of_op].astype(np.int64) + (csum_excl - seg_base[rec_of_op])

    is_block = np.isin(ops, (OP_M, OP_EQ, OP_X))
    block_read = rec_of_op[is_block].astype(np.int32)
    block_start = cursor[is_block].astype(np.int32)
    block_end = (cursor[is_block] + lens[is_block]).astype(np.int32)

    w = lens
    aligned_cov = np.bincount(
        rec_of_op, weights=np.where(np.isin(ops, (OP_M, OP_EQ, OP_X, OP_D, OP_I)), w, 0),
        minlength=n).astype(np.int64)
    aligned_pair = np.bincount(
        rec_of_op, weights=np.where(np.isin(ops, (OP_M, OP_EQ, OP_X, OP_I)), w, 0),
        minlength=n).astype(np.int64)
    indels = np.bincount(
        rec_of_op, weights=np.where(np.isin(ops, (OP_I, OP_D)), w, 0),
        minlength=n).astype(np.int64)
    aligned_single = aligned_cov  # M+I+D+X+= is the same op set
    ref_len = np.bincount(rec_of_op, weights=ref_adv, minlength=n).astype(np.int64)
    read_end = (pos.astype(np.int64) + ref_len).astype(np.int32)

    # 4./5. qname hashes + aux tags (python fallback when no native lib)
    if native_nm is not None:
        qname_hash, nm, asv = native_qh, native_nm, native_as
    else:
        qname_hash = np.full(n, _FNV_OFFSET, dtype=np.uint64)
        name_len = l_read_name - 1  # excludes NUL
        max_len = int(name_len.max()) if n else 0
        with np.errstate(over="ignore"):
            for i in range(max_len):
                act = name_len > i
                b = arr[rec_offs[act] + 36 + i].astype(np.uint64)
                qname_hash[act] = (qname_hash[act] ^ b) * _FNV_PRIME

        seq_bytes = ((l_seq.astype(np.int64) + 1) // 2)
        aux_start = cig_start + 4 * n_cigar + seq_bytes + l_seq
        nm, asv = _scan_aux(arr, aux_start, rec_end)

    batch = RecordBatch(
        n_records=n, tid=tid, pos=pos, flag=flag, mapq=mapq,
        nm=nm, as_score=asv, seq_len=l_seq,
        aligned_cov=aligned_cov, aligned_single=aligned_single,
        aligned_pair=aligned_pair, indels=indels, read_end=read_end,
        qname_hash=qname_hash, rec_start=rec_offs, rec_end=rec_end,
        block_read=block_read, block_start=block_start, block_end=block_end,
        data=data,
    )
    return batch, end_off


class BamReader:
    """Decode a BAM file.  Uses the native C++ decoder when available."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            raw = f.read()
        self.header, self.batch = parse_bam_bytes(raw)


class BamStreamReader:
    """Stream a BGZF BAM in bounded memory.

    The reference scans record-by-record through htslib
    (bam_generator.rs:103-144); here the compressed file is memory-mapped,
    its BGZF blocks inflate segment by segment (~``target_bytes``
    uncompressed each), and records decode into RecordBatches that are
    CUT AT CONTIG BOUNDARIES — every contig's records land in exactly one
    batch, so per-batch depth statistics are disjoint and merge by plain
    addition (scan.merge_scans). Memory is O(segment + largest single
    contig's records) instead of O(file).

    `device` (device.resolve_device: None is the card) says where a BGZF
    file's segments inflate and parse: on a CUDA device the card's inflate
    kernel puts each segment into a card slot after the carry, the card's
    parse (ops/bam_scan.parse_segment) writes the columns, and they come
    back into pinned host memory; the header is parsed on the host from
    the first segment's bytes, and the carry stays in host memory. The
    slot and the parse's buffers live only inside the card's turn
    (device.card_turn), which the engine's dispatch takes too. There is
    no fall-back to the host there. On the CPU the host inflates (native
    threads) and parses (parse_records_full). The segments are cut alike
    on both, so are the batches. CRAM, and BGZF without the native library
    (the portable zlib path), stay on the host. With `timing` the card
    route keeps its seconds and milliseconds in `timings`.

    `keep_bytes` keeps each batch's decoded bytes (RecordBatch.data) for
    the consumers that read records whole: the pair filters
    (readfilter._mtid, RecordBatch.qnames), `filter` and the shard merge.
    Without them (data None) the card route copies back only the
    columns and the carry, and the joins of a held contig's rows copy no
    bytes; a reader of whole records then raises (record_bytes).
    """

    def __init__(self, path: str, target_bytes: int = 1 << 28,
                 cut_contigs: bool = True, device=None, timing=False,
                 keep_bytes: bool = True):
        self.path = path
        self.target_bytes = int(target_bytes)
        # cut_contigs=False yields plain complete-record segment batches
        # (for NAME-sorted inputs — shard BAMs — where contig-boundary
        # cutting is meaningless and could make the carry unbounded)
        self.cut_contigs = cut_contigs
        self.device = device
        self.timing = timing
        self.keep_bytes = keep_bytes
        self.timings = {}
        self.header = None

    def read(self):
        """(header, batch_iterator) — the header is parsed eagerly."""
        gen = self._run()
        header = next(gen)
        return header, gen

    def _bgzf_table(self):
        """(memmap, block offsets, compressed and inflated sizes) of a BGZF
        file through the native library, else None."""
        from . import native
        with open(self.path, "rb") as f:
            if f.read(4) == b"CRAM" or native.get_lib() is None:
                return None
        mm = np.memmap(self.path, np.uint8, mode="r")
        tables = native.bgzf_scan(mm)
        return None if tables is None else (mm, *tables)

    def _segments(self, table):
        """The inflated segments on the host: a CRAM's containers as BAM
        bytes, a BGZF file's blocks through the native library by its
        `table` (_bgzf_table), or through zlib when there is none."""
        with open(self.path, "rb") as f:
            magic = f.read(4)
        if magic == b"CRAM":
            # containerwise CRAM decode: each yielded segment is
            # uncompressed-BAM bytes, so _run()'s header parse /
            # contig-boundary cutting applies unchanged
            from .cram import iter_bam_segments
            import mmap
            with open(self.path, "rb") as f:
                mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
                try:
                    yield from iter_bam_segments(mm)
                finally:
                    mm.close()
            return
        from . import native
        if table is not None:
            from .fastscan import plan_segments
            mm, off, csz, usz = table
            for i, j in plan_segments(usz, 0, self.target_bytes):
                seg = native.bgzf_inflate_blocks(
                    mm, off[i:j], csz[i:j], usz[i:j])
                if seg is None:
                    raise BamFormatError(
                        f"BGZF inflate failed in {self.path}")
                yield seg
            return
        # portable fallback: sequential zlib streaming
        from . import bgzf as _bgzf
        with open(self.path, "rb") as f:
            pend, size = [], 0
            for piece in _bgzf.iter_decompress(f):
                pend.append(piece)
                size += len(piece)
                if size >= self.target_bytes:
                    yield b"".join(pend)
                    pend, size = [], 0
            if pend:
                yield b"".join(pend)

    def parsed(self, header_at):
        """(batch, tail, last) for each segment in file order: the batch
        of its complete records (after the carry) parsed from the start
        that header_at gives, with its bytes when keep_bytes, and the bytes
        after them (the next carry); `last` marks the bytes left after the
        last segment (parsed when there are any). header_at(buf, final) ->
        (start, n_ref) reads the header
        from the first bytes: n_ref None while it spans beyond buf (buf
        from `start` is then carried whole); with final (the bytes left
        at the end) it raises on a header cut short, or gives n_ref None
        when nothing is left to parse. The card route on a CUDA device,
        else the host's; each a segment ahead on prefetch_iter's
        thread."""
        from ..device import resolve_device
        from ..prefetch import prefetch_iter
        from . import fastscan
        self.device = resolve_device(self.device)
        table = self._bgzf_table()
        make = fastscan._card_inflater(self.device) \
            if table is not None else None
        if make is not None:
            return prefetch_iter(self._card_parsed(make, table, header_at))
        return self._host_parsed(table, header_at)

    def _host_parsed(self, table, header_at):
        # carry: the raw bytes of a record that straddles two segments
        # (or of a header that spans them), never parsed yet. Segments are
        # uint8 ndarrays on the native path, so the carry slices below are
        # zero-copy views of the inflate buffer. The inflate runs a
        # segment ahead of the parse on prefetch_iter's thread.
        from ..prefetch import prefetch_iter
        carry = b""
        n_ref = None
        for seg in prefetch_iter(self._segments(table)):
            buf = _cat(carry, seg)
            start = 0
            if n_ref is None:
                start, n_ref = header_at(buf, False)
                if n_ref is None:
                    carry = buf[start:]
                    continue
            batch, end_off = parse_records(buf, start)
            carry = buf[end_off:]
            yield self._bytes_kept(batch), carry, False
        if n_ref is None:
            start, n_ref = header_at(carry, True)
            carry = carry[start:] if start else carry
        if n_ref is not None and len(carry):
            batch, end_off = parse_records(carry, 0)
            yield self._bytes_kept(batch), carry[end_off:], True

    def _bytes_kept(self, batch):
        if not self.keep_bytes:
            batch.data = None
        return batch

    def _card_parsed(self, make, table, header_at):
        """_host_parsed's segments, each inflated into a card slot after
        the carry (ops/bgzf_inflate.SegmentInflater) and parsed there
        (ops/bam_scan.parse_segment), the columns and the carry (with
        keep_bytes the slot's bytes instead) copied back into pinned host
        memory, all inside the card's turn."""
        import torch

        from ..device import card_turn
        from ..ops import bam_scan
        from .fastscan import _CARD_HEADROOM, plan_segments
        mm, off, csz, usz = table
        segments = plan_segments(usz, 0, self.target_bytes)
        inf = make(self.path, off, csz, usz, segments, _CARD_HEADROOM)
        turn = card_turn(inf.device)
        t = self.timings
        if self.timing:
            t.update(segments=0, records=0, parse_s=0.0, parse_ms={})

        def parse(slot, start, hi, n_ref, base, keep_bytes):
            t0 = time.perf_counter()
            ps = bam_scan.parse_segment(slot, start, hi, n_ref,
                                        timing=self.timing, base=base,
                                        keep_bytes=keep_bytes)
            if self.timing:
                t["parse_s"] += time.perf_counter() - t0
                t["segments"] += 1
                t["records"] += ps.n_records
                for k, v in ps.timing.items():
                    t["parse_ms"][k] = t["parse_ms"].get(k, 0.0) + v
            return ps
        carry = None
        n_ref = None
        try:
            if segments:
                inf.start(0)
            for s in range(len(segments)):
                if s + 1 < len(segments):
                    inf.start(s + 1)
                with turn:
                    try:
                        slot, lo, hi = inf.take(s, carry)
                    except ValueError:  # a block failed: the host's error
                        raise BamFormatError(
                            f"BGZF inflate failed in {self.path}") from None
                    with inf.on_stream():
                        buf, start = None, 0
                        if n_ref is None:
                            buf = _host_bytes(slot[lo:hi])
                            start, n_ref = header_at(buf, False)
                        ps = None if n_ref is None else parse(
                            slot, lo + start, hi, n_ref, lo,
                            self.keep_bytes and buf is None)
                    del slot
                if ps is None:  # the header spans beyond this segment
                    carry = buf[start:]
                    continue
                if buf is None:
                    buf, carry = ps.data, ps.tail
                else:  # the first segment's bytes, on the host already
                    carry = buf[ps.end_off:]
                yield batch_of_columns(
                    ps.columns, buf if self.keep_bytes else None), carry, \
                    False
            if self.timing:
                t.update(slot_wait_s=inf.wait_s, stage_s=inf.stage_s,
                         inflate_ms=sum(inf.kernel_ms))
            if n_ref is None:
                buf = np.empty(0, np.uint8) if carry is None else carry
                start, n_ref = header_at(buf, True)
                carry = buf[start:]
            if n_ref is not None and carry is not None and len(carry):
                with turn:
                    with inf.on_stream():
                        tail = torch.from_numpy(np.ascontiguousarray(
                            carry)).to(inf.device)
                        ps = parse(tail, 0, tail.numel(), n_ref, 0, False)
                        del tail
                yield batch_of_columns(
                    ps.columns, carry if self.keep_bytes else None), \
                    carry[ps.end_off:], True
        finally:
            inf.close()

    def _header_at(self, buf, final):
        """parsed()'s header_at for the reader: the header parsed from
        buf into self.header."""
        if not final:
            try:
                self.header, start = _parse_header(buf)
            except (struct.error, IndexError, UnicodeDecodeError,
                    TruncatedHeaderError):
                return 0, None  # header spans segments; keep accumulating
        else:
            self.header, start = _parse_header(buf)
        return start, self.header.n_ref

    def _run(self):
        # held: the parsed rows of the trailing open contig, yielded when
        # it closes. Every record is parsed once.
        held = []
        said = False
        for batch, tail, last in self.parsed(self._header_at):
            if not said:
                yield self.header
                said = True
            check_stuck_zero(tail, 0)
            if batch.n_records == 0:
                continue
            if last:
                held.append(batch)
                continue
            if not self.cut_contigs:
                yield batch
                continue
            # hold back the trailing open contig so no contig spans
            # batches; records of no contig (tid -1: the unplaced
            # unmapped tail) are yielded at once
            last_tid = int(batch.tid[-1])
            if last_tid < 0:
                cut = batch.n_records
            else:
                earlier = np.flatnonzero(batch.tid != last_tid)
                cut = int(earlier[-1]) + 1 if earlier.size else 0
            if cut == 0:
                if held and int(held[0].tid[0]) != last_tid:
                    yield concat_batches(held)
                    held = []
                held.append(batch)
                continue
            yield concat_batches(held + [batch.rows(0, cut)])
            n = batch.n_records
            held = [batch.rows(cut, n)] if cut < n else []
        if not said:
            yield self.header
        if held:
            yield concat_batches(held)


def _host_bytes(t) -> np.ndarray:
    """The bytes of uint8 tensor `t` in host memory: a view of a CPU
    tensor; a card tensor's in pinned memory, once the current stream has
    copied them."""
    if t.device.type == "cpu":
        return t.numpy()
    import torch
    h = torch.empty(t.numel(), dtype=torch.uint8, pin_memory=True)
    h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return h.numpy()
