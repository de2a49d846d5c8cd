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


CRAM_UNSUPPORTED = "CRAM input is not yet supported by coverm_tpu_torch"


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
    data: bytes = b""  # decoded BAM byte stream (for record re-emission)

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

    def head(self, k: int) -> "RecordBatch":
        """First k record rows (and their blocks) as zero-copy views.
        block_read is non-decreasing (blocks are emitted in record
        order), so the block cut is a searchsorted prefix."""
        bcut = int(np.searchsorted(self.block_read, k, side="left"))
        return RecordBatch(
            n_records=k,
            tid=self.tid[:k], pos=self.pos[:k], flag=self.flag[:k],
            mapq=self.mapq[:k], nm=self.nm[:k], as_score=self.as_score[:k],
            seq_len=self.seq_len[:k], aligned_cov=self.aligned_cov[:k],
            aligned_single=self.aligned_single[:k],
            aligned_pair=self.aligned_pair[:k], indels=self.indels[:k],
            read_end=self.read_end[:k], qname_hash=self.qname_hash[:k],
            rec_start=self.rec_start[:k], rec_end=self.rec_end[:k],
            block_read=self.block_read[:bcut],
            block_start=self.block_start[:bcut],
            block_end=self.block_end[:bcut],
            data=self.data,
        )

    def qnames(self) -> list:
        """Decode query names (slow path; used by pair-filtering)."""
        out = []
        data = self.data
        for s in self.rec_start:
            l_read_name = data[s + 12]
            off = s + 36
            out.append(bytes(data[off:off + l_read_name - 1]).decode())
        return out


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
            names.append(data[off : off + l_name - 1].decode())
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
        raise BamFormatError(CRAM_UNSUPPORTED)
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
        batch = RecordBatch(
            n_records=full["tid"].size,
            tid=full["tid"], pos=full["pos"], flag=full["flag"],
            mapq=full["mapq"], nm=full["nm"], as_score=full["as_score"],
            seq_len=full["seq_len"], aligned_cov=full["aligned_cov"],
            aligned_single=full["aligned_cov"],  # M+I+D+X+= is the same set
            aligned_pair=full["aligned_pair"], indels=full["indels"],
            read_end=full["read_end"], qname_hash=full["qname_hash"],
            rec_start=full["rec_start"], rec_end=full["rec_end"],
            block_read=full["block_read"], block_start=full["block_start"],
            block_end=full["block_end"], data=data,
        )
        return batch, full["end_off"]
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
    BGZF blocks inflate natively (multi-threaded) segment by segment
    (~``target_bytes`` uncompressed each), and records decode into
    RecordBatches that are CUT AT CONTIG BOUNDARIES — every contig's
    records land in exactly one batch, so per-batch depth statistics are
    disjoint and merge by plain addition (scan.merge_scans).  Memory is
    O(segment + largest single contig's records) instead of O(file).
    """

    def __init__(self, path: str, target_bytes: int = 1 << 28,
                 cut_contigs: bool = True):
        self.path = path
        self.target_bytes = int(target_bytes)
        # cut_contigs=False yields plain complete-record segment batches
        # (for NAME-sorted inputs — shard BAMs — where contig-boundary
        # cutting is meaningless and could make the carry unbounded)
        self.cut_contigs = cut_contigs
        self.header = None

    def read(self):
        """(header, batch_iterator) — the header is parsed eagerly."""
        gen = self._run()
        header = next(gen)
        return header, gen

    def _segments(self):
        with open(self.path, "rb") as f:
            magic = f.read(4)
        if magic == b"CRAM":
            raise BamFormatError(CRAM_UNSUPPORTED)
        from . import native
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
                    seg = native.bgzf_inflate_blocks(
                        mm, off[i:j], csz[i:j], usz[i:j])
                    if seg is None:
                        raise BamFormatError(
                            f"BGZF inflate failed in {self.path}")
                    yield seg
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
                    yield b"".join(pend)
                    pend, size = [], 0
            if pend:
                yield b"".join(pend)

    def _run(self):
        from ..prefetch import prefetch_iter

        carry = b""
        # prefetch one segment ahead: BGZF inflate (native thread pool)
        # overlaps record parse — the pipeline analogue of htslib's
        # decode-thread overlap with the reference's scan thread.
        # Segments are uint8 ndarrays on the native path, so the carry
        # slices below are zero-copy views of the inflate buffer.
        for seg in prefetch_iter(self._segments()):
            buf = _cat(carry, seg)
            carry = b""
            start = 0
            if self.header is None:
                try:
                    self.header, start = _parse_header(buf)
                except (struct.error, IndexError, UnicodeDecodeError,
                        TruncatedHeaderError):
                    carry = buf  # header spans segments; keep accumulating
                    continue
                yield self.header
            batch, end_off = parse_records(buf, start)
            check_stuck_zero(buf, end_off)
            if batch.n_records == 0:
                carry = buf[end_off:]
                continue
            if not self.cut_contigs:
                yield batch
                carry = buf[end_off:]
                continue
            # hold back the trailing open contig so no contig spans batches
            last_tid = int(batch.tid[-1])
            earlier = np.flatnonzero(batch.tid != last_tid)
            cut = int(earlier[-1]) + 1 if earlier.size else 0
            if cut == 0:
                carry = buf[int(batch.rec_start[0]):]
                continue
            cut_off = int(batch.rec_start[cut])
            yield batch.head(cut)
            carry = buf[cut_off:]
        if self.header is None:
            self.header, start = _parse_header(carry)
            yield self.header
            carry = carry[start:] if start else carry
            batch, e2 = parse_records(carry, 0) if len(carry) else (None, 0)
            check_stuck_zero(carry, e2)
        elif len(carry):
            batch, e2 = parse_records(carry, 0)
            check_stuck_zero(carry, e2)
        else:
            batch = None
        if batch is not None and batch.n_records:
            yield batch
