"""ctypes binding for the native C++ BAM ingestion library.

Compiles lazily with the in-tree Makefile on first use (falling back to
the pure-python path when no toolchain is available).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_lib = None
_lock = threading.Lock()
_tried = False

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "native")
_SO_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libcovermio.so"))


def get_lib():
    """Return the loaded native library, building it if needed, or None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("COVERM_TPU_NO_NATIVE"):
            return None
        try:
            # make is a no-op when the .so is newer than the source
            subprocess.run(["make", "-C", os.path.abspath(_NATIVE_DIR)],
                           capture_output=True, check=True, timeout=300)
        except Exception:
            if not os.path.exists(_SO_PATH):
                return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:
            return None
        c_i64 = ctypes.c_int64
        c_u8p = ctypes.POINTER(ctypes.c_uint8)
        c_i64p = ctypes.POINTER(ctypes.c_int64)
        c_u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.ct_bgzf_scan.restype = c_i64
        lib.ct_bgzf_scan.argtypes = [c_u8p, c_i64, c_i64p, c_i64p, c_i64p]
        lib.ct_bgzf_inflate.restype = ctypes.c_int
        lib.ct_bgzf_inflate.argtypes = [c_u8p, c_i64, c_i64p, c_i64p, c_i64p,
                                        c_i64p, c_u8p, ctypes.c_int32]
        lib.ct_count_records.restype = c_i64
        lib.ct_count_records.argtypes = [c_u8p, c_i64, c_i64]
        lib.ct_walk_complete.restype = c_i64
        lib.ct_walk_complete.argtypes = [c_u8p, c_i64, c_i64, c_i64p]
        lib.ct_scan_records.restype = c_i64
        lib.ct_scan_records.argtypes = [c_u8p, c_i64, c_i64, c_i64, c_i64p,
                                        c_i64p, c_i64p, c_u64p]
        lib.ct_walk_refs.restype = c_i64
        lib.ct_walk_refs.argtypes = [c_u8p, c_i64, c_i64, c_i64, c_i64p,
                                     c_i64p, c_i64p]
        c_i32p = ctypes.POINTER(ctypes.c_int32)
        c_u16p = ctypes.POINTER(ctypes.c_uint16)
        try:
            lib.ct_parse_phase1.restype = c_i64
            lib.ct_parse_phase1.argtypes = [c_u8p, c_i64, c_i64, c_i64,
                                            c_i64p, c_i64p]
            lib.ct_parse_phase2.restype = ctypes.c_int
            lib.ct_parse_phase2.argtypes = [
                c_u8p, c_i64, c_i64p, c_i64p, c_i32p, c_i32p, c_u16p, c_u8p,
                c_i32p, c_i64p, c_i64p, c_u64p, c_i64p, c_i64p, c_i64p,
                c_i32p, c_i64p, c_i32p, c_i32p, c_i32p, ctypes.c_int32]
        except AttributeError:
            pass  # stale .so without the full parser; callers fall back
        try:
            lib.ct_rans_decode.restype = c_i64
            lib.ct_rans_decode.argtypes = [c_u8p, c_i64, c_u8p, c_i64]
            lib.ct_rans_decode_batch.restype = c_i64
            lib.ct_rans_decode_batch.argtypes = [c_u8p, c_i64p, c_u8p,
                                                 c_i64p, c_i64,
                                                 ctypes.c_int32]
        except AttributeError:
            pass
        try:
            c_f64p = ctypes.POINTER(ctypes.c_double)
            lib.ct_stats_scan.restype = ctypes.c_void_p
            lib.ct_stats_scan.argtypes = [c_u8p, c_i64, c_i64, ctypes.c_int32,
                                          ctypes.c_int32, ctypes.c_int32,
                                          ctypes.c_int32, c_i64p]
            lib.ct_stats_fill.restype = ctypes.c_int
            lib.ct_stats_fill.argtypes = [
                ctypes.c_void_p, ctypes.c_int32, c_i64p, c_i64p, c_i64p,
                c_i64p, c_i64p, c_f64p, c_f64p, c_u8p, c_i32p, c_i32p,
                c_i32p, c_i64p]
            lib.ct_stats_free.restype = None
            lib.ct_stats_free.argtypes = [ctypes.c_void_p]
            lib.ct_ingest_scan.restype = ctypes.c_void_p
            lib.ct_ingest_scan.argtypes = [
                c_u8p, c_i64, c_i64p, c_i64p, c_i64p, c_u8p, c_i64, c_i64,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, c_i64p]
            lib.ct_stats_leftover.restype = None
            lib.ct_stats_leftover.argtypes = [ctypes.c_void_p, c_u8p]
        except AttributeError:
            pass
        try:
            lib.ct_cram_decode_slice.restype = ctypes.c_void_p
            lib.ct_cram_decode_slice.argtypes = [
                c_u8p, c_i64, c_u8p, c_i64, c_u8p, c_i64, c_u8p, c_i64p,
                c_i64p, c_i64, c_u8p, c_i64, c_i64p]
            lib.ct_cram_out.restype = None
            lib.ct_cram_out.argtypes = [ctypes.c_void_p, c_u8p]
            lib.ct_cram_free.restype = None
            lib.ct_cram_free.argtypes = [ctypes.c_void_p]
        except AttributeError:
            pass
        try:
            lib.ct_cram_stats_slice.restype = ctypes.c_void_p
            lib.ct_cram_stats_slice.argtypes = [
                c_u8p, c_i64, c_u8p, c_i64, c_u8p, c_i64, c_u8p, c_i64p,
                c_i64p, c_i64p, c_i64, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, c_i64p]
        except AttributeError:
            pass
        _lib = lib
        return _lib


def _as_u8(data) -> np.ndarray:
    """Zero-copy uint8 view of bytes / bytearray / ndarray buffers."""
    if isinstance(data, np.ndarray):
        return data
    return np.frombuffer(data, dtype=np.uint8)


def _u8p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i64p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _u64p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def bgzf_decompress(raw: bytes, n_threads: int = 0) -> bytes | None:
    """Multi-threaded BGZF decode; None if the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    data = np.frombuffer(raw, dtype=np.uint8)
    n = lib.ct_bgzf_scan(_u8p(data), data.size, None, None, None)
    if n < 0:
        return None
    off = np.empty(n, np.int64)
    csz = np.empty(n, np.int64)
    usz = np.empty(n, np.int64)
    lib.ct_bgzf_scan(_u8p(data), data.size, _i64p(off), _i64p(csz), _i64p(usz))
    out_off = np.concatenate(([0], np.cumsum(usz)))[:-1]
    total = int(usz.sum())
    out = np.empty(total, np.uint8)
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 8)
    rc = lib.ct_bgzf_inflate(_u8p(data), n, _i64p(off), _i64p(csz),
                             _i64p(usz), _i64p(out_off), _u8p(out),
                             n_threads)
    if rc != 0:
        return None
    return out.tobytes()


def walk_complete(data, start: int, end: int | None = None):
    """(n_complete, end_off) of the records fully inside [start, end),
    or None without the native lib."""
    lib = get_lib()
    if lib is None:
        return None
    arr = _as_u8(data)
    end = arr.size if end is None else end
    end_off = np.zeros(1, np.int64)
    n = lib.ct_walk_complete(_u8p(arr), end, start, _i64p(end_off))
    return int(n), int(end_off[0])


def bgzf_scan(arr: np.ndarray):
    """Per-block (offset, csize, usize) tables of a BGZF byte array
    (may be a memmap), or None."""
    lib = get_lib()
    if lib is None:
        return None
    n = lib.ct_bgzf_scan(_u8p(arr), arr.size, None, None, None)
    if n < 0:
        return None
    off = np.empty(n, np.int64)
    csz = np.empty(n, np.int64)
    usz = np.empty(n, np.int64)
    lib.ct_bgzf_scan(_u8p(arr), arr.size, _i64p(off), _i64p(csz), _i64p(usz))
    return off, csz, usz


def bgzf_inflate_blocks(arr: np.ndarray, off, csz, usz,
                        n_threads: int = 0) -> np.ndarray | None:
    """Multi-threaded inflate of a RANGE of BGZF blocks from `arr`.

    Returns a uint8 ndarray (NOT bytes) so downstream record parsing and
    contig-boundary cuts are zero-copy views of the inflate buffer."""
    lib = get_lib()
    if lib is None:
        return None
    out_off = np.concatenate(([0], np.cumsum(usz)))[:-1]
    out = np.empty(int(usz.sum()), np.uint8)
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 8)
    rc = lib.ct_bgzf_inflate(_u8p(arr), off.size,
                             _i64p(np.ascontiguousarray(off)),
                             _i64p(np.ascontiguousarray(csz)),
                             _i64p(np.ascontiguousarray(usz)),
                             _i64p(out_off), _u8p(out), n_threads)
    if rc != 0:
        return None
    return out


def bgzf_inflate_into(arr: np.ndarray, off, csz, usz, out: np.ndarray,
                      at: int, n_threads: int = 0) -> bool:
    """Inflate a range of BGZF blocks into out[at:] (caller-allocated,
    e.g. with carry headroom before `at`).  Returns False on failure."""
    lib = get_lib()
    if lib is None:
        return False
    out_off = np.concatenate(([0], np.cumsum(usz)))[:-1]
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 8)
    rc = lib.ct_bgzf_inflate(_u8p(arr), off.size,
                             _i64p(np.ascontiguousarray(off)),
                             _i64p(np.ascontiguousarray(csz)),
                             _i64p(np.ascontiguousarray(usz)),
                             _i64p(out_off), _u8p(out[at:]), n_threads)
    return rc == 0


def walk_refs(data, off: int, n_ref: int):
    """Native walk of the header reference list.

    Returns (name_off, name_len, tlen, end_off) or None (no lib);
    end_off is -1 when the buffer is truncated mid-list."""
    lib = get_lib()
    if lib is None:
        return None
    arr = _as_u8(data)
    name_off = np.empty(n_ref, np.int64)
    name_len = np.empty(n_ref, np.int64)
    tlen = np.empty(n_ref, np.int64)
    end = lib.ct_walk_refs(_u8p(arr), arr.size, off, n_ref, _i64p(name_off),
                           _i64p(name_len), _i64p(tlen))
    return name_off, name_len, tlen, int(end)


def parse_records_full(data, header_end: int, end: int | None = None,
                       n_threads: int = 0):
    """Full native record parse of the COMPLETE records in
    [header_end, end): every RecordBatch column in one C++ pass
    (sequential offset walk, then parallel per-record decode).

    Returns a dict of arrays (+ "end_off"), or None when the native lib
    (or the parser entry points) is unavailable.  Raises ValueError on a
    malformed aux region, matching the python parser.
    """
    lib = get_lib()
    if lib is None or not hasattr(lib, "ct_parse_phase1"):
        return None
    arr = _as_u8(data)
    end = arr.size if end is None else end
    end_off = np.zeros(1, np.int64)
    n = lib.ct_walk_complete(_u8p(arr), end, header_end, _i64p(end_off))
    rec_off = np.empty(n, np.int64)
    nblocks = np.empty(n, np.int64)
    if lib.ct_parse_phase1(_u8p(arr), end, header_end, n, _i64p(rec_off),
                           _i64p(nblocks)) != n:
        return None
    csum = np.cumsum(nblocks)
    block_base = csum - nblocks  # exclusive prefix sum
    n_blocks = int(csum[-1]) if n else 0

    def i32(k=n):
        return np.empty(k, np.int32)

    out = dict(
        tid=i32(), pos=i32(), flag=np.empty(n, np.uint16),
        mapq=np.empty(n, np.uint8), seq_len=i32(),
        nm=np.empty(n, np.int64), as_score=np.empty(n, np.int64),
        qname_hash=np.empty(n, np.uint64),
        aligned_cov=np.empty(n, np.int64), aligned_pair=np.empty(n, np.int64),
        indels=np.empty(n, np.int64), read_end=i32(),
        rec_start=rec_off, rec_end=np.empty(n, np.int64),
        block_read=i32(n_blocks), block_start=i32(n_blocks),
        block_end=i32(n_blocks),
    )
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 8)
    c_i32p = ctypes.POINTER(ctypes.c_int32)
    c_u16p = ctypes.POINTER(ctypes.c_uint16)
    rc = lib.ct_parse_phase2(
        _u8p(arr), n, _i64p(rec_off), _i64p(block_base),
        out["tid"].ctypes.data_as(c_i32p), out["pos"].ctypes.data_as(c_i32p),
        out["flag"].ctypes.data_as(c_u16p), _u8p(out["mapq"]),
        out["seq_len"].ctypes.data_as(c_i32p), _i64p(out["nm"]),
        _i64p(out["as_score"]), _u64p(out["qname_hash"]),
        _i64p(out["aligned_cov"]), _i64p(out["aligned_pair"]),
        _i64p(out["indels"]), out["read_end"].ctypes.data_as(c_i32p),
        _i64p(out["rec_end"]), out["block_read"].ctypes.data_as(c_i32p),
        out["block_start"].ctypes.data_as(c_i32p),
        out["block_end"].ctypes.data_as(c_i32p), n_threads)
    if rc < 0:
        raise ValueError(
            f"Unknown aux tag type while scanning BAM record {-rc - 1}")
    out["end_off"] = int(out["rec_end"][-1]) if n else header_end
    return out


def scan_records(data, header_end: int, end: int | None = None):
    """Native record-offset walk + NM/AS aux scan + qname hashing over
    the COMPLETE records in [header_end, end).

    Returns (rec_off, nm, as_score, qname_hash) or None."""
    lib = get_lib()
    if lib is None:
        return None
    arr = _as_u8(data)
    end = arr.size if end is None else end
    end_off = np.zeros(1, np.int64)
    n = lib.ct_walk_complete(_u8p(arr), end, header_end, _i64p(end_off))
    rec_off = np.empty(n, np.int64)
    nm = np.empty(n, np.int64)
    as_score = np.empty(n, np.int64)
    qh = np.empty(n, np.uint64)
    filled = lib.ct_scan_records(_u8p(arr), end, header_end, n,
                                 _i64p(rec_off), _i64p(nm), _i64p(as_score),
                                 _u64p(qh))
    if filled < 0:
        raise ValueError(
            f"Unknown aux tag type while scanning BAM record {-filled - 1}")
    if filled != n:
        return None
    return rec_off, nm, as_score, qh


class StatsAccum:
    """Per-contig statistics accumulated across fused native scans.

    The arrays are passed straight to ct_stats_fill, which += into them
    in deterministic chunk order, so a multi-segment streaming pass
    accumulates without any numpy merging."""

    def __init__(self, n_ref: int):
        self.n_ref = n_ref
        z = lambda: np.zeros(n_ref, np.int64)
        self.reads_primary = z()
        self.reads_nonsupp = z()
        self.reads_all = z()
        self.nm_sum = z()
        self.indel_sum = z()
        self.ident_primary = np.zeros(n_ref, np.float64)
        self.ident_nonsupp = np.zeros(n_ref, np.float64)
        self.observed = np.zeros(n_ref, np.uint8)
        self.n_primary = 0
        self.nm_missing = 0
        self.n_records = 0
        self.last_tid = -1  # cross-segment sortedness
        self.sorted = True


def _finish_stats_handle(lib, h, scalars, acc: StatsAccum,
                         leftover_from_buf: bool):
    """Shared epilogue for stats_scan / ingest_scan: error checks, block
    extraction, per-contig accumulation, cross-segment sortedness."""
    try:
        if scalars[9]:
            raise ValueError("BGZF inflate failed inside the fused ingest")
        if scalars[8]:
            raise ValueError(
                f"Malformed BAM record {int(scalars[8]) - 1} "
                "(unknown aux tag type or truncated record)")
        n_blocks = int(scalars[2])
        btid = np.empty(n_blocks, np.int32)
        bstart = np.empty(n_blocks, np.int32)
        bend = np.empty(n_blocks, np.int32)
        c_i32p = ctypes.POINTER(ctypes.c_int32)
        c_f64p = ctypes.POINTER(ctypes.c_double)
        seg_counts = np.zeros(acc.n_ref, np.int64)
        rc = lib.ct_stats_fill(
            h, acc.n_ref, _i64p(acc.reads_primary), _i64p(acc.reads_nonsupp),
            _i64p(acc.reads_all), _i64p(acc.nm_sum), _i64p(acc.indel_sum),
            acc.ident_primary.ctypes.data_as(c_f64p),
            acc.ident_nonsupp.ctypes.data_as(c_f64p), _u8p(acc.observed),
            btid.ctypes.data_as(c_i32p), bstart.ctypes.data_as(c_i32p),
            bend.ctypes.data_as(c_i32p), _i64p(seg_counts))
        if rc != 0:
            raise ValueError("BAM record references an out-of-range tid")
        leftover = None
        if leftover_from_buf:
            leftover = np.empty(max(int(scalars[10]), 0), np.uint8)
            if leftover.size:
                lib.ct_stats_leftover(h, _u8p(leftover))
    finally:
        lib.ct_stats_free(h)
    acc.n_primary += int(scalars[3])
    acc.nm_missing += int(scalars[4])
    acc.n_records += int(scalars[0])
    first_tid, last_tid = int(scalars[6]), int(scalars[7])
    if not scalars[5]:
        acc.sorted = False
    if first_tid >= 0:
        if acc.last_tid >= 0 and first_tid < acc.last_tid:
            acc.sorted = False
        acc.last_tid = last_tid
    return btid, bstart, bend, seg_counts, leftover


def ingest_scan(comp: np.ndarray, off, csz, usz, carry, start: int,
                acc: StatsAccum, skip_mask: int, req_mask: int,
                n_threads: int = 0):
    """Fully fused segment ingest: threaded BGZF inflate + frontier-
    chasing chain walk + stats/block scan in one native call.

    Returns (btid, bstart, bend, seg_counts, leftover_bytes) or None
    when the entry points are unavailable; raises ValueError on
    malformed input."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "ct_ingest_scan"):
        return None
    carry = _as_u8(carry if carry is not None else b"")
    off = np.ascontiguousarray(off)
    csz = np.ascontiguousarray(csz)
    usz = np.ascontiguousarray(usz)
    if n_threads <= 0:
        # one worker beyond the core count fills the bubbles left by
        # the chain walker's frontier waits (measured ~10% on 2 vCPUs)
        n_threads = min((os.cpu_count() or 1) + 1, 8)
    scalars = np.zeros(11, np.int64)
    h = lib.ct_ingest_scan(_u8p(comp), off.size, _i64p(off), _i64p(csz),
                           _i64p(usz), _u8p(carry), carry.size, start,
                           acc.n_ref, skip_mask, req_mask, n_threads,
                           _i64p(scalars))
    if not h:
        return None
    total = carry.size + int(usz.sum())
    scalars[10] = total - int(scalars[1])  # leftover length
    return _finish_stats_handle(lib, h, scalars, acc, leftover_from_buf=True)


def stats_scan(data, start: int, acc: StatsAccum, skip_mask: int,
               req_mask: int, end: int | None = None,
               n_threads: int = 0):
    """Fused chain-walk + stats + block extraction over the COMPLETE
    records in [start, end), accumulating per-contig statistics into
    `acc` (deterministic chunk-ordered merge in C++).

    Returns (btid, bstart, bend, end_off) — the filtered coverage-block
    arrays in record order — or None when the native entry points are
    unavailable.  Raises ValueError on malformed records."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "ct_stats_scan"):
        return None
    arr = _as_u8(data)
    end = arr.size if end is None else end
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 8)
    scalars = np.zeros(11, np.int64)
    h = lib.ct_stats_scan(_u8p(arr), end, start, acc.n_ref, skip_mask,
                          req_mask, n_threads, _i64p(scalars))
    if not h:
        return None
    btid, bstart, bend, seg_counts, _ = _finish_stats_handle(
        lib, h, scalars, acc, leftover_from_buf=False)
    return btid, bstart, bend, seg_counts, int(scalars[1])


def cram_decode_slice(comp_hdr, slice_hdr, core, ext_items, rg_blob):
    """Native CRAM slice decode -> (bam_record_bytes, n_records,
    n_seq_incomplete), or None (unavailable / malformed -> the caller
    falls back to the pure-python decoder for this slice)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "ct_cram_decode_slice"):
        return None
    comp = _as_u8(comp_hdr)
    sh = _as_u8(slice_hdr)
    cr = _as_u8(core)
    ids = np.asarray([cid for cid, _ in ext_items], np.int64)
    lens = np.asarray([len(d) for _, d in ext_items], np.int64)
    off = np.zeros(ids.size + 1, np.int64)
    if ids.size:
        np.cumsum(lens, out=off[1:])
    buf = _as_u8(b"".join(bytes(d) for _, d in ext_items))
    rg = _as_u8(rg_blob)
    scalars = np.zeros(4, np.int64)
    h = lib.ct_cram_decode_slice(_u8p(comp), comp.size, _u8p(sh), sh.size,
                                 _u8p(cr), cr.size, _u8p(buf), _i64p(off),
                                 _i64p(ids), ids.size, _u8p(rg), rg.size,
                                 _i64p(scalars))
    if not h:
        return None
    try:
        if scalars[2]:
            return None
        out = np.empty(int(scalars[1]), np.uint8)
        if out.size:
            lib.ct_cram_out(h, _u8p(out))
    finally:
        lib.ct_cram_free(h)
    return out.tobytes(), int(scalars[0]), int(scalars[3])


def cram_stats_slice(comp_hdr, slice_hdr, core, ext_items,
                     acc: StatsAccum, skip_mask: int, req_mask: int):
    """Native CRAM slice decode STRAIGHT into the fused-scan stats model
    (no BAM wire bytes, no re-scan): accumulates per-contig statistics
    into `acc` and returns (btid, bstart, bend, seg_counts), or None
    (unavailable / malformed -> the caller falls back to the python
    record model + stats_scan for this slice)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "ct_cram_stats_slice"):
        return None
    comp = _as_u8(comp_hdr)
    sh = _as_u8(slice_hdr)
    cr = _as_u8(core)
    # an ext item may be a LazyBlock (size-only stream, never
    # decompressed): it contributes NO bytes to the buffer but its
    # uncompressed size keeps the native skip cursors in lockstep
    ids = np.asarray([cid for cid, _ in ext_items], np.int64)
    present = [b"" if hasattr(d, "rsize") else bytes(d)
               for _, d in ext_items]
    sizes = np.asarray(
        [d.rsize if hasattr(d, "rsize") else len(d)
         for _, d in ext_items], np.int64)
    off = np.zeros(ids.size + 1, np.int64)
    if ids.size:
        np.cumsum([len(b) for b in present], out=off[1:])
    buf = _as_u8(b"".join(present))
    scalars = np.zeros(11, np.int64)
    h = lib.ct_cram_stats_slice(_u8p(comp), comp.size, _u8p(sh), sh.size,
                                _u8p(cr), cr.size, _u8p(buf), _i64p(off),
                                _i64p(sizes), _i64p(ids), ids.size,
                                acc.n_ref, skip_mask,
                                req_mask, _i64p(scalars))
    if not h:
        return None
    btid, bstart, bend, seg_counts, _ = _finish_stats_handle(
        lib, h, scalars, acc, leftover_from_buf=False)
    return btid, bstart, bend, seg_counts


def rans_decode_batch(blobs, out_sizes) -> list | None:
    """Threaded decode of independent rANS blocks -> list of bytes, or
    None (unavailable / any block malformed -> caller decodes blocks
    one by one with full error context)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "ct_rans_decode_batch"):
        return None
    n = len(blobs)
    in_off = np.zeros(n + 1, np.int64)
    np.cumsum([len(b) for b in blobs], out=in_off[1:])
    out_off = np.zeros(n + 1, np.int64)
    np.cumsum(out_sizes, out=out_off[1:])
    in_buf = _as_u8(b"".join(bytes(b) for b in blobs))
    out = np.empty(max(int(out_off[-1]), 1), np.uint8)
    nt = min((os.cpu_count() or 1) + 1, 8)
    rc = lib.ct_rans_decode_batch(_u8p(in_buf), _i64p(in_off), _u8p(out),
                                  _i64p(out_off), n, nt)
    if rc != 0:
        return None
    buf = out.tobytes()
    return [buf[int(out_off[k]):int(out_off[k + 1])] for k in range(n)]


def rans_decode(blob) -> bytes | None:
    """Native rANS 4x8 block decode (order 0/1); None -> caller falls
    back to the pure-python decoder in io/cram.py."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "ct_rans_decode"):
        return None
    arr = _as_u8(blob)
    if arr.size < 9:
        return None
    n_out = int(np.frombuffer(arr[5:9].tobytes(), np.uint32)[0])
    out = np.empty(max(n_out, 1), np.uint8)
    r = lib.ct_rans_decode(_u8p(arr), arr.size, _u8p(out), n_out)
    if r != n_out:
        return None
    return out[:n_out].tobytes()
